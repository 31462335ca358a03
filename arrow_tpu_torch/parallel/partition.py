"""Hash-partitioned shuffle: the engine's distributed exchange
(counterpart of arrow_tpu/parallel/partition.py:34-110).

Static-shape discipline, as in the reference: every shard sends a fixed
(n_shards, capacity) slab; real rows are marked by a validity mask, and
slots past a destination's count carry garbage masked by it.  Overflow
is never silent: `bucketize` flags a destination whose rows exceed the
capacity, and `exchange` sums the flag over the mesh, so every shard
agrees whether the shuffle lost rows.

Keys are u64 bits on int64 storage (torch's uint64 has no `>>`, `%` or
compare): `hash_u64` shifts logically and `_umod` takes the unsigned
modulo, so a key at or above 2^63 lands on the reference's shard.

All functions here are per-shard bodies or helpers of them: no host
syncs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.bits import lsr, mix64

__all__ = ["hash_u64", "bucketize", "exchange", "ShuffleResult",
           "repartition_arrays"]

def _umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """u64 x % m on int64 storage (m < 2^62)."""
    return ((lsr(x, 1) % m) * 2 + (x & 1)) % m


def hash_u64(key: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over u64 order keys (int64 storage): uniform
    shard assignment even for sequential keys.  Multiply and xor wrap
    the same on int64 as on u64."""
    return mix64(key.to(torch.int64))


class ShuffleResult(NamedTuple):
    """Per-shard receive slab: arrays shaped (n_shards * capacity, ...),
    `valid` marking real rows, `overflow` a mesh-wide flag (True anywhere
    => some shard dropped rows for capacity: results are incomplete and
    the table API raises)."""
    arrays: tuple              # value tensors
    valid: torch.Tensor        # bool (n_shards * capacity,)
    overflow: torch.Tensor     # bool scalar, agreed across the mesh


def bucketize(target: torch.Tensor, valid: torch.Tensor, n_shards: int,
              capacity: int, *arrays: torch.Tensor):
    """Scatter local rows into per-destination buckets.

    target: int32 destination shard per row; rows with valid=False are
    dropped.  Returns (slabs, slab_valid, overflow) with each slab shaped
    (n_shards, capacity).  One stable sort groups rows by destination;
    a slab is a gather, slab[s, p] = row order[starts[s] + p] while p <
    counts[s], and a clamped row past it.  An array passed twice (the
    same tensor) is gathered once.
    """
    n = target.shape[0]
    t = torch.where(valid, target, n_shards)     # invalid rows -> last bin
    t_sorted, order = torch.sort(t, stable=True)
    # run bounds of each destination in the sorted order (no host sync)
    bounds = torch.searchsorted(t_sorted, torch.arange(
        n_shards + 1, dtype=t.dtype, device=t.device))
    del t_sorted
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    overflow = (counts > capacity).any()
    slot = torch.arange(capacity, device=target.device)
    slab_valid = slot[None, :] < counts[:, None]
    src = torch.clamp(starts[:, None] + slot[None, :], max=max(n - 1, 0))
    gidx = order[src.reshape(-1)]
    del order, src
    done = {}
    slabs = []
    for a in arrays:
        if id(a) not in done:
            done[id(a)] = a[gidx].reshape((n_shards, capacity)
                                          + tuple(a.shape[1:]))
        slabs.append(done[id(a)])
    return tuple(slabs), slab_valid, overflow


def exchange(comm, slabs: tuple, slab_valid: torch.Tensor,
             overflow: Optional[torch.Tensor] = None) -> ShuffleResult:
    """all_to_all the (n_shards, capacity) slabs: row block i of the
    result came from shard i.  The local overflow flag is summed over
    the mesh so every shard agrees whether the shuffle lost rows."""
    done = {}
    out = []
    for s in slabs:
        if id(s) not in done:
            done[id(s)] = comm.all_to_all(s).reshape(
                (-1,) + tuple(s.shape[2:]))
        out.append(done[id(s)])
    valid = comm.all_to_all(slab_valid).reshape(-1)
    if overflow is None:
        overflow = torch.zeros((), dtype=torch.bool, device=valid.device)
    agreed = comm.psum(overflow.to(torch.int32)) > 0
    return ShuffleResult(tuple(out), valid, agreed)


def repartition_arrays(comm, key: torch.Tensor, valid: torch.Tensor,
                       capacity: int, *arrays: torch.Tensor
                       ) -> ShuffleResult:
    """Full shuffle: route each row to shard hash(key) % n_shards (the
    u64 modulo).  Per-shard body; arrays are the row payloads (the key
    itself may be one of them)."""
    target = _umod(hash_u64(key), comm.size).to(torch.int32)
    slabs, slab_valid, overflow = bucketize(target, valid, comm.size,
                                            capacity, *arrays)
    return exchange(comm, slabs, slab_valid, overflow)
