"""The shard mesh, its communicators and `shard_map`, the runner of
per-shard bodies (counterpart of arrow_tpu/parallel/mesh.py:23-37 and of
`jax.shard_map` with `P(axis)` / `P()` specs).

The reference's bodies are `shard_map` programs: one function per shard
that takes the mesh axis' name and calls `all_to_all`, `all_gather` and
`psum` on it.  Here a body takes, in the axis' place, a communicator
bound to one shard:

  * `size` and `rank`;
  * `all_to_all(t)`: dim 0 cut into `size` equal blocks; block i of the
    result came from shard i (`jax.lax.all_to_all(..., split_axis=0,
    concat_axis=0, tiled=True)`);
  * `all_gather(t)`: every shard's `t` concatenated in rank order;
  * `psum(t)`: the sum over shards.

Two implementations:

  * `LocalMesh` holds n shards in one process, one thread a shard, on
    one device or on a list of devices: the single-controller form the
    table API needs, and the route that runs several shards on one card
    (NCCL refuses two ranks on one GPU).  Collectives meet at a
    `threading.Barrier`; results are ordered by rank, never by arrival,
    so `psum` of floats adds in rank order.  The shards of one device
    take turns between collectives (`_Exchange`).  An exception in one
    shard aborts the barrier, so the others raise instead of waiting,
    and the runner re-raises the first error.
  * `ProcessGroupComm` is one process a shard over `torch.distributed`:
    NCCL for CUDA tensors, gloo for CPU tensors.  Its `psum` of floats
    adds in the order the collective picks.  Each process calls the body
    itself with its own rows: there is no runner.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import torch

from ..config import DeviceLike, resolve_device

__all__ = ["make_mesh", "shard_axis", "table_sharding", "RowSplit",
           "LocalMesh", "ProcessGroupComm", "shard_map"]

SHARD_AXIS = "shards"
BARRIER_TIMEOUT = 600.0      # seconds a shard waits for the others


class LocalMesh:
    """`n_shards` shards in this process: shard i runs on `devices[i]`."""

    def __init__(self, devices: Sequence[torch.device],
                 timeout: float = BARRIER_TIMEOUT):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices = tuple(devices)
        self.timeout = timeout
        self.axis_names = (SHARD_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_shards: int,
              device: Union[DeviceLike, Sequence[DeviceLike]]) -> LocalMesh:
    """A mesh of `n_shards` shards on `device` (all of them on one card
    or on the CPU), or on a list of `n_shards` devices, one a shard.
    There is no default device."""
    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
        if len(devices) != n_shards:
            raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    else:
        devices = [resolve_device(device)] * n_shards
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    return LocalMesh(devices)


def shard_axis(mesh) -> str:
    return mesh.axis_names[0]


@dataclass(frozen=True)
class RowSplit:
    """Rows cut into `n_shards` contiguous blocks of equal size, block i
    on shard i: what the reference's `table_sharding` (a NamedSharding
    of `P("shards")`) names.  torch has no sharded tensor, so this only
    names the split that `shard_map` makes of a `P(axis)` input."""
    n_shards: int
    dim: int = 0

    def blocks(self, t: torch.Tensor) -> List[torch.Tensor]:
        if t.shape[self.dim] % self.n_shards:
            raise ValueError(f"{t.shape[self.dim]} rows do not split into "
                             f"{self.n_shards} equal blocks")
        return list(torch.chunk(t, self.n_shards, self.dim))


def table_sharding(mesh) -> RowSplit:
    """Rows sharded over the mesh axis (columns are 1-D row tensors)."""
    return RowSplit(mesh.size)


# ---- communicators ----------------------------------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    """Integer storage of the same bits (bool as uint8)."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


class _Exchange:
    """One run's meeting point: a slot per shard, a barrier, and a lock
    per device.  A shard's thread holds its device's lock while it works
    and lets go of it only while it waits in a collective, so the shards
    of one card take turns between collectives: their kernels share the
    card's stream anyway, and only one shard's temporaries are live at a
    time (eight shards' sorts at once would need eight times the
    memory)."""

    def __init__(self, n: int, timeout: float, devices):
        self.slots: List[object] = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.locks = {d: threading.Lock() for d in devices}

    def swap(self, rank: int, value, lock: threading.Lock) -> list:
        """Every shard's `value`, in rank order."""
        self.slots[rank] = value
        lock.release()
        try:
            self.barrier.wait()       # all deposited
            got = list(self.slots)
            self.barrier.wait()       # all read before the next deposit
        finally:
            lock.acquire()
        return got


class _LocalComm:
    """A LocalMesh communicator bound to shard `rank`."""

    def __init__(self, exchange: _Exchange, rank: int, size: int,
                 device: torch.device):
        self._x = exchange
        self._lock = exchange.locks[device]
        self.rank = rank
        self.size = size
        self.device = device

    def _swap(self, t: torch.Tensor) -> list:
        return self._x.swap(self.rank, t, self._lock)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat([g.chunk(self.size)[self.rank].to(self.device)
                          for g in self._swap(t)])

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat([g.to(self.device) for g in self._swap(t)])

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        got = self._swap(t)
        out = got[0].to(self.device)
        for g in got[1:]:             # rank order: floats add the same way
            out = out + g.to(self.device)
        return out


class ProcessGroupComm:
    """The communicator of this process in a `torch.distributed` group
    (one process a shard; NCCL for CUDA tensors, gloo for CPU ones)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._nccl = dist.get_backend(group) == "nccl"

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        src = _bits(t.contiguous())
        out = torch.empty_like(src)
        self._dist.all_to_all_single(out, src, group=self.group)
        return out.view(t.dtype)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        src = _bits(t.contiguous())
        if self._nccl:
            out = torch.empty((self.size * src.shape[0],) + src.shape[1:],
                              dtype=src.dtype, device=src.device)
            self._dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            parts = [torch.empty_like(src) for _ in range(self.size)]
            self._dist.all_gather(parts, src, group=self.group)
            out = torch.cat(parts)
        return out.view(t.dtype)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return out


# ---- the runner -------------------------------------------------------------

Spec = Optional[int]        # None: P(); d: P(axis) along dim d (0 rows)


def _combine(spec: Spec, parts: list, device: torch.device):
    if spec is None:
        first = parts[0]
        for i, p in enumerate(parts[1:], 1):
            if not torch.equal(_bits(p.to(first.device)), _bits(first)):
                raise AssertionError(f"shard {i}'s copy of a P() output "
                                     "differs from shard 0's")
        return first
    return torch.cat([p.to(device) for p in parts], spec)


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(tree, leaves: iter):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return next(leaves)


def shard_map(body: Callable, mesh: LocalMesh, in_specs: Sequence,
              out_specs) -> Callable:
    """Run `body(comm, *shard_args)` once per shard of `mesh`, each on its
    own thread and device (`jax.shard_map`'s counterpart).

    Specs: `0` is `P(axis)` (the tensor's rows cut into contiguous
    blocks, one a shard; an output's blocks concatenated in rank order),
    `1` is `P(None, axis)` (the same along dim 1), `None` is `P()` (the
    whole tensor on every shard; one copy of an output, after checking
    that every shard's copy is equal).  An input spec applies to every
    tensor of its argument (a tensor or a tuple of them); `out_specs` is
    a prefix of the output's structure.
    """
    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "in_specs")
        n = mesh.size
        per_shard = [[] for _ in range(n)]
        placed = {}         # a tensor passed twice is placed once
        for spec, arg in zip(in_specs, args):
            cut = []
            for x in _leaves(arg):
                if (id(x), spec) not in placed:
                    blocks = RowSplit(n, spec).blocks(x) \
                        if spec is not None else [x] * n
                    placed[id(x), spec] = [
                        b.contiguous().to(d)
                        for b, d in zip(blocks, mesh.devices)]
                cut.append(placed[id(x), spec])
            for i in range(n):
                per_shard[i].append(_unflatten(arg, iter(c[i] for c in cut)))
        del placed
        exchange = _Exchange(n, mesh.timeout, mesh.devices)
        results: list = [None] * n
        errors: list = []

        def shard(i: int) -> None:
            dev = mesh.devices[i]
            try:
                with exchange.locks[dev], _device_scope(dev):
                    results[i] = body(_LocalComm(exchange, i, n, dev),
                                      *per_shard[i])
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)        # list.append is atomic
                exchange.barrier.abort()

        threads = [threading.Thread(target=shard, args=(i,),
                                    name=f"shard-{i}") for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            first = next((e for e in errors
                          if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0])
            raise first
        return _gather_outputs(out_specs, results, mesh.devices[0])
    return run


def _gather_outputs(out_specs, results: list, device: torch.device):
    """The per-shard outputs combined under `out_specs`."""
    def rebuild(like, items):
        items = list(items)
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)

    def walk(spec, parts):
        first = parts[0]
        if isinstance(spec, (tuple, list)):
            if not isinstance(first, (tuple, list)) \
                    or len(first) != len(spec):
                raise ValueError("output structure does not match "
                                 "out_specs")
            return rebuild(first, (walk(s, [p[j] for p in parts])
                                   for j, s in enumerate(spec)))
        if isinstance(first, (tuple, list)):
            return rebuild(first, (walk(spec, [p[j] for p in parts])
                                   for j in range(len(first))))
        return _combine(spec, parts, device)
    return walk(out_specs, results)


def _device_scope(dev: torch.device):
    """The shard's card as the thread's current device (a no-op on the
    CPU), as FlightServer._device_scope does for gRPC workers."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
