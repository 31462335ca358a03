"""Distributed operators: group-by, join and sort over the shard mesh
(counterpart of arrow_tpu/parallel/dist.py:35-594): BASELINE configs
3-5 at scale.  Each operator is a per-shard body (`mesh.shard_map` or
one process a shard) made of local tensor steps and one hash or range
repartition (`all_to_all`).

As in the reference, shapes are static: outputs are capacity-padded
with validity masks, and every capacity-bounded stage reports overflow
rather than drop rows.  Slots outside the masks hold garbage.  The
table API (parallel/api.py) trims the padding.

Keys are u64 bits on int64 storage; the u64 sentinel 0xFFFF...FFFF is
-1 there.  Every sort, `searchsorted` and compare of keys goes through
the sign-flip order map of kernels/groupagg.py::encode_order_key (`k ^
2^63`: u64 order as int64 order), so the sentinel sorts last as in the
reference.  `jax.lax.sort` with two keys becomes a stable sort by the
key whose tail of sentinel-keyed rows is then put valid-first
(`_valid_first_order`).

K1 (kernels/compact.py) does the three compactions the reference does
with a partition sort: the run starts of `local_group_aggregate`,
`_compact_front` and the table API's trim.  On CUDA tensors it launches
the kernel; on CPU tensors it takes its plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..kernels.compact import compact
from ..ops.groupby import float_group_sums
from .partition import bucketize, exchange, repartition_arrays

__all__ = ["local_group_aggregate", "dist_group_by",
           "dist_group_by_stream", "dist_join_unique",
           "dist_join", "dist_join_stream", "dist_join_skew",
           "dist_sort", "dist_sum"]

_U64_MAX = -1                  # u64 0xFFFFFFFFFFFFFFFF on int64 storage
_SIGN = -(1 << 63)


def _order(k: torch.Tensor) -> torch.Tensor:
    """u64 keys (int64 storage) as int64 keys of the same order."""
    return k ^ _SIGN


def _sort_u64(k: torch.Tensor) -> torch.Tensor:
    return _order(torch.sort(_order(k)).values)


def _argsort_u64(k: torch.Tensor) -> torch.Tensor:
    return torch.sort(_order(k), stable=True).indices


def _valid_first_order(k: torch.Tensor, valid: torch.Tensor):
    """(order, k[order]): the stable order by (k, ~valid) that
    `jax.lax.sort((k, ~valid, ...), num_keys=2, is_stable=True)` gives,
    for k whose invalid rows hold the sentinel.  Only sentinel-keyed rows
    can tie a valid row with an invalid one, and they sort last: after
    one stable sort by k, that tail is put valid-first, stably (its keys
    are all the sentinel, so k[order] is the sorted keys as they are)."""
    srt = torch.sort(_order(k), stable=True)
    ks = _order(srt.values)
    tail = ks == _U64_MAX
    # 0 before the tail, 1 its valid rows, 2 its invalid rows
    rank = tail.to(torch.int8) + (tail & ~valid[srt.indices]).to(torch.int8)
    return srt.indices[torch.sort(rank, stable=True).indices], ks


# ---- local building blocks (per shard, static shapes) -----------------------

def _run_starts(eligible: torch.Tensor, group_cap: int) -> torch.Tensor:
    """int32 (group_cap + 1,): the positions where `eligible`, in order,
    then n.  K1 compacts the positions; its rows past the count are
    replaced by n (the reference's partition sort of (~eligible, iota)
    padded with n-sentinels)."""
    n = eligible.shape[0]
    (pos,), count = compact(eligible, (), positions=torch.int32)
    m = min(n, group_cap + 1)
    slots = torch.arange(group_cap + 1, dtype=torch.int32,
                         device=eligible.device)
    out = torch.full((group_cap + 1,), n, dtype=torch.int32,
                     device=eligible.device)
    out[:m] = pos[:m]
    return torch.where(slots < count, out, n)


def local_group_aggregate(key: torch.Tensor, valid: torch.Tensor,
                          group_cap: int,
                          specs: Sequence[Tuple[str, torch.Tensor]]):
    """Sort-based grouped aggregation with a static group capacity.

    Returns (group_keys (cap,), group_valid (cap,), [agg results (cap,)],
    overflow).  Groups beyond `group_cap` cannot fit the static output:
    `overflow` goes True instead of returning wrong aggregates.  A valid
    group whose key equals the invalid rows' sentinel sorts before them
    (`_valid_first_order`), so its run start is its own row and its rows
    never merge into the previous group.
    """
    n = key.shape[0]
    dev = key.device
    order, ks = _valid_first_order(torch.where(valid, key, _U64_MAX), valid)
    vs = valid[order]
    uniq = {}
    for _, arr in specs:
        if id(arr) not in uniq:
            uniq[id(arr)] = arr[order]
    del order
    run_start = torch.ones(n, dtype=torch.bool, device=dev)
    run_start[1:] = ks[1:] != ks[:-1]
    gid_all = torch.cumsum(run_start, 0, dtype=torch.int32) - 1
    gid = torch.where(vs, torch.clamp(gid_all, max=group_cap), group_cap)

    eligible = run_start & vs & (gid_all < group_cap)
    starts_all = _run_starts(eligible, group_cap)
    slots = torch.arange(group_cap, dtype=torch.int32, device=dev)
    n_groups = eligible.sum(dtype=torch.int32)
    starts = torch.where(slots < n_groups, starts_all[:group_cap], n)
    starts_c = torch.clamp(starts, max=n - 1)
    group_keys = torch.where(slots < n_groups, ks[starts_c], 0)
    nxt = torch.where(slots + 1 <= n_groups - 1,
                      starts_all[1:group_cap + 1], n)

    def diff_sums(contrib: torch.Tensor) -> torch.Tensor:
        cs = torch.cumsum(contrib, 0)
        end_cs = cs[torch.clamp(nxt - 1, min=0)]
        start_cs = torch.where(starts_c > 0,
                               cs[torch.clamp(starts_c - 1, min=0)],
                               torch.zeros((), dtype=cs.dtype, device=dev))
        return torch.where(slots < n_groups, end_cs - start_cs,
                           torch.zeros((), dtype=cs.dtype, device=dev))

    in_cap = vs & (gid_all < group_cap)
    counts = diff_sums(in_cap.to(torch.int64))
    group_valid = counts > 0
    outs = []
    mm_cache = {}
    for op, arr in specs:
        a = uniq[id(arr)]
        if op == "count":
            outs.append(counts)
            continue
        if op == "sum":
            contrib = torch.where(in_cap, a, torch.zeros((), dtype=a.dtype,
                                                         device=dev))
            if a.is_floating_point():
                outs.append(float_group_sums(contrib.to(torch.float64),
                                             diff_sums).to(a.dtype))
            else:
                outs.append(diff_sums(contrib.to(torch.int64)).to(a.dtype))
            continue
        if op in ("min", "max"):
            if id(arr) not in mm_cache:
                mm_cache[id(arr)] = _minmax_sorted(a, in_cap, gid, n,
                                                   diff_sums)
            v_final, ckey, nonnull, isfloat = mm_cache[id(arr)]

            def pick(idx):
                v = v_final[idx]
                if isfloat:
                    v = torch.where((ckey[idx] & 3) == 1,
                                    torch.tensor(float("nan"), dtype=v.dtype,
                                                 device=dev), v)
                return v

            if op == "min":
                outs.append(pick(starts_c))
            else:
                pos = torch.clamp(starts_c + torch.clamp(nonnull, min=1) - 1,
                                  max=n - 1)
                outs.append(pick(pos))
            continue
        raise ValueError(f"unknown aggregate {op}")
    # count ALL distinct valid keys (not the capped eligible set) so an
    # undersized capacity is reported, never silently dropped
    total_groups = (run_start & vs).sum(dtype=torch.int32)
    overflow = total_groups > group_cap
    return group_keys, group_valid, outs, overflow


def _minmax_sorted(a: torch.Tensor, in_cap: torch.Tensor,
                   gid: torch.Tensor, n: int, diff_sums):
    """Values sorted by (gid, class, value) (dist.py:136-150): the 2-bit
    class (0 valid, 1 NaN, 2 excluded) packs into the gid key's low bits
    on int32, so a group's least value is at its run start and its
    largest non-null value nonnull - 1 rows on.  Two stable passes stand
    for the reference's two-key sort: by value, then by the packed key
    (its sort is unstable, but rows tied on both keys hold equal
    values)."""
    assert n < 2 ** 29, "shard too large for packed gid|cls"
    isfloat = a.is_floating_point()
    if isfloat:
        isnan = torch.isnan(a)
        vals = torch.where(isnan, torch.zeros((), dtype=a.dtype,
                                              device=a.device), a)
        cls = torch.where(in_cap, isnan.to(torch.int32), 2)
        bits = vals.to(torch.float64).view(torch.int64)
        # IEEE total order as int64 order: negatives' magnitude bits flip
        vkey = torch.where(bits < 0, bits ^ ((1 << 63) - 1), bits)
    else:
        vals = a
        cls = (~in_cap).to(torch.int32)
        vkey = a.to(torch.int64)
    packed = (gid.to(torch.int32) << 2) | cls
    by_value = torch.sort(vkey, stable=True).indices
    by_group = torch.sort(packed[by_value], stable=True).indices
    order = by_value[by_group]
    nonnull = diff_sums(in_cap.to(torch.int64))
    return vals[order], packed[order], nonnull, isfloat


def _sort_build_side(build_key, build_valid,
                     build_vals: Sequence[torch.Tensor]):
    """Sort the build side once for repeated lookups: returns (sorted
    keys, sorted invalid flags, [build values in key order]).  The
    invalid flag is the second key, so a probe key equal to the sentinel
    lands on the valid build row, not an invalid one that ties it."""
    order, bks = _valid_first_order(
        torch.where(build_valid, build_key, _U64_MAX), build_valid)
    return bks, ~build_valid[order], [bv[order] for bv in build_vals]


def _lookup_sorted(probe_key, probe_valid, bks, inv_s, bvals_sorted):
    """Probe a pre-sorted unique-key build side."""
    pos = torch.searchsorted(_order(bks), _order(probe_key))
    pos_c = torch.clamp(pos, 0, bks.shape[0] - 1)
    hit = (bks[pos_c] == probe_key) & probe_valid & ~inv_s[pos_c]
    return hit, [bv[pos_c] for bv in bvals_sorted]


def _local_lookup_unique(probe_key, probe_valid, build_key, build_valid,
                         build_vals: Sequence[torch.Tensor]):
    """For each probe row find the (unique) matching build row.
    Returns (match_valid, [gathered build values])."""
    bks, inv_s, bvals_sorted = _sort_build_side(build_key, build_valid,
                                                build_vals)
    return _lookup_sorted(probe_key, probe_valid, bks, inv_s, bvals_sorted)


def _agree(comm, flag: torch.Tensor) -> torch.Tensor:
    """A flag True on any shard, on every shard."""
    return comm.psum(flag.to(torch.int32)) > 0


# ---- distributed operators --------------------------------------------------

def dist_group_by(comm, key: torch.Tensor, valid: torch.Tensor,
                  shuffle_cap: int, group_cap: int,
                  specs: Sequence[Tuple[str, torch.Tensor]]):
    """Per-shard body: hash-shuffle rows by key, then local grouped
    aggregation.  Output groups are disjoint across shards (sharded by
    hash(key) % n_shards)."""
    arrays = (key,) + tuple(a for _, a in specs)
    sh = repartition_arrays(comm, key, valid, shuffle_cap, *arrays)
    specs2 = [(op, arr) for (op, _), arr in zip(specs, sh.arrays[1:])]
    gk, gv, outs, g_over = local_group_aggregate(sh.arrays[0], sh.valid,
                                                 group_cap, specs2)
    return gk, gv, outs, sh.overflow | _agree(comm, g_over)


_MERGE_OP = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def dist_group_by_stream(comm, key_chunks: torch.Tensor,
                         valid_chunks: torch.Tensor, shuffle_cap: int,
                         group_cap: int, ops: Sequence[str],
                         val_chunks: Sequence[torch.Tensor]):
    """Chunked distributed group-by: inputs are (C, n)-shaped per-shard
    chunk stacks.  Each chunk is shuffled and aggregated in turn; the
    chunk partials then merge in one local aggregation (sum/count->sum,
    min->min, max->max).  Output groups are disjoint across shards,
    padded to group_cap.

    The reference overlaps chunk i+1's all_to_all with chunk i's
    aggregation inside one `lax.scan`.  That is scheduling, not meaning:
    here a Python loop runs them one after the other on the current
    stream, with the same outputs.

    Returns (group_keys, group_valid, [agg results], overflow).
    """
    over = torch.zeros((), dtype=torch.bool, device=key_chunks.device)
    partials = []
    for c in range(key_chunks.shape[0]):
        k = key_chunks[c]
        vs = [v[c] for v in val_chunks]
        sh = repartition_arrays(comm, k, valid_chunks[c], shuffle_cap, k,
                                *vs)
        gk, gv, outs, g_over = local_group_aggregate(
            sh.arrays[0], sh.valid, group_cap,
            list(zip(ops, sh.arrays[1:])))
        over = over | sh.overflow | g_over
        partials.append((gk, gv, outs))
    if len(partials) == 1:
        gk, gv, outs = partials[0]
        return gk, gv, list(outs), _agree(comm, over)
    all_k = torch.cat([p[0] for p in partials])
    all_v = torch.cat([p[1] for p in partials])
    merged = [torch.cat([p[2][i] for p in partials])
              for i in range(len(ops))]
    mk, mv, mouts, m_over = local_group_aggregate(
        all_k, all_v, group_cap,
        list(zip([_MERGE_OP[o] for o in ops], merged)))
    return mk, mv, mouts, _agree(comm, over | m_over)


def dist_sum(comm, values: torch.Tensor, valid: torch.Tensor):
    """Global masked sum: local reduce + psum (no shuffle)."""
    local = torch.where(valid, values,
                        torch.zeros((), dtype=values.dtype,
                                    device=values.device)).sum()
    return comm.psum(local)


def dist_join_unique(comm,
                     probe_key, probe_valid, probe_vals: Sequence,
                     build_key, build_valid, build_vals: Sequence,
                     probe_cap: int, build_cap: int):
    """FK join (unique build keys): co-shuffle both sides by key hash,
    then a local sorted lookup.  Returns (probe_key', probe_valid',
    probe_vals', match_valid, build_vals', overflow).

    Probe rows stay row-aligned with their shuffled slab; `match_valid`
    marks rows with a build-side match (left-join semantics; inner =
    probe_valid' & match_valid).  `overflow` reports shuffle capacity
    loss on either side, agreed across the mesh."""
    psh = repartition_arrays(comm, probe_key, probe_valid, probe_cap,
                             probe_key, *probe_vals)
    bsh = repartition_arrays(comm, build_key, build_valid, build_cap,
                             build_key, *build_vals)
    pk = psh.arrays[0]
    hit, gathered = _local_lookup_unique(pk, psh.valid, bsh.arrays[0],
                                         bsh.valid, bsh.arrays[1:])
    return pk, psh.valid, psh.arrays[1:], hit, gathered, \
        psh.overflow | bsh.overflow


def dist_join_stream(comm,
                     probe_key_chunks: torch.Tensor,
                     probe_valid_chunks: torch.Tensor,
                     probe_val_chunks: Sequence[torch.Tensor],
                     build_key, build_valid,
                     build_vals: Sequence[torch.Tensor],
                     probe_cap: int, build_cap: int):
    """Chunked FK join (the streamed form of dist_join_unique).  The
    build side co-shuffles and sorts once; the (C, n)-shaped probe chunk
    stacks are shuffled and looked up chunk by chunk, in a Python loop on
    the current stream (the reference's `lax.scan` overlaps chunk i+1's
    exchange with chunk i's lookup: scheduling only).  Returns per-chunk
    stacks (probe_key', probe_valid', [probe vals'], match_valid, [build
    vals']) and a mesh-agreed overflow flag."""
    bsh = repartition_arrays(comm, build_key, build_valid, build_cap,
                             build_key, *build_vals)
    bks, inv_s, bvals_sorted = _sort_build_side(
        bsh.arrays[0], bsh.valid, list(bsh.arrays[1:]))
    over = torch.zeros((), dtype=torch.bool, device=build_key.device)
    rows = []
    for c in range(probe_key_chunks.shape[0]):
        k = probe_key_chunks[c]
        sh = repartition_arrays(comm, k, probe_valid_chunks[c], probe_cap,
                                k, *[v[c] for v in probe_val_chunks])
        hit, got = _lookup_sorted(sh.arrays[0], sh.valid, bks, inv_s,
                                  bvals_sorted)
        over = over | sh.overflow
        rows.append((sh.arrays[0], sh.valid, sh.arrays[1:], hit, got))
    over = _agree(comm, over) | bsh.overflow
    return (torch.stack([r[0] for r in rows]),
            torch.stack([r[1] for r in rows]),
            tuple(torch.stack([r[2][i] for r in rows])
                  for i in range(len(probe_val_chunks))),
            torch.stack([r[3] for r in rows]),
            tuple(torch.stack([r[4][i] for r in rows])
                  for i in range(len(build_vals))),
            over)


def dist_join(comm,
              probe_key, probe_valid, probe_vals: Sequence,
              build_key, build_valid, build_vals: Sequence,
              probe_cap: int, build_cap: int, out_cap: int):
    """General many-to-many distributed inner join, per-shard body.

    Co-shuffles both sides by key hash, then expands all (probe, build)
    match pairs locally with the capacity-padded searchsorted-over-cumsum
    expansion.  Returns (out_valid (out_cap,), probe_key', [probe vals'],
    [build vals'], overflow); overflow covers both shuffle capacity loss
    and expansion beyond out_cap, agreed across the mesh.  Within a probe
    row the build rows come in key-sort order, which the reference's
    unstable sort leaves unspecified: compare pairs as multisets.
    """
    psh = repartition_arrays(comm, probe_key, probe_valid, probe_cap,
                             probe_key, *probe_vals)
    bsh = repartition_arrays(comm, build_key, build_valid, build_cap,
                             build_key, *build_vals)
    pk, pvalid = psh.arrays[0], psh.valid
    bk, bvalid = bsh.arrays[0], bsh.valid
    dev = pk.device

    n_b = bk.shape[0]
    b_order, bk_sorted = _valid_first_order(
        torch.where(bvalid, bk, _U64_MAX), bvalid)
    bk_sorted = _order(bk_sorted)
    nvalid = bvalid.sum()
    pk_o = _order(pk)
    lo = torch.searchsorted(bk_sorted, pk_o)
    hi = torch.minimum(torch.searchsorted(bk_sorted, pk_o, right=True),
                       nvalid)
    del bk_sorted, pk_o
    counts = torch.where(pvalid, torch.clamp(hi - lo, min=0), 0)

    incl = torch.cumsum(counts, 0)
    total = incl[-1]
    out_i = torch.arange(out_cap, dtype=torch.int64, device=dev)
    probe_pos = torch.searchsorted(incl, out_i, right=True)
    probe_pos_c = torch.clamp(probe_pos, max=pk.shape[0] - 1)
    excl = (incl - counts)[probe_pos_c]
    build_pos = torch.clamp(lo[probe_pos_c] + (out_i - excl), 0, n_b - 1)
    build_idx = b_order[build_pos]
    out_valid = out_i < total

    out_probe_key = pk[probe_pos_c]
    out_pvals = [v[probe_pos_c] for v in psh.arrays[1:]]
    out_bvals = [v[build_idx] for v in bsh.arrays[1:]]
    expand_over = _agree(comm, total > out_cap)
    overflow = psh.overflow | bsh.overflow | expand_over
    return out_valid, out_probe_key, out_pvals, out_bvals, overflow


def dist_sort(comm, key: torch.Tensor, valid: torch.Tensor,
              capacity: int, payloads: Sequence[torch.Tensor] = (),
              oversample: int = 32):
    """Distributed sort by sample-based range partitioning:

      1. local sample -> all_gather  (splitter estimation)
      2. route rows to their key range's shard (all_to_all)
      3. local stable sort

    Afterwards shard i holds keys <= shard i+1's keys: globally sorted
    across the mesh.  Equal keys stay in their input order (one shard
    each, routed in order).  Invalid rows sort to the back.
    """
    n_shards = comm.size
    n = key.shape[0]
    dev = key.device
    k = torch.where(valid, key, _U64_MAX)

    # 1: deterministic strided sample of the locally sorted keys
    ks_local = _sort_u64(k)
    n_samples = min(n, oversample * n_shards)
    stride = max(n // max(n_samples, 1), 1)
    sample = ks_local[::stride][:n_samples]
    del ks_local
    all_samples = torch.sort(_order(comm.all_gather(sample))).values
    m = all_samples.shape[0]
    qpos = (torch.arange(1, n_shards, device=dev) * m) // n_shards
    splitters = all_samples[qpos]

    # 2: route and exchange
    target = torch.searchsorted(splitters, _order(k), right=True) \
        .to(torch.int32)
    slabs, slab_valid, b_over = bucketize(
        target, torch.ones_like(valid), n_shards, capacity, k, valid,
        *payloads)
    del target
    sh = exchange(comm, slabs, slab_valid, b_over)
    del slabs, slab_valid
    k2, valid2 = sh.arrays[0], sh.arrays[1]

    # 3: local stable sort; slab padding and invalid rows go last
    ok = sh.valid & valid2
    order = _argsort_u64(torch.where(ok, k2, _U64_MAX))
    return k2[order], ok[order], tuple(p[order] for p in sh.arrays[2:]), \
        sh.overflow


# ---- skew-aware join (BASELINE config 5: Zipf keys) -------------------------

def local_heavy_keys(key: torch.Tensor, valid: torch.Tensor,
                     heavy_cap: int, min_count: int) -> torch.Tensor:
    """Top-`heavy_cap` locally heavy keys (count >= min_count), from the
    local key histogram (sort + per-row run count via two binary
    searches), heaviest first.  Padded with the u64 sentinel."""
    ks = _sort_u64(torch.where(valid, key, _U64_MAX))
    ko = _order(ks)
    cnt = (torch.searchsorted(ko, ko, right=True)
           - torch.searchsorted(ko, ko)).to(torch.int32)
    del ko
    run_start = torch.ones(ks.shape[0], dtype=torch.bool, device=ks.device)
    run_start[1:] = ks[1:] != ks[:-1]
    cand = run_start & (ks != _U64_MAX) & (cnt >= min_count)
    rank_key = torch.where(cand, -cnt, 1)
    order = torch.sort(rank_key, stable=True).indices
    return torch.where(cand[order], ks[order], _U64_MAX)[:heavy_cap]


def _compact_front(mask: torch.Tensor, cap: int, *arrays: torch.Tensor):
    """Rows where mask, packed to the front in order (K1), cut to cap;
    returns (kept_valid (cap,), arrays' (cap,)).  Rows at or past the
    count hold garbage, masked by kept_valid (the reference's partition
    sort leaves the rows not kept there; its callers read them only
    under the mask)."""
    outs, count = compact(mask, arrays)
    m = min(cap, mask.shape[0])
    kept = torch.arange(m, device=mask.device) < count
    return kept, tuple(o[:m] for o in outs)


def dist_join_skew(comm,
                   probe_key, probe_valid, probe_vals: Sequence,
                   build_key, build_valid, build_vals: Sequence,
                   probe_cap: int, build_cap: int,
                   heavy_cap: int = 64, build_heavy_cap: int = 256,
                   heavy_min_frac: float = 1.0 / 64):
    """Skew-aware FK join (unique build keys), per-shard body.

    Heavy probe keys (from per-shard histograms, agreed via all_gather)
    would overflow a hash-routed shard, so their build rows are
    replicated to every shard and their probe rows stay local (no
    shuffle: the hottest keys move no probe bytes); light keys take the
    co-shuffled path (dist_join_unique).

    Returns (light_result, heavy_result):
      light_result = dist_join_unique's output over the light rows
      heavy_result = (match_valid, [build vals], heavy_overflow) aligned
                     with the LOCAL probe rows (heavy rows only)
    """
    n = probe_key.shape[0]
    min_count = max(int(n * heavy_min_frac), 2)

    heavy_local = local_heavy_keys(probe_key, probe_valid, heavy_cap,
                                   min_count)
    heavy_all = _sort_u64(comm.all_gather(heavy_local))
    heavy_o = _order(heavy_all)

    def is_heavy(k, valid):
        pos = torch.clamp(torch.searchsorted(heavy_o, _order(k)), 0,
                          heavy_all.shape[0] - 1)
        return valid & (heavy_all[pos] == k) & (k != _U64_MAX)

    ph = is_heavy(probe_key, probe_valid)
    bh = is_heavy(build_key, build_valid)

    # light path: the standard co-shuffled join
    light = dist_join_unique(comm, probe_key, probe_valid & ~ph,
                             probe_vals, build_key, build_valid & ~bh,
                             build_vals, probe_cap, build_cap)

    # heavy path: replicate heavy build rows everywhere, probe locally
    kept, packed = _compact_front(bh, build_heavy_cap, build_key,
                                  *build_vals)
    heavy_over = _agree(comm, bh.sum() > build_heavy_cap)
    rep = [comm.all_gather(a) for a in (packed[0], kept) + packed[1:]]
    hit_h, got_h = _local_lookup_unique(probe_key, ph, rep[0], rep[1],
                                        rep[2:])
    return light, (hit_h, got_h, heavy_over)
