"""The multi-shard dry run (counterpart of __graft_entry__.py:51-222,
`dryrun_multichip`): every distributed operator over a mesh of
`n_shards` shards at a tiny size (64 rows a shard, seed 0), each held
to a truth computed on the host.  chip_smoke.py's phase 34 runs it on
the card."""

from __future__ import annotations

import numpy as np
import torch

from ..config import DeviceLike

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_shards: int, device: DeviceLike) -> None:
    """The reference's dry run on a `LocalMesh` of `n_shards` shards on
    `device`; raises AssertionError where an answer differs from its
    host truth."""
    from .. import parallel as par
    from ..core.table import Table
    from ..ops.groupby import AggSpec
    from ..ops.sort import SortOptions

    mesh = par.make_mesh(n_shards, device)
    dev = mesh.devices[0]
    per = 64                      # tiny per-shard row count
    n = per * n_shards
    rng = np.random.default_rng(0)
    keys_np = rng.integers(0, 37, n).astype(np.int64)
    vals_np = rng.integers(-100, 100, n).astype(np.int64)
    valid_np = rng.random(n) > 0.1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keys, vals, valid = t(keys_np), t(vals_np), t(valid_np)
    bkeys = torch.arange(n, dtype=torch.int64, device=dev)
    bvals = bkeys * 3

    def step(comm, k, v, ok, bk, bv):
        # 1) distributed hash aggregate (shuffle + local segment reduce)
        _, _, (gsum,), agg_over = par.dist_group_by(
            comm, k, ok, per, 37, [("sum", v)])
        # 2) distributed FK join of rows against the build side
        ones_b = torch.ones(bk.shape, dtype=torch.bool, device=bk.device)
        jk, jvalid, _, hit, (joined,), join_over = par.dist_join_unique(
            comm, k, ok, (v,), bk, ones_b, (bv,), per, per)
        # 2b) skew-aware variant: heavy keys replicate build rows and
        # probe locally (BASELINE config-5 Zipf plan)
        light, (hit_h, _, _) = par.dist_join_skew(
            comm, k, ok, (v,), bk, ones_b, (bv,), per * n_shards,
            per * n_shards, heavy_cap=8, build_heavy_cap=64,
            heavy_min_frac=1.0 / 8)
        skew_matches = comm.psum((light[1] & light[3]).sum()
                                 + hit_h.sum())
        # 3) distributed sort of the joined payload by key
        sk, svalid, (spay,), _ = par.dist_sort(
            comm, jk, jvalid & hit, per * n_shards * 2, (joined,))
        # 3b) general many-to-many distributed join (overflow-flagged)
        mm_valid, _, _, _, mm_over = par.dist_join(
            comm, k, ok, (v,), bk, ones_b, (bv,), per, per,
            out_cap=per * 2)
        mm_matches = comm.psum(mm_valid.sum())
        # 4) global reduction (psum over the mesh)
        total = par.dist_sum(comm, v, ok)
        any_over = agg_over | join_over | mm_over
        return (gsum, sk, svalid, spay, skew_matches, total, mm_matches,
                any_over)

    outs = par.shard_map(step, mesh, in_specs=(0,) * 5,
                         out_specs=(0, 0, 0, 0, None, None, None, None))(
        keys, vals, valid, bkeys, bvals)
    # the global sum must match the host truth
    expect = int(vals_np[valid_np].sum())
    got = int(outs[5])
    assert got == expect, f"dist_sum mismatch {got} != {expect}"
    # the skew-aware join matched every valid probe row exactly once
    n_valid = int(valid_np.sum())
    got_m = int(outs[4])
    assert got_m == n_valid, f"skew join matches {got_m} != {n_valid}"
    # the many-to-many join matched every valid probe row (the build side
    # has unique keys covering all probes) and no capacity overflowed
    got_mm = int(outs[6])
    assert got_mm == n_valid, f"dist_join matches {got_mm} != {n_valid}"
    assert not bool(outs[7]), "capacity overflow flagged in dryrun"

    # 5) the table API: a string-keyed group-by and a two-key sort through
    # the u64 key packing
    words = ["ant", "bee", "cat", None]
    s = [words[i] for i in rng.integers(0, 4, n)]
    tab = Table.from_pydict({"s": s, "v": vals_np}, device=dev)
    g = par.dist_table_group_by(tab, ["s"], [AggSpec("v", "sum")], mesh)
    exp_sums = {}
    for sv, vv in zip(s, vals_np.tolist()):
        exp_sums[sv] = exp_sums.get(sv, 0) + vv
    gd = g.to_pydict()
    assert dict(zip(gd["s"], gd["v_sum"])) == exp_sums, \
        "dist_table_group_by mismatch"
    srt = par.dist_table_sort(
        tab, ["s", "v"], [SortOptions(), SortOptions(descending=True)],
        mesh=mesh).to_pydict()
    exp_rows = sorted(zip(s, vals_np.tolist()),
                      key=lambda r: (r[0] is not None, r[0] or "", -r[1]))
    assert list(zip(srt["s"], srt["v"])) == exp_rows, \
        "dist_table_sort mismatch"

    # 6) the streamed operators: a chunked group-by and FK join
    C = 3
    skeys_np = rng.integers(0, 37, (C, n)).astype(np.int64)
    svals_np = rng.integers(-100, 100, (C, n)).astype(np.int64)
    sok_np = rng.random((C, n)) > 0.1
    # join probes use a wide key domain so the hash shuffle spreads rows
    # evenly (a 37-key domain can overflow the per-shard shuffle cap)
    pk_np = rng.integers(0, 600, (C, n)).astype(np.int64)
    bk2 = t((np.arange(n) * 2).astype(np.int64))
    bw2 = t(np.arange(n, dtype=np.int64) * 3)
    bok2 = torch.ones(n, dtype=torch.bool, device=dev)

    def stream_step(comm, k, okk, v, pk, bkk, bokk, bww):
        gk, gv, (gsum, gcnt), gover = par.dist_group_by_stream(
            comm, k, okk, per * 4, 64, ["sum", "count"], [v, v])
        ks, oks, (vs,), hits, (gots,), jover = par.dist_join_stream(
            comm, pk, okk, (v,), bkk, bokk, (bww,), per * 4, per * 4)
        return gk, gv, gsum, gcnt, ks, oks, vs, hits, gots, gover | jover

    res = par.shard_map(stream_step, mesh, in_specs=(1,) * 4 + (0,) * 3,
                        out_specs=(0,) * 4 + (1,) * 5 + (None,))(
        t(skeys_np), t(sok_np), t(svals_np), t(pk_np), bk2, bok2, bw2)
    (gk2, gv2, gs2, gc2, ks2, oks2, vs2, hits2, gots2, over2) = (
        x.cpu().numpy() for x in res)
    assert not over2.any(), "streamed-op capacity overflow in dryrun"
    kf, vf, of = skeys_np.ravel(), svals_np.ravel(), sok_np.ravel()
    exp_g = {int(kk): (int(vf[(kf == kk) & of].sum()),
                       int(((kf == kk) & of).sum()))
             for kk in np.unique(kf[of])}
    got_g2 = {int(gk2[i]): (int(gs2[i]), int(gc2[i]))
              for i in range(len(gk2)) if gv2[i]}
    assert got_g2 == exp_g, "dist_group_by_stream host-truth mismatch"
    got_j = sorted(
        (int(ks2[c, i]), int(vs2[c, i]), int(gots2[c, i]))
        for c in range(ks2.shape[0]) for i in range(ks2.shape[1])
        if oks2[c, i] and hits2[c, i])
    exp_j = sorted(
        (int(k), int(v), int(k) // 2 * 3)
        for k, v, o in zip(pk_np.ravel().tolist(), vf.tolist(), of.tolist())
        if o and k % 2 == 0 and k < 2 * n)
    assert got_j == exp_j, "dist_join_stream host-truth mismatch"
