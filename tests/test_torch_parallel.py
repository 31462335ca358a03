"""arrow_tpu_torch.parallel against the reference (arrow_tpu.parallel),
case for case with tests/test_parallel.py: each body runs under
`jax.shard_map` on conftest.py's 8 virtual CPU devices and under the
port's `shard_map` on `make_mesh(8, "cpu")`, on the same numpy inputs
(u64 keys reach the port as int64 storage of the same bits).

Tolerances: valid masks and overflow flags equal; values equal bit for
bit under the masks (slots outside them are garbage by contract,
partition.py:70-80).  Where the reference sorts unstably (the m:n
join's build side) the match pairs compare as multisets, per shard.
Integer sums are exact; float sums across shards (psum) and float group
sums (prefix-sum differences) within rtol 1e-12, since the order of
their additions is the collective's or the cumsum's.
"""

import functools
import importlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import parallel as rpar
from arrow_tpu_torch import parallel as ppar
from arrow_tpu_torch.errors import ArrowInvalid, ArrowNotImplementedError
from arrow_tpu_torch.kernels import compact as kc
from arrow_tpu_torch.parallel.partition import _umod

from torch_port_util import (assert_tables_equal, bits, cuda_device,  # noqa: F401
                             port_table)

rdist = importlib.import_module("arrow_tpu.parallel.dist")
pdist = importlib.import_module("arrow_tpu_torch.parallel.dist")

NDEV = 8
AXIS = "shards"
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jmesh():
    return rpar.make_mesh(NDEV)


@pytest.fixture(scope="module")
def mesh():
    return ppar.make_mesh(NDEV, "cpu")


def _pspec(spec):
    if isinstance(spec, (tuple, list)):
        return type(spec)(_pspec(s) for s in spec)
    return P() if spec is None else P(AXIS) if spec == 0 else P(None, AXIS)


def _port_in(a):
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def _host(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(t) for t in tree) \
            if not hasattr(tree, "_fields") else type(tree)(*map(_host, tree))
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def run_both(jmesh, mesh, ref_body, port_body, in_specs, out_specs, *args):
    """(port outputs, reference outputs) as numpy trees; `ref_body`
    takes the axis name first, `port_body` the communicator."""
    f = jax.jit(jax.shard_map(functools.partial(ref_body, AXIS), mesh=jmesh,
                              in_specs=_pspec(tuple(in_specs)),
                              out_specs=_pspec(out_specs)))
    want = jax.tree.map(np.asarray, f(*[jnp.asarray(a) for a in args]))
    got = ppar.shard_map(port_body, mesh, in_specs, out_specs)(
        *[_port_in(a) for a in args])
    return _host(got), want


def eq(got, want, mask=None, what=""):
    """Equal shapes, and equal bits (under `mask`)."""
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if mask is not None:
        g, w = g[np.asarray(mask)], w[np.asarray(mask)]
    assert np.array_equal(bits(g), bits(w)), what


def close(got, want, mask, what=""):
    g, w = np.asarray(got)[mask], np.asarray(want)[mask]
    np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=what)


# ---- hashing and the shuffle ------------------------------------------------

def test_hash_u64_over_the_whole_range():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        np.arange(100_000, dtype=np.uint64),
        rng.integers(0, 2 ** 64, 100_000, dtype=np.uint64),
        np.array([2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, 2 ** 64 - 1],
                 np.uint64)])
    assert (keys >= 2 ** 63).sum() > 40_000
    want = np.asarray(rpar.hash_u64(jnp.asarray(keys)))
    got = ppar.hash_u64(_port_in(keys)).numpy()
    eq(got, want)
    high = want >= 2 ** 63
    assert high.sum() > 40_000
    for m in (2, 3, 7, NDEV):            # the unsigned modulo, any shards
        ref = np.asarray(rpar.hash_u64(jnp.asarray(keys)) % jnp.uint64(m))
        port = _umod(ppar.hash_u64(_port_in(keys)), m).numpy()
        eq(port, ref.astype(np.int64), what=f"% {m}")
        if m in (3, 7):    # a signed modulo of hashes past 2^63 differs
            assert not np.array_equal(want.view(np.int64)[high] % m,
                                      ref[high].astype(np.int64))


def test_hash_u64_uniformity():
    keys = np.arange(100_000, dtype=np.uint64)
    shards = _umod(ppar.hash_u64(_port_in(keys)), NDEV).numpy()
    counts = np.bincount(shards, minlength=NDEV)
    assert counts.min() > 100_000 / NDEV * 0.9


def test_repartition_roundtrip(jmesh, mesh):
    """Every valid row arrives at the reference's shard and slot."""
    n = 1024
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 64, n, dtype=np.uint64)
    vals = np.arange(n, dtype=np.int64)
    valid = rng.random(n) > 0.1

    def ref(axis, k, v, ok):
        sh = rpar.repartition_arrays(axis, k, ok, 128, k, v)
        return sh.arrays[0], sh.arrays[1], sh.valid, sh.overflow

    def port(comm, k, v, ok):
        sh = ppar.repartition_arrays(comm, k, ok, 128, k, v)
        return sh.arrays[0], sh.arrays[1], sh.valid, sh.overflow

    got, want = run_both(jmesh, mesh, ref, port, (0, 0, 0),
                         (0, 0, 0, None), keys, vals, valid)
    eq(got[2], want[2], what="valid")
    eq(got[0], want[0], got[2], "keys")
    eq(got[1], want[1], got[2], "values")
    eq(got[3], want[3], what="overflow")
    assert got[2].sum() == valid.sum() and not got[3]


def test_exchange_orders_blocks_by_source_shard(mesh):
    """all_to_all: block i of a shard's result came from shard i."""
    def body(comm, x):
        return comm.all_to_all(x * 10 + comm.rank), \
            comm.all_gather(x[:1]), comm.psum(x[:1])

    x = torch.arange(NDEV * NDEV, dtype=torch.int64)
    a2a, gathered, summed = ppar.shard_map(body, mesh, (0,), (0, 0, None))(x)
    a2a = a2a.reshape(NDEV, NDEV)          # a2a[r, i]: shard r's block i
    for r in range(NDEV):
        for i in range(NDEV):
            assert int(a2a[r, i]) == (i * NDEV + r) * 10 + i
    assert gathered.reshape(NDEV, NDEV)[0].tolist() == \
        list(range(0, NDEV * NDEV, NDEV))
    assert int(summed) == sum(range(0, NDEV * NDEV, NDEV))


# ---- the distributed operators ---------------------------------------------

SPECS4 = ("sum", "count", "min", "max")


def test_dist_group_by_matches_local(jmesh, mesh):
    n = 2048
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 64, n).astype(np.uint64)
    vals = rng.integers(-100, 100, n).astype(np.int64)
    valid = rng.random(n) > 0.15
    shuffle_cap, group_cap = n // NDEV, 64

    def ref(axis, k, v, ok):
        gk, gv, outs, over = rpar.dist_group_by(
            axis, k, ok, shuffle_cap, group_cap, [(o, v) for o in SPECS4])
        return (gk, gv) + tuple(outs) + (over,)

    def port(comm, k, v, ok):
        gk, gv, outs, over = ppar.dist_group_by(
            comm, k, ok, shuffle_cap, group_cap, [(o, v) for o in SPECS4])
        return (gk, gv) + tuple(outs) + (over,)

    got, want = run_both(jmesh, mesh, ref, port, (0, 0, 0),
                         (0,) * 6 + (None,), keys, vals, valid)
    eq(got[1], want[1], what="group_valid")
    eq(got[6], want[6], what="overflow")
    for i, name in enumerate(("keys",) + SPECS4):
        eq(got[i if i == 0 else i + 1], want[i if i == 0 else i + 1],
           got[1], name)
    assert got[1].sum() == len(np.unique(keys[valid])) and not got[6]


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_dist_sum(jmesh, mesh, dtype):
    n = 1024
    rng = np.random.default_rng(2)
    vals = rng.integers(-50, 50, n).astype(dtype)
    if dtype == "float64":
        vals = vals * np.pi
    valid = rng.random(n) > 0.2
    got, want = run_both(
        jmesh, mesh, lambda axis, v, ok: rpar.dist_sum(axis, v, ok),
        lambda comm, v, ok: ppar.dist_sum(comm, v, ok), (0, 0), None,
        vals, valid)
    assert got.dtype == want.dtype
    if dtype == "int64":
        eq(got, want)
        assert int(got) == int(vals[valid].sum())
    else:                # the psum's order of additions: rtol 1e-12
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_dist_sum_adds_shards_in_rank_order(mesh):
    """LocalMesh's psum adds the shards' partial sums in rank order."""
    vals = np.zeros((NDEV, 16))
    vals[:3, 0] = [1.0, 1e16, -1e16]       # 1 + 1e16 rounds the 1 away
    vals = vals.ravel()
    got = ppar.shard_map(lambda comm, v, ok: ppar.dist_sum(comm, v, ok),
                         mesh, (0, 0), None)(torch.from_numpy(vals),
                                             torch.ones(len(vals),
                                                        dtype=torch.bool))
    parts = [torch.from_numpy(b).sum() for b in vals.reshape(NDEV, -1)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    assert float(got) == float(acc)
    assert float(sum(reversed(parts))) != float(acc)    # the order shows


def test_dist_join_unique(jmesh, mesh):
    n_probe, n_build = 2048, 512
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 600, n_probe).astype(np.uint64)
    pv = np.arange(n_probe, dtype=np.int64)
    bk = rng.permutation(600)[:n_build].astype(np.uint64)
    bv = (bk * 7).astype(np.int64)

    def ref(axis, pkk, pvv, bkk, bvv):
        k, kvalid, pvals, hit, bvals, over = rpar.dist_join_unique(
            axis, pkk, jnp.ones(pkk.shape, bool), (pvv,), bkk,
            jnp.ones(bkk.shape, bool), (bvv,), n_probe // NDEV,
            n_build // NDEV)
        return k, kvalid, pvals[0], hit, bvals[0], over

    def port(comm, pkk, pvv, bkk, bvv):
        k, kvalid, pvals, hit, bvals, over = ppar.dist_join_unique(
            comm, pkk, torch.ones(pkk.shape, dtype=torch.bool), (pvv,), bkk,
            torch.ones(bkk.shape, dtype=torch.bool), (bvv,),
            n_probe // NDEV, n_build // NDEV)
        return k, kvalid, pvals[0], hit, bvals[0], over

    got, want = run_both(jmesh, mesh, ref, port, (0,) * 4,
                         (0,) * 5 + (None,), pk, pv, bk, bv)
    eq(got[1], want[1], what="probe valid")
    eq(got[3] & got[1], want[3] & want[1], what="hit")
    eq(got[0], want[0], got[1], "probe keys")
    eq(got[2], want[2], got[1], "probe values")
    eq(got[4], want[4], got[1] & got[3], "build values")
    eq(got[5], want[5], what="overflow")
    assert got[1].sum() == n_probe


def test_dist_sort(jmesh, mesh):
    n = 4096
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 50, n).astype(np.uint64)
    keys[::97] = np.uint64(2 ** 64 - 1)          # valid keys at the sentinel
    keys[1::89] += np.uint64(2 ** 63)
    payload = np.arange(n, dtype=np.int64)
    valid = rng.random(n) > 0.1
    cap = (n // NDEV) * 3

    def ref(axis, k, ok, p):
        k2, ok2, (p2,), over = rpar.dist_sort(axis, k, ok, cap, (p,))
        return k2, ok2, p2, over

    def port(comm, k, ok, p):
        k2, ok2, (p2,), over = ppar.dist_sort(comm, k, ok, cap, (p,))
        return k2, ok2, p2, over

    got, want = run_both(jmesh, mesh, ref, port, (0,) * 3,
                         (0, 0, 0, None), keys, valid, payload)
    eq(got[1], want[1], what="valid")
    eq(got[0], want[0], got[1], "keys")
    eq(got[2], want[2], got[1], "payload")
    eq(got[3], want[3], what="overflow")
    flat = got[0][got[1]].view(np.uint64)
    assert np.array_equal(flat, np.sort(keys[valid], kind="stable"))


def test_dist_join_skew_zipf(jmesh, mesh):
    """Heavy keys replicate their build rows and probe locally, light keys
    co-shuffle: both paths equal to the reference's, and together they
    match every probe row exactly once."""
    rng = np.random.default_rng(42)
    per = 256
    n = per * NDEV
    hot = rng.choice([5, 9, 13], n)
    cold = rng.integers(0, 512, n)
    keys = np.where(rng.random(n) < 0.5, hot, cold).astype(np.uint64)
    pvals = rng.integers(-100, 100, n).astype(np.int64)
    bkeys = np.arange(512, dtype=np.uint64)
    bvals = (np.arange(512, dtype=np.int64) * 7) % 101
    ok = np.ones(n, bool)
    kw = dict(heavy_cap=8, build_heavy_cap=64, heavy_min_frac=1.0 / 16)

    def ref(axis, pk, pv, okk, bk, bv):
        light, (hit_h, got_h, hover) = rpar.dist_join_skew(
            axis, pk, okk, (pv,), bk, jnp.ones(bk.shape, bool), (bv,),
            per * 8, per * 8, **kw)
        lk, lvalid, lpv, lhit, lgot, lover = light
        return lk, lvalid, lpv[0], lhit, lgot[0], hit_h, got_h[0], \
            lover | hover

    def port(comm, pk, pv, okk, bk, bv):
        light, (hit_h, got_h, hover) = ppar.dist_join_skew(
            comm, pk, okk, (pv,), bk, torch.ones(bk.shape, dtype=torch.bool),
            (bv,), per * 8, per * 8, **kw)
        lk, lvalid, lpv, lhit, lgot, lover = light
        return lk, lvalid, lpv[0], lhit, lgot[0], hit_h, got_h[0], \
            lover | hover

    got, want = run_both(jmesh, mesh, ref, port, (0,) * 5,
                         (0,) * 7 + (None,), keys, pvals, ok, bkeys, bvals)
    eq(got[1], want[1], what="light valid")
    eq(got[3] & got[1], want[3] & want[1], what="light hit")
    for i in (0, 2):
        eq(got[i], want[i], got[1], f"light output {i}")
    eq(got[4], want[4], got[1] & got[3], "light build values")
    eq(got[5], want[5], what="heavy hit")
    eq(got[6], want[6], got[5], "heavy build values")
    eq(got[7], want[7], what="overflow")
    expect = {int(k): int(v) for k, v in zip(bkeys, bvals)}
    assert (got[6][got[5]] == [expect[int(k)] for k in keys[got[5]]]).all()
    assert int((got[1] & got[3]).sum()) + int(got[5].sum()) == n
    assert int(got[5].sum()) > n // 4


def _group_overflow(jmesh, mesh, keys, vals, shuffle_cap, group_cap):
    def ref(axis, k, v, o):
        return rpar.dist_group_by(axis, k, o, shuffle_cap, group_cap,
                                  [("sum", v)])[3]

    def port(comm, k, v, o):
        return ppar.dist_group_by(comm, k, o, shuffle_cap, group_cap,
                                  [("sum", v)])[3]

    ok = np.ones(len(keys), bool)
    return run_both(jmesh, mesh, ref, port, (0,) * 3, None, keys, vals, ok)


def test_overflow_flags_detected(jmesh, mesh):
    """Undersized capacities flag, never drop silently."""
    n = 64 * NDEV
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 1000, n).astype(np.uint64)
    vals = rng.integers(0, 10, n).astype(np.int64)
    for caps, flagged in (((n, 1000), False), ((n, 4), True),
                          ((2, 1000), True)):
        got, want = _group_overflow(jmesh, mesh, keys, vals, *caps)
        assert bool(got) == bool(want) == flagged, caps


def test_dist_join_many_to_many(jmesh, mesh):
    """m:n join: every (probe, build) key pair, the same multiset of pairs
    on each shard as the reference's; overflow flagged when out_cap is
    undersized."""
    n = 64 * NDEV
    rng = np.random.default_rng(8)
    pk = rng.integers(0, 40, n).astype(np.uint64)
    pv = np.arange(n, dtype=np.int64)
    bk = rng.integers(0, 40, n).astype(np.uint64)
    bv = np.arange(n, dtype=np.int64) * 7

    def bodies(out_cap):
        def ref(axis, pkk, pvv, bkk, bvv):
            ones = jnp.ones(pkk.shape, bool)
            ov, key, (pvo,), (bvo,), over = rpar.dist_join(
                axis, pkk, ones, (pvv,), bkk, ones, (bvv,), n, n, out_cap)
            return ov, key, pvo, bvo, over

        def port(comm, pkk, pvv, bkk, bvv):
            ones = torch.ones(pkk.shape, dtype=torch.bool)
            ov, key, (pvo,), (bvo,), over = ppar.dist_join(
                comm, pkk, ones, (pvv,), bkk, ones, (bvv,), n, n, out_cap)
            return ov, key, pvo, bvo, over
        return ref, port

    got, want = run_both(jmesh, mesh, *bodies(8 * n), (0,) * 4,
                         (0,) * 4 + (None,), pk, pv, bk, bv)
    eq(got[0], want[0], what="out_valid")
    eq(got[4], want[4], what="overflow")
    assert not got[4]

    def pairs(out, shard):
        rows = slice(shard * 8 * n, (shard + 1) * 8 * n)
        m = out[0][rows]
        return sorted(zip(out[1][rows][m].view(np.uint64).tolist(),
                          out[2][rows][m].tolist(), out[3][rows][m].tolist()))
    for s in range(NDEV):
        assert pairs(got, s) == pairs(want, s), s
    exp = sorted((int(p), int(b)) for p, kp in zip(pv, pk)
                 for b, kb in zip(bv, bk) if kp == kb)
    assert sorted((p, b) for s in range(NDEV)
                  for _, p, b in pairs(got, s)) == exp
    got, want = run_both(jmesh, mesh, *bodies(4), (0,) * 4,
                         (0,) * 4 + (None,), pk, pv, bk, bv)
    assert bool(got[4]) and bool(want[4])


def test_dist_sort_overflow_flag(jmesh, mesh):
    n = 64 * NDEV
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 5, n).astype(np.uint64)
    ok = np.ones(n, bool)
    for cap, flagged in ((n * 2, False), (8, True)):
        got, want = run_both(
            jmesh, mesh,
            lambda axis, k, o: rpar.dist_sort(axis, k, o, cap, ())[3],
            lambda comm, k, o: ppar.dist_sort(comm, k, o, cap, ())[3],
            (0, 0), None, keys, ok)
        assert bool(got) == bool(want) == flagged, cap


# ---- local building blocks --------------------------------------------------

MAX = 0xFFFFFFFFFFFFFFFF


def _local_group(keys, valid, vals, cap, specs):
    r = rdist.local_group_aggregate(
        jnp.asarray(keys), jnp.asarray(valid), cap,
        [(op, jnp.asarray(vals)) for op in specs])
    p = pdist.local_group_aggregate(
        _port_in(keys), _port_in(valid), cap,
        [(op, _port_in(vals)) for op in specs])
    return _host(p[:2]) + (list(_host(p[2])), _host(p[3])), \
        (np.asarray(r[0]), np.asarray(r[1]), [np.asarray(o) for o in r[2]],
         np.asarray(r[3]))


def test_local_group_aggregate_sentinel_key_group():
    """A valid group whose key equals the invalid rows' sentinel does not
    merge into the previous group when invalid rows tie it."""
    keys = np.array([MAX, 5, MAX, MAX], np.uint64)
    valid = np.array([False, True, True, True])
    vals = np.array([100, 1, 10, 20], np.int64)
    got, want = _local_group(keys, valid, vals, 4, ("sum", "count"))
    eq(got[1], want[1])
    for g, w in zip([got[0]] + got[2], [want[0]] + want[2]):
        eq(g, w, got[1])
    found = {int(k) & MAX: (int(s), int(c)) for k, v, s, c in
             zip(got[0], got[1], *got[2]) if v}
    assert found == {5: (1, 1), MAX: (30, 2)}
    assert not got[3] and not want[3]


def test_local_group_aggregate_floats_nan_and_signed_zero():
    """Float min/max bit for bit (NaN, -0.0, infinities); float sums within
    rtol 1e-12 (prefix-sum differences); capacity overflow flagged."""
    rng = np.random.default_rng(12)
    n = 600
    keys = rng.integers(0, 20, n).astype(np.uint64)
    vals = rng.normal(size=n) * 1e3
    vals[::37] = np.nan
    vals[1::41] = -0.0
    vals[2::43] = 0.0
    vals[3::53] = np.inf
    valid = rng.random(n) > 0.1
    got, want = _local_group(keys, valid, vals, 32, SPECS4)
    eq(got[1], want[1])
    eq(got[0], want[0], got[1])
    for i in (1, 2, 3):
        eq(got[2][i], want[2][i], got[1], SPECS4[i])
    close(got[2][0], want[2][0], got[1] & np.isfinite(want[2][0]), "sum")
    eq(got[2][0], want[2][0], got[1] & ~np.isfinite(want[2][0]),
       "non-finite sums")
    got, want = _local_group(keys, valid, vals, 8, SPECS4)
    assert bool(got[3]) and bool(want[3])


def test_local_lookup_unique_sentinel_probe():
    """A probe key equal to the sentinel matches the valid build row, not
    an invalid row that ties it."""
    bk = np.array([0, MAX], np.uint64)
    bv = np.array([False, True])
    pk = np.array([MAX], np.uint64)
    pv = np.array([True])
    vals = np.array([111, 222], np.int64)
    r_hit, (r_got,) = rdist._local_lookup_unique(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bk), jnp.asarray(bv),
        [jnp.asarray(vals)])
    p_hit, (p_got,) = pdist._local_lookup_unique(
        _port_in(pk), _port_in(pv), _port_in(bk), _port_in(bv),
        [_port_in(vals)])
    assert bool(p_hit[0]) and bool(np.asarray(r_hit)[0])
    assert int(p_got[0]) == int(np.asarray(r_got)[0]) == 222


def test_compact_front_packs_the_kept_rows_through_k1():
    mask = torch.tensor([False, True, True, False, True])
    vals = torch.tensor([10, 11, 12, 13, 14])
    for cap in (2, 3, 8):
        kept, (out,) = pdist._compact_front(mask, cap, vals)
        r_kept, (r_out,) = rdist._compact_front(jnp.asarray(mask.numpy()),
                                                cap, jnp.asarray(vals.numpy()))
        eq(kept.numpy(), np.asarray(r_kept))
        eq(out.numpy(), np.asarray(r_out), kept.numpy())


def test_local_heavy_keys():
    rng = np.random.default_rng(13)
    keys = np.concatenate([
        np.full(50, 7, np.uint64), np.full(30, 2 ** 63 + 3, np.uint64),
        np.full(20, MAX, np.uint64),
        rng.integers(0, 1000, 200).astype(np.uint64)])
    valid = rng.random(len(keys)) > 0.05
    want = np.asarray(rdist.local_heavy_keys(jnp.asarray(keys),
                                             jnp.asarray(valid), 4,
                                             jnp.int32(10)))
    got = pdist.local_heavy_keys(_port_in(keys), _port_in(valid), 4, 10)
    eq(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_dist_group_by_parity(jmesh, mesh, seed):
    """Random cardinality, null rates and wide sums, both packages."""
    n = 64 * NDEV
    rng = np.random.default_rng(500 + seed)
    card = int(rng.integers(1, 50))
    keys = rng.integers(0, card, n).astype(np.uint64)
    if seed == 2:
        keys += np.uint64(2 ** 64 - 25)        # keys past 2^63, the sentinel
    ok = rng.random(n) > rng.choice([0.0, 0.2])
    vals = rng.integers(-10 ** 9, 10 ** 9, n)
    cap = 2 * card + 4

    def ref(axis, k, o, v):
        gk, gv, outs, over = rpar.dist_group_by(axis, k, o, n, cap,
                                                [(s, v) for s in SPECS4])
        return (gk, gv) + tuple(outs) + (over,)

    def port(comm, k, o, v):
        gk, gv, outs, over = ppar.dist_group_by(comm, k, o, n, cap,
                                                [(s, v) for s in SPECS4])
        return (gk, gv) + tuple(outs) + (over,)

    got, want = run_both(jmesh, mesh, ref, port, (0,) * 3,
                         (0,) * 6 + (None,), keys, ok, vals)
    eq(got[1], want[1])
    eq(got[6], want[6])
    for i in (0, 2, 3, 4, 5):
        eq(got[i], want[i], got[1], str(i))
    assert not got[6]


def test_dist_group_by_stream_pipelined(jmesh, mesh):
    rng = np.random.default_rng(21)
    C, n = 4, 1024
    keys = rng.integers(0, 37, (C, n)).astype(np.uint64)
    vals = rng.integers(-100, 100, (C, n)).astype(np.int64)
    ok = rng.random((C, n)) > 0.1

    def ref(axis, k, okk, v):
        gk, gv, outs, over = rpar.dist_group_by_stream(
            axis, k, okk, 512, 64, list(SPECS4), [v] * 4)
        return (gk, gv) + tuple(outs) + (over,)

    def port(comm, k, okk, v):
        gk, gv, outs, over = ppar.dist_group_by_stream(
            comm, k, okk, 512, 64, list(SPECS4), [v] * 4)
        return (gk, gv) + tuple(outs) + (over,)

    got, want = run_both(jmesh, mesh, ref, port, (1,) * 3,
                         (0,) * 6 + (None,), keys, ok, vals)
    eq(got[1], want[1])
    eq(got[6], want[6])
    for i in (0, 2, 3, 4, 5):
        eq(got[i], want[i], got[1], str(i))
    assert not got[6]


def test_dist_join_stream_pipelined(jmesh, mesh):
    rng = np.random.default_rng(22)
    C, n = 3, 1024
    pk = rng.integers(0, 600, (C, n)).astype(np.uint64)
    pv = rng.integers(-50, 50, (C, n)).astype(np.int64)
    ok = rng.random((C, n)) > 0.1
    bk = (np.arange(512) * 2).astype(np.uint64)
    bw = np.arange(512, dtype=np.int64) * 3
    bok = np.ones(512, bool)

    def ref(axis, k, okk, v, bkk, bokk, bww):
        ks, oks, (vs,), hits, (gots,), over = rpar.dist_join_stream(
            axis, k, okk, (v,), bkk, bokk, (bww,), 512, 512)
        return ks, oks, vs, hits, gots, over

    def port(comm, k, okk, v, bkk, bokk, bww):
        ks, oks, (vs,), hits, (gots,), over = ppar.dist_join_stream(
            comm, k, okk, (v,), bkk, bokk, (bww,), 512, 512)
        return ks, oks, vs, hits, gots, over

    got, want = run_both(jmesh, mesh, ref, port, (1,) * 3 + (0,) * 3,
                         (1,) * 5 + (None,), pk, ok, pv, bk, bok, bw)
    eq(got[1], want[1], what="probe valid")
    eq(got[3] & got[1], want[3] & want[1], what="hit")
    eq(got[0], want[0], got[1])
    eq(got[2], want[2], got[1])
    eq(got[4], want[4], got[1] & got[3])
    eq(got[5], want[5])
    assert not got[5]


# ---- the table API ----------------------------------------------------------

def test_dist_table_group_by_string_key(jmesh, mesh):
    from arrow_tpu.ops.groupby import AggSpec
    rng = np.random.default_rng(7)
    n = 3000
    words = ["alpha", "beta", "gamma", None, "delta", "epsilon"]
    s = [words[i] for i in rng.integers(0, len(words), n)]
    v = rng.integers(-1000, 1000, n)
    t = at.Table.from_pydict({"s": s, "v": v})
    aggs = [AggSpec("v", op) for op in SPECS4]
    want = rpar.dist_table_group_by(t, ["s"], aggs, mesh=jmesh)
    got = ppar.dist_table_group_by(port_table(t), ["s"], aggs, mesh)
    assert_tables_equal(got, port_table(want))


def test_dist_table_group_by_two_keys(jmesh, mesh):
    from arrow_tpu.ops.groupby import AggSpec
    rng = np.random.default_rng(8)
    n = 2000
    k1 = rng.integers(-5, 6, n)
    k2 = [["x", "y", "z"][i] for i in rng.integers(0, 3, n)]
    v = rng.integers(0, 100, n)
    t = at.Table.from_pydict({"k1": k1, "k2": k2, "v": v})
    want = rpar.dist_table_group_by(t, ["k1", "k2"], [AggSpec("v", "sum")],
                                    mesh=jmesh)
    got = ppar.dist_table_group_by(port_table(t), ["k1", "k2"],
                                   [AggSpec("v", "sum")], mesh)
    assert_tables_equal(got, port_table(want))


def test_dist_table_group_by_unsigned_and_float_sources(jmesh, mesh):
    """min/max of an unsigned column order as the type does (the port
    holds uint32 on int32 storage); float and unsigned sums."""
    from arrow_tpu.ops.groupby import AggSpec
    rng = np.random.default_rng(14)
    n = 1500
    t = at.Table.from_pydict({
        "k": rng.integers(0, 9, n),
        "u": rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32),
        "w": rng.integers(0, 2 ** 64, n, dtype=np.uint64),
        "f": rng.integers(-50, 50, n).astype(np.float64)})
    aggs = [AggSpec(c, op) for c in ("u", "w", "f") for op in SPECS4]
    want = rpar.dist_table_group_by(t, ["k"], aggs, mesh=jmesh)
    got = ppar.dist_table_group_by(port_table(t), ["k"], aggs, mesh)
    assert_tables_equal(got, port_table(want))


def test_dist_table_sort_two_keys(jmesh, mesh):
    from arrow_tpu.ops.sort import SortOptions as RSort
    from arrow_tpu_torch.ops.sort import SortOptions as PSort
    rng = np.random.default_rng(9)
    n = 2500
    words = ["aa", "bb", "cc", None]
    s = [words[i] for i in rng.integers(0, 4, n)]
    k = rng.integers(-10, 10, n)
    v = rng.integers(0, 10 ** 6, n)
    t = at.Table.from_pydict({"k": k, "s": s, "v": v})
    want = rpar.dist_table_sort(
        t, ["k", "s"], [RSort(descending=True, nulls_first=False), RSort()],
        mesh=jmesh)
    got = ppar.dist_table_sort(
        port_table(t), ["k", "s"],
        [PSort(descending=True, nulls_first=False), PSort()], mesh=mesh)
    assert_tables_equal(got, port_table(want))
    rows = sorted(zip(k.tolist(), s, v.tolist()),
                  key=lambda r: (-r[0], r[1] is not None, r[1] or ""))
    assert list(zip(*got.to_pydict().values())) == rows      # stable


def test_dist_table_join_string_key(jmesh, mesh):
    rng = np.random.default_rng(10)
    n = 1500
    words = ["alpha", "beta", "gamma", "delta", None]
    s = [words[i] for i in rng.integers(0, 5, n)]
    v = rng.integers(0, 1000, n)
    left = at.Table.from_pydict({"s": s, "v": v})
    right = at.Table.from_pydict({"s": ["alpha", "beta", "zeta"],
                                  "w": [1, 2, 3]})
    want = port_table(rpar.dist_table_join(left, right, ["s"], mesh=jmesh))
    got = ppar.dist_table_join(port_table(left), port_table(right), ["s"],
                               mesh)
    assert [(f.name, repr(f.dtype), f.nullable) for f in got.schema.fields] \
        == [(f.name, repr(f.dtype), f.nullable) for f in want.schema.fields]
    # one build row a key here: the rows' order is the reference's too
    assert got.to_pydict() == want.to_pydict()


def test_dist_table_join_many_to_many_int_keys(jmesh, mesh):
    rng = np.random.default_rng(15)
    left = at.Table.from_pydict({"k": rng.integers(0, 30, 700),
                                 "a": rng.integers(0, 99, 700)})
    right = at.Table.from_pydict({"k": rng.integers(0, 30, 300),
                                  "b": rng.normal(size=300)})
    want = port_table(rpar.dist_table_join(left, right, ["k"], mesh=jmesh))
    got = ppar.dist_table_join(port_table(left), port_table(right), ["k"],
                               mesh)
    assert got.num_rows == want.num_rows

    def rows(t):
        return sorted(zip(*t.to_pydict().values()))
    assert rows(got) == rows(want)            # m:n: as multisets (C5)


def test_dist_table_key_too_wide(jmesh, mesh):
    from arrow_tpu.ops.groupby import AggSpec
    rng = np.random.default_rng(11)
    n = 64
    t = at.Table.from_pydict({"a": rng.integers(0, 1 << 40, n),
                              "b": rng.integers(0, 1 << 40, n),
                              "v": np.ones(n, np.int64)})
    with pytest.raises(at.ArrowNotImplementedError):
        rpar.dist_table_group_by(t, ["a", "b"], [AggSpec("v", "sum")],
                                 mesh=jmesh)
    with pytest.raises(ArrowNotImplementedError):
        ppar.dist_table_group_by(port_table(t), ["a", "b"],
                                 [AggSpec("v", "sum")], mesh)


def test_dist_table_overflow_raises(mesh):
    from arrow_tpu_torch.ops.groupby import AggSpec
    t = att.Table.from_pydict({"k": np.arange(64), "v": np.ones(64, np.int64)},
                              device="cpu")
    with pytest.raises(ArrowInvalid, match="capacity overflow"):
        ppar.dist_table_group_by(t, ["k"], [AggSpec("v", "sum")], mesh,
                                 group_cap=2)


def test_dist_table_calls_need_a_mesh():
    from arrow_tpu_torch.ops.groupby import AggSpec
    t = att.Table.from_pydict({"k": [1, 2], "v": [3, 4]}, device="cpu")
    with pytest.raises(TypeError):
        ppar.dist_table_group_by(t, ["k"], [AggSpec("v", "sum")])
    with pytest.raises(TypeError):
        ppar.dist_table_sort(t, ["k"])
    with pytest.raises(TypeError):
        ppar.dist_table_join(t, t, ["k"])
    with pytest.raises(ValueError, match="explicit device"):
        ppar.make_mesh(8, None)


# ---- the mesh itself --------------------------------------------------------

def test_make_mesh_on_one_device_or_a_list():
    m = ppar.make_mesh(3, "cpu")
    assert m.size == 3 and set(m.devices) == {torch.device("cpu")}
    assert ppar.shard_axis(m) == "shards"
    assert ppar.table_sharding(m) == ppar.RowSplit(3)
    m = ppar.make_mesh(2, ["cpu", torch.device("cpu")])
    assert m.size == 2
    with pytest.raises(ValueError):
        ppar.make_mesh(3, ["cpu", "cpu"])


def test_a_shard_that_raises_raises_in_the_caller(mesh):
    """An exception in one shard aborts the others' barrier: the caller
    gets the first error at once, not after the barrier's timeout."""
    slow = ppar.LocalMesh(mesh.devices, timeout=60.0)

    def body(comm, x):
        y = comm.all_to_all(x)
        if comm.rank == 3:
            raise KeyError("shard 3 fails")
        return comm.psum(y.sum())

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="shard 3 fails"):
        ppar.shard_map(body, slow, (0,), None)(torch.arange(64))
    assert time.perf_counter() - t0 < 30
    assert not [t for t in threading.enumerate()
                if t.name.startswith("shard-")]


def test_a_shard_that_never_arrives_times_out(mesh):
    quick = ppar.LocalMesh(mesh.devices[:2], timeout=0.5)

    def body(comm, x):
        if comm.rank == 0:
            return x.sum()
        return comm.psum(x.sum())          # shard 0 never comes

    with pytest.raises(threading.BrokenBarrierError):
        ppar.shard_map(body, quick, (0,), 0)(torch.arange(4))


def test_replicated_outputs_must_agree(mesh):
    with pytest.raises(AssertionError, match="differs"):
        ppar.shard_map(lambda comm, x: x.sum() + comm.rank, mesh, (0,),
                       None)(torch.arange(16))


def test_dryrun_multichip_on_eight_cpu_shards():
    from arrow_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, "cpu")


def test_parallel_exports_every_reference_name():
    names = [n for n in dir(rpar) if not n.startswith("_")
             and n not in ("api", "dist", "mesh", "partition")]
    missing = [n for n in names if not hasattr(ppar, n)]
    assert missing == ["P"]           # PartitionSpec: shard_map's int specs


# ---- torch.distributed over gloo --------------------------------------------

GLOO_CHILD = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
from arrow_tpu_torch import parallel as par

store, rank, world, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
comm = par.ProcessGroupComm()
rng = np.random.default_rng(3)
n = 256 * world
keys = torch.from_numpy(rng.integers(0, 2 ** 64, n, dtype=np.uint64)
                        .view(np.int64) % 97)
vals = torch.from_numpy(rng.integers(-1000, 1000, n))
ok = torch.from_numpy(rng.random(n) > 0.1)
rows = slice(rank * 256, (rank + 1) * 256)
gk, gv, outs, over = par.dist_group_by(
    comm, keys[rows], ok[rows], 256, 128,
    [(o, vals[rows]) for o in ("sum", "count", "min", "max")])
sk, sv, (sp,), sover = par.dist_sort(comm, keys[rows] * 7919, ok[rows], 512,
                                     (vals[rows],))
total = par.dist_sum(comm, vals[rows], ok[rows])
torch.save({"group": [gk, gv, *outs, over], "sort": [sk, sv, sp, sover],
            "sum": total}, out)
dist.destroy_process_group()
assert "jax" not in sys.modules and "arrow_tpu" not in sys.modules
"""


def _local_answers(world: int):
    mesh = ppar.make_mesh(world, "cpu")
    rng = np.random.default_rng(3)
    n = 256 * world
    keys = torch.from_numpy(rng.integers(0, 2 ** 64, n, dtype=np.uint64)
                            .view(np.int64) % 97)
    vals = torch.from_numpy(rng.integers(-1000, 1000, n))
    ok = torch.from_numpy(rng.random(n) > 0.1)

    def body(comm, k, o, v):
        gk, gv, outs, over = ppar.dist_group_by(
            comm, k, o, 256, 128,
            [(op, v) for op in ("sum", "count", "min", "max")])
        sk, sv, (sp,), sover = ppar.dist_sort(comm, k * 7919, o, 512, (v,))
        return [gk, gv, *outs], [sk, sv, sp], \
            ppar.dist_sum(comm, v, o), over, sover
    return ppar.shard_map(body, mesh, (0, 0, 0),
                          (0, 0, None, None, None))(keys, ok, vals)


@pytest.mark.parametrize("world", [2, 4])
def test_process_group_route_equals_local_mesh(world, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_CHILD, str(tmp_path / "store"), str(r),
         str(world), str(tmp_path / f"out{r}.pt")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    parts = [torch.load(tmp_path / f"out{r}.pt") for r in range(world)]
    group, srt, total, over, sover = _local_answers(world)
    valid = torch.cat([p["group"][1] for p in parts])
    assert torch.equal(valid, group[1])
    for i in (0, 2, 3, 4, 5):
        got = torch.cat([p["group"][i] for p in parts])
        assert torch.equal(got[valid], group[i][valid]), i
    svalid = torch.cat([p["sort"][1] for p in parts])
    assert torch.equal(svalid, srt[1])
    for i in (0, 2):
        got = torch.cat([p["sort"][i] for p in parts])
        assert torch.equal(got[svalid], srt[i][svalid]), i
    for p in parts:
        assert int(p["sum"]) == int(total)
        assert not bool(p["group"][-1]) and not bool(p["sort"][-1])
    assert not bool(over) and not bool(sover)


# ---- on the card ------------------------------------------------------------

def test_k1_at_the_parallel_sites_on_the_card(cuda_device):
    """K1 launches at the three new sites and equals its plain version."""
    gen = torch.Generator().manual_seed(0)
    n = 1 << 20
    keys = torch.randint(0, 5000, (n,), generator=gen)
    valid = torch.rand(n, generator=gen) > 0.1
    vals = torch.randint(-100, 100, (n,), generator=gen)
    before = kc.compact.launches
    got = pdist.local_group_aggregate(keys.to(cuda_device),
                                      valid.to(cuda_device), 8192,
                                      [("sum", vals.to(cuda_device))])
    want = pdist.local_group_aggregate(keys, valid, 8192, [("sum", vals)])
    assert kc.compact.launches == before + 1
    gv = want[1]
    assert torch.equal(got[1].cpu(), gv)
    assert torch.equal(got[0].cpu()[gv], want[0][gv])
    assert torch.equal(got[2][0].cpu()[gv], want[2][0][gv])
    mask = valid & (keys % 7 == 0)
    kept, outs = pdist._compact_front(mask.to(cuda_device), n, keys.to(
        cuda_device), vals.to(cuda_device))
    r_kept, r_outs = pdist._compact_front(mask, n, keys, vals)
    assert torch.equal(kept.cpu(), r_kept)
    for a, b in zip(outs, r_outs):
        assert torch.equal(a.cpu()[r_kept], b[r_kept])
    from arrow_tpu_torch.parallel import api
    before = kc.compact.launches
    (k,) = api._trim(mask.to(cuda_device), torch.tensor(False,
                                                        device=cuda_device),
                     [keys.to(cuda_device)], "test")
    assert kc.compact.launches == before + 1
    assert torch.equal(k.cpu(), keys[mask])


def test_local_mesh_on_the_card_equals_the_cpu(cuda_device):
    """Every body on an 8-shard LocalMesh on the card against the same
    mesh on the CPU."""
    from arrow_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, cuda_device)
    rng = np.random.default_rng(5)
    n = 8 * 4096
    keys = torch.from_numpy(rng.integers(0, 2 ** 64, n, dtype=np.uint64)
                            .view(np.int64) % 5000)
    vals = torch.from_numpy(rng.integers(-1000, 1000, n))
    ok = torch.from_numpy(rng.random(n) > 0.1)
    bk = torch.arange(4096 * 8, dtype=torch.int64) * 3
    bv = bk * 7

    def body(comm, k, o, v, b, w):
        ones = torch.ones_like(o)
        g = ppar.dist_group_by(comm, k, o, 8192, 8192,
                               [(op, v) for op in SPECS4])
        s = ppar.dist_sort(comm, k, o, 3 * 4096, (v,))
        j = ppar.dist_join_unique(comm, k, o, (v,), b, ones, (w,),
                                  8192, 8192)
        m = ppar.dist_join(comm, k % 4096, o, (v,), b % 4096, ones, (w,),
                           8192, 8192, 1 << 17)
        light, heavy = ppar.dist_join_skew(comm, k % 300, o, (v,), b,
                                           ones, (w,), 8192, 8192)
        return g, s, j, (m[0], m[4]), light, heavy, ppar.dist_sum(comm, v, o)

    specs = ((0, 0, (0, 0, 0, 0), None), (0, 0, (0,), None),
             (0, 0, (0,), 0, (0,), None), (0, None), (0, 0, (0,), 0, (0,),
                                                      None),
             (0, (0,), None), None)
    args = (keys, ok, vals, bk, bv)
    want = ppar.shard_map(body, ppar.make_mesh(8, "cpu"), (0,) * 5,
                          specs)(*args)
    got = ppar.shard_map(body, ppar.make_mesh(8, cuda_device), (0,) * 5,
                         specs)(*[a.to(cuda_device) for a in args])
    got = _host(got)
    want = _host(want)
    # group-by
    eq(got[0][1], want[0][1])
    for g, w in zip([got[0][0]] + list(got[0][2]), [want[0][0]]
                    + list(want[0][2])):
        eq(g, w, got[0][1])
    eq(got[0][3], want[0][3])
    # sort
    eq(got[1][1], want[1][1])
    eq(got[1][0], want[1][0], got[1][1])
    eq(got[1][2][0], want[1][2][0], got[1][1])
    # FK join
    eq(got[2][1], want[2][1])
    eq(got[2][3] & got[2][1], want[2][3] & want[2][1])
    eq(got[2][4][0], want[2][4][0], got[2][3] & got[2][1])
    # m:n join: masks and flags (pairs within a probe row: C5)
    eq(got[3][0], want[3][0])
    eq(got[3][1], want[3][1])
    # skew join
    eq(got[4][1], want[4][1])
    eq(got[4][3] & got[4][1], want[4][3] & want[4][1])
    eq(got[5][0], want[5][0])
    eq(got[5][1][0], want[5][1][0], got[5][0])
    eq(got[6], want[6])
