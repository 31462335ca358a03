"""K2 of the PyTorch port against the JAX reference: the port's
grouped_aggregate (its plain version on the CPU) against the reference's
Pallas grouped_aggregate in interpret mode.  Wrapping int sums, counts
with no valid rows, min/max over i8, i64, u64, f16 and f32 with NaN and
+-inf, decoded and encoded partials; all exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from arrow_tpu.kernels import groupagg as ref_ga
from arrow_tpu.kernels.groupminmax import grouped_min_max as ref_min_max
from arrow_tpu.kernels.segagg import (grouped_count as ref_count,
                                      grouped_sum_count as ref_sum_count)
from arrow_tpu_torch import dtypes as tdt
from arrow_tpu_torch.errors import ArrowInvalid
from arrow_tpu_torch.kernels import groupagg as kg

from torch_port_util import bits, cuda_device  # noqa: F401

N = 2000
SPECIAL_F32 = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000,
                        0x7F800001, 0x7FFFFFFF, 0x80000000, 0x00000001],
                       np.uint32).view(np.float32)
SPECIAL_F16 = np.array([0x7C00, 0xFC00, 0x7E00, 0xFE00, 0x7C01, 0x7FFF,
                        0x8000, 0x0001, 0x03FF], np.uint16).view(np.float16)


def _values(rng, name, n=N):
    d = np.dtype(name)
    if d.kind in "iu":
        info = np.iinfo(d)
        return rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    v = rng.normal(0, 100, n).astype(d)
    special = SPECIAL_F32 if name == "float32" else SPECIAL_F16
    idx = rng.choice(n, 40, replace=False)
    v[idx] = np.resize(special, 40)
    return v


def _codes(rng, G, n=N):
    # a few codes out of range on both sides: dropped by both
    return rng.integers(-2, G + 3, n).astype(np.int32)


def _key_of_planes(hi, lo):
    """The reference's (hi, lo) i32 order planes as one u64 key."""
    h = np.asarray(hi).view(np.uint32).astype(np.uint64) ^ np.uint64(1 << 31)
    l_ = np.asarray(lo).view(np.uint32).astype(np.uint64) ^ np.uint64(1 << 31)
    return (h << np.uint64(32)) | l_


def _t(a):
    """The port's storage of a numpy array (signed for uint16/32/64)."""
    if a is None:
        return None
    storage = tdt.from_numpy_dtype(a.dtype).storage_numpy()
    return torch.from_numpy(np.ascontiguousarray(a).view(storage))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _run_both(codes, G, sums, mms, decode):
    """sums: [(values, valid)], mms: [(values, valid, want_min, want_max)]."""
    want = ref_ga.grouped_aggregate(
        _j(codes), G, [ref_ga.SumCol(_j(v), _j(m)) for v, m in sums],
        [ref_ga.MinMaxCol(_j(v), _j(m), a, b) for v, m, a, b in mms],
        decode=decode)
    got = kg.grouped_aggregate(
        _t(codes), G,
        [kg.SumCol(_t(v), _t(m), tdt.from_numpy_dtype(v.dtype))
         for v, m in sums],
        [kg.MinMaxCol(_t(v), _t(m), tdt.from_numpy_dtype(v.dtype), a, b)
         for v, m, a, b in mms],
        decode=decode)
    return got, want


def _assert_sums_counts(got, want):
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert (g.numpy() == np.asarray(w)).all()


@pytest.mark.parametrize("G", [1, 37, 140, 1024])
@pytest.mark.parametrize("name", ["int64", "uint64", "int32", "uint32",
                                  "int8", "uint16"])
def test_sums_and_counts_match_reference(rng, name, G):
    vals = _values(rng, name)
    valid = rng.random(N) > 0.25
    got, want = _run_both(_codes(rng, G), G, [(vals, valid), (vals, None)],
                          [], decode=True)
    _assert_sums_counts(got, want)


def test_wrapping_sums_match_reference(rng):
    # every partial sum overflows i64 many times
    vals = rng.integers(2 ** 62, 2 ** 63, N).astype(np.uint64) \
        .astype(np.int64)
    codes = _codes(rng, 3)
    got, want = _run_both(codes, 3, [(vals, None)], [], True)
    _assert_sums_counts(got, want)
    # numpy's int64 sum wraps too: a sequential wrapping loop
    assert [int(s) for s in got[0][0]] \
        == [int(vals[codes == g].sum()) for g in range(3)]


def test_count_with_no_valid_rows(rng):
    vals = _values(rng, "int64")
    none = np.zeros(N, bool)
    got, want = _run_both(_codes(rng, 9), 9, [(vals, none)],
                          [(vals, none, True, True)], decode=False)
    _assert_sums_counts(got, want)
    assert all((c.numpy() == 0).all() for c in got[1])
    mn, mx = got[2][0]
    assert (mn.numpy() == -1).all() and (mx.numpy() == 0).all()


@pytest.mark.parametrize("decode", [True, False], ids=["decoded", "encoded"])
@pytest.mark.parametrize("want", [(True, True), (True, False), (False, True)],
                         ids=["minmax", "min", "max"])
@pytest.mark.parametrize("name", ["int8", "int64", "uint64", "float16",
                                  "float32"])
def test_min_max_match_reference(rng, name, want, decode):
    G = 41                      # several groups stay empty: identities
    vals = _values(rng, name)
    valid = rng.random(N) > 0.2
    codes = rng.integers(0, 30, N).astype(np.int32)
    got, ref = _run_both(codes, G, [], [(vals, valid, *want)], decode)
    if decode:
        for g, w in zip(got[2][0], ref[2][0]):
            assert (g is None) == (w is None)
            if g is not None:
                # same bits; uint64 lives on int64 storage in the port
                g, w = g.numpy(), np.asarray(w)
                assert g.dtype.itemsize == w.dtype.itemsize
                assert (bits(g) == bits(w)).all()
        return
    # undecoded keys; a part that was not requested is not compared (the
    # reference leaves it at its identity, the port computes it anyway)
    mn_hi, mn_lo, mx_hi, mx_lo = ref[2][0]
    mn, mx = (k.numpy().view(np.uint64) for k in got[2][0])
    if want[0]:
        assert (mn == _key_of_planes(mn_hi, mn_lo)).all()
    if want[1]:
        assert (mx == _key_of_planes(mx_hi, mx_lo)).all()


def test_fused_slots_match_reference(rng):
    """The group_by plan's shape: occupancy, count and sum slots plus
    one min/max slot, in one call."""
    G = 1001
    vals = (rng.integers(0, 2 ** 63, N) % 1000).astype(np.int64)
    valid = rng.random(N) > 0.1
    codes = _codes(rng, G)
    ones = np.ones(N, np.int64)
    got, want = _run_both(codes, G, [(ones, None), (ones, valid),
                                     (vals, valid)],
                          [(vals, valid, True, True)], decode=True)
    _assert_sums_counts(got, want)
    for g, w in zip(got[2][0], want[2][0]):
        assert (g.numpy() == np.asarray(w)).all()


def test_wrappers_match_reference(rng):
    G = 23
    vals = _values(rng, "int32")
    valid = rng.random(N) > 0.3
    codes = _codes(rng, G)
    s, c = kg.grouped_sum_count(_t(vals), _t(codes), _t(valid), G)
    rs, rc = ref_sum_count(_j(vals), _j(codes), _j(valid), G)
    assert (s.numpy() == np.asarray(rs)).all()
    assert (c.numpy() == np.asarray(rc)).all()
    cnt = kg.grouped_count(_t(codes), None, G)
    assert (cnt.numpy() == np.asarray(ref_count(_j(codes), None, G))).all()
    mn, mx = kg.grouped_min_max(_t(vals), _t(codes), _t(valid), G)
    rmn, rmx = ref_min_max(_j(vals), _j(codes), _j(valid), G)
    assert (mn.numpy() == np.asarray(rmn)).all()
    assert (mx.numpy() == np.asarray(rmx)).all()


def test_order_keys_round_trip_every_f16():
    """Every f16 bit pattern encodes to the f32-widened key and decodes
    back to its own bits (NaNs come back quieted, as in the reference)."""
    allbits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    vals = torch.from_numpy(allbits.view(np.float16).copy())
    key = kg.encode_order_key(vals, tdt.float16)
    back = kg.decode_order_key(key, tdt.float16).numpy().view(np.uint16)
    is_nan = np.isnan(allbits.view(np.float16))
    assert (back[~is_nan] == allbits[~is_nan]).all()
    assert (back[is_nan] == (allbits[is_nan] | 0x0200)).all()
    order = np.argsort(key.numpy().view(np.uint64), kind="stable")
    ordered = allbits.view(np.float16)[order].astype(np.float64)
    finite = ordered[~np.isnan(ordered)]
    assert (np.diff(finite) >= 0).all()


@pytest.mark.parametrize("bad", ["groups", "sum-float", "mm-bool", "codes"])
def test_rejects_outside_contract(bad):
    codes = torch.zeros(4, dtype=torch.int32)
    if bad == "groups":
        args = (codes, kg.G_MAX + 1)
        kw = {}
    elif bad == "sum-float":
        args, kw = (codes, 2), {"sum_cols": [kg.SumCol(torch.ones(4))]}
    elif bad == "mm-bool":
        args = (codes, 2)
        kw = {"mm_cols": [kg.MinMaxCol(torch.ones(4, dtype=torch.bool))]}
    else:                         # keys of any integer width are codes
        args, kw = (codes.to(torch.float32), 2), {}
    with pytest.raises(ArrowInvalid):
        kg.grouped_aggregate(*args, **kw)


def test_plain_version_never_counts_a_launch(rng):
    before = kg.grouped_aggregate.launches
    kg.grouped_count(_t(_codes(rng, 5)), None, 5)
    assert kg.grouped_aggregate.launches == before


@pytest.mark.parametrize("G", [1, 999, 1024])
def test_kernel_matches_plain_on_cuda(cuda_device, G):
    n = 200_003
    g = torch.Generator(device=cuda_device)
    g.manual_seed(G)
    dev = cuda_device
    codes = torch.randint(-2, G + 2, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    valid = torch.rand(n, generator=g, device=dev) > 0.1
    i64 = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g, device=dev)
    i8 = i64.to(torch.int8)
    f16 = torch.randn(n, generator=g, device=dev, dtype=torch.float16)
    f16[::17] = float("nan")
    f32 = torch.randn(n, generator=g, device=dev)
    f32[::23] = -float("inf")
    sums = [kg.SumCol(None), kg.SumCol(None, valid), kg.SumCol(i64, valid),
            kg.SumCol(i8), kg.SumCol(i64, None, tdt.uint64)]
    mms = [kg.MinMaxCol(i64, valid), kg.MinMaxCol(i64, None, tdt.uint64),
           kg.MinMaxCol(i8, valid), kg.MinMaxCol(f16, valid),
           kg.MinMaxCol(f32)]
    before = kg.grouped_aggregate.launches
    got = kg.grouped_aggregate(codes, G, sums, mms, decode=False)
    want = kg.grouped_aggregate_plain(codes, G, sums, mms)
    torch.cuda.synchronize()
    assert kg.grouped_aggregate.launches == before + 1
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    for (a0, a1), (b0, b1) in zip(got[2], want[2]):
        assert torch.equal(a0, b0) and torch.equal(a1, b1)


def test_kernel_repeated_launches_agree_on_cuda(cuda_device):
    """K2's blocks meet in shared-memory atomics, where an ordering fault
    would show now and then, not at every launch.  compute-sanitizer
    refused the H100 these tests run on ("Device not supported";
    PERF.md), so the same inputs go through the kernel 100 times at 1
    and 1,024 groups, each launch equal to the plain version."""
    n = 2_000_003
    g = torch.Generator(device=cuda_device)
    g.manual_seed(16)
    dev = cuda_device
    valid = torch.rand(n, generator=g, device=dev) > 0.1
    i64 = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g, device=dev)
    f32 = torch.randn(n, generator=g, device=dev)
    for G in (1, 1024):
        codes = torch.randint(0, G, (n,), generator=g, device=dev,
                              dtype=torch.int32)
        sums = [kg.SumCol(None, valid), kg.SumCol(i64, valid)]
        mms = [kg.MinMaxCol(i64, valid), kg.MinMaxCol(f32)]
        want = kg.grouped_aggregate_plain(codes, G, sums, mms)
        for _ in range(100):
            got = kg.grouped_aggregate(codes, G, sums, mms, decode=False)
            for a, b in zip(got[0] + got[1], want[0] + want[1]):
                assert torch.equal(a, b)
            for (a0, a1), (b0, b1) in zip(got[2], want[2]):
                assert torch.equal(a0, b0) and torch.equal(a1, b1)


KEY_TYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
             "uint64"]


def _keys_near(rng, d, base, G, n=N):
    """Keys of numpy dtype d in [base - 3, base + G + 3], clipped to the
    type: some below the base, some past the last code."""
    info = np.iinfo(d)
    lo, hi = max(info.min, base - 3), min(info.max, base + G + 3)
    return rng.integers(lo, hi, n, dtype=d, endpoint=True)


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("key", KEY_TYPES)
def test_key_width_base_and_nulls_match_reference(rng, key, nulls):
    """K2 reading a key column at its own width: code = key - base, null
    keys take the last code, codes outside [0, G) drop their rows.  The
    reference runs on the same codes rebased to int32 by numpy."""
    G = 37
    d = np.dtype(key)
    base = int(np.iinfo(d).max) - 30 if d.kind == "u" \
        else int(np.iinfo(d).min) + 2
    keys = _keys_near(rng, d, base, G)
    kvalid = rng.random(N) > 0.2 if nulls else None
    codes = np.array([int(k) - base for k in keys])
    if nulls:
        codes = np.where(kvalid, codes, G - 1)
    codes = np.where((codes >= 0) & (codes < G), codes, -1).astype(np.int32)
    vals = _values(rng, "int64")
    small = _values(rng, "int16")
    valid = rng.random(N) > 0.25
    want = ref_ga.grouped_aggregate(
        _j(codes), G, [ref_ga.SumCol(_j(vals), _j(valid)),
                       ref_ga.SumCol(_j(small), None)],
        [ref_ga.MinMaxCol(_j(small), _j(valid), True, True)], decode=True)
    got = kg.grouped_aggregate(
        _t(keys), G, [kg.SumCol(_t(vals), _t(valid)), kg.SumCol(_t(small))],
        [kg.MinMaxCol(_t(small), _t(valid))], base=base,
        codes_valid=_t(kvalid), codes_dtype=tdt.from_numpy_dtype(d))
    _assert_sums_counts(got, want)
    for g, w in zip(got[2][0], want[2][0]):
        assert (g.numpy() == np.asarray(w)).all()


def test_row_codes_of_bool_keys():
    """Bool keys are 1-byte unsigned codes: 0/1 less the base."""
    keys = torch.tensor([True, False, True, True])
    valid = torch.tensor([True, True, False, True])
    assert kg.row_codes(keys, 3, 0, valid).tolist() == [1, 0, 2, 1]
    assert kg.row_codes(keys, 2, 1).tolist() == [0, -1, 0, 0]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("key", ["int8", "uint8", "int16", "int32", "int64",
                                 "bool"])
@pytest.mark.parametrize("G", [1, 1024])
def test_key_width_and_base_on_cuda(cuda_device, G, key, aligned):
    """Every key width with a base and key nulls, every value width and
    class, at G = 1 (every row on one group) and G = 1,024; unaligned
    inputs take the kernel's scalar loads."""
    n = 300_007
    s = 0 if aligned else 1
    rng = np.random.default_rng(G)
    dev = cuda_device

    def cut(a):
        """`a` on the card, from an element in when unaligned."""
        t = _t(np.concatenate([a[:1], a]) if s else a).to(dev)
        return t[s:]

    if key == "bool":
        keys, base, kd = rng.random(n) < 0.5, 1 - (G > 1), tdt.bool_
    else:
        d = np.dtype(key)
        base = int(np.iinfo(d).min) + 1 if d.kind == "i" else 3
        keys, kd = _keys_near(rng, d, base, G, n), tdt.from_numpy_dtype(d)
    kvalid = rng.random(n) > 0.1
    valid = rng.random(n) > 0.2
    sums, mms = [kg.SumCol(None), kg.SumCol(None, cut(valid))], []
    for name in ["int8", "uint8", "int16", "uint16", "int32", "uint32",
                 "int64", "uint64"]:
        v = cut(_values(rng, name, n))
        dt_ = tdt.from_numpy_dtype(np.dtype(name))
        sums.append(kg.SumCol(v, cut(valid), dt_))
        mms.append(kg.MinMaxCol(v, None, dt_))
    for name in ["float16", "float32", "float64"]:
        v = _values(rng, name, n) if name != "float64" \
            else rng.normal(0, 1, n)
        mms.append(kg.MinMaxCol(cut(v), cut(valid)))
    args = (cut(keys), G, sums, mms)
    kw = dict(base=base, codes_valid=cut(kvalid), codes_dtype=kd)
    before = kg.grouped_aggregate.launches
    got = kg.grouped_aggregate(*args, decode=False, **kw)
    want = kg.grouped_aggregate_plain(*args, **kw)
    torch.cuda.synchronize()
    assert kg.grouped_aggregate.launches > before
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    for (a0, a1), (b0, b1) in zip(got[2], want[2]):
        assert torch.equal(a0, b0) and torch.equal(a1, b1)
