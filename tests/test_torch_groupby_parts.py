"""The modules under arrow_tpu_torch's group_by against the reference:
the key encoder and lexsort (ops/row_format.py), take, concat,
float_group_sums and segment_aggregate; plus the CUDA tests of the
group_by plans (each kernel's launches, and the card's output against
the CPU's), which skip where there is no card.  Bitwise under
`_py_equal` unless a test says otherwise."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.ops.groupby import AggSpec as RefAggSpec
from arrow_tpu.ops.groupby import float_group_sums as ref_float_group_sums
from arrow_tpu.ops.groupby import group_by as ref_group_by
from arrow_tpu.ops.groupby import segment_aggregate as ref_segment_aggregate
from arrow_tpu.ops.row_format import SortOptions, lexsort_indices_fused
from arrow_tpu_torch.errors import (ArrowInvalid, ArrowNotImplementedError,
                                    ArrowTypeError)
from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
from arrow_tpu_torch.ops import groupby as gb, row_format as rf
from arrow_tpu_torch.ops.concat import concat, concat_tables
from arrow_tpu_torch.ops.groupby import (AggSpec, GroupByAccumulator,
                                         float_group_sums, group_by,
                                         segment_aggregate)
from arrow_tpu_torch.ops.take import take

from torch_port_util import (assert_columns_equal,  # noqa: F401
                             assert_tables_equal, cuda_device, port_column,
                             port_table, rand_column)

ref_take = importlib.import_module("arrow_tpu.ops.take")
ref_concat = importlib.import_module("arrow_tpu.ops.concat")
ref_rf = importlib.import_module("arrow_tpu.ops.row_format")

N = 3000


def dict_column(rng, n, values, nulls=0.1):
    return at.DictionaryColumn(
        jnp.asarray(rng.integers(0, len(values), n).astype(np.int32)),
        at.column(values), jnp.asarray(rng.random(n) >= nulls))


KEY_SETS = {
    "int64-full": lambda rng: [rand_column(rng, "int64", N)],
    "uint64-f64": lambda rng: [rand_column(rng, "uint64", N, small=True),
                               rand_column(rng, "float64", N, small=True)],
    "f16-int8-dict": lambda rng: [
        rand_column(rng, "float16", N, small=True),
        rand_column(rng, "int8", N, small=True),
        dict_column(rng, N, ["q", None, "b", "q", "a"])],
    "bool-uint32-f32": lambda rng: [rand_column(rng, "bool", N),
                                    rand_column(rng, "uint32", N),
                                    rand_column(rng, "float32", N)],
}


@pytest.mark.parametrize("keys", list(KEY_SETS))
def test_lexsort_order_matches_reference(rng, keys):
    """Stable lexicographic order of the key stack, nulls first, NaN
    last, -0.0 tied with +0.0: the same permutation as the reference's
    lexsort_indices_fused."""
    cols = KEY_SETS[keys](rng)
    want = np.asarray(lexsort_indices_fused(cols, [SortOptions()] * len(cols)))
    got = rf.lexsort_order(rf.encode_keys([port_column(c) for c in cols]),
                           N, "cpu")
    assert (got.numpy() == want).all()


def test_key_ranges_narrow_the_words(rng):
    """Two int64 keys of small range pack into ONE int32 word and sort
    as the native-width keys do; a 64-bit key is a word of its own,
    between its null class and the next column's keys."""
    cols = [port_column(rand_column(rng, "int64", N, small=True))
            for _ in range(2)]
    ranges = [rf.KeyRange(0, 39, True), rf.KeyRange(0, 39, True)]
    narrow = rf.encode_keys(cols, ranges)
    words = rf._pack_words(narrow)
    assert [w.dtype for w in words] == [torch.int32]
    assert torch.equal(rf.lexsort_order(narrow, N, "cpu"),
                       rf.lexsort_order(rf.encode_keys(cols), N, "cpu"))
    wide = rf.encode_keys([port_column(rand_column(rng, "int64", N))] + cols,
                          [None] + ranges)
    assert [w.dtype for w in rf._pack_words(wide)] == [
        torch.int32, torch.int64, torch.int32]


@pytest.mark.parametrize("values", [["b", None, "a", "b"], [3.5, -1.0, 2.0]])
def test_dictionary_value_ranks_match_reference(values):
    want = ref_rf.dictionary_value_ranks(at.column(values))
    got = rf.dictionary_value_ranks(att.column(values, device="cpu"))
    for g, w in zip(got, want):
        assert (g == np.asarray(w)).all()


@pytest.mark.parametrize("kind", ["int16", "uint64", "float16", "dict"])
def test_take_matches_reference(rng, kind):
    """Indices with nulls and out of range (clamped)."""
    col = dict_column(rng, 50, ["x", "y", None]) if kind == "dict" \
        else rand_column(rng, kind, 50)
    idx = at.column(rng.integers(-3, 55, 80), validity=rng.random(80) > 0.2)
    want = ref_take.take(col, idx)
    got = take(port_column(col), port_column(idx))
    assert_columns_equal(got, want)
    assert_columns_equal(take(port_column(col), torch.arange(5)),
                         ref_take.take(col, at.column(np.arange(5))))
    with pytest.raises(ArrowInvalid, match="out of bounds"):
        take(port_column(col), port_column(idx), check_bounds=True)


def test_concat_matches_reference(rng):
    a, b = rand_column(rng, "uint16", 30), rand_column(rng, "uint16", 20,
                                                       nulls=0)
    assert_columns_equal(concat([port_column(a), port_column(b)]),
                         ref_concat.concat([a, b]))
    d = dict_column(rng, 40, ["p", "q"])
    pd = port_column(d)
    assert_columns_equal(concat([pd, pd.slice(3, 10)]),
                         ref_concat.concat([d, d.slice(3, 10)]))
    t = at.Table.from_pydict({"k": a, "v": rand_column(rng, "float32", 30)})
    pt = port_table(t)
    assert_tables_equal(concat_tables([pt, pt.slice(5, 7)]),
                        ref_concat.concat_tables([t, t.slice(5, 7)]))
    with pytest.raises(ArrowTypeError):
        concat([port_column(a), port_column(rand_column(rng, "int16", 3))])
    d2 = dict_column(rng, 4, ["p", "q"])
    assert_columns_equal(concat([pd, port_column(d2)]),
                         ref_concat.concat([d, d2]))
    with pytest.raises(ArrowInvalid):
        concat([])


def test_float_group_sums_matches_reference(rng):
    """NaN, +inf, -inf and both infinities in a group; exact values."""
    contrib = rng.integers(-100, 100, 60) / 4.0
    contrib[[3, 20]] = np.inf
    contrib[[21, 41]] = -np.inf
    contrib[45] = np.nan
    ends = np.array([9, 19, 29, 39, 49, 59])

    def ref_diff(x):
        cs = jnp.cumsum(x)[ends]
        return cs - jnp.concatenate([jnp.zeros(1, cs.dtype), cs[:-1]])

    def diff(x):
        cs = torch.cumsum(x, 0)[torch.from_numpy(ends)]
        return cs - torch.cat([cs.new_zeros(1), cs[:-1]])

    want = np.asarray(ref_float_group_sums(jnp.asarray(contrib), ref_diff))
    got = float_group_sums(torch.from_numpy(contrib), diff).numpy()
    assert (got.view(np.uint64) == want.view(np.uint64)).all()


@pytest.mark.parametrize("op", ["count", "count_all", "sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["int32", "uint16", "float32"])
def test_segment_aggregate_matches_reference(rng, op, dtype):
    """Static group capacity 16 with empty groups (identities)."""
    v = rand_column(rng, dtype, 400, nulls=0)
    if dtype == "float32":
        v = at.column((rng.integers(-800, 800, 400) / 8.0)
                      .astype(np.float32))
    vals = np.asarray(v.values)
    valid = rng.random(400) > 0.3
    gid = rng.integers(0, 12, 400).astype(np.int32)
    want = np.asarray(ref_segment_aggregate(jnp.asarray(vals),
                                            jnp.asarray(valid),
                                            jnp.asarray(gid), 16, op))
    pv = port_column(v)
    got = segment_aggregate(pv.values, torch.from_numpy(valid),
                            torch.from_numpy(gid), 16, op, pv.dtype).numpy()
    got = got.view(want.dtype) if got.dtype.itemsize == want.dtype.itemsize \
        else got
    assert (got == want).all()


@pytest.mark.parametrize("nulls", [0.0, 0.1], ids=["no-nulls", "nulls"])
@pytest.mark.parametrize("key", ["int16", "dict"])
def test_k2_plan_counts_share_slots(rng, monkeypatch, key, nulls):
    """count(v) reads slot 0 (the row count) when v has no validity and
    v's sum slot when it has one: the K2 call holds one sum slot fewer
    than a slot per count would, and the outputs equal the
    reference's."""
    n = 2000
    k = dict_column(rng, n, [f"w{i}" for i in range(30)]) if key == "dict" \
        else rand_column(rng, key, n, small=True)
    t = at.Table.from_pydict({"k": k,
                              "v": rand_column(rng, "int64", n, nulls=nulls)})
    ops = ["count", "sum", "min", "max", "count_all", "mean"]
    seen = []
    real = gb.grouped_aggregate

    def spy(codes, G, sum_cols=(), mm_cols=(), *args, **kw):
        seen.append(len(sum_cols))
        return real(codes, G, sum_cols, mm_cols, *args, **kw)

    monkeypatch.setattr(gb, "grouped_aggregate", spy)
    got = group_by(port_table(t), ["k"], [AggSpec("v", op) for op in ops])
    assert seen == [2]          # rows, sum(v); no count-only slot
    assert_tables_equal(got, ref_group_by(t, ["k"], [RefAggSpec("v", op)
                                                     for op in ops]))


# ---- on the card -------------------------------------------------------------

def test_small_domain_plan_on_cuda_launches_k2(cuda_device, rng):
    """Config 4's 1K shape at 300K rows: one K2 launch, no K1, and the
    card's output equals the CPU's."""
    n = 300_000
    t = at.Table.from_pydict({"k": at.column(rng.integers(0, 1000, n)),
                              "v": rand_column(rng, "int64", n)})
    aggs = [AggSpec("v", op) for op in ("sum", "count", "min", "max",
                                        "count_all", "mean")]
    k0, g0 = kc.compact.launches, kg.grouped_aggregate.launches
    got = group_by(port_table(t, cuda_device), ["k"], aggs)
    assert (kc.compact.launches, kg.grouped_aggregate.launches) == \
        (k0, g0 + 1)
    assert_tables_equal(got, group_by(port_table(t), ["k"], aggs))


@pytest.mark.parametrize("groups", [700, 50_000])
def test_sort_plan_on_cuda_launches_k1(cuda_device, rng, groups):
    """Wide int64 keys: one K1 launch at the run starts; with at most
    G_MAX groups, one K2 launch for the integer min/max; float columns
    ride the secondary sort.  The card's output equals the CPU's."""
    n = 300_000
    keys = rng.integers(-2 ** 62, 2 ** 62, groups)[rng.integers(0, groups, n)]
    t = at.Table.from_pydict({"k": at.column(keys),
                              "v": rand_column(rng, "int32", n),
                              "w": rand_column(rng, "float32", n)})
    aggs = [AggSpec(c, op) for c in ("v", "w")
            for op in ("sum", "count", "min", "max", "count_all", "mean")]
    k0, g0 = kc.compact.launches, kg.grouped_aggregate.launches
    got = group_by(port_table(t, cuda_device), ["k"], aggs)
    assert kc.compact.launches == k0 + 1
    assert kg.grouped_aggregate.launches == g0 + (groups <= kg.G_MAX)
    assert_tables_equal(got, group_by(port_table(t), ["k"], aggs))


def test_k2_splits_slots_across_launches(cuda_device, rng):
    """20 min/max slots over 1,024 groups exceed one block's shared
    memory (14 slots): two launches, equal to the plain version."""
    n = 100_000
    codes = torch.from_numpy(rng.integers(0, 1024, n).astype(np.int32))
    cols = [torch.from_numpy(rng.integers(-1000, 1000, n)) for _ in range(20)]
    want = kg.grouped_aggregate_plain(
        codes, 1024, mm_cols=[kg.MinMaxCol(c) for c in cols])
    g0 = kg.grouped_aggregate.launches
    got = kg.grouped_aggregate(
        codes.to(cuda_device), 1024,
        mm_cols=[kg.MinMaxCol(c.to(cuda_device)) for c in cols],
        decode=False)
    assert kg.grouped_aggregate.launches == g0 + 2
    for (a0, a1), (b0, b1) in zip(got[2], want[2]):
        assert torch.equal(a0.cpu(), b0) and torch.equal(a1.cpu(), b1)


def test_accumulator_on_cuda_matches_cpu(cuda_device, rng):
    n = 200_000
    t = at.Table.from_pydict({"k": at.column(rng.integers(0, 40_000, n)),
                              "v": rand_column(rng, "int64", n)})
    aggs = [AggSpec("v", op) for op in ("sum", "count", "min", "max",
                                        "mean")]
    out = []
    for dev in (cuda_device, "cpu"):
        acc = GroupByAccumulator(["k"], aggs)
        pt = port_table(t, dev)
        for lo in range(0, n, 50_000):
            acc.update(pt.slice(lo, 50_000))
        out.append(acc.finalize())
    assert_tables_equal(*out)
