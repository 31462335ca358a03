"""arrow_tpu_torch group_by against the reference over value columns of
every type, special float values, nulls and degenerate shapes, on both
reference routes.

Tolerance: bitwise under `_py_equal` (rand_values' floats are multiples
of 1/8, so float sums are exact in any order), except where a test says
otherwise and why."""

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu.ops.groupby import AggSpec as RefAggSpec
from arrow_tpu.ops.groupby import group_by as ref_group_by
from arrow_tpu_torch.ops.groupby import AggSpec, group_by

from torch_port_util import (assert_same, assert_tables_equal,  # noqa: F401
                             port_table, rand_column, route)

N = 1024
ALL = ["sum", "count", "min", "max", "count_all", "mean"]
TYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
         "uint64", "bool", "float16", "float32", "float64"]


def both(ref_t, keys, aggs):
    """(port output, reference output) on the same table."""
    want = ref_group_by(ref_t, keys, [RefAggSpec(*a) for a in aggs])
    got = group_by(port_table(ref_t), keys, [AggSpec(*a) for a in aggs])
    return got, want


def key_column(rng, shape, n):
    """'small': 40 values + 10% nulls (K2 plans where the aggregates
    allow); 'wide': int64 over its whole range, pairs of rows sharing a
    key (the sort plan)."""
    if shape == "small":
        return rand_column(rng, "int32", n, small=True)
    k = rng.integers(-2 ** 63, 2 ** 63 - 1, n // 2 + 1)
    return at.column(np.repeat(k, 2)[:n])


@pytest.mark.parametrize("shape", ["small", "wide"])
@pytest.mark.parametrize("value_dtype", TYPES)
def test_every_value_type(rng, route, value_dtype, shape):
    """All six aggregates over values of one type with 10% nulls; floats
    carry NaN, +inf, -inf and -0.0."""
    t = at.Table.from_pydict({"k": key_column(rng, shape, N),
                              "v": rand_column(rng, value_dtype, N)})
    got, want = both(t, ["k"], [("v", op) for op in ALL])
    assert_tables_equal(got, want)


@pytest.mark.parametrize("value_dtype", ["int32", "uint64", "float32",
                                         "float64"])
def test_all_null_value_column(rng, route, value_dtype):
    """Every value null: sum, min, max and mean are null in every group,
    count is 0."""
    v = rand_column(rng, value_dtype, N, nulls=1.0)
    t = at.Table.from_pydict({"k": key_column(rng, "small", N), "v": v})
    got, want = both(t, ["k"], [("v", op) for op in ALL])
    assert_tables_equal(got, want)
    assert set(got.column("v_sum").to_pylist()) == {None}


@pytest.mark.parametrize("case", ["one-row", "one-group", "all-distinct"])
def test_degenerate_group_shapes(rng, route, case):
    n = 1 if case == "one-row" else 500
    if case == "all-distinct":
        k = at.column(rng.permutation(n).astype(np.float32))
    else:
        k = at.column(np.full(n, 7, np.int16))
    t = at.Table.from_pydict({"k": k, "v": rand_column(rng, "int64", n),
                              "w": rand_column(rng, "float64", n)})
    got, want = both(t, ["k"], [("v", op) for op in ALL]
                     + [("w", op) for op in ALL])
    assert_tables_equal(got, want)
    assert got.num_rows == (n if case == "all-distinct" else 1)


@pytest.mark.parametrize("key", ["int", "float"])
def test_mean_of_int8_divides_the_wide_sum(route, key):
    """mean of int8 [100, 100] is 100.0, not the wrapped -28.0
    (groupby.py:2583-2590), on the small-domain and the sort plan."""
    k = [1, 1] if key == "int" else [1.5, 1.5]
    t = at.Table.from_pydict({"k": at.column(k),
                              "v": at.column(np.array([100, 100], np.int8))})
    got, want = both(t, ["k"], [("v", "mean"), ("v", "sum")])
    assert_tables_equal(got, want)
    assert got.to_pydict() == {"k": k[:1], "v_mean": [100.0], "v_sum": [-56]}


def test_inexact_float_sums_within_the_reference_bound(rng, route):
    """Random positive f64 values: the group sums are differences of
    prefix sums, and the reference's scan adds in another order than
    torch.cumsum, so the last bits may differ.  They are held within
    rtol 1e-12, the reference's own bound for this plan
    (groupby.py:2572-2576); every other column stays bitwise."""
    v = rng.uniform(0, 1000, N)
    t = at.Table.from_pydict({"k": key_column(rng, "small", N),
                              "v": at.column(v)})
    aggs = [("v", op) for op in ("sum", "mean", "min", "max", "count")]
    got, want = both(t, ["k"], aggs)
    for name in ("k", "v_min", "v_max", "v_count"):
        assert_same(got.column(name).to_pylist(),
                    want.column(name).to_pylist(), name)
    for name in ("v_sum", "v_mean"):
        g = np.array(got.column(name).to_pylist(), dtype=float)
        w = np.array(want.column(name).to_pylist(), dtype=float)
        np.testing.assert_allclose(g, w, rtol=1e-12)


def test_min_max_of_tied_zeros(route):
    """A group whose extreme value is both -0.0 and +0.0: the reference
    returns either sign (its value sort orders the two as equal and is
    not stable), the port the IEEE total order's (-0.0 for min, +0.0 for
    max).  Held by value, and the port's signs pinned."""
    v = np.array([0.0, -0.0, 1.0, -0.0, 0.0, 2.0] * 40, np.float32)
    t = at.Table.from_pydict({"k": at.column(np.repeat([1, 2], 120)),
                              "v": at.column(-v)})
    got, want = both(t, ["k"], [("v", "max"), ("v", "min")])
    assert got.to_pydict() == want.to_pydict()
    assert np.signbit(got.column("v_max").to_numpy()).tolist() == [False] * 2
