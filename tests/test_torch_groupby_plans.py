"""arrow_tpu_torch group_by against the reference, on inputs that reach
each of the reference's plans, on both reference routes (the `route`
fixture).  The port has three plans of its own (dictionary and
small-domain on K2, the sort plan on K1); each test names the port plan
its input takes.

Tolerance: keys, counts, integer sums, min and max are bitwise under
`_py_equal`; float sums are bitwise too, because rand_values' floats are
multiples of 1/8 whose sums are exact in any order, except in
test_inexact_float_sums_within_the_reference_bound."""

import numpy as np
import pytest

import arrow_tpu as at
import jax.numpy as jnp
from arrow_tpu.ops.groupby import AggSpec as RefAggSpec
from arrow_tpu.ops.groupby import group_by as ref_group_by
from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
from arrow_tpu_torch.ops.groupby import AggSpec, group_by

from torch_port_util import (assert_tables_equal, port_table,  # noqa: F401
                             rand_column, route)

N = 2048
ALL = ["sum", "count", "min", "max", "count_all", "mean"]
INTS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
        "uint64"]


def check(ref_t, keys, aggs):
    """The port's group_by equals the reference's on the same table."""
    want = ref_group_by(ref_t, keys, [RefAggSpec(*a) for a in aggs])
    got = group_by(port_table(ref_t), keys, [AggSpec(*a) for a in aggs])
    assert_tables_equal(got, want)
    return got


def on(col, ops):
    return [(col, op) for op in ops]


@pytest.mark.parametrize("key_dtype", INTS + ["bool"])
def test_small_integer_range_matches_perfect_binning(rng, route, key_dtype):
    """Reference: perfect binning.  Port: the small-domain plan (one K2
    pass; 40 key values + null)."""
    t = at.Table.from_pydict({"k": rand_column(rng, key_dtype, N, small=True),
                              "v": rand_column(rng, "int64", N)})
    k0, g0 = kc.compact.launches, kg.grouped_aggregate.launches
    got = check(t, ["k"], on("v", ALL))
    assert got.num_rows == (3 if key_dtype == "bool" else 41)
    assert (kc.compact.launches, kg.grouped_aggregate.launches) == (k0, g0)


@pytest.mark.parametrize("case", ["uint64-top", "uint64-across-2^63",
                                  "int64-extremes", "int8-full"])
def test_integer_keys_at_the_type_edges(rng, route, case):
    """Key ranges at the edges of their types: the rebase by the range
    scan's minimum and the decode of the output keys hold there.  The
    first three take the small-domain plan; int8-full (256 keys, and
    f64 sums K2 does not cover) the sort plan."""
    n = N
    if case == "uint64-top":
        k = np.uint64(2 ** 64 - 1) - rng.integers(0, 30, n).astype(np.uint64)
    elif case == "uint64-across-2^63":
        k = np.uint64(2 ** 63 - 15) + rng.integers(0, 30, n).astype(np.uint64)
    elif case == "int64-extremes":
        k = np.where(rng.random(n) < 0.5, -2 ** 63, 2 ** 63 - 1)
    else:
        k = rng.integers(-128, 128, n).astype(np.int8)
    t = at.Table.from_pydict({"k": at.column(k, validity=rng.random(n) > 0.1),
                              "v": rand_column(rng, "uint64", n),
                              "w": rand_column(rng, "float64", n)})
    aggs = on("v", ALL) + (on("w", ["sum", "min", "max"])
                           if case == "int8-full" else [])
    check(t, ["k"], aggs)


@pytest.mark.parametrize("key_dtype", ["int32", "int64", "uint32", "uint64"])
def test_wide_integer_range_matches_packed_sort(rng, route, key_dtype):
    """Reference: the packed-sort plan (its K1 stage on route 1).  Port:
    the sort plan; keys span the type's range, so most rows are their
    own group, and a few repeat."""
    k = rand_column(rng, key_dtype, N)
    keys = np.array(k.values)
    keys[::5] = keys[7]
    t = at.Table.from_pydict({"k": at.column(keys, validity=k.validity),
                              "v": rand_column(rng, "int32", N)})
    check(t, ["k"], on("v", ALL))


@pytest.mark.parametrize("key_dtype", ["float16", "float32", "float64"])
def test_float_keys_match_general_discovery(rng, route, key_dtype):
    """Reference: general discovery.  Keys hold NaN, -0.0 and +0.0 (one
    group each for NaN and zero, represented by the first row's bits),
    and 10% nulls.  Port: the sort plan."""
    t = at.Table.from_pydict({"k": rand_column(rng, key_dtype, N, small=True),
                              "v": rand_column(rng, "int16", N),
                              "w": rand_column(rng, "float32", N)})
    got = check(t, ["k"], on("v", ALL) + on("w", ["sum", "min", "max"]))
    keys = got.column("k").to_pylist()
    assert keys[0] is None and np.isnan(keys[-1])


def test_float_key_group_takes_its_first_rows_bits(route):
    """-0.0 and +0.0 are one group, as are NaNs of any payload; the
    output key carries the bits of the group's first row."""
    nan2 = np.array([0x7FF8000000000001], np.uint64).view(np.float64)[0]
    k = np.array([-0.0, 1.0, 0.0, nan2, np.nan, -0.0])
    t = at.Table.from_pydict({"k": at.column(k),
                              "v": at.column(np.arange(6))})
    got = check(t, ["k"], on("v", ["sum", "count_all"]))
    assert np.asarray(got.column("k").to_numpy()).view(np.uint64).tolist() \
        == [1 << 63, 0x3FF0000000000000, 0x7FF8000000000001]


@pytest.mark.parametrize("case", ["int-float", "dict-int", "bool-uint8"])
def test_two_keys_match_general_discovery(rng, route, case):
    """Two key columns, the first most significant.  int-float and
    dict-int reach the reference's general discovery; bool-uint8 its
    perfect binning.  Port: the sort plan, the sort plan and the
    small-domain plan."""
    if case == "int-float":
        a = rand_column(rng, "int32", N, small=True)
        b = rand_column(rng, "float64", N, small=True)
    elif case == "dict-int":
        a = at.DictionaryColumn(jnp.asarray(rng.integers(0, 30, N)
                                            .astype(np.int32)),
                                at.column([f"w{i:02d}" for i in
                                           rng.permutation(30)]),
                                jnp.asarray(rng.random(N) > 0.1))
        b = rand_column(rng, "int64", N, small=True)
    else:
        a = rand_column(rng, "bool", N)
        b = rand_column(rng, "uint8", N, small=True)
    t = at.Table.from_pydict({"a": a, "b": b,
                              "v": rand_column(rng, "int64", N)})
    check(t, ["a", "b"], on("v", ALL))


def test_dictionary_key_beyond_g_max(rng, route):
    """A 1,500-value dictionary: past the dictionary plan, the
    reference's general discovery; the port's sort plan."""
    words = [f"w{i:04d}" for i in rng.permutation(1500)]
    key = at.DictionaryColumn(jnp.asarray(rng.integers(0, 1500, N)
                                          .astype(np.int32)),
                              at.column(words),
                              jnp.asarray(rng.random(N) > 0.1))
    t = at.Table.from_pydict({"k": key, "v": rand_column(rng, "uint16", N)})
    check(t, ["k"], on("v", ALL))


@pytest.mark.parametrize("values", [["b", None, "a", "c"],
                                    ["b", "a", "b", "c"],
                                    [None, "a", "a", None]],
                         ids=["null", "repeated", "both"])
def test_dictionary_with_null_or_repeated_values(rng, route, values):
    """Dictionaries with null or repeated values leave the dictionary
    plan (groupby.py:486-501): codes of a null value are null keys,
    repeated values are one group represented by the first row's code."""
    key = at.DictionaryColumn(jnp.asarray(rng.integers(0, 4, N)
                                          .astype(np.int32)),
                              at.column(values),
                              jnp.asarray(rng.random(N) > 0.1))
    t = at.Table.from_pydict({"k": key, "v": rand_column(rng, "int8", N)})
    check(t, ["k"], on("v", ALL))


@pytest.mark.parametrize("case", ["string-key", "string-min",
                                  "dictionary-max"])
def test_group_by_still_raises_naming_a7(case):
    """String keys and min/max over strings or dictionaries, once ROADMAP
    A7 named, now match the reference (_group_by_string_minmax,
    groupby.py:2131)."""
    words = at.StringColumn.from_pylist(["x", "y", "x"])
    if case == "string-key":
        t = at.Table.from_pydict({"k": words, "v": [1, 2, 3]})
        aggs = [("v", "sum")]
    elif case == "string-min":
        t = at.Table.from_pydict({"k": [1, 1, 2], "s": words})
        aggs = [("s", "min")]
    else:
        t = at.Table.from_pydict({"k": [1, 1, 2], "s": at.DictionaryColumn(
            jnp.asarray(np.array([0, 1, 0], np.int32)),
            at.StringColumn.from_pylist(["p", "q"]))})
        aggs = [("s", "max")]
    check(t, ["k"], aggs)
