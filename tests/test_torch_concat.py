"""concat, concat_tables, interleave and interleave_tables of the port
(arrow_tpu_torch/ops/concat.py) against the JAX package on the CPU:
null, primitive, string and dictionary columns; dictionaries that share
one values object, that differ (codes shifted into the concatenated
values, repeated values kept, the ordered flag dropped) and that pass
the index type's range (the value-dedup merge); and GroupByAccumulator
over dictionary-keyed chunks built separately, whose merge concatenates
differing dictionaries.

Every comparison is bitwise: values (a string's offsets and bytes),
validity, dtype and its ordered flag, and row order.  No tolerance is
needed: the accumulator's sums are of integers.  Inputs come from a
seed through numpy, on both reference routes (the `route` fixture, the
reference's Pallas kernels interpreted, n <= 4,096).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.ops.groupby import AggSpec as RefAggSpec
from arrow_tpu.ops.groupby import GroupByAccumulator as RefAccumulator
from arrow_tpu.ops.groupby import group_by as ref_group_by
from arrow_tpu_torch.core.column import NullColumn, StringColumn
from arrow_tpu_torch.errors import ArrowInvalid, ArrowTypeError
from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
from arrow_tpu_torch.ops.concat import (concat, concat_tables, interleave,
                                        interleave_tables)
from arrow_tpu_torch.ops.groupby import AggSpec, GroupByAccumulator, group_by
from torch_port_util import (assert_columns_equal, assert_tables_equal,
                             cuda_device, port_column, port_table,  # noqa
                             rand_column, route, storage_list)

rconcat = importlib.import_module("arrow_tpu.ops.concat")
rdt = at.dtypes
WORDS = ["", "a", "a\x00", "é", "日本", "word-0042", "zz"]


def strings(rng, n, nulls=0.2, pool=WORDS):
    pick = rng.integers(0, len(pool), n)
    return at.column([None if z else pool[i] for i, z in
                      zip(pick, rng.random(n) < nulls)], rdt.utf8)


def dictionary(rng, n, values, index=np.int32, nulls=0.1, ordered=False):
    return at.DictionaryColumn(
        jnp.asarray(rng.integers(0, max(len(values), 1), n).astype(index)),
        at.column(values) if values else at.StringColumn.from_pylist([]),
        jnp.asarray(rng.random(n) >= nulls), ordered=ordered)


def check(cols, strings_too=False):
    """concat of the port's columns equals the reference's."""
    got = concat([port_column(c) for c in cols])
    want = rconcat.concat(cols)
    assert_columns_equal(got, want, masks=True)
    if strings_too:
        np.testing.assert_array_equal(got.offsets.numpy(),
                                      np.asarray(want.offsets))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    return got


# ---- layouts -----------------------------------------------------------------

def test_null_columns():
    got = check([at.NullColumn(3), at.NullColumn(0), at.NullColumn(4)])
    assert isinstance(got, NullColumn) and len(got) == 7


@pytest.mark.parametrize("sizes", [(5, 7), (0, 6, 0), (30, 1, 12, 9)])
def test_string_columns(rng, sizes):
    """Offsets shift by the bytes before them; empty strings, non-ASCII
    and empty columns included."""
    check([strings(rng, n) for n in sizes], strings_too=True)


def test_sliced_and_unmasked_string_columns(rng):
    a, b = strings(rng, 40), strings(rng, 30, nulls=0.0)
    check([a.slice(7, 20), b, a.slice(0, 0), b.slice(29, 1)],
          strings_too=True)


@pytest.mark.parametrize("dtype", ["int8", "uint64", "float16", "bool"])
def test_primitive_columns(rng, dtype):
    check([rand_column(rng, dtype, 20), rand_column(rng, dtype, 9, nulls=0)])


def test_type_mismatch_and_no_columns(rng):
    with pytest.raises(ArrowTypeError):
        concat([port_column(strings(rng, 3)),
                port_column(rand_column(rng, "int8", 3))])
    with pytest.raises(ArrowTypeError):            # ordered is in the type
        concat([port_column(dictionary(rng, 3, ["a"], ordered=True)),
                port_column(dictionary(rng, 3, ["a"]))])
    with pytest.raises(ArrowInvalid):
        concat([])


# ---- dictionaries ------------------------------------------------------------

def test_shared_dictionary_keeps_its_values_and_order(rng):
    d = port_column(dictionary(rng, 30, ["b", "a", "c"], ordered=True))
    got = concat([d, d.slice(4, 10)])
    assert got.values is d.values and got.dtype.ordered


@pytest.mark.parametrize("index", [np.int8, np.int16, np.int32, np.uint8,
                                   np.uint16])
def test_dictionaries_that_differ_shift_their_codes(rng, index):
    """Separately built dictionaries: values concatenated (a value in two
    of them appears twice), codes shifted, ordered dropped."""
    cols = [dictionary(rng, 25, ["x", "y", "é"], index, ordered=True),
            dictionary(rng, 10, ["y", "", None], index, ordered=True),
            dictionary(rng, 15, ["x", "q"], index, ordered=True)]
    got = check(cols)
    assert got.values.to_pylist() == ["x", "y", "é", "y", "", None,
                                      "x", "q"]
    assert not got.dtype.ordered


@pytest.mark.parametrize("values", [
    lambda i: [f"w{j:03d}" for j in range(20 * i, 20 * i + 60)] + ["", "é"],
    lambda i: [f"w{j:03d}" for j in range(60)] + [None, "é"] * (i + 1),
], ids=["overlapping", "repeated-and-null"])
def test_dictionaries_past_the_index_range_merge(rng, values):
    """Three int8-coded dictionaries of 60-72 values each pass 127: the
    merge deduplicates the values in first-occurrence order and remaps
    the codes (merge_dictionary_values)."""
    cols = [dictionary(rng, 40, values(i), np.int8) for i in range(3)]
    got = check(cols)
    assert got.codes.dtype == torch.int8
    assert len(got.values) <= 128


def test_primitive_dictionaries_merge(rng):
    """A value-dedup over int64 values (a null among them) past int8."""
    cols = [dictionary(rng, 30, list(range(i * 30, i * 30 + 90)) + [None],
                       np.int8) for i in range(2)]
    check(cols)


def test_merge_that_still_overflows_raises(rng):
    cols = [port_column(dictionary(rng, 5, [f"v{i}-{j}" for j in range(100)],
                                   np.int8)) for i in range(2)]
    with pytest.raises(ArrowInvalid, match="overflow"):
        concat(cols)


def test_empty_dictionaries(rng):
    check([dictionary(rng, 0, [], nulls=0), dictionary(rng, 4, ["a"])])


# ---- tables and interleave ---------------------------------------------------

def table(rng, n, words=("x", "y")):
    return at.Table.from_pydict({
        "i": rand_column(rng, "int32", n), "s": strings(rng, n),
        "d": dictionary(rng, n, list(words)), "z": at.NullColumn(n)})


def test_concat_tables(rng):
    ts = [table(rng, 12), table(rng, 0), table(rng, 7, ("y", "é"))]
    assert_tables_equal(concat_tables([port_table(t) for t in ts]),
                        rconcat.concat_tables(ts))


def test_interleave_tables(rng):
    ts = [table(rng, 10), table(rng, 6, ("q",))]
    pairs = [(int(a), int(rng.integers(0, (10, 6)[a])))
             for a in rng.integers(0, 2, 25)]
    assert_tables_equal(interleave_tables([port_table(t) for t in ts], pairs),
                        rconcat.interleave_tables(ts, pairs))


@pytest.mark.parametrize("layout", ["int", "string", "dictionary", "null"])
def test_interleave(rng, layout):
    make = {"int": lambda n: rand_column(rng, "int64", n),
            "string": lambda n: strings(rng, n),
            "dictionary": lambda n: dictionary(rng, n, ["a", "b"]),
            "null": lambda n: at.NullColumn(n)}[layout]
    cols = [make(8), make(3), make(5)]
    pairs = [(2, 4), (0, 0), (1, 2), (0, 7), (2, 0)]
    assert_columns_equal(interleave([port_column(c) for c in cols], pairs),
                         rconcat.interleave(cols, pairs), masks=True)
    assert_columns_equal(interleave([port_column(cols[0])], []),
                         rconcat.interleave([cols[0]], []))


# ---- GroupByAccumulator over separately built dictionaries -----------------

CHUNK_AGGS = [("v", "sum"), ("v", "count"), ("v", "mean"), ("v", "min"),
              ("v", "max"), ("v", "count_all")]


def dict_chunk(rng, n, words, seed):
    """A chunk whose key dictionary is its own permutation of `words`, so
    the same word has another code in every chunk."""
    perm = np.random.default_rng(seed).permutation(len(words))
    wid = rng.integers(0, len(words), n)
    inv = np.argsort(perm)
    key = at.DictionaryColumn(jnp.asarray(inv[wid].astype(np.int32)),
                              at.column([words[j] for j in perm]))
    return at.Table.from_pydict({"k": key, "v": at.column(
        rng.integers(-100, 100, n).astype(np.int32),
        validity=rng.random(n) > 0.1)})


@pytest.mark.parametrize("compact_rows", [10 ** 9, 30])
def test_accumulator_over_separately_built_dictionaries(rng, route,
                                                        compact_rows):
    """Three chunks, each with its own dictionary: the merge concatenates
    partials whose dictionaries differ (and re-merges them on the way
    when COMPACT_ROWS is low); the result is the reference
    accumulator's."""
    words = ["a", "é", "", "word-0042", "zz", "b"]
    chunks = [dict_chunk(rng, 400, words, s) for s in range(3)]
    ref_acc = RefAccumulator(["k"], [RefAggSpec(*a) for a in CHUNK_AGGS])
    acc = GroupByAccumulator(["k"], [AggSpec(*a) for a in CHUNK_AGGS])
    ref_acc.COMPACT_ROWS = acc.COMPACT_ROWS = compact_rows
    for c in chunks:
        ref_acc.update(c)
        acc.update(port_table(c))
    assert_tables_equal(acc.finalize(), ref_acc.finalize())


def test_accumulator_string_min_max_follows_one_group_by(rng):
    """ROADMAP C8: the reference's finalize reads `.values` of the string
    min/max column and raises AttributeError; the port's returns what one
    group_by over the concatenated chunks gives."""
    words = ["a", "é", "", "word-0042", "zz", "b"]
    chunks = []
    for s in range(3):
        t = dict_chunk(rng, 300, words, s)
        sv = dict_chunk(rng, 300, ["p", "q", "r\x00", "日本"], 10 + s)
        chunks.append(at.Table.from_pydict({"k": t.column("k"),
                                            "v": t.column("v"),
                                            "s": sv.column("k")}))
    aggs = [("s", "min"), ("s", "max"), ("v", "sum"), ("v", "count_all")]
    ref_acc = RefAccumulator(["k"], [RefAggSpec(*a) for a in aggs])
    acc = GroupByAccumulator(["k"], [AggSpec(*a) for a in aggs])
    for c in chunks:
        ref_acc.update(c)
        acc.update(port_table(c))
    with pytest.raises(AttributeError):
        ref_acc.finalize()
    whole = rconcat.concat_tables(chunks)
    assert_tables_equal(acc.finalize(), ref_group_by(
        whole, ["k"], [RefAggSpec(*a) for a in aggs]))


def test_string_min_max_partials_merge(rng):
    """The partials' string min/max columns concatenate and re-aggregate
    (a partial merge) to the single group_by's result."""
    words = ["a", "b", "c"]
    chunks = [dict_chunk(rng, 200, words, s) for s in range(4)]
    port = [port_table(at.Table.from_pydict(
        {"k": c.column("k"), "s": strings(rng, 200)})) for c in chunks]
    aggs = [AggSpec("s", "min"), AggSpec("s", "max")]
    acc = GroupByAccumulator(["k"], aggs)
    acc.COMPACT_ROWS = 2
    for t in port:
        acc.update(t)
    got = acc.finalize()
    assert isinstance(got.column("s_min"), StringColumn)
    assert got.to_pydict() == group_by(concat_tables(port), ["k"],
                                       aggs).to_pydict()


# ---- on the card ---------------------------------------------------------------

def test_cuda_concat_matches_the_cpu_route(cuda_device, rng):
    """Strings, differing dictionaries (shifted and merged), nulls and the
    accumulator over separately built chunks on the card."""
    cols = [strings(rng, 50), strings(rng, 0), strings(rng, 9)]
    g = concat([port_column(c, cuda_device) for c in cols])
    c = concat([port_column(c) for c in cols])
    assert g.offsets.device.type == "cuda"
    assert torch.equal(g.offsets.cpu(), c.offsets)
    assert torch.equal(g.data.cpu(), c.data)
    for index, size in ((np.int32, 5), (np.int8, 90)):
        ds = [dictionary(rng, 30, [f"v{(j + 20 * i) % 70}"
                                   for j in range(size)], index)
              for i in range(2)]
        assert concat([port_column(d, cuda_device) for d in ds]) \
            .to_pylist() == concat([port_column(d) for d in ds]).to_pylist()
    chunks = [dict_chunk(rng, 3000, ["a", "é", "", "zz"], s)
              for s in range(3)]
    specs = [AggSpec(*a) for a in CHUNK_AGGS]
    acc_g, acc_c = GroupByAccumulator(["k"], specs), \
        GroupByAccumulator(["k"], specs)
    before = kg.grouped_aggregate.launches
    for ch in chunks:
        acc_g.update(port_table(ch, cuda_device))
        acc_c.update(port_table(ch))
    out_g = acc_g.finalize()
    assert kg.grouped_aggregate.launches > before
    assert kc.compact.launches >= 0
    assert out_g.to_pydict() == acc_c.finalize().to_pydict()
    assert storage_list(out_g.column("v_sum")) == \
        storage_list(acc_c.finalize().column("v_sum"))
