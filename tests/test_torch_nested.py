"""The nested, decimal and interval layouts of the port
(arrow_tpu_torch/core/nested.py, ListColumn and StructColumn of
core/column.py) through take, filter, filter_table, concat, slice and
to_pylist, run_end_encode / run_end_decode, union_extract, the builders,
validate, pool, Tensor, typeparse and the nested dtypes, against the JAX
package on the CPU.

Inputs are pyarrow arrays made from a seed with numpy (nulls at both
levels: null rows and null child values), read by the reference
(`at.column`) and carried into the port buffer for buffer
(`port_column`).  Every comparison is bitwise (`assert_layouts_equal`):
the type, each buffer's bits (offsets with their dtype, values, decimal
limbs, union type ids, run ends, every validity) and to_pylist.  No
tolerance.  The reference's filter_table compacts on both of its routes
(the `route` fixture: its Pallas kernel interpreted, n <= 4,096).
"""

import decimal
import importlib

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu_torch import dtypes as pdt
from arrow_tpu_torch.core import builders as pbuild, nested as pn
from arrow_tpu_torch.core import pool as ppool, validate as pval
from arrow_tpu_torch.core.column import ListColumn
from arrow_tpu_torch.core.tensor import Tensor
from arrow_tpu_torch.errors import (ArrowInvalid, ArrowTypeError,
                                    SchemaError)
from arrow_tpu_torch.kernels import compact as kc
from arrow_tpu_torch.ops import concat as pconcat, filter as pfilter
from arrow_tpu_torch.ops import ree as pree, select_misc as psel
from arrow_tpu_torch.ops import take as ptake
from arrow_tpu_torch.typeparse import parse_data_type
from torch_port_util import (assert_layouts_equal, buffers,  # noqa: F401
                             cuda_device, port_column, port_dtype,
                             port_field, port_table, route)

rtake = importlib.import_module("arrow_tpu.ops.take")
rfilter = importlib.import_module("arrow_tpu.ops.filter")
rconcat = importlib.import_module("arrow_tpu.ops.concat")
rree = importlib.import_module("arrow_tpu.ops.ree")
rsel = importlib.import_module("arrow_tpu.ops.select_misc")
rdt = at.dtypes
N = 97
WORDS = ["", "a", "é", "日本", "word-0042", "zz"]


def _null(rng, x, share=0.15):
    return None if rng.random() < share else x


def pa_layout(kind: str, rng, n: int) -> pa.Array:
    """A pyarrow array of `kind` with n rows from `rng`, nulls at the
    row level and (where the layout has one) in the child."""
    def ints(k, lo=-1000, hi=1000):
        return [_null(rng, int(x)) for x in rng.integers(lo, hi, k)]
    if kind in ("list", "large_list", "list_view", "large_list_view"):
        rows = [_null(rng, ints(int(rng.integers(0, 6))), 0.1)
                for _ in range(n)]
        t = {"list": pa.list_, "large_list": pa.large_list,
             "list_view": pa.list_view,
             "large_list_view": pa.large_list_view}[kind](pa.int64())
        return pa.array(rows, t)
    if kind == "large_list_utf8":
        rows = [_null(rng, [_null(rng, WORDS[i]) for i in
                            rng.integers(0, len(WORDS), rng.integers(0, 4))],
                      0.1) for _ in range(n)]
        return pa.array(rows, pa.large_list(pa.utf8()))
    if kind == "list_list":
        rows = [_null(rng, [_null(rng, ints(int(rng.integers(0, 3))))
                            for _ in range(rng.integers(0, 3))], 0.1)
                for _ in range(n)]
        return pa.array(rows, pa.list_(pa.list_(pa.int32())))
    if kind == "struct":
        i32 = pa.array(ints(n), pa.int32())
        codes = pa.array([_null(rng, int(i)) for i in
                          rng.integers(0, len(WORDS), n)], pa.int32())
        words = pa.DictionaryArray.from_arrays(codes, pa.array(WORDS))
        mask = pa.array(rng.random(n) < 0.1)
        return pa.StructArray.from_arrays([i32, words], ["i", "w"],
                                          mask=mask)
    if kind == "map":
        rows = [_null(rng, [(WORDS[i], _null(rng, int(i) * 7))
                            for i in rng.integers(0, len(WORDS),
                                                  rng.integers(0, 4))], 0.1)
                for _ in range(n)]
        return pa.array(rows, pa.map_(pa.utf8(), pa.int64()))
    if kind == "fsl":
        rows = [_null(rng, [_null(rng, float(x)) for x in
                            rng.integers(-40, 40, 4) / 4], 0.1)
                for _ in range(n)]
        return pa.array(rows, pa.list_(pa.float32(), 4))
    if kind == "fsb":
        return pa.array([_null(rng, rng.bytes(16)) for _ in range(n)],
                        pa.binary(16))
    if kind in ("decimal32", "decimal64", "decimal128", "decimal256"):
        p, s = {"decimal32": (7, 2), "decimal64": (15, 3),
                "decimal128": (15, 2), "decimal256": (40, 5)}[kind]
        hi = 10 ** min(p, 18) - 1
        vals = [_null(rng, decimal.Decimal(int(x)).scaleb(-s))
                for x in rng.integers(-hi, hi, n)]
        return pa.array(vals, getattr(pa, kind)(p, s))
    if kind == "interval_mdn":
        return pa.array([_null(rng, pa.MonthDayNano([
            int(rng.integers(-30, 30)), int(rng.integers(-400, 400)),
            int(rng.integers(-10 ** 15, 10 ** 15))])) for _ in range(n)],
            pa.month_day_nano_interval())
    if kind == "sparse_union":
        tids = pa.array(rng.integers(0, 2, n).astype(np.int8))
        return pa.UnionArray.from_sparse(tids, [
            pa.array(ints(n), pa.int64()),
            pa.array([_null(rng, float(x)) for x in rng.random(n)])],
            ["i", "f"])
    if kind == "dense_union":
        tid = rng.integers(0, 2, n).astype(np.int8)
        offs = np.zeros(n, np.int32)
        for t in (0, 1):
            offs[tid == t] = np.arange((tid == t).sum())
        return pa.UnionArray.from_dense(
            pa.array(tid), pa.array(offs),
            [pa.array(ints(int((tid == 0).sum())), pa.int64()),
             pa.array([_null(rng, WORDS[i]) for i in rng.integers(
                 0, len(WORDS), int((tid == 1).sum()))])], ["i", "s"])
    if kind == "run_end":
        # n logical rows in runs of 1-5
        ends = np.cumsum(rng.integers(1, 6, n))
        ends = np.append(ends[ends < n], n) if n else ends[:0]
        vals = pa.array(ints(len(ends)), pa.int64())
        return pa.RunEndEncodedArray.from_arrays(
            pa.array(ends.astype(np.int32)), vals)
    raise AssertionError(kind)


LAYOUTS = ["list", "large_list", "large_list_utf8", "list_list",
           "list_view", "large_list_view", "struct", "map", "fsl", "fsb",
           "decimal32", "decimal64", "decimal128", "decimal256",
           "interval_mdn", "sparse_union", "dense_union", "run_end"]
# the reference's take, filter and concat return `list` for a large_list
# (ROADMAP C9); the port keeps the type
LARGE = ("large_list", "large_list_utf8")


def ref_column(kind, rng, n=N):
    """A reference column of n rows (an empty one sliced from a longer
    one, so that its child types stay those of the layout)."""
    return at.column(pa_layout(kind, rng, max(n, 1))).slice(0, n)


def check(got, want, kind, what=""):
    """The port's column equals the reference's, bit for bit; a large
    list keeps its type where the reference's output says `list`."""
    dtype = None
    if kind in LARGE and want.dtype.name == "list":
        dtype = pdt.large_list(port_dtype(want.dtype.value_type))
    assert_layouts_equal(got, want, f"{kind} {what}", dtype=dtype)


# ---- construction ------------------------------------------------------------

@pytest.mark.parametrize("kind", LAYOUTS)
def test_port_column_and_to_pylist(rng, kind):
    """The carried column lists what the reference lists and holds the
    same buffers."""
    ref = ref_column(kind, rng)
    col = port_column(ref)
    assert repr(col.dtype) == repr(port_dtype(ref.dtype))
    assert len(col) == len(ref)
    assert_layouts_equal(col, ref, kind)


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("offset,length", [(0, 0), (3, 40), (60, 37)])
def test_slice(rng, kind, offset, length):
    ref = ref_column(kind, rng)
    check(port_column(ref).slice(offset, length), ref.slice(offset, length),
          kind, "slice")


# ---- take / filter / concat --------------------------------------------------

@pytest.mark.parametrize("kind", LAYOUTS)
def test_take(rng, kind):
    """Random indices with repeats and out-of-range ones (clamped)."""
    ref = ref_column(kind, rng)
    idx = rng.integers(-3, N + 3, 150)
    want = rtake.take(ref, at.column(idx))
    got = ptake.take(port_column(ref), att.from_numpy(idx, device="cpu"))
    check(got, want, kind, "take")
    assert repr(got.dtype) == repr(port_column(ref).dtype)


@pytest.mark.parametrize("kind", [k for k in LAYOUTS if k != "run_end"])
def test_take_null_indices(rng, kind):
    """A null index gives a null row (row 0's bits beneath, as in the
    reference); a struct's children are null there too."""
    ref = ref_column(kind, rng)
    idx = rng.integers(0, N, 60)
    valid = rng.random(60) > 0.3
    want = rtake.take(ref, at.column(idx, validity=valid))
    got = ptake.take(port_column(ref),
                     att.from_numpy(idx, valid, device="cpu"))
    check(got, want, kind, "take with null indices")


def test_take_run_end_null_indices_raise(rng):
    ref = ref_column("run_end", rng)
    idx = np.arange(5)
    with pytest.raises(at.ArrowInvalid):
        rtake.take(ref, at.column(idx, validity=idx > 0))
    with pytest.raises(ArrowInvalid):
        ptake.take(port_column(ref),
                   att.from_numpy(idx, idx > 0, device="cpu"))


@pytest.mark.parametrize("kind", LAYOUTS)
def test_take_check_bounds(rng, kind):
    ref = ref_column(kind, rng)
    idx = np.array([0, len(ref)])
    with pytest.raises(at.ArrowInvalid):
        rtake.take(ref, at.column(idx), check_bounds=True)
    with pytest.raises(ArrowInvalid):
        ptake.take(port_column(ref), att.from_numpy(idx, device="cpu"),
                   check_bounds=True)


def predicate(rng, n, share=0.5):
    return rng.random(n) < share, rng.random(n) > 0.1


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_filter(rng, route, kind, share):
    """One K1 call gives the kept rows' positions, the layout is taken by
    them (the plain version here); the reference takes by its indices."""
    ref = ref_column(kind, rng)
    keep, pvalid = predicate(rng, N, share)
    want = rfilter.filter(ref, at.column(keep, validity=pvalid))
    got = pfilter.filter(port_column(ref),
                         att.from_numpy(keep, pvalid, device="cpu"))
    check(got, want, kind, "filter")


def nested_table(rng, n, kinds=LAYOUTS):
    cols = [ref_column(k, rng, n) for k in kinds]
    cols.append(at.column(rng.integers(-9, 9, n).astype(np.int32),
                          validity=rng.random(n) > 0.2))
    names = [*kinds, "i32"]
    return at.Table(tuple(cols), rdt.Schema(tuple(
        rdt.Field(nm, c.dtype) for nm, c in zip(names, cols))))


def _table_check(got, want):
    assert got.column_names == want.column_names
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        check(g, w, name, "filter_table")


@pytest.mark.parametrize("share", [0.0, 0.05, 0.5, 1.0])
def test_filter_table(rng, route, share):
    """Every layout and an Int32 column in one table: the primitive
    buffers and the positions come from ONE compaction."""
    ref = nested_table(rng, N)
    keep, pvalid = predicate(rng, N, share)
    want = rfilter.filter_table(ref, at.column(keep, validity=pvalid))
    table = port_table(ref)
    calls = []
    orig = kc.compact_plain

    def spy(*a, **k):
        calls.append(a)
        return orig(*a, **k)
    kc.compact_plain = spy
    try:
        got = pfilter.filter_table(table,
                                   att.from_numpy(keep, pvalid, device="cpu"))
    finally:
        kc.compact_plain = orig
    assert len(calls) == 1, "one compaction for the whole batch"
    _table_check(got, want)


def test_filter_table_interval_rides_the_compaction(rng):
    """interval[month_day_nano]'s three planes and its validity ride the
    one compaction; no positions are asked for without a gathered
    layout."""
    ref = nested_table(rng, N, ["interval_mdn", "decimal64"])
    keep, pvalid = predicate(rng, N)
    calls = []
    orig = kc.compact_plain

    def spy(keep, arrays, cap, positions=None):
        calls.append((len(arrays), positions))
        return orig(keep, arrays, cap, positions)
    kc.compact_plain = spy
    try:
        got = pfilter.filter_table(port_table(ref), att.from_numpy(
            keep, pvalid, device="cpu"))
    finally:
        kc.compact_plain = orig
    assert calls == [(8, None)]
    _table_check(got, rfilter.filter_table(ref, at.column(keep,
                                                          validity=pvalid)))


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("sizes", [(30, 0, 41), (5, 7, 9, 11)])
def test_concat(rng, kind, sizes):
    """Offsets, dense union offsets and run ends shift by what precedes
    them; sparse children and planes concatenate."""
    refs = [ref_column(kind, rng, n) for n in sizes]
    if kind == "dense_union":
        refs = [r for r in refs if len(r)]
    want = rconcat.concat(refs)
    got = pconcat.concat([port_column(r) for r in refs])
    check(got, want, kind, "concat")


def test_concat_run_end_overflow(rng):
    """A total length past the run-end type's range raises."""
    ref = at.column(pa.RunEndEncodedArray.from_arrays(
        pa.array([20000, 30000], pa.int16()), pa.array([1, 2])))
    with pytest.raises(at.ArrowInvalid):
        rconcat.concat([ref, ref])
    with pytest.raises(ArrowInvalid):
        pconcat.concat([port_column(ref)] * 2)


def test_take_table_and_interleave(rng):
    ref = nested_table(rng, N)
    idx = rng.permutation(N)
    want = rtake.take_table(ref, at.column(idx))
    got = ptake.take_table(port_table(ref), att.from_numpy(idx, device="cpu"))
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        check(g, w, name, "take_table")
    pairs = [(int(a), int(r)) for a, r in zip(rng.integers(0, 2, 50),
                                               rng.integers(0, 40, 50))]
    for kind in ("list", "struct", "decimal128", "map", "sparse_union"):
        a, b = ref_column(kind, rng, 40), ref_column(kind, rng, 40)
        check(pconcat.interleave([port_column(a), port_column(b)], pairs),
              rconcat.interleave([a, b], pairs), kind, "interleave")


def test_reference_drops_the_large_list_tag(rng):
    """ROADMAP C9: the reference's take, filter and concat of a
    large_list return `list` over int64 offsets; the port keeps
    large_list and the same buffers."""
    ref = ref_column("large_list", rng)
    idx = np.arange(5)
    want = rtake.take(ref, at.column(idx))
    assert want.dtype.name == "list" and np.asarray(want.offsets).dtype \
        == np.int64
    got = ptake.take(port_column(ref), att.from_numpy(idx, device="cpu"))
    assert got.dtype.name == "large_list"
    assert got.offsets.dtype == torch.int64
    assert buffers(got) == buffers(want)


def test_range_gather_offsets_dtype_and_empty_rows():
    """The range gather keeps the offsets' dtype; empty rows at the ends
    and in a run, and a null row, gather nothing."""
    for odt in (torch.int32, torch.int64):
        offsets = torch.tensor([0, 0, 3, 3, 3, 5, 9, 9], dtype=odt)
        idx = torch.tensor([6, 0, 2, 1, 1, 4, 6, 5], dtype=torch.int64)
        new, src = ptake.range_gather(offsets, idx, 9)
        assert new.dtype == odt
        assert new.tolist() == [0, 0, 0, 0, 3, 6, 8, 8, 12]
        assert src.dtype == torch.int32
        assert src.tolist() == [0, 1, 2, 0, 1, 2, 3, 4, 5, 6, 7, 8]


# ---- ree, union_extract ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["int8", "int64", "float32", "bool"])
@pytest.mark.parametrize("run_end_type", ["int16", "int32", "int64"])
def test_run_end_encode_decode(rng, dtype, run_end_type):
    """Runs of equal neighbours (nulls equal nulls), then back."""
    n = 300
    vals = np.repeat(rng.integers(0, 4, 60), rng.integers(1, 9, 60))[:n]
    valid = np.repeat(rng.random(60) > 0.2, rng.integers(1, 9, 60))
    valid = np.resize(valid, len(vals))
    ref = at.column(vals.astype(dtype), validity=valid)
    rt = getattr(rdt, run_end_type)
    want = rree.run_end_encode(ref, rt)
    got = pree.run_end_encode(port_column(ref), getattr(pdt, run_end_type))
    check(got, want, "run_end", "encode")
    check(pree.run_end_decode(got), rree.run_end_decode(want), "decode")
    check(pree.run_end_decode(got), ref, "decode = input")


def test_run_end_encode_overflow_and_layouts(rng):
    """A length past the run-end type raises ArrowInvalid; a string
    column raises ArrowTypeError; an empty column encodes to no runs."""
    ref = at.column(np.arange(40000) // 7)
    with pytest.raises(at.ArrowInvalid):
        rree.run_end_encode(ref, rdt.int16)
    with pytest.raises(ArrowInvalid):
        pree.run_end_encode(port_column(ref), pdt.int16)
    with pytest.raises(ArrowTypeError):
        pree.run_end_encode(att.column(["a"], device="cpu"))
    empty = at.column(np.zeros(0, np.int64))
    check(pree.run_end_encode(port_column(empty)),
          rree.run_end_encode(empty), "run_end", "empty")


@pytest.mark.parametrize("kind", ["sparse_union", "dense_union"])
def test_union_extract(rng, kind):
    ref = ref_column(kind, rng)
    col = port_column(ref)
    for f in ref.fields:
        want = rsel.union_extract(ref, f.name)
        got = psel.union_extract(col, f.name)
        check(got, want, f.dtype.name, f"union_extract {f.name}")
    with pytest.raises(ArrowInvalid):
        psel.union_extract(col, "nope")


def test_union_extract_dense_empty_child(rng):
    """A dense union with no row of a type gives an all-null column."""
    arr = pa.UnionArray.from_dense(
        pa.array(np.zeros(4, np.int8)), pa.array(np.arange(4, dtype=np.int32)),
        [pa.array([1, 2, 3, 4]), pa.array([], pa.utf8())], ["i", "s"])
    ref = at.column(arr)
    check(psel.union_extract(port_column(ref), "s"),
          rsel.union_extract(ref, "s"), "utf8", "empty child")


# ---- core: builders, validate, pool, tensor ------------------------------------

BUILD_TYPES = [
    (pdt.list_(pdt.int32), rdt.list_(rdt.int32),
     [[1, None], None, [], [4, 5, 6]]),
    (pdt.large_list(pdt.utf8), rdt.large_list(rdt.utf8),
     [["a", None], None, ["日本"]]),
    (pdt.fixed_size_list(pdt.int16, 2), rdt.fixed_size_list(rdt.int16, 2),
     [[1, 2], None, [None, 3]]),
    (pdt.fixed_size_binary(3), rdt.fixed_size_binary(3),
     [b"abc", None, b"\x00\x01\x02"]),
    (pdt.decimal128(10, 2), rdt.decimal128(10, 2),
     [decimal.Decimal("1.25"), None, 7, decimal.Decimal("-3")]),
    (pdt.decimal256(50, 0), rdt.decimal256(50, 0), [10 ** 45, None, -1]),
    (pdt.interval(), rdt.interval(),
     [(1, 2, 3), None, {"days": -4, "nanoseconds": 5}]),
    (pdt.map_(pdt.utf8, pdt.int64), rdt.map_(rdt.utf8, rdt.int64),
     [[("a", 1), ("b", None)], None, []]),
    (pdt.struct([pdt.Field("x", pdt.int32), pdt.Field("y", pdt.utf8)]),
     rdt.struct([rdt.Field("x", rdt.int32), rdt.Field("y", rdt.utf8)]),
     [{"x": 1, "y": "a"}, None, {"x": None, "y": "b"}, (4, None)]),
    (pdt.dictionary(pdt.int8, pdt.utf8), rdt.dictionary(rdt.int8, rdt.utf8),
     ["x", "y", None, "x"]),
    (None, None, [[1, 2], [3]]),
]


@pytest.mark.parametrize("case", range(len(BUILD_TYPES)))
def test_column_from_pylist(case):
    """column() of Python values builds the reference's layout."""
    pd, rd, values = BUILD_TYPES[case]
    want = at.column(values, rd) if rd is not None else at.column(values)
    got = att.column(values, pd, device="cpu")
    assert_layouts_equal(got, want, repr(pd))


@pytest.mark.parametrize("case", [
    i for i, (_, rd, _) in enumerate(BUILD_TYPES)
    # the reference has no interval builder, and its struct builder
    # appends through the field builders (test_builders_by_hand)
    if rd is not None and rd.name not in ("interval", "struct")])
def test_make_builder(case):
    """make_builder appends and finishes to the same column as the
    reference's builder."""
    from arrow_tpu.core import builders as rbuild
    pd, rd, values = BUILD_TYPES[case]
    rb, pb = rbuild.make_builder(rd), pbuild.make_builder(pd, "cpu")
    for v in values:
        if isinstance(v, tuple) or (isinstance(v, int) and rd.is_decimal):
            continue
        for b in (rb, pb):
            b.append_null() if v is None else b.append(v)
    assert len(pb) == len(rb)
    assert_layouts_equal(pb.finish(), rb.finish(), repr(pd))
    assert len(pb) == 0


def test_builders_by_hand():
    """List, struct and map builders driven through their child
    builders."""
    from arrow_tpu.core import builders as rbuild
    lb, rl = (pbuild.ListBuilder(pbuild.PrimitiveBuilder(pdt.int64, "cpu")),
              rbuild.ListBuilder(rbuild.PrimitiveBuilder(rdt.int64)))
    for b in (lb, rl):
        b.values.append(1).append(None)
        b.append(True)
        b.append_null()
        b.append_value([7])
    assert_layouts_equal(lb.finish(), rl.finish(), "list builder")
    sb = pbuild.StructBuilder([pdt.Field("a", pdt.int8)],
                              [pbuild.PrimitiveBuilder(pdt.int8, "cpu")])
    rs = rbuild.StructBuilder([rdt.Field("a", rdt.int8)],
                              [rbuild.PrimitiveBuilder(rdt.int8)])
    for b in (sb, rs):
        b.field_builder(0).append(3)
        b.append()
        b.append_null()
    assert_layouts_equal(sb.finish(), rs.finish(), "struct builder")
    mb = pbuild.MapBuilder(pbuild.StringBuilder("cpu"),
                           pbuild.PrimitiveBuilder(pdt.int32, "cpu"))
    rm = rbuild.MapBuilder(rbuild.StringBuilder(),
                           rbuild.PrimitiveBuilder(rdt.int32))
    for b in (mb, rm):
        b.append_value([("k", 1), ("l", None)])
        b.append_null()
    assert_layouts_equal(mb.finish(), rm.finish(), "map builder")
    with pytest.raises(ArrowInvalid):
        pbuild.FixedSizeBinaryBuilder(2, "cpu").append(b"abc")


@pytest.mark.parametrize("kind", LAYOUTS)
def test_validate_passes(rng, kind):
    from arrow_tpu.core import validate as rval
    ref = ref_column(kind, rng)
    rval.validate_full(ref)
    pval.validate_full(port_column(ref))


def _broken():
    """(reference column, port column) pairs that fail validate_full."""
    offs = np.array([0, 3, 2, 4], np.int32)
    child = np.arange(4, dtype=np.int64)
    yield (at.ListColumn(at.column(offs).values, at.column(child)),
           ListColumn(torch.from_numpy(offs), att.from_numpy(
               child, device="cpu")))
    ends = np.array([2, 2, 5], np.int32)
    vals = np.arange(3, dtype=np.int64)
    from arrow_tpu.core.nested import RunEndColumn, UnionColumn
    import jax.numpy as jnp
    yield (RunEndColumn(jnp.asarray(ends), at.column(vals)),
           pn.RunEndColumn(torch.from_numpy(ends),
                           att.from_numpy(vals, device="cpu")))
    tids = np.array([0, 3], np.int8)
    yield (UnionColumn(jnp.asarray(tids), None, [at.column(vals[:2])],
                       [rdt.Field("a", rdt.int64)]),
           pn.UnionColumn(torch.from_numpy(tids), None,
                          [att.from_numpy(vals[:2], device="cpu")],
                          [pdt.Field("a", pdt.int64)]))
    codes = np.array([0, 5], np.int32)
    yield (at.DictionaryColumn(jnp.asarray(codes), at.column(["a"])),
           att.DictionaryColumn(torch.from_numpy(codes),
                                att.column(["a"], device="cpu")))


@pytest.mark.parametrize("case", range(4))
def test_validate_full_finds_the_same_faults(case):
    from arrow_tpu.core import validate as rval
    ref, col = list(_broken())[case]
    with pytest.raises(at.ArrowInvalid) as want:
        rval.validate_full(ref)
    with pytest.raises(ArrowInvalid) as got:
        pval.validate_full(col)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", [k for k in LAYOUTS if k != "struct"])
def test_column_memory_size(rng, kind):
    """The bytes of every tensor of the column, as the reference counts
    its pytree leaves."""
    from arrow_tpu.core import pool as rpool
    ref = ref_column(kind, rng)
    assert ppool.column_memory_size(port_column(ref)) == \
        rpool.column_memory_size(ref)


def test_pool_and_occupancy(rng):
    from arrow_tpu.core import pool as rpool
    ref = at.DictionaryColumn(
        at.column(rng.integers(0, 9, 50).astype(np.int32)).values,
        at.column([f"w{i}" for i in range(12)]),
        at.column(rng.random(50) > 0.3).values)
    assert ppool.dictionary_occupancy(port_column(ref)) == \
        rpool.dictionary_occupancy(ref)
    pool = ppool.TrackingMemoryPool()
    with ppool.MemoryReservation.for_column(pool, port_column(ref)) as r:
        r.resize(r.size * 2)
        assert pool.used() == pool.peak() == r.size
    assert pool.used() == 0
    assert ppool.device_memory_stats("cpu") is None


def test_tensor():
    from arrow_tpu.core.tensor import Tensor as RTensor
    import jax.numpy as jnp
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got, want = Tensor(torch.from_numpy(a), ["a", "b", "c"]), \
        RTensor(jnp.asarray(a), ["a", "b", "c"])
    for attr in ("shape", "strides", "ndim", "size", "dim_names"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert repr(got.dtype) == repr(want.dtype)
    assert got.is_row_major() and not got.is_column_major()
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    with pytest.raises(ArrowInvalid):
        Tensor(torch.zeros(2), ["a", "b"])


# ---- dtypes and typeparse ------------------------------------------------------

TYPE_STRINGS = ["Int32", "Timestamp(Nanosecond, None)",
                'Timestamp(Millisecond, Some("+08:00"))',
                "Dictionary(Int32, Utf8)", "List(FixedSizeBinary(2))",
                "Struct(a Int32, b Utf8)", "Decimal128(38, 10)",
                "Decimal64(10, -2)", "Interval(MonthDayNano)",
                "ListView(Int64)", "LargeListView(Utf8)",
                "FixedSizeList(3, Float32)", "Duration(Microsecond)",
                "Time64(Nanosecond)", "Struct()", "  List( Int8 ) ",
                "LargeList(Struct(x Decimal256(60, 4), y Interval(DayTime)))",
                "Dictionary(UInt16, LargeUtf8)", "Binary", "Date64"]
BAD_TYPES = ["NotAType", "Int32, Int64", "Timestamp(Bogus, None)", "List(",
             "Decimal128(1)", "Timestamp(Nanosecond)", ""]


@pytest.mark.parametrize("text", TYPE_STRINGS)
def test_parse_data_type(text):
    from arrow_tpu.typeparse import parse_data_type as rparse
    got, want = parse_data_type(text), rparse(text)
    assert repr(got) == repr(want)
    assert got == port_dtype(want)


@pytest.mark.parametrize("text", BAD_TYPES)
def test_parse_data_type_errors(text):
    from arrow_tpu.typeparse import parse_data_type as rparse
    with pytest.raises(at.ArrowInvalid):
        rparse(text)
    with pytest.raises(ArrowInvalid) as got:
        parse_data_type(text)
    assert "Unsupported type" in str(got.value)


@pytest.mark.parametrize("kind", LAYOUTS)
def test_dtype_predicates(rng, kind):
    """Predicates, byte widths and repr of each layout's type."""
    rd = ref_column(kind, rng).dtype
    d = port_dtype(rd)
    assert repr(d) == repr(rd)
    for p in ("is_nested", "is_decimal", "is_union", "is_run_end_encoded",
              "is_primitive", "is_numeric", "is_temporal", "is_binary",
              "is_string"):
        assert getattr(d, p) == getattr(rd, p), p
    if rd.name in ("decimal32", "decimal64"):
        assert d.byte_width == rd.byte_width
    if rd.is_decimal or rd.name == "fixed_size_binary" or \
            rd.name == "interval":
        assert d.byte_width == {"decimal32": 4, "decimal64": 8,
                                "decimal128": 16, "decimal256": 32,
                                "fixed_size_binary": 16,
                                "interval": 16}[rd.name]


MERGES = [
    ([("a", "int32", True)], [("a", "int32", False), ("b", "utf8", True)]),
    ([("a", "null", False)], [("a", "float64", False)]),
    ([("a", "int32", True)], [("a", "int64", True)]),
]


def _field(pkg, name, t, nullable):
    d = getattr(pkg.dtypes if pkg is at else pdt,
                t if t != "null" else "null")
    return (rdt if pkg is at else pdt).Field(name, d, nullable)


@pytest.mark.parametrize("case", range(len(MERGES)))
def test_schema_try_merge(case):
    a, b = MERGES[case]

    def schemas(pkg):
        S = (rdt if pkg is at else pdt).Schema
        return [S(tuple(_field(pkg, *f) for f in a)),
                S(tuple(_field(pkg, *f) for f in b))]
    try:
        want = rdt.Schema.try_merge(schemas(at))
    except at.errors.SchemaError:
        with pytest.raises(SchemaError):
            pdt.Schema.try_merge(schemas(att))
        return
    got = pdt.Schema.try_merge(schemas(att))
    assert got.fields == tuple(port_field(f) for f in want.fields)


def test_field_try_merge_nested_and_metadata():
    s1 = pdt.struct([pdt.Field("x", pdt.int32)])
    s2 = pdt.struct([pdt.Field("y", pdt.utf8)])
    f = pdt.Field("s", s1, False, (("k", "v"),)).try_merge(
        pdt.Field("s", s2, True, (("k", "v"), ("j", "w"))))
    assert [g.name for g in f.dtype.fields] == ["x", "y"]
    assert f.nullable and dict(f.metadata) == {"k": "v", "j": "w"}
    with pytest.raises(SchemaError):
        pdt.Field("a", pdt.int8, metadata=(("k", "1"),)).try_merge(
            pdt.Field("a", pdt.int8, metadata=(("k", "2"),)))
    lf = pdt.Field("l", pdt.list_(pdt.null)).try_merge(
        pdt.Field("l", pdt.list_(pdt.int16)))
    assert lf.dtype == pdt.list_(pdt.int16)


# ---- the card ------------------------------------------------------------------

def card_columns(rng, n, device):
    """Columns of the offsets, struct, plane and union layouts built by
    the port from Python values (no pyarrow: the card's machine may not
    have it)."""
    def ints(k):
        return [None if rng.random() < 0.1 else int(x)
                for x in rng.integers(-99, 99, k)]
    rows = [None if rng.random() < 0.1 else ints(int(rng.integers(0, 6)))
            for _ in range(n)]
    words = [[WORDS[i] for i in rng.integers(0, len(WORDS),
                                             rng.integers(0, 4))]
             for _ in range(n)]
    pairs = [[(WORDS[i], int(i)) for i in rng.integers(0, len(WORDS),
                                                       rng.integers(0, 3))]
             for _ in range(n)]
    return {
        "list": att.column(rows, pdt.list_(pdt.int64), device=device),
        "large_list_utf8": att.column(words, pdt.large_list(pdt.utf8),
                                      device=device),
        "map": att.column(pairs, pdt.map_(pdt.utf8, pdt.int64),
                          device=device),
        "list_list": att.column([[r, None, []] if r else r for r in rows],
                                pdt.list_(pdt.list_(pdt.int64)),
                                device=device),
        "struct": att.column([None if rng.random() < 0.1 else
                              {"i": int(x), "s": WORDS[int(x) % 6]}
                              for x in rng.integers(0, 99, n)],
                             pdt.struct([pdt.Field("i", pdt.int32),
                                         pdt.Field("s", pdt.utf8)]),
                             device=device),
        "decimal": att.column([None if x % 7 == 0 else int(x) for x in
                               rng.integers(-10 ** 9, 10 ** 9, n)],
                              pdt.decimal128(20, 2), device=device),
        "interval": att.column([(int(x), -int(x), int(x) * 999)
                                for x in rng.integers(-50, 50, n)],
                               pdt.interval(), device=device),
        "fsb": att.column([rng.bytes(16) for _ in range(n)],
                          pdt.fixed_size_binary(16), device=device),
        "i32": att.column([int(x) for x in rng.integers(-9, 9, n)],
                          pdt.int32, device=device)}


def test_filter_table_on_the_card(cuda_device):
    """One K1 launch gives the fixed-width buffers and the positions; the
    columns gathered by them equal the CPU route, bit for bit."""
    from arrow_tpu_torch.core.table import Table
    cols = {}
    for dev in ("cpu", cuda_device):
        cols[str(dev)] = card_columns(np.random.default_rng(5), 5000, dev)
    keep = np.random.default_rng(6).random(5000) < 0.4
    out = {}
    for dev, c in cols.items():
        table = Table(list(c.values()), pdt.Schema(tuple(
            pdt.Field(k, v.dtype) for k, v in c.items())))
        before = kc.compact.launches
        out[dev] = pfilter.filter_table(table, att.from_numpy(
            keep, device=dev))
        if dev != "cpu":
            assert kc.compact.launches == before + 1
    got, want = out[str(cuda_device)], out["cpu"]
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        assert buffers(g) == buffers(w), name


def test_range_gather_on_the_card(cuda_device):
    """The device range gather (lists, large lists, maps, nested lists)
    equals the CPU route, int32 and int64 offsets alike."""
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 3000, 5000)
    host = card_columns(np.random.default_rng(8), 3000, "cpu")
    card = card_columns(np.random.default_rng(8), 3000, cuda_device)
    for kind in ("list", "large_list_utf8", "map", "list_list"):
        got = ptake.take(card[kind], att.from_numpy(idx, device=cuda_device))
        want = ptake.take(host[kind], att.from_numpy(idx, device="cpu"))
        assert buffers(got) == buffers(want), kind
