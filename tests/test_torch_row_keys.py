"""Parity of the port's remaining sort and group keys, RowConverter and
the comparators (arrow_tpu_torch/ops/row_format.py, sort.py, groupby.py
and ord.py) with the JAX package on the CPU.

Key columns of every kind the reference sorts and groups -- decimal32,
decimal64, decimal128 (precision 15 and 38) and decimal256, run-end
columns of integers and strings, interval[month_day_nano], list, large
list, list view, fixed-size list, fixed-size binary, struct and map --
are made from a seed with pyarrow, read by the reference and carried
into the port buffer for buffer.  Both go through sort_to_indices,
sort, rank, lexsort, sort_table, partition and group_by under every
(descending, nulls_first) pair; indices and ranks compare exactly,
columns and tables by type, buffers and values (`assert_columns_equal`,
`assert_tables_equal`).  No tolerance.  RowConverter's rows compare
byte for byte; make_comparator over every pair of rows.  The departure:
ROADMAP C11, a day_time interval round-trips through the port's rows
where the reference's decode leaves bit 31 flipped.
"""

import decimal
import importlib

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu_torch import dtypes as pdt
from arrow_tpu_torch.core.column import PrimitiveColumn
from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
from arrow_tpu_torch.ops import groupby as pg, join as pj, ord as pord
from arrow_tpu_torch.ops import row_format as pf, sort as ps
from arrow_tpu_torch.ops.ree import run_end_encode
from torch_port_util import (assert_columns_equal,  # noqa: F401
                             assert_layouts_equal, assert_same, cuda_device,
                             port_column, port_options, port_table,
                             ref_pylist, route, storage_list)

rs = importlib.import_module("arrow_tpu.ops.sort")
rg = importlib.import_module("arrow_tpu.ops.groupby")
rf = importlib.import_module("arrow_tpu.ops.row_format")
rord = importlib.import_module("arrow_tpu.ops.ord")
rj = importlib.import_module("arrow_tpu.ops.join")
rree = importlib.import_module("arrow_tpu.ops.ree")
rcast = importlib.import_module("arrow_tpu.ops.cast")
rtake = importlib.import_module("arrow_tpu.ops.take")
rdt = at.dtypes
D = decimal.Decimal
N = 80
OPTIONS = [(False, True), (False, False), (True, True), (True, False)]
OPT_IDS = ["asc-nf", "asc-nl", "desc-nf", "desc-nl"]


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _null(rng, x, share=0.12):
    return None if rng.random() < share else x


def _decimals(rng, t, lo, hi, scale_exp=0):
    return at.column(pa.array(
        [_null(rng, D(int(x) * 10 ** scale_exp).scaleb(-t.scale))
         for x in rng.integers(lo, hi, N)], t))


def _ree(rng, values_type):
    runs = rng.integers(1, 5, N)
    vals = [_null(rng, int(x)) for x in rng.integers(-4, 4, len(runs))]
    if values_type == "utf8":
        vals = [None if v is None else f"w{v}" for v in vals]
    flat = [v for v, r in zip(vals, runs) for _ in range(r)][:N]
    if values_type == "utf8":
        return rcast.cast(at.column(flat), rdt.run_end_encoded(rdt.int32,
                                                               rdt.utf8))
    return rree.run_end_encode(at.column(flat))


def _lists(rng, t, size=None):
    rows = [_null(rng, [_null(rng, int(v), 0.2) for v in
                        rng.integers(0, 3, size or rng.integers(0, 4))])
            for _ in range(N)]
    return at.column(pa.array(rows, t))


KEYS = {
    "decimal128(15, 2)": lambda r: _decimals(r, pa.decimal128(15, 2),
                                             -3000, 3000),
    "decimal128(38, 4)": lambda r: _decimals(r, pa.decimal128(38, 4), -6, 6,
                                             30),
    "decimal256(60, 0)": lambda r: _decimals(r, pa.decimal256(60, 0), -6, 6,
                                             50),
    "decimal256(20, 2)": lambda r: _decimals(r, pa.decimal256(20, 2), -50,
                                             50),
    "decimal32(7, 2)": lambda r: _decimals(r, pa.decimal32(7, 2), -99, 99),
    "decimal64(18, 3)": lambda r: _decimals(r, pa.decimal64(18, 3), -99, 99),
    "run_end<int64>": lambda r: _ree(r, "int64"),
    "run_end<utf8>": lambda r: _ree(r, "utf8"),
    "month_day_nano": lambda r: at.column(pa.array(
        [_null(r, pa.MonthDayNano([int(m), int(d), int(ns)]))
         for m, d, ns in zip(r.integers(-1, 2, N), r.integers(-1, 2, N),
                             r.integers(-2, 3, N))],
        pa.month_day_nano_interval())),
    "list<int64>": lambda r: _lists(r, pa.list_(pa.int64())),
    "large_list<int64>": lambda r: _lists(r, pa.large_list(pa.int64())),
    "list_view<int64>": lambda r: _lists(r, pa.list_view(pa.int64())),
    "fixed_size_list<int64, 2>": lambda r: _lists(
        r, pa.list_(pa.int64(), 2), 2),
    "list<float64>": lambda r: at.column(pa.array(
        [_null(r, [float(v) if v < 2 else float("nan") for v in
                   r.integers(-1, 3, r.integers(0, 3))]) for _ in range(N)],
        pa.list_(pa.float64()))),
    "fixed_size_binary(2)": lambda r: at.column(pa.array(
        [_null(r, bytes(r.integers(0, 3, 2).astype(np.uint8).tolist()))
         for _ in range(N)], pa.binary(2))),
    "struct<int64, utf8>": lambda r: at.column(pa.array(
        [_null(r, {"a": _null(r, int(a), 0.2), "b": _null(r, f"s{b}", 0.2)})
         for a, b in zip(r.integers(0, 3, N), r.integers(0, 2, N))],
        pa.struct([("a", pa.int64()), ("b", pa.string())]))),
    "struct<float64>": lambda r: at.column(pa.array(
        [_null(r, {"f": _null(r, float(v) if v else float("nan"))})
         for v in r.integers(-1, 2, N)], pa.struct([("f", pa.float64())]))),
    "map<utf8, int64>": lambda r: at.column(pa.array(
        [_null(r, [(f"k{k}", _null(r, int(v), 0.2)) for k, v in
                   zip(r.integers(0, 2, r.integers(0, 3)),
                       r.integers(0, 2, 3))]) for _ in range(N)],
        pa.map_(pa.string(), pa.int64()))),
}


def key_col(name):
    return KEYS[name](_rng(name))


def _indices(col) -> list:
    v = col.values
    return (v.numpy().view(np.uint32) if isinstance(v, torch.Tensor)
            else np.asarray(v)).astype(np.int64).tolist()


def _ranks(r) -> list:
    return (r.numpy().view(np.uint32) if isinstance(r, torch.Tensor)
            else np.asarray(r)).astype(np.int64).tolist()


def _ropt(o):
    return rf.SortOptions(*o)


def check_col(got, want, what=""):
    """assert_columns_equal, but for two known differences: a decimal32 /
    decimal64 sorted by its keys holds zeros under its nulls in the
    port, the reference's decoded key there (values compare by
    `_py_equal`'s rule); the reference's take of a large_list returns the
    list type (ROADMAP C9)."""
    if want.dtype.name in ("decimal32", "decimal64"):
        assert repr(got.dtype) == repr(want.dtype), what
        assert_same(got.to_pylist(), ref_pylist(want), what)
    elif got.dtype.name == "large_list" and want.dtype.name == "list":
        assert_layouts_equal(got, want, what, dtype=got.dtype)
    else:
        assert_columns_equal(got, want, what)


def check_table(got, want):
    assert got.column_names == want.column_names
    for g, w in zip(got.schema.fields, want.schema.fields):
        assert (g.name, repr(g.dtype), g.nullable) == \
            (w.name, repr(w.dtype), w.nullable), (g, w)
    for name, g, w in zip(got.column_names, got.columns, want.columns):
        check_col(g, w, name)


def _popt(o):
    return port_options(rf.SortOptions(*o))


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("name", list(KEYS))
def test_sort_indices_rank_and_sort(name, opt):
    """sort_to_indices, rank and sort of one key column (row_format.py:
    375-480,585-604): decimal limb keys, run-end columns by their rows,
    host comparator ranks with child nulls placed by child_nf."""
    ref = key_col(name)
    port = port_column(ref)
    assert _indices(ps.sort_to_indices(port, _popt(opt))) == \
        _indices(rs.sort_to_indices(ref, _ropt(opt)))
    assert _ranks(ps.rank(port, _popt(opt))) == \
        _ranks(rs.rank(ref, _ropt(opt)))
    check_col(ps.sort(port, _popt(opt)), rs.sort(ref, _ropt(opt)), name)


@pytest.mark.parametrize("limit", [0, 1, 17, N])
@pytest.mark.parametrize("name", ["decimal128(15, 2)", "decimal256(60, 0)",
                                  "struct<int64, utf8>", "run_end<int64>"])
def test_sort_limit(name, limit):
    ref = key_col(name)
    opt = (True, False)
    assert _indices(ps.sort_to_indices(port_column(ref), _popt(opt),
                                       limit)) == \
        _indices(rs.sort_to_indices(ref, _ropt(opt), limit))


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("name", list(KEYS))
def test_lexsort_after_a_small_key(name, opt):
    """lexsort_to_indices and lexsort with a three-value integer key first
    and the column second, so its order breaks the ties."""
    ref = key_col(name)
    small = at.column(_rng("small").integers(0, 3, N))
    rcols = [rs.SortColumn(small, _ropt((False, True))),
             rs.SortColumn(ref, _ropt(opt))]
    pcols = [ps.SortColumn(port_column(small), _popt((False, True))),
             ps.SortColumn(port_column(ref), _popt(opt))]
    assert _indices(ps.lexsort_to_indices(pcols)) == \
        _indices(rs.lexsort_to_indices(rcols))
    for got, want in zip(ps.lexsort(pcols), rs.lexsort(rcols)):
        check_col(got, want, name)


def _table(name):
    ref = key_col(name)
    rng = _rng(name + "v")
    v = rng.integers(-50, 50, N)
    date = rng.integers(8000, 11000, N).astype(np.int32)
    return at.Table.from_pydict({
        "k": ref, "v": at.column(v, validity=rng.random(N) >= 0.1),
        "d": at.column(date, dtype=rdt.date32),
        "f": at.column(rng.integers(-400, 400, N) / 8)})   # exact sums


@pytest.mark.parametrize("limit", [None, 9])
@pytest.mark.parametrize("opt", [(False, True), (True, False)],
                         ids=["asc-nf", "desc-nl"])
@pytest.mark.parametrize("name", list(KEYS))
def test_sort_table(name, opt, limit):
    """A key that does not decode from its keys rides the gather with the
    other columns (sort.py:95-113); v breaks the ties.  The reference's
    sort_table fails on a run-end key of strings beside a decodable key
    (ROADMAP C12): the port equals its take_table by the lexsort."""
    t = _table(name)
    by_r = [("k", _ropt(opt)), ("v", _ropt((False, True)))]
    by_p = [("k", _popt(opt)), ("v", _popt((False, True)))]
    got = ps.sort_table(port_table(t), by_p, limit)
    if name == "run_end<utf8>":
        with pytest.raises(AttributeError):
            rs.sort_table(t, by_r, limit)
        idx = rs.lexsort_to_indices([rs.SortColumn(t.column(c), o)
                                     for c, o in by_r], limit)
        check_table(got, rtake.take_table(t, idx))
        return
    check_table(got, rs.sort_table(t, by_r, limit))


AGGS = [("v", "count_all"), ("v", "count"), ("v", "sum"), ("v", "min"),
        ("v", "max"), ("d", "min"), ("d", "max"), ("f", "mean"),
        ("f", "max")]


@pytest.mark.parametrize("name", list(KEYS))
def test_group_by(route, name):
    """The sort plan (groupby.py:152-156) on one key column: groups in
    key order, nulls first, output keys gathered at each group's first
    row with their layout and type."""
    t = _table(name)
    want = rg.group_by(t, ["k"], [rg.AggSpec(*a) for a in AGGS])
    got = pg.group_by(port_table(t), ["k"], [pg.AggSpec(*a) for a in AGGS])
    check_table(got, want)


@pytest.mark.parametrize("name", ["decimal128(15, 2)", "struct<int64, utf8>",
                                  "run_end<utf8>", "list<int64>",
                                  "decimal32(7, 2)"])
def test_group_by_two_keys(name):
    t = _table(name)
    small = at.column(_rng("two").integers(0, 2, N))
    t = at.Table.from_pydict({**{c: t.column(c) for c in t.column_names},
                              "s": small})
    aggs = [("v", "sum"), ("d", "min"), ("v", "count_all")]
    for keys in (["k", "s"], ["s", "k"]):
        want = rg.group_by(t, keys, [rg.AggSpec(*a) for a in aggs])
        got = pg.group_by(port_table(t), keys,
                          [pg.AggSpec(*a) for a in aggs])
        check_table(got, want)


@pytest.mark.parametrize("name", list(KEYS))
def test_partition_raises_as_the_reference(name):
    """partition takes the value key, which has no decimal128/256,
    run-end or nested arm in either package (row_format.py:163): both
    raise ArrowNotImplementedError, the month_day_nano column too; a
    decimal32 / decimal64 partitions by its storage integer."""
    ref = key_col(name)
    if name.startswith(("decimal32", "decimal64")):
        assert ps.partition([port_column(ref)]).boundaries.tolist() == \
            rs.partition([ref]).boundaries.tolist()
        return
    with pytest.raises(Exception) as want:
        rs.partition([ref])
    with pytest.raises(Exception) as got:
        ps.partition([port_column(ref)])
    assert type(got.value).__name__ == type(want.value).__name__ == \
        "ArrowNotImplementedError"


@pytest.mark.parametrize("name", ["decimal128(38, 4)", "list<int64>",
                                  "struct<int64, utf8>",
                                  "decimal128(15, 2)"])
def test_join_raises_on_decimal_and_nested_keys(name):
    """The join's key is encode_value_key, which raises on decimal128 and
    nested columns in both packages (row_format.py:163): the port's join
    is unchanged and raises the same error."""
    t = at.Table.from_pydict({"k": key_col(name),
                              "v": at.column(np.arange(N))})
    with pytest.raises(Exception) as want:
        rj.join_indices(t, t, ["k"])
    with pytest.raises(Exception) as got:
        pj.join_indices(port_table(t), port_table(t), ["k"])
    assert type(got.value).__name__ == type(want.value).__name__


# ---- the one-word decimal128 key --------------------------------------------

def _two_limb_keys(col, opt):
    """The reference's layout: the top limb sign-flipped, then the low
    limb as unsigned, for every decimal128."""
    limbs = col.limbs
    keys = [(limbs[:, 1] ^ pf._SIGN, 64), (limbs[:, 0], 64)]
    if opt.descending:
        keys = [(~v, b) for v, b in keys]
    out = []
    if col.validity is not None:
        out.append(pf.SortKey((col.validity if opt.nulls_first
                               else ~col.validity).to(torch.int64), 1))
        keys = [(torch.where(col.validity, v, 0), b) for v, b in keys]
    return out + [pf.SortKey(v, b) for v, b in keys]


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("precision", [1, 9, 15, 18])
def test_one_word_decimal_key_equals_two_limbs(precision, opt):
    """A decimal128 of precision <= 18 keys by its low limb alone; the
    order (ties and their stable order included) and the sorted rows
    equal the two-limb encoding's, and the reference's."""
    rng = np.random.default_rng(precision)
    hi = 10 ** precision
    vals = [_null(rng, D(int(x))) for x in rng.integers(-hi + 1, hi, 500)]
    vals[:6] = [D(hi - 1), D(-hi + 1), D(0), D(-1), D(1), None]
    ref = at.column(pa.array(vals, pa.decimal128(max(precision, 1), 0)))
    col = port_column(ref)
    one = pf.encode_keys([col], options=[_popt(opt)])
    assert len(one) == (2 if col.validity is not None else 1)
    order_one = pf.lexsort_order(one, len(col), col.device)
    order_two = pf.lexsort_order(_two_limb_keys(col, _popt(opt)), len(col),
                                 col.device)
    assert order_one.tolist() == order_two.tolist()
    assert order_one.tolist() == \
        _indices(rs.sort_to_indices(ref, _ropt(opt)))
    check_col(ps.sort(col, _popt(opt)), rs.sort(ref, _ropt(opt)))


def test_decimal_past_its_precision_keeps_two_limbs():
    """Limbs outside the declared precision (a decimal128(15, 2) holding
    2**70) fail the top-limb check, so the key keeps both limbs and
    still sorts as the reference."""
    ints = [2 ** 70, -(2 ** 70), 5, -5, 0]
    col = pn_decimal(ints)
    keys = pf.encode_keys([col], options=[pf.SortOptions()])
    assert len(keys) == 2
    assert ps.sort_to_indices(col).values.tolist() == [1, 3, 4, 2, 0]


def pn_decimal(ints):
    from arrow_tpu_torch.core.nested import DecimalColumn
    return DecimalColumn.from_pyints(ints, pdt.decimal128(15, 2),
                                     device="cpu")


# ---- RowConverter -----------------------------------------------------------

def _row_columns():
    rng = _rng("rows")
    words = [f"word-{i:04d}" for i in range(12)] + ["", "x" * 70]
    return [
        at.column(rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32),
                  validity=rng.random(N) >= 0.1),
        at.column(rng.integers(0, 10 ** 15, N), dtype=rdt.timestamp("us")),
        at.DictionaryColumn(
            at.column(rng.integers(0, 5, N).astype(np.int32)).values,
            at.column(["d", "b", "a", "c", "b"]), None),
        at.column([_null(rng, words[i]) for i in
                   rng.integers(0, len(words), N)]),
        at.column(np.where(rng.random(N) < 0.1, np.nan,
                           rng.standard_normal(N))),
        at.column(rng.random(N) < 0.5),
        at.column(rng.integers(0, 2 ** 63, N).astype(np.uint64) * 2),
        at.column(rng.integers(-99, 99, N).astype(np.int8)),
    ]


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
def test_row_converter(opt):
    """convert_columns gives the reference's bytes (tag + big-endian value
    key; arrow-row's variable-length cells for strings), convert_rows
    gives the columns back as the reference's does, and Rows.argsort
    orders as the reference's."""
    cols = _row_columns()
    rconv = rf.RowConverter([rf.SortField(_ropt(opt)) for _ in cols])
    pconv = pf.RowConverter([pf.SortField(_popt(opt)) for _ in cols])
    pcols = [port_column(c) for c in cols]
    rrows = rconv.convert_columns(cols)
    prows = pconv.convert_columns(pcols)
    assert prows.layout == rrows.layout and len(prows) == len(rrows)
    assert np.array_equal(prows.to_numpy(), np.asarray(rrows.data))
    for got, want in zip(pconv.convert_rows(prows, pcols),
                         rconv.convert_rows(rrows, cols)):
        assert_columns_equal(got, want, masks=True)
    for got, src in zip(pconv.convert_rows(prows, pcols), pcols):
        if isinstance(src, PrimitiveColumn):
            assert storage_list(got) == storage_list(src)
        else:
            assert got.to_pylist() == src.to_pylist()
    assert _ranks(prows.argsort()) == _ranks(rrows.argsort())


def test_rows_argsort_is_the_lexsort():
    """Rows.argsort of config 2's fields (int32, timestamp, dictionary,
    the words as utf8) equals lexsort_to_indices on the same fields."""
    cols = [port_column(c) for c in _row_columns()[:4]]
    for opt in OPTIONS:
        conv = pf.RowConverter([pf.SortField(_popt(opt)) for _ in cols])
        got = _ranks(conv.convert_columns(cols).argsort())
        want = _indices(ps.lexsort_to_indices(
            [ps.SortColumn(c, _popt(opt)) for c in cols]))
        assert got == want, opt


def test_reference_rows_flip_day_time_bit_31():
    """ROADMAP C11: encode_value_key flips bit 31 of a day_time interval
    as well as the sign bit (row_format.py:145-147), and the reference's
    decode undoes only the sign bit (:347), so its rows give back other
    intervals.  The port's rows give back the column, bit for bit."""
    ref = at.column(np.array([(3 << 32) | 5, (-1 << 32) | 0xFFFFFFFF, 0],
                             np.int64), dtype=rdt.interval("day_time"))
    port = port_column(ref)
    rconv = rf.RowConverter([rf.SortField()])
    pconv = pf.RowConverter([pf.SortField()])
    rrows, prows = rconv.convert_columns([ref]), pconv.convert_columns([port])
    assert np.array_equal(prows.to_numpy(), np.asarray(rrows.data))
    back = rconv.convert_rows(rrows, [ref])[0]
    assert storage_list(back) != storage_list(ref)
    assert storage_list(pconv.convert_rows(prows, [port])[0]) == \
        storage_list(port)


@pytest.mark.parametrize("name", ["decimal128(15, 2)", "list<int64>"])
def test_row_converter_raises_as_the_reference(name):
    ref = key_col(name)
    with pytest.raises(Exception) as want:
        rf.RowConverter([rf.SortField()]).convert_columns([ref])
    with pytest.raises(Exception) as got:
        pf.RowConverter([pf.SortField()]).convert_columns([port_column(ref)])
    assert type(got.value).__name__ == type(want.value).__name__


# ---- comparators ------------------------------------------------------------

CMP_KEYS = ["list<int64>", "struct<int64, utf8>", "map<utf8, int64>",
            "month_day_nano", "fixed_size_binary(2)", "list<float64>",
            "list_view<int64>", "decimal128(15, 2)", "run_end<int64>"]
CMP_PLAIN = {
    "int64": lambda r: at.column(r.integers(-3, 3, N),
                                 validity=r.random(N) >= 0.1),
    "float64": lambda r: at.column(np.where(r.random(N) < 0.1, np.nan,
                                            r.integers(-2, 2, N) * 0.5)),
    "utf8": lambda r: at.column([_null(r, f"s{i}") for i in
                                 r.integers(0, 4, N)]),
}


def _both_outcomes(port_fn, ref_fn):
    try:
        want = ref_fn()
    except Exception as e:
        with pytest.raises(Exception) as got:
            port_fn()
        assert type(got.value).__name__ == type(e).__name__
        return None, None
    return port_fn(), want


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("name", CMP_KEYS + list(CMP_PLAIN))
def test_make_comparator(name, opt):
    """cmp(i, j) of two arrays (ord.py:23-58) over every pair of rows:
    ranks over the concatenation of both arrays."""
    make = CMP_PLAIN.get(name) or KEYS[name]
    a, b = make(_rng(name)).slice(0, 30), make(_rng(name + "b")).slice(0, 25)
    got, want = _both_outcomes(
        lambda: pord.make_comparator(port_column(a), port_column(b),
                                     _popt(opt)),
        lambda: rord.make_comparator(a, b, _ropt(opt)))
    if want is None:
        return
    assert [[got(i, j) for j in range(len(b))] for i in range(len(a))] == \
        [[want(i, j) for j in range(len(b))] for i in range(len(a))]


def test_make_comparator_type_mismatch():
    with pytest.raises(TypeError):
        pord.make_comparator(port_column(at.column([1])),
                             port_column(at.column([1.0])))


def test_make_lexicographic_comparator():
    """The multi-column comparator (ord.py:61-88)."""
    names = ["struct<int64, utf8>", "int64", "list<int64>"]
    left = [(CMP_PLAIN.get(n) or KEYS[n])(_rng(n)).slice(0, 20)
            for n in names]
    right = [(CMP_PLAIN.get(n) or KEYS[n])(_rng(n + "r")).slice(0, 20)
             for n in names]
    opts = [(False, True), (True, False), (False, False)]
    got = pord.make_lexicographic_comparator(
        [port_column(c) for c in left], [port_column(c) for c in right],
        [_popt(o) for o in opts])
    want = rord.make_lexicographic_comparator(left, right,
                                              [_ropt(o) for o in opts])
    assert [[got(i, j) for j in range(20)] for i in range(20)] == \
        [[want(i, j) for j in range(20)] for i in range(20)]


# ---- phase 28 of chip_smoke.py at a small size ------------------------------

def lineitem(n, seed=28):
    """A small lineitem of the columns phase 28 uses, by TPC-H's rules
    (spec 4.2.3): orders of 1-7 lines, prices from the quantity and the
    part key, discounts 0.00-0.10, taxes 0.00-0.08."""
    rng = np.random.default_rng(seed)
    lines = rng.integers(1, 8, n)
    orderkey = np.repeat(np.arange(1, n + 1) * 4, lines)[:n]
    linenumber = np.concatenate([np.arange(1, k + 1) for k in lines])[:n]
    qty = rng.integers(1, 51, n)
    price = qty * (90000 + rng.integers(0, 20001, n))
    disc, tax = rng.integers(0, 11, n), rng.integers(0, 9, n)
    dec = lambda v: at.column(pa.array([D(int(x)).scaleb(-2) for x in v],
                                       pa.decimal128(15, 2)))
    flag = at.DictionaryColumn(
        at.column(rng.integers(0, 3, n).astype(np.int32)).values,
        at.column(["A", "N", "R"]), None)
    status = at.DictionaryColumn(
        at.column(rng.integers(0, 2, n).astype(np.int32)).values,
        at.column(["F", "O"]), None)
    return at.Table.from_pydict({
        "l_orderkey": at.column(orderkey),
        "l_linenumber": at.column(linenumber.astype(np.int32)),
        "l_quantity": dec(qty * 100), "l_extendedprice": dec(price),
        "l_discount": dec(disc), "l_tax": dec(tax),
        "l_returnflag": flag, "l_linestatus": status,
        "l_shipdate": at.column(rng.integers(8000, 10500, n).astype(
            np.int32), dtype=rdt.date32)}), (disc, tax, price, orderkey)


def test_phase28_rehearsal():
    """Phase 28's calls at 3,000 rows, against the reference and against
    the independent computations chip_smoke.py holds them to: the
    (discount, tax) group-by by bincount over disc * 9 + tax, rank by a
    searchsorted rank of the prices, sort_table's order, the group-by
    over run_end_encode(l_orderkey) by the line counts, and the struct
    and list keys."""
    t, (disc, tax, price, orderkey) = lineitem(3000)
    pt = port_table(t)
    aggs = [("l_linenumber", "count_all"), ("l_linenumber", "sum"),
            ("l_shipdate", "min"), ("l_shipdate", "max")]
    want = rg.group_by(t, ["l_discount", "l_tax"],
                       [rg.AggSpec(*a) for a in aggs])
    got = pg.group_by(pt, ["l_discount", "l_tax"],
                      [pg.AggSpec(*a) for a in aggs])
    check_table(got, want)
    code = disc * 9 + tax
    present = np.nonzero(np.bincount(code, minlength=99))[0]
    assert got.column("l_linenumber_count_all").values.tolist() == \
        np.bincount(code, minlength=99)[present].tolist()
    lin = t.column("l_linenumber")
    assert got.column("l_linenumber_sum").values.tolist() == np.bincount(
        code, np.asarray(lin.values), 99)[present].astype(np.int64).tolist()

    by = [("l_extendedprice", (True, True)), ("l_orderkey", (False, True))]
    sub = at.Table.from_pydict({c: t.column(c) for c in (
        "l_orderkey", "l_extendedprice", "l_shipdate")})
    got = ps.sort_table(port_table(sub), [(c, _popt(o)) for c, o in by])
    check_table(got, rs.sort_table(sub, [(c, _ropt(o))
                                                 for c, o in by]))
    r = ps.rank(port_column(t.column("l_extendedprice")))
    assert _ranks(r) == np.searchsorted(np.sort(price), price,
                                        side="right").tolist()

    ree = run_end_encode(port_column(t.column("l_orderkey")))
    out = pg.group_by(pdt_table({"k": ree, "v": port_column(lin)}), ["k"],
                      [pg.AggSpec("v", "count_all")])
    keys, counts = np.unique(orderkey, return_counts=True)
    assert out.column("v_count_all").values.tolist() == counts.tolist()
    assert out.column("k").to_pylist() == keys.tolist()

    st = at.StructColumn((t.column("l_returnflag"), t.column("l_linestatus")),
                         (rdt.Field("f", t.column("l_returnflag").dtype),
                          rdt.Field("s", t.column("l_linestatus").dtype)),
                         None)
    kt = at.Table.from_pydict({"k": st, "v": lin})
    check_table(
        pg.group_by(port_table(kt), ["k"], [pg.AggSpec("v", "count_all")]),
        rg.group_by(kt, ["k"], [rg.AggSpec("v", "count_all")]))
    check_table(ps.sort_table(port_table(kt), [("k", _popt(
        (False, True)))]), rs.sort_table(kt, [("k", _ropt((False, True)))]))
    lst = key_col("list<int64>")
    assert _indices(ps.sort_to_indices(port_column(lst))) == \
        _indices(rs.sort_to_indices(lst))


def test_phase28_cpu_route_takes_the_first_rows(monkeypatch):
    """chip_smoke.py's phase 28 at 20,000 rows (2,000 for the host-ranked
    keys and text casts) with the CUDA calls stubbed and each plain
    kernel call counted as a launch: its full-size calls pass their
    independent checks, and its CPU route holds each call over the first
    5,000 rows of its inputs (500 for the host calls) to the same call
    on CPU copies."""
    from arrow_tpu_torch.core.column import Column
    from arrow_tpu_torch.core.table import Table
    from test_torch_tpch_strings import _chip_smoke
    chip = _chip_smoke()
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip, "time_ms", lambda fn, reps=5: (fn(), 0.0)[1])
    monkeypatch.setattr(chip, "once_ms", lambda fn: (fn(), 0.0))
    monkeypatch.setattr(chip, "kernel_ms", lambda *a, **k: None)
    for name, value in (("P28_ROWS", 20_000), ("P28_HOST_ROWS", 2_000),
                        ("CONFIG2_ROWS", 20_000), ("P28_CPU_ROWS", 5_000),
                        ("P28_CPU_HOST_ROWS", 500)):
        monkeypatch.setattr(chip, name, value)
    for mod, plain, wrapper in ((kc, "compact_plain", kc.compact),
                                (kg, "grouped_aggregate_plain",
                                 kg.grouped_aggregate)):
        def counted(*args, real=getattr(mod, plain), wrapper=wrapper,
                    **kwargs):
            wrapper.launches += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(mod, plain, counted)
    entries, checks = chip.run_phase28(torch.device("cpu"), False)
    assert len(entries) == 5 and len(checks) == 25
    for what, _, args in checks:
        rows = 500 if "(2,000 rows)" in what else 5_000
        assert what.endswith(f"first {rows:,} rows"), what
        for a in args:
            n = a.num_rows if isinstance(a, Table) else \
                len(a) if isinstance(a, Column) else None
            assert n in (None, rows), what
    chip.check_against_cpu(checks)


def pdt_table(cols):
    from arrow_tpu_torch.core.table import Table
    return Table(list(cols.values()), pdt.Schema(tuple(
        pdt.Field(k, c.dtype) for k, c in cols.items())))


# ---- the kernels at the new call sites (on the card) ------------------------

def test_decimal_group_by_and_rank_launch_k1_and_k2(cuda_device):
    """On the card, the (discount, tax) group-by takes the sort plan: K1
    at its run starts, K2 for the min and max of l_shipdate over its
    groups; rank of a decimal launches K1; both equal the CPU route."""
    t, _ = lineitem(20_000)
    host = port_table(t)
    card = port_table(t, cuda_device)
    aggs = [pg.AggSpec("l_shipdate", "min"), pg.AggSpec("l_shipdate", "max"),
            pg.AggSpec("l_linenumber", "count_all")]
    k1, k2 = kc.compact.launches, kg.grouped_aggregate.launches
    got = pg.group_by(card, ["l_discount", "l_tax"], aggs)
    torch.cuda.synchronize()
    assert kc.compact.launches > k1 and kg.grouped_aggregate.launches > k2
    want = pg.group_by(host, ["l_discount", "l_tax"], aggs)
    for g, w in zip(got.columns, want.columns):
        assert storage_list(g) == storage_list(w) if isinstance(
            w, PrimitiveColumn) else g.to_pylist() == w.to_pylist()
    k1 = kc.compact.launches
    r = ps.rank(card.column("l_extendedprice"))
    torch.cuda.synchronize()
    assert kc.compact.launches > k1
    assert r.cpu().tolist() == ps.rank(host.column("l_extendedprice")
                                       ).tolist()


# ---- the reference's own cases (tests/test_sort.py, test_extended_types.py)

def test_row_format_varlen_strings_layout():
    """arrow-row's string cells (variable.rs:28-100; test_sort.py:202-237):
    'hello' is 0x02, the bytes, zeros and the token 0x06; an empty string
    0x01; a null 0x00; a 40-byte string continues its first block (0xFF)
    and ends with 9; the rows order as the strings, nulls first, and come
    back as they were; the reference's bytes, bit for bit."""
    vals = ["hello", "", None, "hell", "a" * 40, "a" * 32, "b", None, "az"]
    for opt in OPTIONS:
        ref = at.column(vals)
        rrows = rf.RowConverter([rf.SortField(_ropt(opt))]) \
            .convert_columns([ref])
        conv = pf.RowConverter([pf.SortField(_popt(opt))])
        rows = conv.convert_columns([port_column(ref)])
        assert np.array_equal(rows.to_numpy(), np.asarray(rrows.data))
        assert _ranks(rows.argsort()) == _ranks(rrows.argsort())
        back, = conv.convert_rows(rows, [port_column(ref)])
        assert back.to_pylist() == vals
    r = pf.RowConverter([pf.SortField()]).convert_columns(
        [port_column(at.column(vals))]).to_numpy()
    assert r[0][0] == 0x02 and bytes(r[0][1:6]) == b"hello"
    assert (r[0][6:33] == 0).all() and r[0][33] == 0x06
    assert r[1][0] == 0x01 and r[2][0] == 0x00
    assert r[4][33] == 0xFF and r[4][66] == 9


NESTED_GOLDENS = {
    "map": (pa.array([[("b", 2)], None, [("a", 1)], []],
                     pa.map_(pa.string(), pa.int64())),
            [None, [], [("a", 1)], [("b", 2)]]),
    "list of maps": (pa.array([[[("a", 1)]], None, [[("b", 2)], [("a", 1)]],
                               []],
                              pa.list_(pa.map_(pa.string(), pa.int64()))),
                     [None, [], [[("a", 1)]], [[("b", 2)], [("a", 1)]]]),
    "run-end": (pa.RunEndEncodedArray.from_arrays(
        pa.array([2, 4, 6], pa.int32()), pa.array([30, 10, 20], pa.int64())),
        [10, 10, 20, 20, 30, 30]),
}


@pytest.mark.parametrize("name", list(NESTED_GOLDENS))
def test_sort_nested_goldens(name):
    """test_sort.py:470-481 and test_extended_types.py:295-300: maps by
    their entries, maps inside lists, a run-end column by its rows."""
    arr, want = NESTED_GOLDENS[name]
    ref = at.column(arr)
    got = ps.sort(port_column(ref))
    assert got.to_pylist() == want
    check_col(got, rs.sort(ref), name)


def test_sort_table_mixed_nested_key():
    """A decodable key first and a list key second (test_sort.py:429)."""
    t = at.Table.from_pydict({
        "k": [2, 1, 2, 1],
        "n": at.column([[1], [2], None, [0]], rdt.list_(rdt.int64))})
    got = ps.sort_table(port_table(t), [("k", pf.SortOptions()),
                                        ("n", pf.SortOptions())])
    assert got.to_pydict() == {"k": [1, 1, 2, 2],
                               "n": [[0], [2], None, [1]]}
    check_table(got, rs.sort_table(t, [("k", rf.SortOptions()),
                                       ("n", rf.SortOptions())]))


def test_make_comparator_goldens():
    """test_sort.py:440-495: list prefixes, nulls first, struct fields,
    and string ranks over both arrays ('b' against 'b' is 0)."""
    a = at.column([[1, 2], None, [5]], rdt.list_(rdt.int64))
    b = at.column([[1, 2, 0], [0]], rdt.list_(rdt.int64))
    cmp = pord.make_comparator(port_column(a), port_column(b))
    assert (cmp(0, 0), cmp(2, 1), cmp(1, 0)) == (-1, 1, -1)
    s = rdt.struct([rdt.Field("x", rdt.int64)])
    c2 = pord.make_comparator(port_column(at.column([{"x": 3}], s)),
                              port_column(at.column([{"x": 3}, {"x": 9}],
                                                    s)))
    assert (c2(0, 0), c2(0, 1)) == (0, -1)
    c3 = pord.make_comparator(port_column(at.column(["b", "z"])),
                              port_column(at.column(["a", "b"])))
    assert (c3(0, 1), c3(0, 0), c3(1, 1), c3(1, 0)) == (0, 1, 1, 1)
