"""Parity of the port's cast, comparison, string-predicate and boolean
kernels (arrow_tpu_torch/ops/{cast,cmp,strings,boolean}.py) with the
JAX package on the CPU, bit for bit (tolerance 0): values, validity,
dtype, and the presence of a validity mask where the reference's
contract fixes it.  Config 2's pipeline (bench.py:172-202) runs on both
at 4,096 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.core.datum import Scalar as RScalar
from arrow_tpu.ops import boolean as rbool, cmp as rcmp
from arrow_tpu.ops.cast import CastOptions as RCastOptions, can_cast as \
    rcan_cast, cast as rcast
from arrow_tpu.ops.filter import filter_table as rfilter_table
from arrow_tpu_torch import dtypes as pdt, errors as perr
from arrow_tpu_torch.core.column import NullColumn, StringColumn
from arrow_tpu_torch.ops import boolean as pbool, cmp as pcmp
from arrow_tpu_torch.ops.cast import CastOptions, can_cast, cast
from arrow_tpu_torch.ops.filter import filter_table
from torch_port_util import (assert_columns_equal, assert_tables_equal,
                             port_column, port_datum, port_dtype,
                             port_table, same_outcome)

rdt = at.dtypes

NUMERIC = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
           "uint64", "float16", "float32", "float64"]
TEMPORAL = {"date32": rdt.date32, "date64": rdt.date64,
            **{f"timestamp[{u}]": rdt.timestamp(u)
               for u in ("s", "ms", "us", "ns")},
            "time32[s]": rdt.time32("s"), "time32[ms]": rdt.time32("ms"),
            "time64[us]": rdt.time64("us"), "time64[ns]": rdt.time64("ns"),
            **{f"duration[{u}]": rdt.duration(u)
               for u in ("s", "ms", "us", "ns")}}
TYPES = {**{n: getattr(rdt, n) for n in NUMERIC}, "bool": rdt.bool_,
         **TEMPORAL}

FLOAT_EDGES = [2.0 ** 63, -2.0 ** 63, 2.0 ** 64, 2.0 ** 63 + 2048, 1e300,
               -1e300, np.nan, np.inf, -np.inf, -0.0, 0.0, 0.5, -0.5,
               127.9, 128.0, -128.9, -129.0, 255.5, 256.0, 32767.5, 32768.0,
               -32769.0, 65535.9, 65536.0, 2.0 ** 31 - 0.5, 2.0 ** 31,
               -2.0 ** 31 - 1, 2.0 ** 32 - 1, 2.0 ** 32, 2.0 ** 53 + 2,
               1 + 2.0 ** -11 + 2.0 ** -40, 65519.99, 65520.0, 1e-8,
               2.0 ** -24, 2.0 ** -25 + 2.0 ** -40, 3.4e38, 3.5e38, 1e-46]
INT_EDGES = [0, 1, -1, 127, 128, -128, -129, 255, 256, 32767, 32768,
             -32768, -32769, 65535, 65536, 2 ** 31 - 1, 2 ** 31, -2 ** 31,
             -2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32, 2 ** 53 + 1, 2 ** 63 - 1,
             -2 ** 63, 2 ** 63, 2 ** 63 + 1, 2 ** 63 + 2 ** 40 + 1,
             2 ** 64 - 1, 9223372036854776, -9223372036854776,
             9223372036854775, -9223372036854775, 9223372036854, -86400001]


def values_of(name, rng, n=64):
    """Edge values of a type's storage, then random ones."""
    d = TYPES[name]
    store = np.dtype(d.to_jax())
    if store == bool:
        return rng.random(n + 8) < 0.5
    if store.kind == "f":
        with np.errstate(over="ignore"):
            edges = np.array(FLOAT_EDGES).astype(store)
            rand = (rng.standard_normal(n) *
                    10.0 ** rng.integers(-3, 12, n)).astype(store)
        return np.concatenate([edges, rand])
    info = np.iinfo(store)
    edges = np.array([v for v in INT_EDGES if info.min <= v <= info.max],
                     dtype=object).astype(store)
    rand = rng.integers(info.min, info.max, n, dtype=store, endpoint=True)
    return np.concatenate([edges, rand])


def ref_column(name, rng, nulls):
    vals = values_of(name, rng)
    valid = rng.random(len(vals)) >= 0.15 if nulls else None
    return at.PrimitiveColumn(jnp.asarray(vals), TYPES[name],
                              None if valid is None else jnp.asarray(valid))


# ---- cast ----------------------------------------------------------------

PAIRS = [(a, b) for a in TYPES for b in TYPES if a != b]


@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
@pytest.mark.parametrize("src,dst", PAIRS)
def test_cast_matrix(src, dst, nulls):
    """Every pair of numeric, bool and temporal types, safe and unsafe:
    the edge values above (+-2**63, 2**64, NaN, +-inf, -0.0, each width's
    bounds, float16's rounding ties, temporal rescale overflow)."""
    col = ref_column(src, np.random.default_rng(len(src) * 31 + len(dst)),
                     nulls)
    pcol = port_column(col)
    for safe in (True, False):
        same_outcome(
            lambda: cast(pcol, port_dtype(TYPES[dst]), CastOptions(safe)),
            lambda: rcast(col, TYPES[dst], RCastOptions(safe)),
            f"{src}->{dst} safe={safe}", masks=True)


def test_float_to_int64_saturates_at_2_pow_63():
    """float(2**63 - 1) is 2**63, so 2**63 passes the bound and the
    reference's conversion saturates; torch's own would wrap."""
    col = at.column([2.0 ** 63, -2.0 ** 63, 2.0 ** 63 + 2048, 1.5])
    for to, want in ((rdt.int64, [2 ** 63 - 1, -2 ** 63, None, 1]),
                     (rdt.uint64, [2 ** 63, None, 2 ** 63 + 2048, 1])):
        got = cast(port_column(col), port_dtype(to))
        assert got.to_pylist() == want
        assert_columns_equal(got, rcast(col, to), repr(to))
    top = at.column([2.0 ** 64, 2.0 ** 64 - 4096])
    got = cast(port_column(top), pdt.uint64)
    assert got.to_pylist() == [2 ** 64 - 1, 2 ** 64 - 4096]
    assert_columns_equal(got, rcast(top, rdt.uint64))


@pytest.mark.parametrize("to", ["float64", "float32", "float16"])
def test_uint64_to_float_rounds_once(to):
    """uint64 bits on int64 storage: a million random values (the naive
    signed conversion differs on about half of them)."""
    u = np.random.default_rng(5).integers(0, 2 ** 64 - 1, 1_000_000,
                                          dtype=np.uint64, endpoint=True)
    col = at.column(u)
    got = cast(port_column(col), getattr(pdt, to))
    want = rcast(col, getattr(rdt, to))
    assert np.array_equal(got.values.numpy().view(f"u{got.values.element_size()}"),
                          np.asarray(want.values).view(
                              f"u{got.values.element_size()}"))


def test_float64_to_float16_rounds_once():
    """torch goes through float32 (two roundings); the port rounds to odd
    first, as the reference's single conversion rounds."""
    v = np.random.default_rng(6).standard_normal(200_000) * \
        10.0 ** np.random.default_rng(7).integers(-9, 6, 200_000)
    v[:4] = [1 + 2.0 ** -11 + 2.0 ** -40, -(1 + 2.0 ** -11 + 2.0 ** -40),
             2049 + 2.0 ** -30, 65519.99]
    col = at.column(v)
    got = cast(port_column(col), pdt.float16)
    want = np.asarray(rcast(col, rdt.float16).values)
    assert np.array_equal(got.values.numpy().view(np.uint16),
                          want.view(np.uint16))


def test_temporal_rescale_overflow_and_floor():
    """x1000 overflows to null (safe) or raises (unsafe); us -> s floors
    toward -inf."""
    ts = at.PrimitiveColumn(jnp.asarray(np.array(
        [9223372036854775, 9223372036854776, -9223372036854775,
         -9223372036854776, -1, -1_000_001, 1_999_999], np.int64)),
        rdt.timestamp("us"))
    p = port_column(ts)
    assert_columns_equal(cast(p, pdt.timestamp("ns")),
                         rcast(ts, rdt.timestamp("ns")), masks=True)
    got = cast(p, pdt.timestamp("s"))
    assert got.values.tolist()[4:] == [-1, -2, 1]
    assert_columns_equal(got, rcast(ts, rdt.timestamp("s")), masks=True)
    with pytest.raises(perr.CastError):
        cast(p, pdt.timestamp("ns"), CastOptions(safe=False))


def _dict_ref(codes, values, valid=None, index=np.int32):
    vals = at.column(values) if not isinstance(values, at.Column) else values
    return at.DictionaryColumn(jnp.asarray(np.asarray(codes, index)), vals,
                               None if valid is None
                               else jnp.asarray(np.asarray(valid)))


DICT_CASTS = {
    "utf8 narrow int8": (lambda: _dict_ref(
        np.arange(300) % 200, [f"w{i}" for i in range(200)],
        np.arange(300) % 7 != 0), rdt.dictionary(rdt.int8, rdt.utf8)),
    "utf8 widen int64": (lambda: _dict_ref(
        [0, 2, 1, 2], ["a", None, "c"]), rdt.dictionary(rdt.int64, rdt.utf8)),
    "int64 values -> float64": (lambda: _dict_ref(
        [0, 1, 2, 1, 0], at.column([5, None, -7])),
        rdt.dictionary(rdt.int16, rdt.float64)),
    "float values -> int8": (lambda: _dict_ref(
        [0, 1, 2, 3], at.column([1.5, 300.0, np.nan, -2.0])),
        rdt.dictionary(rdt.int32, rdt.int8)),
    "unpack utf8": (lambda: _dict_ref(
        [1, 0, 2, 1], ["x", "y", None], [True, True, True, False]),
        rdt.utf8),
    "unpack int64 -> float32": (lambda: _dict_ref(
        [1, 0, 2, 1], at.column([3, None, 2 ** 40]),
        [True, False, True, True]), rdt.float32),
    "unpack to bool": (lambda: _dict_ref(
        [1, 0, 1], at.column([0, 9])), rdt.bool_),
}


@pytest.mark.parametrize("name", list(DICT_CASTS))
def test_dictionary_casts(name):
    make, to = DICT_CASTS[name]
    ref = make()
    port = port_column(ref)
    for safe in (True, False):
        same_outcome(lambda: cast(port, port_dtype(to), CastOptions(safe)),
                     lambda: rcast(ref, to, RCastOptions(safe)),
                     f"{name} safe={safe}")


@pytest.mark.parametrize("to", [rdt.int32, rdt.float64, rdt.bool_,
                                rdt.timestamp("ms"), rdt.null,
                                rdt.dictionary(rdt.int32, rdt.utf8)],
                         ids=repr)
def test_null_column_casts(to):
    ref = at.NullColumn(5)
    got = cast(NullColumn(5, "cpu"), port_dtype(to))
    want = rcast(ref, to)
    assert repr(got.dtype) == repr(want.dtype)
    assert got.to_pylist() == want.to_pylist() == [None] * 5
    assert cast(port_column(at.column([1, 2])), pdt.null).to_pylist() == \
        rcast(at.column([1, 2]), rdt.null).to_pylist()


CAN_CAST_TYPES = {**TYPES, "null": rdt.null, "utf8": rdt.utf8,
                  "interval[year_month]": rdt.interval("year_month"),
                  "interval[day_time]": rdt.interval("day_time"),
                  "dict<int32,utf8>": rdt.dictionary(rdt.int32, rdt.utf8),
                  "dict<int8,int64>": rdt.dictionary(rdt.int8, rdt.int64),
                  "dict<int16,float32>": rdt.dictionary(rdt.int16,
                                                        rdt.float32)}


@pytest.mark.parametrize("src", list(CAN_CAST_TYPES))
def test_can_cast_matrix(src):
    """can_cast from one type to every type of the port, against the
    reference (logic on dtypes alone)."""
    f = CAN_CAST_TYPES[src]
    for name, t in CAN_CAST_TYPES.items():
        assert can_cast(port_dtype(f), port_dtype(t)) == rcan_cast(f, t), \
            (src, name)


def test_unsupported_families_raise():
    """int64 -> utf8 answers as the reference does (ROADMAP A7.7, the
    text casts); int64 -> interval[year_month] stays outside the
    reference's interval matrix, and both raise
    ArrowNotImplementedError."""
    ref = at.column([1, 2])
    col = port_column(ref)
    assert_columns_equal(cast(col, pdt.utf8), rcast(ref, rdt.utf8),
                         masks=True)
    with pytest.raises(perr.ArrowNotImplementedError):
        cast(col, pdt.interval("year_month"))
    with pytest.raises(Exception) as want:
        rcast(ref, rdt.interval("year_month"))
    assert type(want.value).__name__ == "ArrowNotImplementedError"


# ---- comparisons -----------------------------------------------------------

CMP_TYPES = NUMERIC + ["bool", "date32", "timestamp[us]", "duration[ns]",
                       "time64[ns]"]
CMP_OPS = ["eq", "neq", "lt", "lt_eq", "gt", "gt_eq", "distinct",
           "not_distinct"]
FORMS = ["col_col", "col_scalar", "scalar_col", "col_null_scalar"]


def _cmp_inputs(name, form, rng):
    a = ref_column(name, rng, True)
    n = len(a)
    b_vals = np.asarray(a.values)[rng.permutation(n)]
    b = at.PrimitiveColumn(jnp.asarray(b_vals), a.dtype,
                           jnp.asarray(rng.random(n) >= 0.15))
    s = RScalar(jnp.asarray(np.asarray(a.values)[5]), a.dtype)
    if form == "col_col":
        return a, b
    if form == "col_scalar":
        return a, s
    if form == "scalar_col":
        return s, a
    return a, RScalar(0, a.dtype, valid=False)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("op", CMP_OPS)
@pytest.mark.parametrize("name", CMP_TYPES)
def test_compare(name, op, form):
    """Every comparison against a column and a scalar, on both sides
    (unsigned values above 2**63 and NaNs included)."""
    lhs, rhs = _cmp_inputs(name, form, np.random.default_rng(len(name)))
    same_outcome(lambda: getattr(pcmp, op)(port_datum(lhs), port_datum(rhs)),
                 lambda: getattr(rcmp, op)(lhs, rhs), f"{name} {op} {form}",
                 masks=True)


@pytest.mark.parametrize("pair", [("int32", "uint32"), ("int64", "float64"),
                                  ("timestamp[us]", "int64"),
                                  ("timestamp[us]", "timestamp[ns]")])
def test_compare_type_mismatch_raises(pair):
    rng = np.random.default_rng(1)
    a, b = (ref_column(p, rng, False) for p in pair)
    b = at.PrimitiveColumn(b.values[:len(a)], b.dtype)
    a = at.PrimitiveColumn(a.values[:len(b)], a.dtype)
    same_outcome(lambda: pcmp.lt(port_column(a), port_column(b)),
                 lambda: rcmp.lt(a, b), str(pair))


WORDS = ["word-0042", "apple", "", "zeta", "Word-0042", "word-0041",
         "été", "word-00420"]
DICTS = {
    "plain": lambda: _dict_ref(np.arange(40) % 8, WORDS),
    "null entries and rows": lambda: _dict_ref(
        np.arange(40) % 9, WORDS + [None], np.arange(40) % 5 != 3),
}
LITERALS = {"str": "word-0042", "bytes": b"apple",
            "null": RScalar(jnp.zeros((), jnp.int32), rdt.utf8, valid=False)}


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("lit", list(LITERALS))
@pytest.mark.parametrize("op", CMP_OPS[:6])
@pytest.mark.parametrize("kind", list(DICTS))
def test_dictionary_predicate(kind, op, lit, side):
    """eq(dict_col, "word-0042") and friends: one evaluation per
    dictionary value, gathered by code; a raw str passes through; a null
    literal gives an all-null result."""
    ref = DICTS[kind]()
    port = port_column(ref)
    r_lit = LITERALS[lit]
    p_lit = att.Scalar(None, pdt.utf8, valid=False) if lit == "null" \
        else r_lit
    args = ((port, p_lit), (ref, r_lit)) if side == "left" \
        else ((p_lit, port), (r_lit, ref))
    same_outcome(lambda: getattr(pcmp, op)(*args[0]),
                 lambda: getattr(rcmp, op)(*args[1]), f"{kind} {op}")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("op", CMP_OPS[:6])
def test_string_column_predicate(op, side):
    vals = ["b", None, "a", "word-0042", "", "é", "word-00420"]
    ref = at.column(vals)
    port = StringColumn.from_pylist(vals, device="cpu")
    args = ((port, "word-0042"), (ref, "word-0042")) if side == "left" \
        else (("word-0042", port), ("word-0042", ref))
    same_outcome(lambda: getattr(pcmp, op)(*args[0]),
                 lambda: getattr(rcmp, op)(*args[1]), op)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "merged"])
@pytest.mark.parametrize("op", CMP_OPS[:6])
def test_dictionary_against_dictionary(op, shared):
    a = _dict_ref(np.arange(30) % 8, WORDS, np.arange(30) % 4 != 1)
    b = _dict_ref((np.arange(30) * 7) % 8, WORDS) if shared else \
        _dict_ref(np.arange(30) % 5, ["zeta", None, "apple", "b", "word-0042"])
    same_outcome(lambda: getattr(pcmp, op)(port_column(a), port_column(b)),
                 lambda: getattr(rcmp, op)(a, b), op)


# ---- boolean -----------------------------------------------------------------

TRUTH = [True, True, True, False, False, False, None, None, None]
TRUTH_R = [True, False, None] * 3


@pytest.mark.parametrize("rhs", ["col", "true", "false", "null"])
@pytest.mark.parametrize("fn", ["and_", "or_", "and_kleene", "or_kleene"])
def test_boolean_truth_tables(fn, rhs):
    """All nine (left, right) pairs, against a column and each scalar on
    both sides; the Kleene variants always return a mask."""
    a = at.column(TRUTH)
    b = {"col": at.column(TRUTH_R), "true": RScalar(True, rdt.bool_),
         "false": RScalar(False, rdt.bool_),
         "null": RScalar(False, rdt.bool_, valid=False)}[rhs]
    for l, r in ((a, b), (b, a)):
        if isinstance(l, RScalar) and isinstance(r, RScalar):
            continue
        same_outcome(lambda: getattr(pbool, fn)(port_datum(l), port_datum(r)),
                     lambda: getattr(rbool, fn)(l, r), f"{fn} {rhs}",
                     masks=True)


@pytest.mark.parametrize("fn", ["not_", "is_null", "is_not_null"])
@pytest.mark.parametrize("vals", [TRUTH, [True, False]], ids=["nulls", "dense"])
def test_boolean_unary(fn, vals):
    a = at.column(vals)
    same_outcome(lambda: getattr(pbool, fn)(port_column(a)),
                 lambda: getattr(rbool, fn)(a), fn, masks=True)


def test_boolean_rejects_other_types():
    a = port_column(at.column([1, 2]))
    with pytest.raises(perr.ArrowTypeError):
        pbool.and_(a, a)


# ---- config 2 -----------------------------------------------------------------

N2 = 4096


def config2_inputs(n=N2):
    """bench.py:181-193's generator at n rows."""
    rng = np.random.default_rng(1)
    i32 = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    valid = rng.random(n) > 0.1
    ts = rng.integers(0, 2 ** 40, n)
    codes = rng.integers(0, 1000, n).astype(np.int32)
    words = [f"word-{i:04d}" for i in range(1000)]
    ref = (at.PrimitiveColumn(jnp.asarray(i32), rdt.int32,
                              jnp.asarray(valid)),
           at.PrimitiveColumn(jnp.asarray(ts), rdt.timestamp("us")),
           at.DictionaryColumn(jnp.asarray(codes),
                               at.StringColumn.from_pylist(words)))
    return ref, tuple(port_column(c) for c in ref)


def config2_run(ops, d, i32, ts, dcol):
    """bench.py's config-2 run(): three casts and three comparisons."""
    a = ops["cast"](i32, d.int64)
    b = ops["cast"](i32, d.float64)
    c = ops["cast"](ts, d.timestamp("ns"))
    return (ops["lt"](b, ops["cast"](a, d.float64)),
            ops["eq"](dcol, "word-0042"), ops["gt_eq"](c, c))


PORT_OPS = {"cast": cast, "lt": pcmp.lt, "eq": pcmp.eq, "gt_eq": pcmp.gt_eq}
REF_OPS = {"cast": rcast, "lt": rcmp.lt, "eq": rcmp.eq, "gt_eq": rcmp.gt_eq}


def test_config2_run_matches_reference():
    ref, port = config2_inputs()
    got = config2_run(PORT_OPS, pdt, *port)
    want = config2_run(REF_OPS, rdt, *ref)
    for g, w, name in zip(got, want, ("m1", "m2", "m3")):
        assert_columns_equal(g, w, name, masks=True)
    valid = np.asarray(ref[0].validity)
    assert not got[0].values.any()
    assert np.array_equal(got[0].validity.numpy(), valid)
    assert np.array_equal(got[1].values.numpy(), np.asarray(ref[2].codes) == 42)
    assert bool(got[2].values.all()) and bool(got[2].validity.all())


def test_config2_where_query_matches_reference():
    """WHERE (m1 OR m4) AND m2 AND m3 with Kleene logic, filtered through
    filter_table: the same rows as the reference and as numpy."""
    ref, port = config2_inputs()
    rm1, rm2, rm3 = config2_run(REF_OPS, rdt, *ref)
    pm1, pm2, pm3 = config2_run(PORT_OPS, pdt, *port)
    rm4 = rcmp.gt_eq(rcast(ref[0], rdt.int64), RScalar(0, rdt.int64))
    pm4 = pcmp.gt_eq(cast(port[0], pdt.int64), att.Scalar(0, pdt.int64))
    rkeep = rbool.and_kleene(rbool.and_kleene(rbool.or_kleene(rm1, rm4), rm2),
                             rm3)
    pkeep = pbool.and_kleene(pbool.and_kleene(pbool.or_kleene(pm1, pm4), pm2),
                             pm3)
    assert_columns_equal(pkeep, rkeep, "keep", masks=True)
    rt = at.Table((ref[0], ref[1], ref[2]), rdt.Schema(tuple(
        rdt.Field(n, c.dtype) for n, c in zip("itd", ref))))
    got = filter_table(port_table(rt), pkeep)
    assert_tables_equal(got, rfilter_table(rt, rkeep))
    i32 = np.asarray(ref[0].values)
    want = np.asarray(ref[0].validity) & (i32 >= 0) & \
        (np.asarray(ref[2].codes) == 42)
    assert got.column("i").values.tolist() == i32[want].tolist()


# ---- core additions -------------------------------------------------------------

@pytest.mark.parametrize("masks", [(None, None), (True, None), (True, False)],
                         ids=["none", "one", "two"])
def test_intersect_all_and_valid_count(masks):
    from arrow_tpu.core import validity as rvd
    from arrow_tpu_torch.core import validity as pvd
    rng = np.random.default_rng(3)
    ms = [None if m is None else rng.random(50) > 0.3 for m in masks]
    want = rvd.intersect_all(*[None if m is None else jnp.asarray(m)
                               for m in ms])
    got = pvd.intersect_all(*[None if m is None else torch.from_numpy(m)
                              for m in ms])
    assert (got is None) == (want is None)
    if got is not None:
        assert got.tolist() == np.asarray(want).tolist()
    assert int(pvd.valid_count(got, 50)) == int(rvd.valid_count(want, 50))


@pytest.mark.parametrize("op", CMP_OPS[:6])
def test_temporal_scalar_from_a_python_value_broadcasts(op):
    """Scalar(t, timestamp("ns")) against a column of that type."""
    ts = at.PrimitiveColumn(jnp.asarray(np.array([5, -3, 7000, 12],
                                                 np.int64)),
                            rdt.timestamp("ns"),
                            jnp.asarray(np.array([True, True, False, True])))
    got = getattr(pcmp, op)(port_column(ts), att.Scalar(7000, pdt.timestamp(
        "ns")))
    want = getattr(rcmp, op)(ts, RScalar(7000, rdt.timestamp("ns")))
    assert_columns_equal(got, want, op, masks=True)
    assert att.Scalar(7000, pdt.timestamp("ns")).as_py() == 7000
