"""The port's elementwise compute and reductions against the JAX package
on the CPU: div, rem, neg and neg_wrapping (ops/numeric.py), the scalar
aggregates (ops/aggregate.py), the bitwise ops (ops/bitwise.py), zip_,
nullif and shift (ops/select_misc.py) and BatchCoalescer
(ops/coalesce.py).

Every comparison is bitwise: values (floats by their bits, so NaN
payloads and -0.0 count), validity, dtype and row order, and errors of
the same name (`same_outcome`).  No tolerance is needed: the only float
sums here are of values exact in any order.  Inputs come from a seed
through numpy, with the edge values planted: integer MIN / -1, zero
divisors on valid and on null slots, uint64 values past 2^63, shift
counts of -1, the width and the width + 1, NaN and -0.0; the reference
runs on both of its routes (the `route` fixture).
"""

import importlib

import numpy as np
import pytest

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.core.datum import Scalar as RScalar
from arrow_tpu_torch.core.column import NullColumn
from arrow_tpu_torch.errors import ArrowInvalid
from arrow_tpu_torch.ops import aggregate as pa, bitwise as pb
from arrow_tpu_torch.ops import numeric as pn, select_misc as psel
from arrow_tpu_torch.ops.coalesce import BatchCoalescer
from torch_port_util import (assert_same, assert_tables_equal,  # noqa: F401
                             cuda_device, port_column, port_datum,
                             port_table, rand_column, route, same_outcome,
                             storage_list)

rn = importlib.import_module("arrow_tpu.ops.numeric")
ragg = importlib.import_module("arrow_tpu.ops.aggregate")
rbit = importlib.import_module("arrow_tpu.ops.bitwise")
rsel = importlib.import_module("arrow_tpu.ops.select_misc")
rco = importlib.import_module("arrow_tpu.ops.coalesce")
rdt = at.dtypes
N = 400
INTS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
        "uint64"]
FLOATS = ["float16", "float32", "float64"]


def operands(rng, dtype, n=N, nulls=0.15):
    """(dividend, divisor) reference columns with MIN / -1, zero
    divisors on valid slots and zero divisors under nulls planted."""
    d = np.dtype(dtype)
    a = rand_column(rng, dtype, n, nulls=nulls)
    b_vals = np.asarray(rand_column(rng, dtype, n, nulls=0).values).copy()
    a_vals = np.asarray(a.values).copy()
    if d.kind == "i":
        a_vals[:4] = np.iinfo(d).min
        b_vals[:4] = -1
    if d.kind == "u":
        a_vals[4:8] = np.iinfo(d).max - np.arange(4, dtype=d)
        b_vals[4:6] = np.arange(2, dtype=d) + d.type(np.iinfo(d).max // 2 + 1)
    b_vals[8:12] = 0
    valid = np.asarray(a.validity) if a.validity is not None \
        else np.ones(n, bool)
    valid = valid.copy()
    return a_vals, valid, b_vals


def cols(a_vals, valid, b_vals):
    return (at.column(a_vals, validity=valid), at.column(b_vals))


def same_scalar(port_fn, ref_fn, what=""):
    """Both raise errors of one name, or return scalars of one type and
    value (floats by their bits)."""
    try:
        want = ref_fn()
    except Exception as e:
        with pytest.raises(Exception) as got:
            port_fn()
        assert type(got.value).__name__ == type(e).__name__, (what, got.value,
                                                             e)
        return
    got = port_fn()
    assert repr(got.dtype) == repr(want.dtype), (what, got.dtype, want.dtype)
    assert got.valid == want.valid, what
    assert_same(got.as_py(), want.as_py(), what)


# ---- div, rem, neg -------------------------------------------------------------

@pytest.mark.parametrize("op", ["div", "rem"])
@pytest.mark.parametrize("dtype", INTS)
def test_integer_div_and_rem_raise_like_rust(rng, route, op, dtype):
    """MIN / -1 and a valid zero divisor raise DivideByZero."""
    a_vals, valid, b_vals = operands(rng, dtype)
    valid[:12] = True
    a, b = cols(a_vals, valid, b_vals)
    same_outcome(lambda: getattr(pn, op)(port_column(a), port_column(b)),
                 lambda: getattr(rn, op)(a, b), f"{op} {dtype}")


@pytest.mark.parametrize("op", ["div", "rem"])
@pytest.mark.parametrize("dtype", INTS)
def test_integer_div_and_rem_values(rng, route, op, dtype):
    """The raising slots under nulls: truncated quotients, remainders of
    the dividend's sign, unsigned values past the signed range (uint64
    above 2^63 on both sides)."""
    a_vals, valid, b_vals = operands(rng, dtype)
    valid[:4] = False
    valid[8:12] = False
    a, b = cols(a_vals, valid, b_vals)
    same_outcome(lambda: getattr(pn, op)(port_column(a), port_column(b)),
                 lambda: getattr(rn, op)(a, b), f"{op} {dtype}", masks=True)


@pytest.mark.parametrize("side", ["scalar-divisor", "scalar-dividend"])
@pytest.mark.parametrize("dtype", ["int32", "uint64"])
def test_div_with_a_scalar(rng, side, dtype):
    a_vals, valid, b_vals = operands(rng, dtype)
    b_vals[b_vals == 0] = 3
    a, b = cols(a_vals, valid, b_vals)
    s = RScalar(7, getattr(rdt, dtype))
    ps_ = port_datum(s)
    if side == "scalar-divisor":
        same_outcome(lambda: pn.div(port_column(a), ps_),
                     lambda: rn.div(a, s), side)
    else:
        same_outcome(lambda: pn.rem(ps_, port_column(b)),
                     lambda: rn.rem(s, b), side)


@pytest.mark.parametrize("op", ["div", "rem"])
@pytest.mark.parametrize("dtype", FLOATS)
def test_float_div_and_rem(rng, route, op, dtype):
    """IEEE division (x / 0 is an infinity or NaN) and the truncated
    fmod, with NaN, infinities and -0.0 on both sides."""
    a = rand_column(rng, dtype, N)
    b = rand_column(rng, dtype, N, nulls=0)
    same_outcome(lambda: getattr(pn, op)(port_column(a), port_column(b)),
                 lambda: getattr(rn, op)(a, b), f"{op} {dtype}")


@pytest.mark.parametrize("dtype", INTS + FLOATS + ["bool"])
def test_neg_and_neg_wrapping(rng, route, dtype):
    """Signed MIN on a valid slot raises in neg and wraps in
    neg_wrapping; unsigned and bool cannot negate."""
    col = rand_column(rng, dtype, N)
    if np.dtype(dtype).kind == "i":
        v = np.asarray(col.values).copy()
        v[0] = np.iinfo(dtype).min
        raising = at.column(v)
        same_outcome(lambda: pn.neg(port_column(raising)),
                     lambda: rn.neg(raising), "neg MIN")
        masked = at.column(v, validity=np.arange(N) > 0)
        same_outcome(lambda: pn.neg(port_column(masked)),
                     lambda: rn.neg(masked), "neg MIN under null")
    same_outcome(lambda: pn.neg(port_column(col)), lambda: rn.neg(col),
                 "neg")
    same_outcome(lambda: pn.neg_wrapping(port_column(col)),
                 lambda: rn.neg_wrapping(col), "neg_wrapping")


@pytest.mark.parametrize("op", ["div", "rem", "neg"])
def test_temporal_arithmetic_waits_for_ops_temporal(op):
    """The temporal arms are ported with ops/temporal.py: timestamp
    division, remainder and negation raise the reference's type error
    (tests/test_torch_temporal.py holds the arms that compute)."""
    ref = at.column(np.arange(3), at.dtypes.timestamp("us"))
    ts = att.from_numpy(np.arange(3), dtype=att.dtypes.timestamp("us"),
                        device="cpu")
    same_outcome(lambda: pn.neg(ts) if op == "neg" else getattr(pn, op)(ts,
                                                                        ts),
                 lambda: rn.neg(ref) if op == "neg" else getattr(rn, op)(
                     ref, ref), op)


def test_checked_ops_wrap_inside_a_fused_region():
    """Inside `fuse` the flag is not read: MIN / -1 wraps to MIN and a
    zero divisor gives 0, as in the reference's jit."""
    from arrow_tpu_torch.config import fused_region
    a = att.from_numpy(np.array([-2 ** 31, 7, 9], np.int32), device="cpu")
    b = att.from_numpy(np.array([-1, 0, 2], np.int32), device="cpu")
    with fused_region():
        assert pn.div(a, b).to_pylist() == [-2 ** 31, 0, 4]
        assert pn.rem(a, b).to_pylist() == [0, 0, 1]


# ---- aggregates ------------------------------------------------------------------

AGGS = ["sum_checked", "min_", "max_", "count_nulls", "bit_and", "bit_or",
        "bit_xor", "bool_and", "bool_or"]


def _agg(mod, name, col):
    out = getattr(mod, name)(col)
    return out if not isinstance(out, int) else att.Scalar(out,
                                                           att.dtypes.int64)


@pytest.mark.parametrize("name", AGGS)
@pytest.mark.parametrize("dtype", INTS + FLOATS + ["bool"])
def test_scalar_aggregates(rng, route, dtype, name):
    """Every aggregate over every primitive type: non-integer sums, bit
    reductions of floats and bool_* of numbers raise alike."""
    col = rand_column(rng, dtype, N)
    if name == "count_nulls":
        assert pa.count_nulls(port_column(col)) == ragg.count_nulls(col)
        return
    same_scalar(lambda: getattr(pa, name)(port_column(col)),
                lambda: getattr(ragg, name)(col), f"{name} {dtype}")


@pytest.mark.parametrize("case", ["empty", "all-null", "one", "nan-only",
                                  "zeros"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int64"])
def test_min_max_edges(case, dtype):
    """NaN sorts above everything, -0.0 below +0.0; empty and all-null
    columns give null scalars."""
    vals = {"empty": [], "all-null": [1, 2], "one": [3],
            "nan-only": [np.nan, np.nan], "zeros": [0.0, -0.0, 0.0]}[case]
    vals = np.asarray(vals, dtype) if dtype != "int64" or case not in (
        "nan-only", "zeros") else np.asarray([0, -1], dtype)
    valid = np.zeros(len(vals), bool) if case == "all-null" else None
    col = at.column(vals, validity=valid)
    for name in ("min_", "max_"):
        same_scalar(lambda: getattr(pa, name)(port_column(col)),
                    lambda: getattr(ragg, name)(col), f"{name} {case}")
    got, want = pa.min_max(port_column(col)), ragg.min_max(col)
    assert [g.as_py() is None for g in got] == \
        [w.as_py() is None for w in want]


def test_min_max_of_strings_and_dictionaries(rng):
    """Strings by their bytes; a dictionary by its values' ranks, a null
    value slot skipped."""
    words = ["b", "", "é", "a\x00", "a", None]
    pick = rng.integers(0, len(words), 60)
    s = at.column([words[i] for i in pick], rdt.utf8)
    d = at.DictionaryColumn(np.asarray(pick % 5, np.int32),
                            at.column(["q", None, "b", "zz", "b"]),
                            np.asarray(rng.random(60) > 0.2))
    for col in (s, d, s.slice(0, 0)):
        for name in ("min_", "max_"):
            same_scalar(lambda: getattr(pa, name)(port_column(col)),
                        lambda: getattr(ragg, name)(col), name)


@pytest.mark.parametrize("dtype", INTS)
def test_sum_checked_overflow(dtype):
    """A sum one past the type's range raises; one inside returns."""
    info = np.iinfo(dtype)
    over = np.array([info.max, 1] if info.min == 0 else [info.min, -1],
                    dtype)
    fits = np.array([info.max, 0], dtype)
    for vals in (over, fits):
        col = at.column(vals)
        same_scalar(lambda: pa.sum_checked(port_column(col)),
                    lambda: ragg.sum_checked(col), dtype)


def test_sum_checked_of_many_large_int64():
    col = at.column(np.full(5000, 2 ** 62 // 5000, np.int64) *
                    np.where(np.arange(5000) % 2, 1, -1))
    same_scalar(lambda: pa.sum_checked(port_column(col)),
                lambda: ragg.sum_checked(col))


# ---- bitwise ---------------------------------------------------------------------

@pytest.mark.parametrize("op", ["bitwise_and", "bitwise_or", "bitwise_xor"])
@pytest.mark.parametrize("dtype", INTS + ["bool", "float32"])
def test_bitwise_binary(rng, route, op, dtype):
    a, b = rand_column(rng, dtype, N), rand_column(rng, dtype, N)
    same_outcome(lambda: getattr(pb, op)(port_column(a), port_column(b)),
                 lambda: getattr(rbit, op)(a, b), op)


@pytest.mark.parametrize("dtype", INTS + ["bool", "float64"])
def test_bitwise_not(rng, dtype):
    a = rand_column(rng, dtype, N)
    same_outcome(lambda: pb.bitwise_not(port_column(a)),
                 lambda: rbit.bitwise_not(a), "not")


@pytest.mark.parametrize("op", ["bitwise_shift_left", "bitwise_shift_right"])
@pytest.mark.parametrize("dtype", INTS + ["bool", "float32"])
def test_shifts_by_any_count(rng, route, op, dtype):
    """Counts modulo the width: -1, 0, the width, the width + 1 and the
    whole range of the type."""
    a = rand_column(rng, dtype, N)
    d = np.dtype(dtype)
    if d.kind in "iu":
        width = 8 * d.itemsize
        counts = np.asarray(rand_column(rng, dtype, N, nulls=0).values).copy()
        counts[:5] = np.array([-1, 0, width, width + 1, width - 1]
                              ).astype(np.int64).astype(d)
        b = at.column(counts)
    else:
        b = rand_column(rng, dtype, N)
    same_outcome(lambda: getattr(pb, op)(port_column(a), port_column(b)),
                 lambda: getattr(rbit, op)(a, b), op, masks=True)


# ---- zip, nullif, shift --------------------------------------------------------

def layout_columns(rng, layout, n=60):
    """Two reference columns of one layout and type."""
    if layout == "primitive":
        return rand_column(rng, "float32", n), rand_column(rng, "float32", n)
    if layout == "string":
        w = ["", "a", "é", None, "日本"]
        return tuple(at.column([w[i] for i in rng.integers(0, 5, n)],
                               rdt.utf8) for _ in range(2))
    if layout == "dictionary":
        vals = at.column(["x", "y", None])
        return tuple(at.DictionaryColumn(
            rng.integers(0, 3, n).astype(np.int32), vals,
            rng.random(n) > 0.2) for _ in range(2))
    if layout == "dictionary-differ":
        return tuple(at.DictionaryColumn(
            rng.integers(0, 2, n).astype(np.int32), at.column(v))
            for v in (["x", "y"], ["y", "q"]))
    return at.NullColumn(n), at.NullColumn(n)


LAYOUTS = ["primitive", "string", "dictionary", "dictionary-differ", "null"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_zip(rng, route, layout):
    """A null mask slot takes the falsy side."""
    t, f = layout_columns(rng, layout)
    mask = rand_column(rng, "bool", 60)
    same_outcome(lambda: psel.zip_(port_column(mask), port_column(t),
                                   port_column(f)),
                 lambda: rsel.zip_(mask, t, f), layout, masks=True)


@pytest.mark.parametrize("which", ["truthy", "falsy", "null"])
def test_zip_with_scalars(rng, which):
    mask = rand_column(rng, "bool", 40)
    col = rand_column(rng, "int16", 40)
    rs = RScalar(np.int16(-7), rdt.int16, valid=which != "null")
    ps_ = port_datum(rs)
    args = (col, rs) if which == "truthy" else (rs, col)
    pargs = (port_column(col), ps_) if which == "truthy" \
        else (ps_, port_column(col))
    same_outcome(lambda: psel.zip_(port_column(mask), *pargs),
                 lambda: rsel.zip_(mask, *args), which, masks=True)


def test_zip_errors(rng):
    mask = rand_column(rng, "bool", 10)
    s = layout_columns(rng, "string", 10)[0]
    for t, f in ((rand_column(rng, "int8", 10), rand_column(rng, "int16",
                                                            10)),
                 (s, RScalar(np.int8(1), rdt.int8)),
                 (s, layout_columns(rng, "string", 9)[0]),
                 (rand_column(rng, "int8", 10), s)):
        same_outcome(lambda: psel.zip_(port_column(mask), port_datum(t),
                                       port_datum(f)),
                     lambda: rsel.zip_(mask, t, f), "zip error")
    same_outcome(lambda: psel.zip_(port_column(s), port_column(s),
                                   port_column(s)),
                 lambda: rsel.zip_(s, s, s), "non-bool mask")


@pytest.mark.parametrize("layout", LAYOUTS[:3] + ["null"])
def test_nullif(rng, layout):
    col, _ = layout_columns(rng, layout)
    cond = rand_column(rng, "bool", 60)
    same_outcome(lambda: psel.nullif(port_column(col), port_column(cond)),
                 lambda: rsel.nullif(col, cond), layout, masks=True)


@pytest.mark.parametrize("offset", [0, 1, 5, -3, 59, 60, -61, 200])
@pytest.mark.parametrize("layout", LAYOUTS[:3] + ["null"])
def test_shift(rng, layout, offset):
    col, _ = layout_columns(rng, layout)
    same_outcome(lambda: psel.shift(port_column(col), offset),
                 lambda: rsel.shift(col, offset), f"{layout} {offset}",
                 masks=True)


def test_shift_of_an_empty_column():
    col = at.column(np.zeros(0, np.int32))
    same_outcome(lambda: psel.shift(port_column(col), 2),
                 lambda: rsel.shift(col, 2), "empty")


# ---- BatchCoalescer ------------------------------------------------------------

def batches(rng, sizes):
    out = []
    for n in sizes:
        out.append(at.Table.from_pydict({
            "i": rand_column(rng, "int64", n),
            "s": at.column([["a", "", "é", None][j]
                            for j in rng.integers(0, 4, n)], rdt.utf8),
            "z": at.NullColumn(n)}))
    return out


def drain(c):
    out = []
    while c.has_completed_batch():
        out.append(c.next_completed_batch())
    assert c.next_completed_batch() is None
    return out


@pytest.mark.parametrize("target", [1, 7, 25, 100])
def test_batch_coalescer(rng, target):
    """Re-chunked into batches of `target` rows, the tail by finish();
    filtered pushes on the way."""
    bs = batches(rng, [3, 0, 11, 30, 2, 9])
    preds = [at.column(rng.random(b.num_rows) < 0.6) for b in bs]
    got, want = BatchCoalescer(target), rco.BatchCoalescer(target)
    for i, (b, p) in enumerate(zip(bs, preds)):
        if i % 2:
            got.push_batch_with_filter(port_table(b), port_column(p))
            want.push_batch_with_filter(b, p)
        else:
            got.push_batch(port_table(b))
            want.push_batch(b)
    got.finish()
    want.finish()
    g, w = drain(got), drain(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert_tables_equal(a, b)


def test_batch_coalescer_rejects_a_bad_target():
    with pytest.raises(ArrowInvalid):
        BatchCoalescer(0)


# ---- on the card ---------------------------------------------------------------

def test_cuda_compute_matches_the_cpu_route(cuda_device, rng):
    """Each new function on the card equals the plain route bit for bit,
    errors included."""
    def outcome(fn):
        try:
            out = fn()
        except Exception as e:          # compared by name
            return type(e).__name__
        return out.as_py() if hasattr(out, "as_py") else storage_list(out)

    for dtype in ("int32", "uint64", "int8"):
        a_vals, valid, b_vals = operands(rng, dtype, 5000)
        valid[:12] = False
        b_vals[12:][b_vals[12:] == 0] = 1
        a, b = cols(a_vals, valid, b_vals)
        ga, gb = port_column(a, cuda_device), port_column(b, cuda_device)
        ca, cb = port_column(a), port_column(b)
        for op in (pn.div, pn.rem, pb.bitwise_shift_left,
                   pb.bitwise_shift_right, pb.bitwise_xor):
            assert outcome(lambda: op(ga, gb)) == \
                outcome(lambda: op(ca, cb)), (op.__name__, dtype)
        for agg in (pa.min_, pa.max_, pa.bit_and, pa.bit_or, pa.bit_xor,
                    pa.sum_checked):
            assert outcome(lambda: agg(ga)) == outcome(lambda: agg(ca)), \
                (agg.__name__, dtype)
    f = rand_column(rng, "float32", 5000)
    for op in (pn.neg, pn.neg_wrapping):
        assert storage_list(op(port_column(f, cuda_device))) == \
            storage_list(op(port_column(f)))
    s = layout_columns(rng, "string", 5000)
    mask = rand_column(rng, "bool", 5000)
    assert psel.zip_(*(port_column(x, cuda_device) for x in (mask, *s))) \
        .to_pylist() == psel.zip_(*(port_column(x) for x in (mask, *s))) \
        .to_pylist()
    assert psel.shift(port_column(s[0], cuda_device), 3).to_pylist() == \
        psel.shift(port_column(s[0]), 3).to_pylist()
    assert len(psel.shift(NullColumn(4, cuda_device), 1)) == 4
