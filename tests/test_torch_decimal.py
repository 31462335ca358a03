"""Decimals in the port (decimal32/64 PrimitiveColumns, decimal128/256
DecimalColumns of u64 limbs on int64 storage) against the JAX package on
the CPU: the casts of ops/cast.py (decimal <-> decimal rescale, integer,
bool, float and utf8 <-> decimal, under both `safe` settings), the
comparisons of ops/cmp.py across all four widths and mixed scales, the
arithmetic of ops/numeric.py (result types, truncating division, a zero
divisor raising on a valid slot only), and sum_ / min_ / max_.

Inputs are unscaled integers from a seed through numpy, with nulls;
outputs compare bit for bit (values and limbs, validity, type) or by
error name.  No tolerance.
"""

import decimal
import importlib

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu_torch.errors import DivideByZero
from arrow_tpu_torch.ops import aggregate as pagg, cast as pcast
from arrow_tpu_torch.ops import cmp as pcmp, numeric as pn
from torch_port_util import (assert_columns_equal, port_column, port_dtype,
                             port_options, same_outcome)

rcast = importlib.import_module("arrow_tpu.ops.cast")
rcmp = importlib.import_module("arrow_tpu.ops.cmp")
rn = importlib.import_module("arrow_tpu.ops.numeric")
ragg = importlib.import_module("arrow_tpu.ops.aggregate")
rdt = at.dtypes
N = 120
DECIMALS = [("decimal32", 7, 2), ("decimal32", 9, 0), ("decimal64", 15, 3),
            ("decimal64", 18, -2), ("decimal128", 25, 4),
            ("decimal128", 38, 10), ("decimal256", 50, 6),
            ("decimal256", 76, 0)]
IDS = [f"{n}({p},{s})" for n, p, s in DECIMALS]


def ref_decimal(rng, name, p, s, n=N, nulls=0.15, digits=None):
    """A reference decimal column of unscaled values of up to `digits`
    digits (the precision by default), the extremes of that many digits
    and 0 in its first rows."""
    k = min(digits or p, p)
    mag = [int(x) for x in rng.integers(0, 10 ** min(k, 18), n)]
    if k > 18:
        mag = [m * 10 ** (k - 18) + int(x) for m, x in zip(
            mag, rng.integers(0, 10 ** 18, n))]
    ints = [int(sg) * m for sg, m in zip(rng.choice([-1, 1], n), mag)]
    ints[:3] = [0, 10 ** k - 1, -(10 ** k - 1)]
    valid = rng.random(n) >= nulls
    valid[:3] = True
    d = getattr(rdt, name)(p, s)
    if name in ("decimal32", "decimal64"):
        return at.column(np.asarray(ints, d.to_jax()), d, validity=valid)
    from arrow_tpu.core.nested import DecimalColumn
    return DecimalColumn.from_pyints([v if ok else 0 for v, ok in
                                      zip(ints, valid)], d,
                                     at.column(valid).values)


def both(port_fn, ref_fn, what):
    same_outcome(port_fn, ref_fn, what, masks=True)


# ---- casts ------------------------------------------------------------------

@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("to", range(len(DECIMALS)), ids=IDS)
@pytest.mark.parametrize("frm", range(len(DECIMALS)), ids=IDS)
def test_cast_decimal_to_decimal(rng, frm, to, safe):
    """Rescale (half away from zero downward), narrowing overflow null or
    raising by the reference's decimal rule."""
    col = ref_decimal(rng, *DECIMALS[frm], digits=7)
    to_t = getattr(rdt, DECIMALS[to][0])(*DECIMALS[to][1:])
    opt = rcast.CastOptions(safe=safe)
    both(lambda: pcast.cast(port_column(col), port_dtype(to_t),
                            port_options(opt)),
         lambda: rcast.cast(col, to_t, opt), f"{to_t!r} safe={safe}")


TARGETS = ["int8", "int32", "int64", "uint8", "uint64", "float32",
           "float64", "utf8"]


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("to", TARGETS)
@pytest.mark.parametrize("frm", range(len(DECIMALS)), ids=IDS)
def test_cast_from_decimal(rng, frm, to, safe):
    """Truncating to integers (null or an error out of range), to floats
    through a correctly rounded float64, to utf8 with the scale's
    digits."""
    col = ref_decimal(rng, *DECIMALS[frm], digits=12)
    opt = rcast.CastOptions(safe=safe)
    both(lambda: pcast.cast(port_column(col), port_dtype(getattr(rdt, to)),
                            port_options(opt)),
         lambda: rcast.cast(col, getattr(rdt, to), opt), f"{to}")


SOURCES = {
    "int8": lambda rng: at.column(rng.integers(-128, 127, N).astype(np.int8),
                                  validity=rng.random(N) > 0.1),
    "int64": lambda rng: at.column(rng.integers(-2 ** 62, 2 ** 62, N)
                                   // rng.choice([1, 10 ** 9], N),
                                   validity=rng.random(N) > 0.1),
    "uint64": lambda rng: at.column(rng.integers(0, 2 ** 63, N)
                                    .astype(np.uint64) * np.uint64(2)),
    "bool": lambda rng: at.column(rng.random(N) < 0.5),
    "float32": lambda rng: at.column((rng.integers(-10 ** 6, 10 ** 6, N)
                                      / 64).astype(np.float32)),
    "float64": lambda rng: at.column(np.concatenate([
        rng.standard_normal(N - 4) * 10.0 ** rng.integers(-3, 12, N - 4),
        [np.nan, np.inf, -np.inf, 2.5]])),
    "utf8": lambda rng: at.column(["1.25", "-3.335", None, "abc", "1e3",
                                   "99999999999"] * (N // 6)),
}


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("to", range(len(DECIMALS)), ids=IDS)
@pytest.mark.parametrize("frm", list(SOURCES))
def test_cast_to_decimal(rng, frm, to, safe):
    """Integers and bools scale exactly, floats round half to even
    (numpy's round) with NaN and infinities failing, text rounds half
    up; past the precision a value fails."""
    col = SOURCES[frm](rng)
    to_t = getattr(rdt, DECIMALS[to][0])(*DECIMALS[to][1:])
    opt = rcast.CastOptions(safe=safe)
    both(lambda: pcast.cast(port_column(col), port_dtype(to_t),
                            port_options(opt)),
         lambda: rcast.cast(col, to_t, opt), f"{frm} -> {to_t!r}")


def test_can_cast_decimal():
    from arrow_tpu_torch import dtypes as pdt
    for a in (rdt.decimal128(10, 2), rdt.int8, rdt.float32, rdt.utf8,
              rdt.bool_, rdt.timestamp("s")):
        for b in (rdt.decimal64(12, 3), rdt.decimal256(40, 0), rdt.uint64,
                  rdt.float64, rdt.utf8, rdt.date32):
            for x, y in ((a, b), (b, a)):
                assert pcast.can_cast(port_dtype(x), port_dtype(y)) == \
                    rcast.can_cast(x, y), (x, y)
    assert pcast.can_cast(pdt.decimal32(5, 1), pdt.int8)


# ---- comparisons ---------------------------------------------------------------

OPS = ["eq", "neq", "lt", "lt_eq", "gt", "gt_eq"]
PAIRS = [(0, 2), (2, 0), (0, 4), (4, 6), (6, 7), (1, 3), (3, 5), (5, 4),
         (2, 6), (7, 0)]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pair", PAIRS, ids=[f"{IDS[a]}-{IDS[b]}"
                                             for a, b in PAIRS])
def test_compare(rng, pair, op):
    """Rescaled to the common scale; decimal128/256 compare over their
    limb planes (top limb signed); ties and sign changes included."""
    a = ref_decimal(rng, *DECIMALS[pair[0]], digits=6)
    b = ref_decimal(rng, *DECIMALS[pair[1]], digits=6)
    b = rcast.cast(a, b.dtype, rcast.CastOptions(safe=True)) \
        if rng.random() < 0.5 else b          # many equal values
    both(lambda: getattr(pcmp, op)(port_column(a), port_column(b)),
         lambda: getattr(rcmp, op)(a, b), f"{op}")


def test_compare_wide_limbs():
    """Values that differ only in a lower limb, and across the sign."""
    vals = [0, 1, -1, 2 ** 64, 2 ** 64 + 1, -(2 ** 64), 2 ** 63, -(2 ** 63),
            10 ** 40, -(10 ** 40)]
    from arrow_tpu.core.nested import DecimalColumn
    a = DecimalColumn.from_pyints(vals, rdt.decimal256(76, 0))
    b = DecimalColumn.from_pyints(vals[::-1], rdt.decimal256(76, 0))
    for op in OPS:
        both(lambda: getattr(pcmp, op)(port_column(a), port_column(b)),
             lambda: getattr(rcmp, op)(a, b), op)


# ---- arithmetic ---------------------------------------------------------------

ARITH_PAIRS = [(0, 0), (0, 2), (2, 4), (4, 4), (4, 6), (6, 6), (1, 5),
               (3, 3)]


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("pair", ARITH_PAIRS, ids=[f"{IDS[a]}-{IDS[b]}"
                                                   for a, b in ARITH_PAIRS])
def test_arithmetic(rng, pair, op):
    """The result type (precision saturating at 38 or 76, storage at
    least the wider input's), exact values, truncating division; a zero
    divisor under a null does not raise."""
    a = ref_decimal(rng, *DECIMALS[pair[0]], digits=5)
    b = ref_decimal(rng, *DECIMALS[pair[1]], digits=5)
    if op == "div":
        bv = np.asarray(b.to_pylist(), object)
        zero = np.array([v is not None and v == 0 for v in bv])
        if isinstance(b, at.PrimitiveColumn):
            b = at.PrimitiveColumn(b.values, b.dtype,
                                   at.column(~zero & np.asarray(
                                       b.is_valid_mask())).values)
        else:
            b = b.with_validity(at.column(~zero & np.asarray(
                b.is_valid_mask())).values)
    both(lambda: getattr(pn, op)(port_column(a), port_column(b)),
         lambda: getattr(rn, op)(a, b), op)


def test_divide_by_zero_on_a_valid_slot():
    a = at.column(pa.array([decimal.Decimal("1.5"), None],
                           pa.decimal128(10, 1)))
    b = at.column(pa.array([decimal.Decimal("0"), None],
                           pa.decimal128(10, 1)))
    with pytest.raises(at.errors.DivideByZero):
        rn.div(a, b)
    with pytest.raises(DivideByZero):
        pn.div(port_column(a), port_column(b))
    z = at.column(pa.array([decimal.Decimal("1.5"), decimal.Decimal("0")],
                           pa.decimal64(10, 1)))
    masked = at.column(pa.array([decimal.Decimal("2"), None],
                                pa.decimal64(10, 1)))
    both(lambda: pn.div(port_column(z), port_column(masked)),
         lambda: rn.div(z, masked), "zero under a null")


@pytest.mark.parametrize("nulls", [0.0, 0.15])
@pytest.mark.parametrize("case", range(len(DECIMALS)), ids=IDS)
def test_neg(rng, case, nulls):
    """Exact negation, with and without a validity mask."""
    col = ref_decimal(rng, *DECIMALS[case], nulls=nulls)
    if not nulls:
        col = col.with_validity(None)
    both(lambda: pn.neg(port_column(col)), lambda: rn.neg(col), "neg")


# ---- reductions ---------------------------------------------------------------

@pytest.mark.parametrize("nulls", [0.0, 0.2, 1.0])
@pytest.mark.parametrize("fn", ["sum_", "min_", "max_"])
@pytest.mark.parametrize("case", range(len(DECIMALS)), ids=IDS)
def test_reductions(rng, case, fn, nulls):
    """Exact sums at any width, extremes by value; a Decimal scalar of the
    input's type, null when no row is valid."""
    col = ref_decimal(rng, *DECIMALS[case], nulls=nulls)
    if nulls == 1.0:
        col = col.with_validity(at.column(np.zeros(N, bool)).values)
    got, want = getattr(pagg, fn)(port_column(col)), getattr(ragg, fn)(col)
    assert repr(got.dtype) == repr(want.dtype)
    assert got.valid == want.valid
    assert got.as_py() == want.as_py()
    assert str(got.as_py()) == str(want.as_py())


def test_decimal_columns_through_filter_and_sort_keys(rng):
    """A decimal32 column compacts with the batch; as a sort key it sorts
    by its storage integer, as the reference's 'int' key (ROADMAP
    A7.4)."""
    from arrow_tpu_torch.ops.sort import sort_to_indices
    col = ref_decimal(rng, "decimal32", 7, 2)
    keep = rng.random(N) < 0.5
    rfilter = importlib.import_module("arrow_tpu.ops.filter")
    from arrow_tpu_torch.ops import filter as pfilter
    import arrow_tpu_torch as att
    assert_columns_equal(
        pfilter.filter(port_column(col), att.from_numpy(keep, device="cpu")),
        rfilter.filter(col, at.column(keep)), "filter", masks=True)
    rsort = importlib.import_module("arrow_tpu.ops.sort")
    got = sort_to_indices(port_column(col)).values.numpy().view(np.uint32)
    want = np.asarray(rsort.sort_to_indices(col).values)
    assert got.tolist() == want.tolist()
