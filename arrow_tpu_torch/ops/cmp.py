"""Comparison kernels: eq, neq, lt, lt_eq, gt, gt_eq, distinct and
not_distinct (counterpart of arrow_tpu/ops/cmp.py:26-101;
arrow-ord/src/cmp.rs:79-200) on column/scalar pairs.

Outputs are dense bool tensors with the joint validity.  Floats compare
as IEEE values (NaN != NaN); the total order lives in ops/row_format.py.
Unsigned values on signed storage (dtypes.py) order through the
sign-flip map.  Dictionary and string operands go to ops/strings.py
(`compare`) before anything else, so a raw Python str passes straight
through.  Decimal columns (cmp.py:104-178) rescale to their common
scale through the exact host cast (ops/cast.py), then compare on the
device: decimal32/64 as ints, decimal128/256 lexicographically over
their limb planes from the top, the top limb signed and the lower ones
unsigned (through the sign-flip map).  A decimal Scalar is rescaled
exactly on the host to the column's scale instead (`_decimal_vs_scalar`).
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.datum import Datum, Scalar, as_datum, broadcast_pair
from ..errors import ArrowTypeError

__all__ = ["eq", "neq", "lt", "lt_eq", "gt", "gt_eq",
           "distinct", "not_distinct"]

_OPS = {"eq": torch.eq, "neq": torch.ne, "lt": torch.lt,
        "lt_eq": torch.le, "gt": torch.gt, "gt_eq": torch.ge}


def _ordered(v: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """Storage whose signed order is the logical order: unsigned types
    wider than a byte live on signed storage, so flip their sign bit."""
    if d.is_unsigned_integer and v.dtype != torch.uint8:
        return v ^ torch.iinfo(v.dtype).min
    return v


def _is_stringy(x) -> bool:
    if isinstance(x, (StringColumn, DictionaryColumn, str, bytes)):
        return True
    return isinstance(x, Scalar) and x.dtype.is_string


def _dispatch(op: str, lhs, rhs) -> PrimitiveColumn:
    if _is_stringy(lhs) or _is_stringy(rhs):
        from . import strings
        return strings.compare(op, lhs, rhs)
    if any(isinstance(x, Column) and x.dtype.is_decimal for x in (lhs, rhs)):
        return _compare_decimal(op, lhs, rhs)
    lhs, rhs = as_datum(lhs), as_datum(rhs)
    lv, rv, mask, _, ldt, rdt = broadcast_pair(lhs, rhs)
    if ldt != rdt and not (ldt.is_numeric and rdt.is_numeric
                           and ldt.to_numpy() == rdt.to_numpy()):
        raise ArrowTypeError(f"cannot compare {ldt!r} with {rdt!r}")
    if op not in ("eq", "neq"):
        lv, rv = _ordered(lv, ldt), _ordered(rv, rdt)
    return PrimitiveColumn(_OPS[op](lv, rv), dt.bool_, mask)


def eq(lhs, rhs) -> PrimitiveColumn:
    return _dispatch("eq", lhs, rhs)


def neq(lhs, rhs) -> PrimitiveColumn:
    return _dispatch("neq", lhs, rhs)


def lt(lhs, rhs) -> PrimitiveColumn:
    return _dispatch("lt", lhs, rhs)


def lt_eq(lhs, rhs) -> PrimitiveColumn:
    return _dispatch("lt_eq", lhs, rhs)


def gt(lhs, rhs) -> PrimitiveColumn:
    return _dispatch("gt", lhs, rhs)


def gt_eq(lhs, rhs) -> PrimitiveColumn:
    return _dispatch("gt_eq", lhs, rhs)


def distinct(lhs, rhs) -> PrimitiveColumn:
    """Null-aware !=: null distinct null is false, null distinct x is
    true.  The output has no nulls (cmp.rs `distinct`)."""
    lhs, rhs = as_datum(lhs), as_datum(rhs)
    lv, rv, _, n, _, _ = broadcast_pair(lhs, rhs)
    lm, rm = _mask(lhs, n, lv.device), _mask(rhs, n, lv.device)
    return PrimitiveColumn(torch.where(lm & rm, lv != rv, lm != rm),
                           dt.bool_)


def not_distinct(lhs, rhs) -> PrimitiveColumn:
    return PrimitiveColumn(~distinct(lhs, rhs).values, dt.bool_)


def _mask(x: Datum, n: int, device) -> torch.Tensor:
    if isinstance(x, Scalar):
        return torch.full((n,), x.valid, dtype=torch.bool, device=device)
    return vd.make_mask(n, x.validity, device)


def _limb_planes(c, k: int) -> torch.Tensor:
    """(n, k) int64 limb planes of a decimal column, sign-extended."""
    from ..core.nested import DecimalColumn
    lb = c.limbs if isinstance(c, DecimalColumn) \
        else c.values.to(torch.int64)[:, None]
    if lb.shape[1] < k:
        ext = (lb[:, -1:] >> 63).expand(-1, k - lb.shape[1])
        lb = torch.cat([lb, ext], 1)
    return lb


_SWAPPED = {"eq": "eq", "neq": "neq", "lt": "gt", "lt_eq": "gt_eq",
            "gt": "lt", "gt_eq": "lt_eq"}


def _decimal_vs_scalar(op: str, col, s: Scalar) -> PrimitiveColumn:
    """A decimal column against a decimal Scalar: the Scalar's value is
    rescaled on the host to the column's scale, exactly (a literal finer
    than the scale compares through the integers around it), then the
    column's unscaled values compare with that integer on the device
    (pyarrow's answer; the reference raises here, ROADMAP C24)."""
    import decimal
    import math
    n, dev = len(col), col.device
    if not s.valid:
        return PrimitiveColumn(torch.zeros(n, dtype=torch.bool, device=dev),
                               dt.bool_, torch.zeros(n, dtype=torch.bool,
                                                     device=dev))
    v = s.value
    x = decimal.Decimal(repr(v)) if isinstance(v, float) \
        else decimal.Decimal(v)
    t = x.scaleb(col.dtype.scale, decimal.Context(prec=200))
    lo, hi = math.floor(t), math.ceil(t)
    bound = {"lt": hi, "lt_eq": lo, "gt": lo, "gt_eq": hi,
             "eq": lo, "neq": lo}[op]
    k = max(col.limbs.shape[1] if col.dtype.name in ("decimal128",
                                                     "decimal256") else 1,
            (abs(bound).bit_length() + 64) // 64)
    u = bound % (1 << (64 * k))
    limbs = [(u >> (64 * j)) & ((1 << 64) - 1) for j in range(k)]
    const = torch.tensor([w - (1 << 64) if w >> 63 else w for w in limbs],
                         dtype=torch.int64, device=dev).expand(n, k)
    if lo != hi and op in ("eq", "neq"):     # no column value equals t
        out = torch.full((n,), op == "neq", dtype=torch.bool, device=dev)
    else:
        out = _limbs_compare(op, _limb_planes(col, k), const)
    return PrimitiveColumn(out, dt.bool_, col.validity)


def _limbs_compare(op: str, la: torch.Tensor, ra: torch.Tensor
                   ) -> torch.Tensor:
    """`op` over (n, k) limb planes, lexicographically from the top limb,
    which is signed; the lower ones are unsigned (the sign-flip map)."""
    k = la.shape[1]
    lt = torch.zeros(la.shape[0], dtype=torch.bool, device=la.device)
    tied = torch.ones_like(lt)
    for j in range(k - 1, -1, -1):
        a, b = la[:, j], ra[:, j]
        if j < k - 1:                        # lower limbs are unsigned
            a, b = a ^ _SIGN, b ^ _SIGN
        lt = lt | (tied & (a < b))
        tied = tied & (a == b)
    return {"eq": tied, "neq": ~tied, "lt": lt, "lt_eq": lt | tied,
            "gt": ~(lt | tied), "gt_eq": ~lt}[op]


def _compare_decimal(op: str, lhs, rhs) -> PrimitiveColumn:
    """Decimals of any widths and scales (cmp.py:110-178)."""
    from ..core.nested import DecimalColumn
    from .cast import CastOptions, cast
    ld, rd = as_datum(lhs).dtype, as_datum(rhs).dtype
    if ld.is_decimal and rd.is_decimal:
        if isinstance(rhs, Scalar):
            return _decimal_vs_scalar(op, lhs, rhs)
        if isinstance(lhs, Scalar):
            return _decimal_vs_scalar(_SWAPPED[op], rhs, lhs)
    if not (ld.is_decimal and rd.is_decimal):
        raise ArrowTypeError(f"cannot compare {ld!r} with {rd!r}")
    s_ = max(ld.scale, rd.scale)

    def rescaled(c):
        # lossless: the precision grows with the scale
        p = c.dtype.precision + (s_ - c.dtype.scale)
        if p > 76:
            raise ArrowTypeError("decimal comparison scale overflow")
        ctor = dt.decimal32 if p <= 9 else dt.decimal64 if p <= 18 \
            else dt.decimal128 if p <= 38 else dt.decimal256
        return cast(c, ctor(p, s_), CastOptions(safe=False))
    lc, rc = rescaled(lhs), rescaled(rhs)
    mask = vd.union(lc.validity, rc.validity)
    if not (isinstance(lc, DecimalColumn) or isinstance(rc, DecimalColumn)):
        return PrimitiveColumn(_OPS[op](lc.values, rc.values), dt.bool_,
                               mask)
    k = max(c.limbs.shape[1] if isinstance(c, DecimalColumn) else 1
            for c in (lc, rc))
    return PrimitiveColumn(_limbs_compare(op, _limb_planes(lc, k),
                                          _limb_planes(rc, k)), dt.bool_,
                           mask)


_SIGN = -(1 << 63)
