"""Whole-array reductions (counterpart of arrow_tpu/ops/aggregate.py:
sum_, sum_checked, min_, max_, min_max, count, count_nulls, bool_and,
bool_or, bit_and, bit_or and bit_xor, aggregate.py:41-198;
arrow-arith/src/aggregate.rs).

  - nulls are skipped; empty or all-null input -> null scalar
  - `sum_` wraps on integer overflow in the column's own type (unsigned
    sums wrap on their signed storage: the same bits mod 2^width);
    `sum_checked` raises ArithmeticOverflow: narrow integers sum as
    int64, 64-bit ones are checked exactly by 32-bit limb sums on the
    device (the reference sums Python ints on the host)
  - min/max take the first valid row whose order key
    (row_format.encode_value_key) is extreme: floats in IEEE total
    order, NaN above everything and -0.0 below +0.0; strings and
    dictionaries by their values' byte ranks (aggregate.py:75-111)
  - bit_and / bit_or / bit_xor fold the valid values pairwise on the
    device, null rows taking the identity
  - float sums are IEEE; their order is torch's, not XLA's
  - decimal sum_ / min_ / max_ of any width are exact, on the host, in
    Python ints (aggregate.py:199-215): a Scalar of the input type
    holding a `decimal.Decimal`, null when no row is valid
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import Column, DictionaryColumn, PrimitiveColumn
from ..core.datum import Scalar
from ..errors import ArithmeticOverflow, ArrowTypeError
from ..utils.trace import to_host

__all__ = ["sum_", "sum_checked", "min_", "max_", "min_max", "count",
           "count_nulls", "bool_and", "bool_or", "bit_and", "bit_or",
           "bit_xor"]

_SIGN = -(1 << 63)
_LIMB_ROWS = 1 << 30        # rows per exact limb sum: 2^30 x 2^32 < 2^63


def sum_(col: PrimitiveColumn) -> Scalar:
    """Wrapping sum (aggregate.rs sum_array)."""
    if col.dtype.is_decimal:
        return _decimal_reduce(col, sum)
    if not col.dtype.is_numeric:
        raise ArrowTypeError(f"sum of {col.dtype!r}")
    if count(col) == 0:
        return Scalar(0, col.dtype, valid=False)
    vals = vd.canonicalize(col.values, col.validity)   # nulls -> 0
    return Scalar(torch.sum(vals, dtype=vals.dtype), col.dtype)


def _exact_sum(vals: torch.Tensor, d: dt.DataType) -> int:
    """The exact sum of 64-bit integer storage of type d, from int64
    sums of its high and low 32-bit halves: one host fetch."""
    parts = []
    for s in range(0, max(vals.shape[0], 1), _LIMB_ROWS):
        v = vals[s:s + _LIMB_ROWS]
        hi = v >> 32 if d.is_signed_integer else (v >> 32) & 0xFFFFFFFF
        parts += [hi.sum(), (v & 0xFFFFFFFF).sum()]
    got = to_host("aggregate.exact_sum", torch.stack(parts)).tolist()
    return sum((hi << 32) + lo for hi, lo in zip(got[::2], got[1::2]))


def sum_checked(col: PrimitiveColumn) -> Scalar:
    """Checked sum (aggregate.rs:819 try_ variants): integer overflow of
    the column's type raises ArithmeticOverflow."""
    if not col.dtype.is_integer:
        return sum_(col)
    if count(col) == 0:
        return Scalar(0, col.dtype, valid=False)
    d = col.dtype
    vals = vd.canonicalize(col.values, col.validity)
    lo, hi = dt.integer_bounds(d)
    if d.byte_width < 8:
        wide = dt.widen(vals, d).sum()
        if not lo <= int(to_host("aggregate.sum_checked", wide)) <= hi:
            raise ArithmeticOverflow("sum overflowed")
        return Scalar(wide.to(vals.dtype), d)
    if not lo <= _exact_sum(vals, d) <= hi:
        raise ArithmeticOverflow("sum overflowed")
    return Scalar(torch.sum(vals), d)


def _extreme_row(col: Column, want_max: bool) -> Optional[int]:
    """The first valid row holding the least or greatest order key
    (_total_order_reduce, aggregate.py:75-91), None when no row is
    valid; keys compare as u64, so signed after a sign flip."""
    from .row_format import encode_value_key
    key, validity = encode_value_key(col)
    key = key ^ _SIGN
    if validity is None:
        pick = torch.argmax if want_max else torch.argmin
        return int(to_host("aggregate.extreme", pick(key))) \
            if key.numel() else None
    info = torch.iinfo(torch.int64)
    masked = torch.where(validity, key, info.min if want_max else info.max)
    m = masked.max() if want_max else masked.min()
    hit = validity & (key == m)
    row, found = to_host("aggregate.extreme", torch.stack([
        torch.argmax(hit.to(torch.uint8)),
        hit.any().to(torch.int64)])).tolist()
    return row if found else None


def _extremum(col: Column, want_max: bool) -> Scalar:
    if col.dtype.is_decimal:
        return _decimal_reduce(col, max if want_max else min)
    i = None if count(col) == 0 else _extreme_row(col, want_max)
    if isinstance(col, PrimitiveColumn):
        return Scalar(0, col.dtype, valid=False) if i is None \
            else Scalar(col.values[i], col.dtype)
    if i is None:
        return Scalar(None, col.dtype, valid=False)
    if isinstance(col, DictionaryColumn):
        code = int(to_host("aggregate.extreme", col.codes[i]))
        return Scalar(col.values.slice(code, 1).to_pylist()[0], col.dtype)
    return Scalar(col.slice(i, 1).to_pylist()[0], col.dtype)


def min_(col: Column) -> Scalar:
    return _extremum(col, want_max=False)


def max_(col: Column) -> Scalar:
    return _extremum(col, want_max=True)


def min_max(col: Column) -> Tuple[Scalar, Scalar]:
    """(min, max) scalars."""
    return min_(col), max_(col)


def count(col: Column) -> int:
    """Non-null count."""
    return len(col) - col.null_count


def count_nulls(col: Column) -> int:
    return col.null_count


def _check_bool(col: Column, what: str) -> None:
    if not col.dtype.is_boolean:
        raise ArrowTypeError(f"{what} on non-boolean")


def bool_and(col: PrimitiveColumn) -> Scalar:
    """AND of the non-null values (aggregate.rs:754)."""
    _check_bool(col, "bool_and")
    if count(col) == 0:
        return Scalar(False, dt.bool_, valid=False)
    return Scalar(torch.where(col.is_valid_mask(), col.values, True).all(),
                  dt.bool_)


def bool_or(col: PrimitiveColumn) -> Scalar:
    """OR of the non-null values."""
    _check_bool(col, "bool_or")
    if count(col) == 0:
        return Scalar(False, dt.bool_, valid=False)
    return Scalar(torch.where(col.is_valid_mask(), col.values, False).any(),
                  dt.bool_)


def _fold(v: torch.Tensor, fn: Callable, ident: int) -> torch.Tensor:
    """fn folded over v pairwise (fn associative and commutative), as a
    0-d tensor: log2(n) passes, each halving the rows."""
    pad = torch.full((1,), ident, dtype=v.dtype, device=v.device)
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, pad])
        v = fn(v[0::2], v[1::2])
    return v[0]


def _bit_reduce(col: PrimitiveColumn, op: str) -> Scalar:
    """bit_and / bit_or / bit_xor over the non-null values
    (aggregate.rs:719-752); null rows contribute the identity."""
    if not col.dtype.is_integer:
        raise ArrowTypeError(f"{op} on non-integer {col.dtype!r}")
    if count(col) == 0:
        return Scalar(0, col.dtype, valid=False)
    v = col.values
    # all ones for and (-1 on signed storage, 255 for uint8), else 0
    ident = 0 if op != "bit_and" else \
        (255 if v.dtype == torch.uint8 else -1)
    fn = {"bit_and": torch.bitwise_and, "bit_or": torch.bitwise_or,
          "bit_xor": torch.bitwise_xor}[op]
    if col.validity is not None:
        v = torch.where(col.validity, v, torch.full((), ident, dtype=v.dtype,
                                                    device=v.device))
    return Scalar(_fold(v, fn, ident), col.dtype)


def bit_and(col: PrimitiveColumn) -> Scalar:
    return _bit_reduce(col, "bit_and")


def bit_or(col: PrimitiveColumn) -> Scalar:
    return _bit_reduce(col, "bit_or")


def bit_xor(col: PrimitiveColumn) -> Scalar:
    return _bit_reduce(col, "bit_xor")


def _decimal_reduce(col: Column, fold: Callable) -> Scalar:
    """sum / min / max of a decimal column's valid rows in Python ints,
    as a Decimal of the input's scale (aggregate.py:199-215)."""
    from decimal import Decimal
    from ..core.nested import DecimalColumn
    if isinstance(col, DecimalColumn):
        vals = [v for v in col.to_pyints() if v is not None]
    else:
        raw = to_host("aggregate.decimal", col.values).tolist()
        valid = None if col.validity is None else \
            to_host("aggregate.decimal", col.validity).tolist()
        vals = raw if valid is None else [x for x, ok in zip(raw, valid)
                                          if ok]
    if not vals:
        return Scalar(None, col.dtype, valid=False)
    return Scalar(Decimal(fold(vals)).scaleb(-col.dtype.scale), col.dtype)
