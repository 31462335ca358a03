"""Bitwise kernels: and, or, xor, not and the shifts (counterpart of
arrow_tpu/ops/bitwise.py; arrow-arith/src/bitwise.rs), on the integer
storage.

A shift count is taken modulo the bit width first (Rust's
wrapping_shl / wrapping_shr; the reference's `r % bits`, a floor
modulo, so -1 shifts by width - 1).  torch's `<<` and `>>` differ from
XLA's outside [0, width), which the modulo keeps them from seeing.
Right shifts are arithmetic for signed types and logical for unsigned
ones, which live on signed storage (dtypes.py) and are masked after the
shift.  Bool operands shift as XLA shifts them: a left shift keeps the
value, a right shift by true clears it.
"""

from __future__ import annotations

import torch

from ..core.column import PrimitiveColumn
from ..core.datum import Datum, as_datum
from ..errors import ArrowTypeError
from .arity import binary, unary

__all__ = ["bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
           "bitwise_shift_left", "bitwise_shift_right"]


def _check_bits(lhs: Datum, rhs: Datum) -> None:
    """Integer or bool operands, as XLA's bitwise ops take them."""
    for d in (as_datum(lhs).dtype, as_datum(rhs).dtype):
        if not (d.is_integer or d.is_boolean):
            raise TypeError(f"bitwise op of {d!r}")


def bitwise_and(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    _check_bits(lhs, rhs)
    return binary(lhs, rhs, torch.bitwise_and)


def bitwise_or(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    _check_bits(lhs, rhs)
    return binary(lhs, rhs, torch.bitwise_or)


def bitwise_xor(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    _check_bits(lhs, rhs)
    return binary(lhs, rhs, torch.bitwise_xor)


def bitwise_not(col) -> PrimitiveColumn:
    col = as_datum(col)
    if not col.dtype.is_integer:
        raise ArrowTypeError(f"bitwise_not of {col.dtype!r}")
    return unary(col, torch.bitwise_not)


def _count(r: torch.Tensor, bits: int) -> torch.Tensor:
    """The shift count r mod bits (floor modulo) in r's dtype."""
    return torch.remainder(r, bits).to(r.dtype)


def bitwise_shift_left(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    """Wrapping shift left (bitwise.rs bitwise_shift_left)."""
    _check_bits(lhs, rhs)
    if as_datum(lhs).dtype.is_boolean:
        return binary(lhs, rhs, lambda l, r: l.clone())
    return binary(lhs, rhs, lambda l, r: torch.bitwise_left_shift(
        l, _count(r, 8 * l.element_size())))


def bitwise_shift_right(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    """Wrapping shift right: arithmetic for signed types, logical for
    unsigned ones."""
    _check_bits(lhs, rhs)
    d = as_datum(lhs).dtype
    if d.is_boolean:
        return binary(lhs, rhs, lambda l, r: l & ~r)

    def fn(l, r):
        bits = 8 * l.element_size()
        k = _count(r, bits)
        out = torch.bitwise_right_shift(l, k)
        if d.is_unsigned_integer and l.dtype != torch.uint8:
            # clear the sign copies: keep the low (bits - k) bits
            keep = torch.bitwise_left_shift(torch.ones_like(l), bits - k) - 1
            out = torch.where(k == 0, l, out & keep)
        return out
    return binary(lhs, rhs, fn)
