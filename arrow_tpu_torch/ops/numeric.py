"""Arithmetic kernels: add/sub/mul with checked and wrapping variants
(counterpart of arrow_tpu/ops/numeric.py; arrow-arith/src/numeric.rs).

  - both operands share a primitive numeric type (cast first);
  - `add` etc. are CHECKED: integer overflow on a valid slot raises
    ArithmeticOverflow; `add_wrapping` etc. wrap two's-complement;
  - float arithmetic is IEEE.

Unsigned overflow checks compare through the sign-flip map, because
uint16/32/64 live on signed storage (dtypes.py).  Decimal and temporal
arithmetic join with ROADMAP A7.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from ..core.datum import Datum, as_datum
from ..errors import ArithmeticOverflow, ArrowTypeError
from .arity import binary, binary_with_flag, check_flag

__all__ = ["add", "sub", "mul", "add_wrapping", "sub_wrapping",
           "mul_wrapping"]


def _resolve(op: str, lhs: Datum, rhs: Datum) -> dt.DataType:
    l, r = as_datum(lhs).dtype, as_datum(rhs).dtype
    if l == r and l.is_numeric:
        return l
    raise ArrowTypeError(f"cannot {op} {l!r} and {r!r}")


def _ult(a: torch.Tensor, b: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """Unsigned a < b on the storage of unsigned logical type d."""
    if a.dtype == torch.uint8:
        return a < b
    m = torch.iinfo(a.dtype).min
    return (a ^ m) < (b ^ m)


def _add_overflows(l, r, s, d):
    if d.is_signed_integer:
        return ((l >= 0) == (r >= 0)) & ((s >= 0) != (l >= 0))
    return _ult(s, l, d)                 # unsigned wraparound


def _sub_overflows(l, r, s, d):
    if d.is_signed_integer:
        return ((l >= 0) != (r >= 0)) & ((s >= 0) != (l >= 0))
    return _ult(l, r, d)


def _mul_overflows(l, r, p, d):
    if d.byte_width < 8:
        info = np.iinfo(d.to_numpy())
        wide = dt.widen(l, d) * dt.widen(r, d)   # unsigned may wrap < 0
        return (wide < int(info.min)) | (wide > int(info.max))
    if d.is_signed_integer:
        # p = l * r wrapped: overflow iff p / r != l.  r = -1 is kept out
        # of the division (INT64_MIN / -1 traps on x86) and covered by
        # the MIN corner terms
        lo = torch.iinfo(torch.int64).min
        nz = (r != 0) & (r != -1)
        q = torch.div(p, torch.where(nz, r, torch.ones_like(r)),
                      rounding_mode="trunc")
        return (nz & (q != l)) | ((l == lo) & (r == -1)) \
            | ((r == lo) & (l == -1))
    # uint64 via 32-bit limbs: a*b < 2^64 iff not both high limbs are
    # set, the cross term fits 32 bits, and the final add does not carry
    m32 = 0xFFFFFFFF
    ah, al = (l >> 32) & m32, l & m32
    bh, bl = (r >> 32) & m32, r & m32
    cross = ah * bl + al * bh
    low = al * bl
    total = (cross << 32) + low
    return ((ah != 0) & (bh != 0)) | (((cross >> 32) & m32) != 0) \
        | _ult(total, low, d)


def _checked(op: str, fn, overflows):
    def kernel(lhs: Datum, rhs: Datum):
        out_dt = _resolve(op, lhs, rhs)
        if not out_dt.is_integer:
            return binary(lhs, rhs, fn, out_dt)

        def body(l, r):
            s = fn(l, r)
            return s, overflows(l, r, s, out_dt)
        col, flag = binary_with_flag(lhs, rhs, body, out_dt)
        check_flag(flag, ArithmeticOverflow, f"{op} overflowed")
        return col
    kernel.__name__ = op
    kernel.__doc__ = f"Checked {op} (numeric.rs); integer overflow raises."
    return kernel


def _wrapping(op: str, fn):
    def kernel(lhs: Datum, rhs: Datum):
        return binary(lhs, rhs, fn, _resolve(op, lhs, rhs))
    kernel.__name__ = f"{op}_wrapping"
    kernel.__doc__ = f"Wrapping {op} (numeric.rs {op}_wrapping)."
    return kernel


add = _checked("add", torch.add, _add_overflows)
sub = _checked("sub", torch.sub, _sub_overflows)
mul = _checked("mul", torch.mul, _mul_overflows)
add_wrapping = _wrapping("add", torch.add)
sub_wrapping = _wrapping("sub", torch.sub)
mul_wrapping = _wrapping("mul", torch.mul)
