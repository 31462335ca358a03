"""Arithmetic kernels: add/sub/mul/div/rem/neg with checked and wrapping
variants (counterpart of arrow_tpu/ops/numeric.py; arrow-arith/src/
numeric.rs).

  - both operands share a primitive numeric type (cast first), or a
    temporal pair of `_temporal_out` (numeric.py:43-60): timestamp +-
    duration, duration + timestamp, timestamp - timestamp -> duration,
    duration op duration, all of one unit; they compute on the int64
    storage with int64's overflow checks;
  - `add` etc. are CHECKED: integer overflow on a valid slot raises
    ArithmeticOverflow; `add_wrapping` etc. wrap two's-complement;
  - integer division truncates toward zero and the remainder takes the
    dividend's sign (Rust's / and %: torch.div(rounding_mode="trunc")
    and torch.fmod, never // or torch.remainder); a zero divisor, MIN /
    -1 and MIN % -1 on a valid slot raise DivideByZero.  The divisor is
    masked to 1 at those slots before dividing: CUDA integer division by
    zero does not trap, and INT64_MIN / -1 traps on the CPU;
  - float arithmetic is IEEE; float rem is the truncated fmod; the NaNs
    of div and rem carry the bits x86 gives them (`_x86_nans`).

Unsigned values live on signed storage (dtypes.py): overflow checks
compare through the sign-flip map, uint8/16/32 divide as int64, and
uint64 divides exactly on its bits (`_udiv64`).

`neg` of a duration and of a year_month interval is the checked signed
negation; a day_time interval negates its two signed 32-bit halves and a
month_day_nano one its three planes, each checked (numeric.py:194-240).

Decimals (numeric.py:266-365) are computed as the reference computes
them: exactly, on the host, in Python ints, with the result type of
`_dec_result_type`, division truncating toward zero and a zero divisor
raising only on a valid slot; the operands make one round trip to the
host, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from ..core.column import Column, PrimitiveColumn
from ..core.datum import Datum, as_datum
from ..errors import (ArithmeticOverflow, ArrowInvalid,
                      ArrowNotImplementedError, ArrowTypeError, DivideByZero)
from .arity import binary, binary_with_flag, check_flag, unary

__all__ = ["add", "sub", "mul", "div", "rem", "neg", "add_wrapping",
           "sub_wrapping", "mul_wrapping", "neg_wrapping"]


def _temporal_out(op: str, l: dt.DataType, r: dt.DataType):
    """Temporal type rules (numeric.py:43-60; numeric.rs dispatch)."""
    pairs = {("timestamp", "duration"): ("add", "sub"),
             ("duration", "timestamp"): ("add",),
             ("timestamp", "timestamp"): ("sub",),
             ("duration", "duration"): ("add", "sub")}
    if op not in pairs.get((l.name, r.name), ()):
        return None
    if l.unit != r.unit:
        raise ArrowTypeError(f"unit mismatch {l!r} vs {r!r}")
    if l.name == r.name == "timestamp":
        return dt.duration(l.unit)
    return r if l.name == "duration" and r.name == "timestamp" else l


def _resolve(op: str, lhs: Datum, rhs: Datum) -> dt.DataType:
    l, r = as_datum(lhs).dtype, as_datum(rhs).dtype
    if l == r and (l.is_numeric or l.name == "duration"):
        return l
    out = _temporal_out(op, l, r)
    if out is not None:
        return out
    raise ArrowTypeError(f"cannot {op} {l!r} and {r!r}")


def _int_type(d: dt.DataType):
    """The integer type whose arithmetic a result of type d takes: d for
    integers, the signed storage type for temporal types, None else."""
    if d.is_integer:
        return d
    if d.is_temporal and not d.is_floating:
        return dt.int64 if d.to_torch() == torch.int64 else dt.int32
    return None


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
        if _any_decimal(lhs, rhs):
            return _decimal_arith(op, lhs, rhs)
        out_dt = _resolve(op, lhs, rhs)
        it = _int_type(out_dt)
        if it is None:
            return binary(lhs, rhs, fn, out_dt)

        def body(l, r):
            s = fn(l, r)
            return s, overflows(l, r, s, it)
        col, flag = binary_with_flag(lhs, rhs, body, out_dt,
                                     require_same_type=False)
        check_flag(flag, ArithmeticOverflow, f"{op} overflowed")
        return col
    kernel.__name__ = op
    kernel.__doc__ = f"Checked {op} (numeric.rs); integer overflow raises."
    return kernel


def _wrapping(op: str, fn):
    def kernel(lhs: Datum, rhs: Datum):
        return binary(lhs, rhs, fn, _resolve(op, lhs, rhs),
                      require_same_type=False)
    kernel.__name__ = f"{op}_wrapping"
    kernel.__doc__ = f"Wrapping {op} (numeric.rs {op}_wrapping)."
    return kernel


def _lsr1(x: torch.Tensor) -> torch.Tensor:
    """u64 x >> 1 on int64 storage."""
    return (x >> 1) & ((1 << 63) - 1)


def _udiv64(l: torch.Tensor, r: torch.Tensor):
    """(quotient, remainder) of u64 bits on int64 storage, exactly; r is
    never 0.  A divisor of 2^63 or more (negative storage) goes at most
    once; otherwise the halved dividend is below 2^63, so a signed
    division is exact, and one correction step finishes it."""
    big = r < 0
    rr = torch.where(big, torch.ones_like(r), r)
    q = torch.div(_lsr1(l), rr, rounding_mode="trunc") << 1
    m = l - q * rr
    fix = ~_ult(m, rr, dt.uint64)                # m >= rr (unsigned)
    q, m = q + fix, m - torch.where(fix, rr, torch.zeros_like(rr))
    qb = (~_ult(l, r, dt.uint64)).to(l.dtype)   # l >= r: once, else 0
    return (torch.where(big, qb, q),
            torch.where(big, l - torch.where(qb.bool(), r, 0), m))


def _int_divide(l: torch.Tensor, r: torch.Tensor, d: dt.DataType,
                want_rem: bool):
    """Truncated quotient or remainder of integer storage of type d, and
    the slots that raise (zero divisor; MIN / -1 and MIN % -1).  The
    divisor is 1 at those slots; the quotient there is the wrapped
    result (MIN / -1 = MIN), the remainder 0 (numeric.py:147-188)."""
    zero = r == 0
    over = torch.zeros_like(zero)
    if d.is_signed_integer:
        lo = torch.iinfo(l.dtype).min
        over = (l == lo) & (r == -1)
    bad = zero | over
    safe = torch.where(bad, torch.ones_like(r), r)
    if d.name == "uint64":
        q, m = _udiv64(l, safe)
    elif d.is_unsigned_integer:                 # uint8/16/32 as int64
        wl, wr = dt.widen(l, d), dt.widen(safe, d)
        q = torch.div(wl, wr, rounding_mode="trunc").to(l.dtype)
        m = torch.fmod(wl, wr).to(l.dtype)
    else:
        q = torch.div(l, safe, rounding_mode="trunc")
        m = torch.fmod(l, safe)
    if want_rem:
        return torch.where(bad, torch.zeros_like(m), m), bad
    return torch.where(zero, torch.zeros_like(q), q), bad


# (storage, quiet bit, the negative default NaN) per float type
_NAN_BITS = {torch.float16: (torch.int16, 1 << 9, -(1 << 9)),
             torch.float32: (torch.int32, 1 << 22, -(1 << 22)),
             torch.float64: (torch.int64, 1 << 51, -(1 << 51))}


def _x86_nans(out: torch.Tensor, l: torch.Tensor, r: torch.Tensor
              ) -> torch.Tensor:
    """`out` with its NaNs as x86 makes them, so as the reference's XLA
    on the CPU gives them on any device: a NaN operand propagates,
    quieted, the left one first; an invalid operation (0 / 0, inf % x,
    x % 0) gives the negative default NaN.  torch's float64 fmod on the
    CPU and CUDA's NaNs carry other bits."""
    storage, quiet, default = _NAN_BITS[out.dtype]
    bits = torch.where(torch.isnan(l), l.view(storage) | quiet,
                       torch.where(torch.isnan(r), r.view(storage) | quiet,
                                   default))
    return torch.where(torch.isnan(out), bits.view(out.dtype), out)


def div(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    """Checked division (numeric.rs div): integers truncate, a zero
    divisor or MIN / -1 on a valid slot raises DivideByZero; floats are
    IEEE (x / 0 is an infinity or NaN)."""
    if _any_decimal(lhs, rhs):
        return _decimal_arith("div", lhs, rhs)
    out_dt = _resolve("div", lhs, rhs)
    it = _int_type(out_dt)
    if it is None:
        return binary(lhs, rhs, lambda l, r: _x86_nans(l / r, l, r), out_dt)
    col, flag = binary_with_flag(
        lhs, rhs, lambda l, r: _int_divide(l, r, it, False), out_dt)
    check_flag(flag, DivideByZero, "integer division by zero/overflow")
    return col


def rem(lhs: Datum, rhs: Datum) -> PrimitiveColumn:
    """Checked remainder (numeric.rs rem): the dividend's sign; a zero
    divisor or MIN % -1 on a valid slot raises DivideByZero; float rem
    is the truncated fmod."""
    for x in (lhs, rhs):
        if isinstance(x, Column) and not isinstance(x, PrimitiveColumn):
            raise ArrowTypeError(f"binary kernel expects primitive columns, "
                                 f"got {type(x).__name__}")
    out_dt = _resolve("rem", lhs, rhs)
    # decimal32/64: the remainder of the unscaled storage integers
    it = (dt.int32 if out_dt.name == "decimal32" else dt.int64) \
        if out_dt.is_decimal else _int_type(out_dt)
    if it is None:
        return binary(lhs, rhs, lambda l, r: _x86_nans(torch.fmod(l, r), l,
                                                       r), out_dt)
    col, flag = binary_with_flag(
        lhs, rhs, lambda l, r: _int_divide(l, r, it, True), out_dt)
    check_flag(flag, DivideByZero, "integer remainder by zero/overflow")
    return col


def _negate_float(v: torch.Tensor) -> torch.Tensor:
    """IEEE negation as a flip of the sign bit, NaNs included, on any
    device (CUDA's `-x` need not flip a NaN's sign)."""
    storage = _NAN_BITS[v.dtype][0]
    return (v.view(storage) ^ torch.iinfo(storage).min).view(v.dtype)


def neg(col) -> Column:
    """Checked negation (numeric.rs neg): signed MIN on a valid slot
    raises ArithmeticOverflow (also a duration's, a year_month
    interval's and any part of a day_time or month_day_nano one); floats
    flip their sign bit; decimals negate exactly; unsigned types cannot
    negate."""
    from ..core.nested import DecimalColumn, IntervalMDNColumn
    col = as_datum(col)
    d = col.dtype
    if d.is_decimal:
        # any valid decimal's negation fits its precision (numeric.rs:114)
        if isinstance(col, DecimalColumn):
            ints = [0 if v is None else -v for v in col.to_pyints()]
            return DecimalColumn.from_pyints(ints, d, col.validity,
                                             device=col.device)
        return PrimitiveColumn(-col.values, d, col.validity, _canonical=True)
    if isinstance(col, IntervalMDNColumn):
        i32, i64 = torch.iinfo(torch.int32).min, torch.iinfo(torch.int64).min
        bad = (col.months == i32) | (col.days == i32) | (col.nanos == i64)
        check_flag((bad & col.is_valid_mask()).any(), ArithmeticOverflow,
                   "neg overflowed")
        return IntervalMDNColumn(-col.months, -col.days, -col.nanos,
                                 col.validity)
    if d.name == "interval" and d.unit == "day_time":
        # days << 32 | millis: negate each signed half (numeric.rs:147)
        days, ms = (col.values >> 32).to(torch.int32), col.values.to(
            torch.int32)
        i32 = torch.iinfo(torch.int32).min
        bad = (days == i32) | (ms == i32)
        check_flag((bad & col.is_valid_mask()).any(), ArithmeticOverflow,
                   "neg overflowed")
        packed = ((-days).to(torch.int64) << 32) \
            | ((-ms).to(torch.int64) & 0xFFFFFFFF)
        return PrimitiveColumn(packed, d, col.validity, _canonical=True)
    if d.is_signed_integer or d.name in ("duration", "interval"):
        lo = torch.iinfo(col.values.dtype).min
        bad = (col.values == lo) & col.is_valid_mask()
        check_flag(bad.any(), ArithmeticOverflow, "neg overflowed")
        return unary(col, torch.neg)
    if d.is_floating:
        return unary(col, _negate_float)
    raise ArrowTypeError(f"cannot negate {d!r}")


def neg_wrapping(col) -> PrimitiveColumn:
    """Wrapping negation (numeric.rs neg_wrapping): 0 - v on integer
    storage, the IEEE negation of floats."""
    col = as_datum(col)
    if col.dtype.is_boolean:
        raise TypeError(f"neg_wrapping of {col.dtype!r}")
    return unary(col, lambda v: torch.zeros_like(v) - v
                 if not v.is_floating_point() else _negate_float(v))


add = _checked("add", torch.add, _add_overflows)
sub = _checked("sub", torch.sub, _sub_overflows)
mul = _checked("mul", torch.mul, _mul_overflows)
add_wrapping = _wrapping("add", torch.add)
sub_wrapping = _wrapping("sub", torch.sub)
mul_wrapping = _wrapping("mul", torch.mul)


# ---- decimals (numeric.py:266-365): exact, on the host -------------------

def _any_decimal(lhs, rhs) -> bool:
    return any(isinstance(x, Column) and x.dtype.is_decimal
               for x in (lhs, rhs))


def _dec_parts(x):
    """(unscaled Python ints, 0 at nulls; host validity or None;
    precision; scale; length) of a decimal column."""
    from ..core.nested import DecimalColumn
    if not (isinstance(x, Column) and x.dtype.is_decimal):
        raise ArrowTypeError(f"decimal arithmetic with {as_datum(x).dtype!r}")
    d = x.dtype
    ints = [0 if v is None else v for v in x.to_pyints()] \
        if isinstance(x, DecimalColumn) else x.values.cpu().tolist()
    valid = None if x.validity is None else x.validity.cpu().numpy()
    return ints, valid, d.precision, d.scale, len(x)


def _dec_result_type(op: str, p1: int, s1: int, p2: int, s2: int):
    """(precision, scale) of a decimal result (numeric.rs): precision
    saturates at the operands' family's most (38 or 76); a scale past it
    raises."""
    mx = 38 if max(p1, p2) <= 38 else 76
    if op in ("add", "sub"):
        s = max(s1, s2)
        p = max(p1 - s1, p2 - s2) + s + 1
    elif op == "mul":
        s, p = s1 + s2, p1 + p2 + 1
    else:                                    # div (numeric.rs:884): s1 + 4
        s = min(s1 + 4, mx)
        p = p1 - s1 + s2 + s
    if s > mx:
        raise ArrowInvalid(f"decimal scale out of range: {s}")
    return min(p, mx), s


_DEC_CTORS = (dt.decimal32, dt.decimal64, dt.decimal128, dt.decimal256)
_DEC_RANK = {"decimal32": 1, "decimal64": 2, "decimal128": 3,
             "decimal256": 4}


def _decimal_arith(op: str, lhs, rhs) -> Column:
    """add / sub / mul / div of decimals in Python ints (numeric.py:308):
    the storage is at least the wider input's, widened further when the
    result precision needs it."""
    from ..core.nested import DecimalColumn
    li, lv, p1, s1, n1 = _dec_parts(lhs)
    ri, rv, p2, s2, n2 = _dec_parts(rhs)
    if n1 != n2:
        raise ArrowInvalid("decimal arithmetic length mismatch")
    p, s = _dec_result_type(op, p1, s1, p2, s2)
    if op == "add":
        out = [a * 10 ** (s - s1) + b * 10 ** (s - s2) for a, b in zip(li, ri)]
    elif op == "sub":
        out = [a * 10 ** (s - s1) - b * 10 ** (s - s2) for a, b in zip(li, ri)]
    elif op == "mul":
        out = [a * b for a, b in zip(li, ri)]
    else:
        mul_pow = s - s1 + s2
        out = []
        for a, b in zip(li, ri):
            if b == 0:
                out.append(0)
                continue
            num, den = (a * 10 ** mul_pow, b) if mul_pow >= 0 \
                else (a, b * 10 ** -mul_pow)
            q = abs(num) // abs(den)             # truncate toward zero
            out.append(q if (num >= 0) == (den >= 0) else -q)
    valid = None
    if lv is not None or rv is not None:
        valid = np.ones(n1, bool)
        for m in (lv, rv):
            if m is not None:
                valid &= m
    if op == "div":
        bad = np.asarray([b == 0 for b in ri], bool)
        if (bad if valid is None else bad & valid).any():
            raise DivideByZero("decimal divide by zero")
    need = 1 if p <= 9 else 2 if p <= 18 else 3 if p <= 38 else 4
    out_dt = _DEC_CTORS[max(need, _DEC_RANK[lhs.dtype.name],
                            _DEC_RANK[rhs.dtype.name]) - 1](p, s)
    device = lhs.device
    v = None if valid is None else torch.from_numpy(valid).to(device)
    if out_dt.name in ("decimal32", "decimal64"):
        return PrimitiveColumn(torch.from_numpy(np.asarray(
            out, out_dt.to_numpy())).to(device), out_dt, v)
    return DecimalColumn.from_pyints(out, out_dt, v, device=device)
