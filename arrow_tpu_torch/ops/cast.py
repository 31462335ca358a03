"""Type conversion (counterpart of arrow_tpu/ops/cast.py: CastOptions,
can_cast, cast, _all_null, _temporal_scale, _apply_failures,
_cast_primitive and _cast_decimal, cast.py:54-420,824-970;
arrow-cast/src/cast/mod.rs).

    safe=True  -> a value that cannot convert becomes null
    safe=False -> raises CastError (one host sync; inside `fuse` on the
                  card it raises RuntimeError: capture cannot read the
                  flag on the host)

Families of this slice:
  numeric <-> numeric    bounds mask + convert
  numeric <-> bool       nonzero / 0-1
  temporal <-> temporal  checked multiply to a finer unit, floor divide
                         to a coarser one
  temporal <-> numeric   through the storage integer
  dictionary             values cast with the codes kept (key narrowing
                         through the checked cast), or unpacked
  identity, null -> T    no-op, all-null column of any layout
  decimal                decimal <-> decimal rescale (half away from
                         zero), integer/bool/float/utf8 -> decimal,
                         decimal -> integer (truncating)/float/utf8:
                         host-exact Python ints, as the reference
                         computes them (cast/decimal.rs); the unscaled
                         values make one round trip to the host

The string, list, map, struct, REE and interval casts raise
ArrowNotImplementedError naming ROADMAP A7.7.  A decimal cast that fails
a value makes it null when `safe` is False and raises CastError when it
is True: the reference's rule for decimals (cast.py:860-868), the
opposite of its other families.

Bits that torch does not give by itself, each matching the reference's
XLA conversion:
  - float -> int64 / uint64 saturates at 2**63 / 2**64, the one value
    the reference's bound `t <= float(hi)` lets through;
  - uint64 (int64 storage) -> float rounds once: values at or above
    2**63 are halved keeping a sticky bit, converted, then doubled;
  - float64 -> float16 rounds once: torch goes through float32 (two
    roundings), so the float32 step rounds to odd first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..config import sync_guard
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, NullColumn,
                           PrimitiveColumn, StringColumn)
from ..errors import ArrowNotImplementedError, CastError

__all__ = ["CastOptions", "cast", "can_cast"]

_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}
_SIGN = -(1 << 63)
_I64_MAX = (1 << 63) - 1


@dataclass(frozen=True)
class CastOptions:
    safe: bool = True


def can_cast(from_dt: dt.DataType, to_dt: dt.DataType) -> bool:
    """can_cast_types (mod.rs:92), cast.py:59-122, for the families the
    port casts."""
    if from_dt == to_dt:
        return True
    if from_dt.is_null or to_dt.is_null:
        return True
    if from_dt.name == "interval" or to_dt.name == "interval":
        # the reference's narrow interval matrix (cast/mod.rs:283-298);
        # month_day_nano is not a unit of the port
        if from_dt.name == "interval" and to_dt.name == "interval":
            return to_dt.unit == "month_day_nano"
        if from_dt.name == "interval":
            if to_dt.is_string:
                return True
            if to_dt == dt.int64:
                return from_dt.unit in ("year_month", "day_time")
            return to_dt.name == "duration" and \
                from_dt.unit == "month_day_nano"
        if from_dt.is_string:
            return True
        if from_dt == dt.int32:
            return to_dt.unit == "year_month"
        return from_dt.name == "duration" and to_dt.unit == "month_day_nano"
    prim = lambda d: d.is_numeric or d.is_boolean or d.is_temporal
    if prim(from_dt) and prim(to_dt):
        return True
    if (from_dt.is_string or from_dt.is_binary) and (
            prim(to_dt) or to_dt.is_string or to_dt.is_dictionary):
        return True
    if prim(from_dt) and to_dt.is_string:
        return True
    if from_dt.is_dictionary or to_dt.is_dictionary:
        inner_from = from_dt.value_type if from_dt.is_dictionary else from_dt
        inner_to = to_dt.value_type if to_dt.is_dictionary else to_dt
        return can_cast(inner_from, inner_to)
    if from_dt.is_decimal:
        return (to_dt.is_decimal or to_dt.is_integer or to_dt.is_floating
                or to_dt.is_string)
    if to_dt.is_decimal:
        return (from_dt.is_integer or from_dt.is_floating
                or from_dt.is_boolean or from_dt.is_string)
    return False


def _later(what: str) -> ArrowNotImplementedError:
    return ArrowNotImplementedError(f"cast {what} joins with ROADMAP A7.7")


def cast(col: Column, to: dt.DataType,
         options: CastOptions = CastOptions()) -> Column:
    """cast_with_options (mod.rs:696) for the families of this slice."""
    from_dt = col.dtype
    if from_dt == to:
        return col
    if isinstance(col, NullColumn):
        return _all_null(to, len(col), col.device)
    if to.is_null:
        return NullColumn(len(col), col.device)

    if isinstance(col, DictionaryColumn):
        if to.is_dictionary:
            new_values = cast(col.values, to.value_type, options)
            # key narrowing goes through the checked numeric cast
            # (dictionary_cast, mod.rs:742): out-of-range codes become
            # null (safe) or raise (unsafe) instead of wrapping
            key = cast(PrimitiveColumn(col.codes, from_dt.index_type,
                                       col.validity, _canonical=True),
                       to.index_type, options)
            return DictionaryColumn(key.values, new_values, key.validity)
        # unpack: decode, then cast (dictionary_cast, mod.rs:742)
        from .take import take
        idx = PrimitiveColumn(col.codes, from_dt.index_type, col.validity,
                              _canonical=True)
        if isinstance(col.values, StringColumn):
            return cast(take(col.values, idx), to, options)
        values = col.values
        if values.device != col.device:
            values = PrimitiveColumn(
                values.values.to(col.device), values.dtype,
                None if values.validity is None
                else values.validity.to(col.device), _canonical=True)
        return cast(take(values, idx), to, options)
    if from_dt.is_decimal or to.is_decimal:
        return _cast_decimal(col, to, options)
    if not isinstance(col, PrimitiveColumn) or not to.is_primitive or \
            "interval" in (from_dt.name, to.name):
        raise _later(f"{from_dt!r} -> {to!r}")
    return _cast_primitive(col, to, options)


def _all_null(to: dt.DataType, n: int, device) -> Column:
    """All-null column of any target type (cast/mod.rs:306 Null -> T
    arms; cast.py:240-310)."""
    from ..core.column import ListColumn, StructColumn
    from ..core import nested as nd
    if to.is_null:
        return NullColumn(n, device)
    mask = torch.zeros((n,), dtype=torch.bool, device=device) if n else None

    def zeros(m, dtype, *shape):
        return torch.zeros((m,) + shape, dtype=dtype, device=device)
    name = to.name
    if to.is_dictionary:
        return DictionaryColumn(zeros(n, to.index_type.to_torch()),
                                _all_null(to.value_type, 1, device), mask)
    if name == "utf8":
        return StringColumn(zeros(n + 1, torch.int32),
                            zeros(0, torch.uint8), to, mask)
    if name in ("decimal128", "decimal256"):
        k = 2 if name == "decimal128" else 4
        return nd.DecimalColumn(zeros(n, torch.int64, k), to, mask)
    if to.unit == "month_day_nano":
        return nd.IntervalMDNColumn(zeros(n, torch.int32),
                                    zeros(n, torch.int32),
                                    zeros(n, torch.int64), mask)
    if name in ("list", "large_list"):
        return ListColumn(zeros(n + 1, torch.int64 if name == "large_list"
                                else torch.int32),
                          _all_null(to.value_type, 0, device), mask,
                          large=name == "large_list")
    if name in ("list_view", "large_list_view"):
        odt = torch.int64 if name == "large_list_view" else torch.int32
        return nd.ListViewColumn(zeros(n, odt), zeros(n, odt),
                                 _all_null(to.value_type, 0, device), mask,
                                 to)
    if name == "union":
        # no top-level validity: rows of the first child, all null there
        tid = torch.full((n,), to.type_ids[0], dtype=torch.int8,
                         device=device)
        if to.mode == "sparse":
            kids = [_all_null(f.dtype, n, device) for f in to.fields]
            return nd.UnionColumn(tid, None, kids, to.fields, to.type_ids)
        kids = [_all_null(f.dtype, n if i == 0 else 0, device)
                for i, f in enumerate(to.fields)]
        return nd.UnionColumn(tid, torch.arange(n, dtype=torch.int32,
                                                device=device),
                              kids, to.fields, to.type_ids)
    if name == "run_end_encoded":
        re_dt = to.index_type.to_torch()
        if n == 0:
            return nd.RunEndColumn(zeros(0, re_dt),
                                   _all_null(to.value_type, 0, device), 0)
        return nd.RunEndColumn(torch.full((1,), n, dtype=re_dt,
                                          device=device),
                               _all_null(to.value_type, 1, device), n)
    if name == "fixed_size_list":
        return nd.FixedSizeListColumn(
            _all_null(to.value_type, n * to.list_size, device),
            to.list_size, mask)
    if name == "fixed_size_binary":
        return nd.FixedSizeBinaryColumn(zeros(n, torch.uint8, to.list_size),
                                        mask)
    if name == "struct":
        return StructColumn(tuple(_all_null(f.dtype, n, device)
                                  for f in to.fields), to.fields, mask)
    if name == "map":
        kv = _all_null(to.value_type, 0, device)
        return nd.MapColumn(zeros(n + 1, torch.int32),
                            StructColumn(kv.children, kv.fields), mask)
    if not to.is_single_tensor:
        raise _later(f"null -> {to!r}")
    return PrimitiveColumn(zeros(n, to.to_torch()), to, mask,
                           _canonical=True)


# ---- primitive <-> primitive -------------------------------------------------

def _temporal_scale(d: dt.DataType) -> Optional[int]:
    """Nanoseconds per unit for temporal types; None for the others."""
    if d.name in ("timestamp", "duration", "time32", "time64"):
        return _UNIT_NS[d.unit]
    if d.name == "date32":
        return 86_400 * _UNIT_NS["s"]
    if d.name == "date64":
        return _UNIT_NS["ms"]
    return None


def _apply_failures(values: torch.Tensor, failed: torch.Tensor,
                    col_validity: vd.Mask, to: dt.DataType,
                    options: CastOptions) -> PrimitiveColumn:
    if col_validity is not None:
        failed = failed & col_validity
    if not options.safe:
        sync_guard("cast(safe=False)")
        count = int(failed.sum())
        if count:
            raise CastError(f"cast failed for {count} values")
        return PrimitiveColumn(values, to, col_validity)
    return PrimitiveColumn(values, to, vd.union(col_validity, ~failed))


def _none_failed(v: torch.Tensor) -> torch.Tensor:
    return torch.zeros(v.shape, dtype=torch.bool, device=v.device)


def _int_to_float(w: torch.Tensor, d: dt.DataType,
                  to: torch.dtype) -> torch.Tensor:
    """Exact int64 values of logical integer type `d` (uint64: its bits)
    to float type `to`, rounded once."""
    if d.name != "uint64":
        return w.to(to)
    big = w < 0                                  # u64 values >= 2**63
    half = ((w >> 1) & _I64_MAX) | (w & 1)       # sticky bit kept
    f = torch.where(big, half, w).to(to)
    return torch.where(big, f * 2, f)


def _f64_to_f16(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float16 rounded once: round to odd into float32 (no
    tie survives), then float32 -> float16 to nearest even."""
    y = v.to(torch.float32)
    y64 = y.to(torch.float64)
    inexact = (y64 != v) & torch.isfinite(v)
    yb = y.view(torch.int32)
    toward_zero = torch.where(y64.abs() > v.abs(), yb - 1, yb)
    return torch.where(inexact, toward_zero | 1, yb) \
        .view(torch.float32).to(torch.float16)


def _to_float(v: torch.Tensor, d: dt.DataType, to: dt.DataType
              ) -> torch.Tensor:
    target = to.to_torch()
    if d.is_floating:
        if d == dt.float64 and to == dt.float16:
            return _f64_to_f16(v)
        return v.to(target)
    return _int_to_float(dt.widen(v, d), d, target)


def _float_to_int(v: torch.Tensor, to: dt.DataType, validity: vd.Mask,
                  options: CastOptions) -> PrimitiveColumn:
    """Fail on NaN, inf and out-of-range values, truncate toward zero
    (cast.py:394-401)."""
    lo, hi = dt.integer_bounds(to)
    t = torch.trunc(v.to(torch.float64))
    failed = ~(torch.isfinite(t) & (t >= float(lo)) & (t <= float(hi)))
    t = torch.where(failed, 0.0, t)
    if to.byte_width < 8:
        return _apply_failures(t.to(torch.int64).to(to.to_torch()), failed,
                               validity, to, options)
    # float(hi) rounds up to 2**63 (int64) or 2**64 (uint64): the
    # reference's conversion saturates there, torch's wraps
    if to.is_signed_integer:
        out = torch.where(t >= 2.0 ** 63, _I64_MAX, t.to(torch.int64))
    else:
        top = t >= 2.0 ** 63
        low = torch.where(top, t - 2.0 ** 63, t).clamp(max=2.0 ** 63 - 1024)
        out = torch.where(top, low.to(torch.int64) ^ _SIGN,
                          low.to(torch.int64))
        out = torch.where(t >= 2.0 ** 64, -1, out)
    return _apply_failures(out, failed, validity, to, options)


def _int_to_int(v: torch.Tensor, d: dt.DataType, to: dt.DataType,
                validity: vd.Mask, options: CastOptions) -> PrimitiveColumn:
    """Bounds check, then narrow (cast.py:402-418); unsigned values on
    signed storage compare after widening, uint64 by its sign bit."""
    lo, hi = dt.integer_bounds(to)
    x = dt.widen(v, d)
    if d.is_unsigned_integer:
        failed = _none_failed(v)
        if hi < 2 ** 64 - 1:
            failed = x > hi
            if d.name == "uint64":
                failed = failed | (x < 0)         # bits at or above 2**63
    else:
        failed = _none_failed(v)
        if lo > -2 ** 63:
            failed = failed | (x < lo)
        if hi < 2 ** 63 - 1:
            failed = failed | (x > hi)
    x = torch.where(failed, 0, x)
    return _apply_failures(x.to(to.to_torch()), failed, validity, to, options)


def _cast_primitive(col: PrimitiveColumn, to: dt.DataType,
                    options: CastOptions) -> PrimitiveColumn:
    from_dt = col.dtype
    v = col.values
    fs, ts = _temporal_scale(from_dt), _temporal_scale(to)

    # temporal <-> temporal: rescale through the unit ratio
    if fs is not None and ts is not None:
        x = v.to(torch.int64)
        if fs >= ts:
            ratio = fs // ts
            # checked_mul (cast/mod.rs:1542 unary_opt): overflow is null
            # (safe) or an error (unsafe), never a wrapped value
            hi, lo = (2 ** 63 - 1) // ratio, (-2 ** 63) // ratio
            failed = (x > hi) | (x < lo) if ratio > 1 else _none_failed(v)
            out = torch.where(failed, 0, x) * ratio
        else:
            # to a coarser unit: floor toward -inf (chrono semantics)
            out = torch.floor_divide(x, ts // fs)
            failed = _none_failed(v)
        return _apply_failures(out.to(to.to_torch()), failed, col.validity,
                               to, options)

    # temporal -> numeric / numeric -> temporal: through the storage int
    if fs is not None or ts is not None:
        storage = dt.int64 if (from_dt if fs else to).byte_width == 8 \
            else dt.int32
        if fs is not None:
            return _cast_primitive(
                PrimitiveColumn(v, storage, col.validity, _canonical=True),
                to, options)
        inner = _cast_primitive(col, storage, options)
        return PrimitiveColumn(inner.values.to(to.to_torch()), to,
                               inner.validity, _canonical=True)

    if to.is_boolean:
        return PrimitiveColumn(v != 0, to, col.validity)
    if from_dt.is_boolean:
        return PrimitiveColumn(v.to(to.to_torch()), to, col.validity)
    if to.is_floating:
        # never fails: rounding allowed, overflow -> inf (num::cast)
        return PrimitiveColumn(_to_float(v, from_dt, to), to, col.validity)
    if to.is_integer:
        if from_dt.is_floating:
            return _float_to_int(v, to, col.validity, options)
        return _int_to_int(v, from_dt, to, col.validity, options)
    raise _later(f"{from_dt!r} -> {to!r}")


# ---- decimal casts (cast/decimal.rs; cast.py:824-970) ---------------------

def _dec_ints(col: Column) -> list:
    """A decimal column's unscaled Python ints (0 at nulls)."""
    from ..core.nested import DecimalColumn
    if isinstance(col, DecimalColumn):
        return [0 if v is None else v for v in col.to_pyints()]
    return col.values.cpu().tolist()


def _dec_build(ints: list, to: dt.DataType, validity: vd.Mask,
               device) -> Column:
    """A decimal column of unscaled ints on `device`."""
    from ..core.nested import DecimalColumn
    if to.name in ("decimal32", "decimal64"):
        return PrimitiveColumn(torch.tensor(ints, dtype=to.to_torch(),
                                            device=device), to, validity)
    return DecimalColumn.from_pyints(ints, to, validity, device=device)


def _round_half_away(num: int, den: int) -> int:
    """num / den rounded half away from zero (arrow-rs decimal rescale)."""
    q, r = divmod(abs(num), den)
    if 2 * r >= den:
        q += 1
    return q if num >= 0 else -q


def _cast_decimal(col: Column, to: dt.DataType,
                  options: CastOptions) -> Column:
    """decimal <-> decimal / integer / bool / float / utf8, exact on the
    host in Python ints (cast.py:852-969)."""
    from_dt, device = col.dtype, col.device
    valid = None if col.validity is None else col.validity.cpu().numpy()

    def finish(failed):
        validity = valid
        if any(failed):
            if not options.safe:
                raise CastError("decimal cast overflow")
            bad = np.asarray(failed)
            validity = ~bad if validity is None else validity & ~bad
        return None if validity is None else \
            torch.from_numpy(np.ascontiguousarray(validity)).to(device)

    def checked(ys, limit):
        failed = [abs(y) >= limit for y in ys]
        return [0 if f else y for y, f in zip(ys, failed)], finish(failed)

    if from_dt.is_decimal and to.is_decimal:
        ds = to.scale - from_dt.scale
        ys = [x * 10 ** ds if ds >= 0 else _round_half_away(x, 10 ** -ds)
              for x in _dec_ints(col)]
        ys, v = checked(ys, 10 ** to.precision)
        return _dec_build(ys, to, v, device)
    if from_dt.is_decimal:
        ints, scale = _dec_ints(col), 10 ** from_dt.scale
        v = None if valid is None else col.validity
        if to.is_integer:
            lo, hi = dt.integer_bounds(to)
            ys = [abs(x) // scale * (1 if x >= 0 else -1) for x in ints]
            failed = [not lo <= y <= hi for y in ys]
            out = np.asarray([0 if f else y for y, f in zip(ys, failed)],
                             to.to_numpy())
            return PrimitiveColumn(torch.from_numpy(out.view(
                to.storage_numpy())).to(device), to, finish(failed))
        if to.is_floating:
            out = np.asarray([x / scale for x in ints], np.float64)
            return PrimitiveColumn(torch.from_numpy(
                out.astype(to.to_numpy())).to(device), to, v)
        if to.name == "utf8":
            s = from_dt.scale
            text = [str(x) if s == 0 else
                    f"{'-' if x < 0 else ''}{abs(x) // 10 ** s}."
                    f"{str(abs(x) % 10 ** s).zfill(s)}" for x in ints]
            if valid is not None:
                text = [t if ok else "" for t, ok in zip(text, valid)]
            return StringColumn.from_pylist(text, to, device=device) \
                .with_validity(v)
        raise _later(f"{from_dt!r} -> {to!r}")
    limit = 10 ** to.precision
    if from_dt.is_integer or from_dt.is_boolean:
        xs = dt.widen(col.values, from_dt).tolist()
        if from_dt.name == "uint64":
            xs = [x % (1 << 64) for x in xs]
        ys, v = checked([x * 10 ** to.scale for x in xs], limit)
        return _dec_build(ys, to, v, device)
    if from_dt.is_floating:
        src = col.values.cpu().numpy().astype(np.float64)
        ys, failed = [], []
        for x in src:
            if not np.isfinite(x):
                ys.append(0)
                failed.append(True)
                continue
            y = int(np.round(x * 10.0 ** to.scale))
            failed.append(abs(y) >= limit)
            ys.append(0 if failed[-1] else y)
        return _dec_build(ys, to, finish(failed), device)
    if from_dt.name == "utf8":
        from decimal import Decimal
        ys, failed = [], []
        for t in col.to_pylist():
            if t is None:
                ys.append(0)
                failed.append(False)
                continue
            try:
                y = int((Decimal(t) * 10 ** to.scale)
                        .to_integral_value(rounding="ROUND_HALF_UP"))
                bad = abs(y) >= limit
            except Exception:
                y, bad = 0, True
            failed.append(bad)
            ys.append(0 if bad else y)
        return _dec_build(ys, to, finish(failed), device)
    raise _later(f"{from_dt!r} -> {to!r}")
