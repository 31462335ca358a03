"""Type conversion (counterpart of arrow_tpu/ops/cast.py, cast.py:54-1164;
arrow-cast/src/cast/mod.rs), in the reference's dispatch order.

    safe=True  -> a value that cannot convert becomes null
    safe=False -> raises CastError (one host sync; inside `fuse` on the
                  card it raises RuntimeError: capture cannot read the
                  flag on the host)

Families, on the source column's device unless said otherwise:
  numeric <-> numeric    bounds mask + convert
  numeric <-> bool       nonzero / 0-1
  temporal <-> temporal  checked multiply to a finer unit, floor divide
                         to a coarser one
  temporal <-> numeric   through the storage integer
  dictionary             values cast with the codes kept (key narrowing
                         through the checked cast), unpacked, or packed
                         (a cast to utf8, then dictionary_encode)
  run-end                the values cast with the runs kept, decoded
                         then cast, or encoded after the cast (utf8
                         through its dictionary codes)
  identity, null -> T    no-op, all-null column of any layout
  decimal                decimal <-> decimal rescale (half away from
                         zero), integer/bool/float/utf8 -> decimal,
                         decimal -> integer (truncating)/float/utf8:
                         host-exact Python ints, as the reference
                         computes them (cast/decimal.rs); the unscaled
                         values make one round trip to the host
  text                   number, bool and temporal <-> utf8, utf8 ->
                         fixed-size binary, binary <-> utf8 retags, and
                         interval <-> utf8: on the host, value by value,
                         through Python's int, float, repr and datetime
                         as the reference does (the contract), the
                         result back on the column's device
  interval               unit widening to month_day_nano, duration <->
                         month_day_nano, int32 / int64 reinterprets
  list family            list <-> large list <-> fixed-size list <->
                         list view, the child cast on its device; a
                         list view becomes offsets by one gather
  map, struct            entries cast, map <-> list<struct>; struct
                         children cast by position under the target's
                         names
  fixed-size binary      -> binary / utf8 (offsets by width)
  base64_encode / _decode  standard alphabet, on the host

A decimal cast that fails a value makes it null when `safe` is False and
raises CastError when it is True: the reference's rule for decimals
(cast.py:860-868), the opposite of its other families.  A timestamp[ns]
keeps its nanoseconds through text (ROADMAP C10: the reference drops
them; pyarrow keeps them).

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
from ..utils.trace import to_host
from ..core import nested as nd, validity as vd
from ..core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                           PrimitiveColumn, StringColumn, StructColumn,
                           offset_dtype)
from ..errors import (ArrowInvalid, ArrowNotImplementedError,
                      ArrowTypeError, CastError)

__all__ = ["CastOptions", "cast", "can_cast", "base64_encode",
           "base64_decode"]

_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}
_SIGN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_LISTS = ("list", "large_list", "fixed_size_list", "list_view",
          "large_list_view")


@dataclass(frozen=True)
class CastOptions:
    safe: bool = True


def can_cast(from_dt: dt.DataType, to_dt: dt.DataType) -> bool:
    """can_cast_types (mod.rs:92), cast.py:59-122."""
    if from_dt == to_dt:
        return True
    if from_dt.is_null or to_dt.is_null:
        return True
    if from_dt.name == "interval" or to_dt.name == "interval":
        # the reference's narrow interval matrix (cast/mod.rs:283-298)
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
    if from_dt.is_run_end_encoded or to_dt.is_run_end_encoded:
        # value cast with the runs kept, decode then cast, or encode
        # after the cast (cast/mod.rs:166-180)
        inner_from = from_dt.value_type if from_dt.is_run_end_encoded \
            else from_dt
        inner_to = to_dt.value_type if to_dt.is_run_end_encoded else to_dt
        if to_dt.is_run_end_encoded and not (
                prim(inner_to) or inner_to.is_string):
            return False
        return can_cast(inner_from, inner_to)
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
    if from_dt.name in _LISTS and to_dt.name in _LISTS:
        return can_cast(from_dt.value_type, to_dt.value_type)
    if from_dt.name == "map" and to_dt.name == "map":
        return True
    if from_dt.name == "struct" and to_dt.name == "struct":
        return len(from_dt.fields) == len(to_dt.fields) and all(
            can_cast(f.dtype, t.dtype)
            for f, t in zip(from_dt.fields, to_dt.fields))
    return (from_dt.name == "map" and to_dt.name in _LISTS) or \
        (from_dt.name in _LISTS and to_dt.name == "map")


def cast(col: Column, to: dt.DataType,
         options: CastOptions = CastOptions()) -> Column:
    """cast_with_options (mod.rs:696), in the reference's dispatch order
    (cast.py:125-237)."""
    from_dt = col.dtype
    if from_dt == to:
        return col
    if isinstance(col, NullColumn):
        return _all_null(to, len(col), col.device)
    if to.is_null:
        return NullColumn(len(col), col.device)

    if isinstance(col, nd.RunEndColumn):
        if to.is_run_end_encoded:
            # the values cast, the runs kept (their type re-checked)
            vals = cast(col.values, to.value_type, options)
            storage = to.index_type.to_torch()
            if len(col) > torch.iinfo(storage).max:
                raise ArrowInvalid(
                    f"run ends overflow {to.index_type!r}: {len(col)}")
            return nd.RunEndColumn(col.run_ends.to(storage), vals, len(col))
        from .ree import run_end_decode
        return cast(run_end_decode(col), to, options)
    if to.is_run_end_encoded:
        # encode after the cast; strings run through their dictionary
        # codes (run_end_encode takes primitive columns)
        from .ree import run_end_encode
        inner = cast(col, to.value_type, options)
        if not isinstance(inner, StringColumn):
            return run_end_encode(inner, to.index_type)
        from .strings import dictionary_encode
        from .take import take
        d = dictionary_encode(inner)
        ree = run_end_encode(PrimitiveColumn(d.codes, dt.int32, d.validity,
                                             _canonical=True), to.index_type)
        return nd.RunEndColumn(ree.run_ends, take(d.values, ree.values),
                               len(col))

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
    if to.is_dictionary:
        # pack: cast to the value type, then dictionary-encode
        inner = cast(col, to.value_type, options)
        if isinstance(inner, StringColumn):
            from .strings import dictionary_encode
            return dictionary_encode(inner, to.index_type.to_torch())
        raise ArrowNotImplementedError(f"pack {to.value_type!r} dictionary")
    if from_dt.is_decimal or to.is_decimal:
        return _cast_decimal(col, to, options)
    if isinstance(col, nd.MapColumn) or to.name == "map":
        return _cast_map(col, to, options)
    if isinstance(col, StructColumn) and to.name == "struct":
        return _cast_struct(col, to, options)
    if isinstance(col, (ListColumn, nd.FixedSizeListColumn,
                        nd.ListViewColumn)) or to.name in _LISTS:
        return _cast_list(col, to, options)
    if from_dt.name == "interval" or to.name == "interval":
        return _cast_interval(col, to, options)
    if isinstance(col, StringColumn):
        return _cast_from_string(col, to, options)
    if isinstance(col, nd.FixedSizeBinaryColumn):
        # fixed-size binary -> binary / utf8 (cast.py:221-234)
        if not (to.is_binary or to.is_string):
            raise ArrowNotImplementedError(f"cast fsb -> {to!r}")
        if to.name == "fixed_size_binary":
            raise ArrowInvalid(f"fsb width change {col.byte_width}->"
                               f"{to.list_size}")
        n, w = col.data.shape
        offs = torch.arange(0, (n + 1) * w, w, dtype=offset_dtype(to),
                            device=col.device)
        return StringColumn(offs, col.data.reshape(-1), to, col.validity)
    if not isinstance(col, PrimitiveColumn):
        raise ArrowNotImplementedError(f"cast {from_dt!r} -> {to!r}")
    if to.is_string:
        return _cast_to_string(col, to)
    return _cast_primitive(col, to, options)


def _all_null(to: dt.DataType, n: int, device) -> Column:
    """All-null column of any target type (cast/mod.rs:306 Null -> T
    arms; cast.py:240-310)."""
    if to.is_null:
        return NullColumn(n, device)
    mask = torch.zeros((n,), dtype=torch.bool, device=device) if n else None

    def zeros(m, dtype, *shape):
        return torch.zeros((m,) + shape, dtype=dtype, device=device)
    name = to.name
    if to.is_dictionary:
        return DictionaryColumn(zeros(n, to.index_type.to_torch()),
                                _all_null(to.value_type, 1, device), mask)
    if (to.is_string or to.is_binary) and name != "fixed_size_binary":
        return StringColumn(zeros(n + 1, offset_dtype(to)),
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
        raise ArrowNotImplementedError(f"cast null -> {to!r}")
    return PrimitiveColumn(zeros(n, to.to_torch()), to, mask,
                           _canonical=True)


# ---- primitive <-> primitive ------------------------------------------------

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
        count = int(to_host("cast(safe=False)", failed.sum(), guard=True))
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
    raise ArrowNotImplementedError(f"cast {from_dt!r} -> {to!r}")


# ---- decimal casts (cast/decimal.rs; cast.py:824-970) ---------------------

def _dec_ints(col: Column) -> list:
    """A decimal column's unscaled Python ints (0 at nulls)."""
    if isinstance(col, nd.DecimalColumn):
        return [0 if v is None else v for v in col.to_pyints()]
    return col.values.cpu().tolist()


def _dec_build(ints: list, to: dt.DataType, validity: vd.Mask,
               device) -> Column:
    """A decimal column of unscaled ints on `device`."""
    if to.name in ("decimal32", "decimal64"):
        return PrimitiveColumn(torch.tensor(ints, dtype=to.to_torch(),
                                            device=device), to, validity)
    return nd.DecimalColumn.from_pyints(ints, to, validity, device=device)


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
        raise ArrowNotImplementedError(f"cast {from_dt!r} -> {to!r}")
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
    raise ArrowNotImplementedError(f"cast {from_dt!r} -> {to!r}")


# ---- interval casts (cast/mod.rs:283-298, 365-500; cast.py:425-669) -------

def _cast_interval(col: Column, to: dt.DataType,
                   options: CastOptions) -> Column:
    """The reference's narrow interval matrix: unit widening to
    month_day_nano, duration <-> month_day_nano (zero months and days
    going out, truncating toward zero), int64 / int32 reinterprets, and
    text both ways (cast.py:425-491)."""
    f = col.dtype
    if not can_cast(f, to):
        raise ArrowNotImplementedError(f"cast {f!r} -> {to!r}")
    if isinstance(col, StringColumn):
        return _parse_interval_strings(col, to, options)
    if to.is_string:
        return _interval_to_string(col, to)
    if isinstance(col, nd.IntervalMDNColumn):
        scale = _UNIT_NS[to.unit]
        n = col.nanos
        bad = (col.months != 0) | (col.days != 0)
        q = torch.where(n < 0, -((-n) // scale), n // scale)
        return _apply_failures(torch.where(bad, 0, q), bad, col.validity,
                               to, options)
    v = col.values
    if f.name == "duration":                 # -> interval[month_day_nano]
        scale = _UNIT_NS[f.unit]
        x = v.to(torch.int64)
        bad = (x > (2 ** 63 - 1) // scale) | (x < -((2 ** 63) // scale))
        ns = torch.where(bad, 0, x) * scale
        validity = col.validity
        if options.safe:
            validity = vd.union(validity, ~bad)
        else:
            if bool(to_host("cast(safe=False)", (
                    bad if validity is None else bad & validity).any(),
                    guard=True)):
                raise CastError("duration -> interval[mdn] overflow")
        z = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
        return nd.IntervalMDNColumn(z, z, ns, validity)
    if f.name == "interval":
        if to == dt.int64:                   # reinterpret the storage
            return PrimitiveColumn(v.to(torch.int64), to, col.validity,
                                   _canonical=True)
        z = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
        if f.unit == "year_month":           # months, 0 days, 0 ns
            return nd.IntervalMDNColumn(v.to(torch.int32), z,
                                     z.to(torch.int64), col.validity)
        # day_time (days << 32 | millis): the low word is signed millis
        x = v.to(torch.int64)
        return nd.IntervalMDNColumn(z, (x >> 32).to(torch.int32),
                                 x.to(torch.int32).to(torch.int64)
                                 * 1_000_000, col.validity)
    return PrimitiveColumn(v, to, col.validity, _canonical=True)


def _tdiv(a: int, b: int) -> int:
    """Integer division truncating toward zero (Rust / semantics)."""
    q = abs(a) // b
    return -q if a < 0 else q


def _fmt_clock(parts: list, total: int, unit_per_sec: int, digits: int):
    """Hours, mins and '{sign}{secs}.{frac} secs' (display.rs), zero
    groups skipped (cast.py:499-515)."""
    secs = _tdiv(total, unit_per_sec)
    mins = _tdiv(secs, 60)
    hours = _tdiv(mins, 60)
    secs -= mins * 60
    mins -= hours * 60
    frac = total - _tdiv(total, unit_per_sec) * unit_per_sec
    if hours:
        parts.append(f"{hours} hours")
    if mins:
        parts.append(f"{mins} mins")
    if secs or frac:
        sign = "-" if (secs < 0 or frac < 0) else ""
        parts.append(f"{sign}{abs(secs)}.{abs(frac):0{digits}d} secs")


def _interval_to_string(col: Column, to: dt.DataType) -> StringColumn:
    """display.rs:699-846 interval formatting, on the host
    (cast.py:518-560)."""
    mask = col.is_valid_mask().cpu().numpy()
    out = []
    if isinstance(col, nd.IntervalMDNColumn):
        planes = zip(*(t.cpu().numpy().tolist()
                       for t in (col.months, col.days, col.nanos)))
        for ok, (m, d, ns) in zip(mask, planes):
            parts = []
            if m:
                parts.append(f"{m} mons")
            if d:
                parts.append(f"{d} days")
            if ns:
                _fmt_clock(parts, ns, 1_000_000_000, 9)
            out.append(" ".join(parts) if ok else None)
    elif col.dtype.unit == "year_month":
        for ok, m in zip(mask, col.values.cpu().numpy().tolist()):
            years = m // 12
            out.append(f"{years} years {m - years * 12} mons" if ok
                       else None)
    else:                                     # day_time
        x = col.values.cpu().numpy().astype(np.int64)
        days = (x >> 32).astype(np.int32).tolist()
        ms = x.astype(np.int32).tolist()
        for ok, d, t in zip(mask, days, ms):
            parts = []
            if d:
                parts.append(f"{d} days")
            if t:
                _fmt_clock(parts, t, 1_000, 3)
            out.append(" ".join(parts) if ok else None)
    return StringColumn.from_pylist(out, to, device=col.device)


_INTERVAL_UNIT_FACTORS = {
    "year": ("months", 12), "years": ("months", 12),
    "mon": ("months", 1), "mons": ("months", 1),
    "month": ("months", 1), "months": ("months", 1),
    "week": ("days", 7), "weeks": ("days", 7),
    "day": ("days", 1), "days": ("days", 1),
    "hour": ("nanos", 3_600_000_000_000),
    "hours": ("nanos", 3_600_000_000_000),
    "minute": ("nanos", 60_000_000_000), "minutes": ("nanos", 60_000_000_000),
    "second": ("nanos", 1_000_000_000), "seconds": ("nanos", 1_000_000_000),
    "millisecond": ("nanos", 1_000_000), "milliseconds": ("nanos", 1_000_000),
    "microsecond": ("nanos", 1_000), "microseconds": ("nanos", 1_000),
    "nanosecond": ("nanos", 1), "nanoseconds": ("nanos", 1),
}


def _parse_one_interval(s: str):
    """Interval text -> (months, days, nanos) or None: '<n> <unit>' pairs
    and an optional trailing [-]HH:MM[:SS[.f]] clock (parse.rs
    parse_interval's subset, cast.py:596-644)."""
    parts = s.strip().split()
    if not parts:
        return None
    months = days = nanos = 0
    i = 0
    while i < len(parts):
        tok = parts[i]
        if ":" in tok:                       # the clock, last
            if i != len(parts) - 1:
                return None
            neg = tok.startswith("-")
            hms = tok.lstrip("+-").split(":")
            if len(hms) not in (2, 3):
                return None
            try:
                h, m = int(hms[0]), int(hms[1])
                sec = float(hms[2]) if len(hms) == 3 else 0.0
            except ValueError:
                return None
            t = h * 3_600_000_000_000 + m * 60_000_000_000 \
                + round(sec * 1e9)
            nanos += -t if neg else t
            i += 1
            continue
        if i + 1 >= len(parts):
            return None
        unit = parts[i + 1].lower().rstrip(",")
        if unit not in _INTERVAL_UNIT_FACTORS:
            return None
        field, mult = _INTERVAL_UNIT_FACTORS[unit]
        try:
            qty = float(tok) if "." in tok else int(tok)
        except ValueError:
            return None
        amt = qty * mult
        if field == "months":
            whole = int(amt)
            months += whole
            days += round((amt - whole) * 30)   # a fractional month: days
        elif field == "days":
            whole = int(amt)
            days += whole
            nanos += round((amt - whole) * 86_400_000_000_000)
        else:
            nanos += round(amt)
        i += 2
    return months, days, nanos


def _parse_interval_strings(col: StringColumn, to: dt.DataType,
                            options: CastOptions) -> Column:
    """utf8 -> any interval unit, on the host (cast.py:647-669)."""
    vals = col.to_pylist()
    n = len(vals)
    months = np.zeros(n, np.int32)
    days = np.zeros(n, np.int32)
    nanos = np.zeros(n, np.int64)
    ok = np.zeros(n, bool)
    for i, s in enumerate(vals):
        if s is None:
            continue
        r = _parse_one_interval(s)
        if r is None:
            if not options.safe:
                raise CastError(f"cannot parse interval {s!r}")
            continue
        ok[i] = True
        months[i], days[i], nanos[i] = r
    dev = col.device
    validity = vd.union(col.validity, torch.from_numpy(ok).to(dev))
    if to.unit == "month_day_nano":
        return nd.IntervalMDNColumn(*(torch.from_numpy(a).to(dev)
                                   for a in (months, days, nanos)), validity)
    if to.unit == "year_month":
        bad = ok & ((days != 0) | (nanos != 0))
        return _apply_failures(torch.from_numpy(months).to(dev),
                               torch.from_numpy(bad).to(dev), validity, to,
                               options)
    bad = ok & ((months != 0) | (nanos % 1_000_000 != 0))
    ms = nanos // 1_000_000
    bad |= ok & ((ms > 2 ** 31 - 1) | (ms < -2 ** 31))
    packed = (days.astype(np.int64) << 32) | (ms & 0xFFFFFFFF)
    return _apply_failures(torch.from_numpy(packed).to(dev),
                           torch.from_numpy(bad).to(dev), validity, to,
                           options)


# ---- text (host, value by value: cast/display.rs, parse.rs;
#      cast.py:671-822) -------------------------------------------------------

def _cast_to_string(col: PrimitiveColumn, to: dt.DataType) -> StringColumn:
    """Numbers, bools and temporal values as text (cast.py:671-687)."""
    d = col.dtype
    vals = col.to_numpy().tolist()
    mask = None if col.validity is None else col.validity.cpu().numpy()
    if d.is_boolean:
        fmt = lambda v: "true" if v else "false"
    elif d.is_floating:
        fmt = _format_float
    elif d.is_temporal:
        fmt = lambda v: _format_temporal(v, d)
    else:
        fmt = str
    out = [fmt(v) if mask is None or mask[i] else None
           for i, v in enumerate(vals)]
    return StringColumn.from_pylist(out, to, device=col.device)


def _format_float(x: float) -> str:
    """Shortest round-trip text (cast.py:690-698): Python's repr, so an
    integral float prints '1.0' where Rust's Display prints '1'."""
    if x != x:
        return "NaN"
    if x in (float("inf"), float("-inf")):
        return "inf" if x > 0 else "-inf"
    return repr(x)


def _format_temporal(v: int, d: dt.DataType) -> str:
    """ISO text through datetime (cast.py:701-726).  A timestamp[ns]
    keeps its nanoseconds: the reference formats at microsecond
    precision and drops them, where pyarrow keeps them (ROADMAP C10)."""
    import datetime
    if d.name == "date32":
        return (datetime.date(1970, 1, 1)
                + datetime.timedelta(days=v)).isoformat()
    if d.name == "date64":
        return (datetime.datetime(1970, 1, 1) + datetime.timedelta(
            milliseconds=v)).isoformat(sep="T")
    if d.name in ("time32", "time64"):
        secs, frac_ns = divmod(v * _UNIT_NS[d.unit], 1_000_000_000)
        hh, rem = divmod(secs, 3600)
        mm, ss = divmod(rem, 60)
        digits = {"s": 0, "ms": 3, "us": 6, "ns": 9}[d.unit]
        base = f"{hh:02d}:{mm:02d}:{ss:02d}"
        return base + "." + f"{frac_ns:09d}"[:digits] if digits else base
    if d.name == "timestamp":
        ns = v * _UNIT_NS[d.unit]
        text = (datetime.datetime(1970, 1, 1) + datetime.timedelta(
            microseconds=ns // 1000)).isoformat(sep="T")
        if ns % 1000:
            text += ("" if "." in text else ".000000") + f"{ns % 1000:03d}"
        return text
    return str(v)


def _cast_from_string(col: StringColumn, to: dt.DataType,
                      options: CastOptions) -> Column:
    """utf8 / binary -> fixed-size binary (values of another length
    fail), a binary or string retag, or a parse value by value
    (cast.py:728-760)."""
    if to.name == "fixed_size_binary":
        w = to.list_size
        offs = col.offsets.cpu().numpy().astype(np.int64)
        ok = np.diff(offs) == w
        valid = None if col.validity is None else col.validity.cpu().numpy()
        if not options.safe and (~ok if valid is None else ~ok & valid).any():
            raise CastError(f"value length != fixed-size width {w}")
        data = col.data.cpu().numpy()
        rows = np.zeros((len(col), w), np.uint8)
        if len(data):
            idx = np.where(ok[:, None],
                           offs[:-1][:, None] + np.arange(w)[None, :], 0)
            rows = np.where(ok[:, None], data[np.minimum(idx, len(data) - 1)],
                            0).astype(np.uint8)
        return nd.FixedSizeBinaryColumn(
            torch.from_numpy(rows).to(col.device),
            torch.from_numpy(ok if valid is None else valid & ok
                             ).to(col.device))
    if to.is_binary or to.is_string:
        return col.retag(to)
    if not (to.is_numeric or to.is_boolean or to.is_temporal):
        raise ArrowNotImplementedError(f"parse to {to!r}")
    offs = col.offsets.cpu().numpy().astype(np.int64)
    data = col.data.cpu().numpy()
    valid = np.ones(len(col), bool) if col.validity is None \
        else col.validity.cpu().numpy()
    vals = np.zeros(len(col), to.to_numpy())
    failed = np.zeros(len(col), bool)
    slow = valid
    if to.name == "date32":
        days, fast = _iso_days(offs, data)
        vals[fast] = days[fast]
        slow = valid & ~fast
    raw = data.tobytes()
    for i in np.flatnonzero(slow).tolist():
        s = raw[offs[i]:offs[i + 1]]
        try:
            vals[i] = _parse_one(s.decode() if col.dtype.is_string else s,
                                 to)
        except (ValueError, OverflowError):
            failed[i] = True
    dev = col.device
    return _apply_failures(
        torch.from_numpy(vals.view(to.storage_numpy())).to(dev),
        torch.from_numpy(failed).to(dev), col.validity, to, options)


_MONTH_DAYS = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])


def _iso_days(offs: np.ndarray, data: np.ndarray):
    """(days since 1970-01-01, which values) for the values that are
    exactly YYYY-MM-DD of a real date with a year of at least 1, read
    with numpy; `_parse_one` gives the same days for them
    (date.fromisoformat) and parses every other value."""
    n = len(offs) - 1
    ok = offs[1:] - offs[:-1] == 10
    days = np.zeros(n, np.int64)
    if not ok.any():
        return days, ok
    idx = np.where(ok, offs[:-1], 0)[:, None] + np.arange(10)
    b = data[np.minimum(idx, len(data) - 1)].astype(np.int64)
    dig = b - 48
    num = [0, 1, 2, 3, 5, 6, 8, 9]
    ok &= ((dig[:, num] >= 0) & (dig[:, num] <= 9)).all(1) \
        & (b[:, 4] == 45) & (b[:, 7] == 45)
    y = dig[:, 0] * 1000 + dig[:, 1] * 100 + dig[:, 2] * 10 + dig[:, 3]
    m = dig[:, 5] * 10 + dig[:, 6]
    d = dig[:, 8] * 10 + dig[:, 9]
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
    dim = _MONTH_DAYS[np.clip(m - 1, 0, 11)] + (leap & (m == 2))
    ok &= (y >= 1) & (m >= 1) & (m <= 12) & (d >= 1) & (d <= dim)
    # days from the civil date (the proleptic Gregorian calendar)
    yy = y - (m <= 2)
    era = yy // 400
    yoe = yy - era * 400
    doy = (153 * ((m + 9) % 12) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    days = np.where(ok, era * 146_097 + doe - 719_468, 0)
    return days, ok


def _iso_datetime(s: str):
    """(naive UTC datetime, nanoseconds beyond its microseconds) of ISO
    text; an offset converts to UTC (string_to_timestamp_nanos,
    parse.rs).  fromisoformat reads six fractional digits; the next
    three are kept apart, which the reference drops (ROADMAP C10)."""
    import datetime
    import re
    s = s.replace("Z", "+00:00")
    extra = 0
    m = re.search(r"\.(\d{7,})", s)
    if m:
        extra = int(m.group(1)[6:9].ljust(3, "0"))
    x = datetime.datetime.fromisoformat(s)
    if x.tzinfo is not None:
        x = x.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return x, extra


def _parse_one(s: str, to: dt.DataType):
    """One value of type `to` from text (cast.py:763-822); raises
    ValueError or OverflowError where it cannot."""
    import datetime
    s = s.strip()
    if to.is_boolean:
        low = s.lower()
        if low in ("true", "t", "1", "yes"):
            return True
        if low in ("false", "f", "0", "no"):
            return False
        raise ValueError(s)
    if to.is_integer:
        v = int(s)
        lo, hi = dt.integer_bounds(to)
        if v < lo or v > hi:
            raise OverflowError(s)
        return v
    if to.is_floating:
        return float(s)
    epoch = datetime.datetime(1970, 1, 1)
    if to.name == "date32":
        return (datetime.date.fromisoformat(s)
                - datetime.date(1970, 1, 1)).days
    if to.name == "timestamp":
        x, extra = _iso_datetime(s)
        us = (x - epoch) // datetime.timedelta(microseconds=1)
        if to.unit == "ns":
            return us * 1000 + extra
        return us // (_UNIT_NS[to.unit] // 1000)
    if to.name == "date64":
        try:
            return (datetime.date.fromisoformat(s)
                    - datetime.date(1970, 1, 1)).days * 86_400_000
        except ValueError:
            x, _ = _iso_datetime(s)
            return (x - epoch) // datetime.timedelta(milliseconds=1)
    if to.name in ("time32", "time64"):
        # 'HH:MM[:SS[.f]]' (string_to_time_nanoseconds, parse.rs:299)
        x = datetime.time.fromisoformat(s)
        ns = ((x.hour * 60 + x.minute) * 60 + x.second) \
            * 1_000_000_000 + x.microsecond * 1_000
        return ns // _UNIT_NS[to.unit]
    raise ArrowNotImplementedError(f"parse to {to!r}")


# ---- list, map and struct casts (cast/list.rs, map.rs; cast.py:974-1122) --

def _child(child: Column, to: dt.DataType, options: CastOptions) -> Column:
    return cast(child, to, options) if child.dtype != to else child


def _cast_list(col: Column, to: dt.DataType, options: CastOptions) -> Column:
    """list <-> large list <-> fixed-size list <-> list view, the child
    cast on its own device (cast.py:974-1067)."""
    from .take import take
    dev = col.device
    if isinstance(col, nd.ListViewColumn):
        if to.name in ("list_view", "large_list_view"):
            odt = torch.int64 if to.name == "large_list_view" \
                else torch.int32
            return nd.ListViewColumn(col.offsets.to(odt), col.sizes.to(odt),
                                  _child(col.child, to.value_type, options),
                                  col.validity, to)
        # the views become offsets: the child gathered in view order
        sizes = col.sizes.to(torch.int64)
        new_offs = torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])
        total = int(new_offs[-1])
        src = torch.repeat_interleave(
            col.offsets.to(torch.int64) - new_offs[:-1], sizes,
            output_size=total) + torch.arange(total, device=dev)
        as_list = ListColumn(new_offs.to(torch.int32),
                             take(col.child, PrimitiveColumn(src, dt.int64)),
                             col.validity)
        return cast(as_list, to, options)
    if to.name in ("list_view", "large_list_view"):
        if isinstance(col, nd.FixedSizeListColumn):
            col = _cast_list(col, dt.list_(col.child.dtype), options)
        if not isinstance(col, ListColumn):
            raise ArrowNotImplementedError(f"cast {col.dtype!r} -> {to!r}")
        odt = torch.int64 if to.name == "large_list_view" else torch.int32
        return nd.ListViewColumn(col.offsets[:-1].to(odt),
                              torch.diff(col.offsets).to(odt),
                              _child(col.child, to.value_type, options),
                              col.validity, to)
    if isinstance(col, ListColumn) and to.name in ("list", "large_list"):
        offs = col.offsets.to(torch.int64) if to.name == "large_list" \
            else col.offsets
        return ListColumn(offs, _child(col.child, to.value_type, options),
                          col.validity, large=to.name == "large_list")
    if isinstance(col, ListColumn) and to.name == "fixed_size_list":
        k = to.list_size
        offs = col.offsets.to(torch.int64)
        exact = torch.diff(offs) == k
        ok = exact if col.validity is None else exact | ~col.validity
        valid = col.validity
        if not bool(ok.all()):
            if not options.safe:
                raise CastError(f"list lengths != {k}")
            valid = ok if valid is None else valid & ok
        # each row's k slots (rows of another length: slot 0)
        idx = offs[:-1, None] + torch.arange(k, device=dev)[None, :]
        idx = torch.where(exact[:, None], idx, 0).reshape(-1)
        child = take(col.child, PrimitiveColumn(idx, dt.int64))
        return nd.FixedSizeListColumn(_child(child, to.value_type, options), k,
                                   valid)
    if isinstance(col, nd.FixedSizeListColumn) and \
            to.name in ("list", "large_list"):
        odt = torch.int64 if to.name == "large_list" else torch.int32
        offs = torch.arange(len(col) + 1, dtype=odt, device=dev) \
            * col.list_size
        return ListColumn(offs, _child(col.child, to.value_type, options),
                          col.validity, large=to.name == "large_list")
    if isinstance(col, nd.FixedSizeListColumn) and \
            to.name == "fixed_size_list" and to.list_size == col.list_size:
        return nd.FixedSizeListColumn(cast(col.child, to.value_type, options),
                                   col.list_size, col.validity)
    raise ArrowNotImplementedError(f"cast {col.dtype!r} -> {to!r}")


def _cast_map(col: Column, to: dt.DataType, options: CastOptions) -> Column:
    """map -> map (the entries cast), map <-> list<struct<key, value>>
    (cast.py:1070-1108)."""

    def entries(e: StructColumn, kv: dt.DataType) -> StructColumn:
        kf, vf = kv.fields
        return StructColumn((_child(e.children[0], kf.dtype, options),
                             _child(e.children[1], vf.dtype, options)),
                            kv.fields, e.validity)

    if isinstance(col, nd.MapColumn) and to.name == "map":
        return nd.MapColumn(col.offsets, entries(col.entries, to.value_type),
                         col.validity)
    if isinstance(col, nd.MapColumn) and to.name in ("list", "large_list") \
            and to.value_type.name == "struct":
        return ListColumn(col.offsets,
                          entries(col.entries,
                                  dt.struct(to.value_type.fields)),
                          col.validity, large=to.name == "large_list")
    if isinstance(col, ListColumn) and to.name == "map":
        if not isinstance(col.child, StructColumn) or \
                len(col.child.fields) != 2:
            raise ArrowNotImplementedError(
                "map cast needs list<struct<2 fields>>")
        return nd.MapColumn(col.offsets, entries(col.child, to.value_type),
                         col.validity)
    raise ArrowNotImplementedError(f"cast {col.dtype!r} -> {to!r}")


def _cast_struct(col, to: dt.DataType, options: CastOptions):
    """Struct -> struct: children cast by position and renamed to the
    target's fields (cast.py:1111-1122)."""
    if len(col.fields) != len(to.fields):
        raise ArrowInvalid(f"struct cast arity mismatch: {len(col.fields)} "
                           f"vs {len(to.fields)}")
    return StructColumn(tuple(cast(c, f.dtype, options)
                              for c, f in zip(col.children, to.fields)),
                        tuple(to.fields), col.validity)


# ---- base64 (arrow-cast/src/base64.rs; cast.py:1124-1164) -----------------

def _b64(col, fn, to: dt.DataType) -> StringColumn:
    """Each value's bytes through `fn`, on the host, back on the
    column's device."""
    if not isinstance(col, StringColumn):
        raise ArrowTypeError(f"base64 of {type(col).__name__}")
    offs = col.offsets.cpu().numpy().astype(np.int64).tolist()
    data = col.data.cpu().numpy().tobytes()
    parts = [fn(data[offs[i]:offs[i + 1]]) for i in range(len(col))]
    out_offs = np.zeros(len(col) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=out_offs[1:])
    return StringColumn.from_numpy(
        out_offs.astype(np.int32), np.frombuffer(b"".join(parts), np.uint8),
        None if col.validity is None else col.validity.cpu().numpy(), to,
        device=col.device)


def base64_encode(col) -> StringColumn:
    """Binary -> utf8, standard base64 alphabet (base64.rs b64_encode)."""
    import base64
    return _b64(col, base64.b64encode, dt.utf8)


def base64_decode(col) -> StringColumn:
    """utf8 -> binary, standard base64 (base64.rs b64_decode); malformed
    input raises whatever `safe` says, as in the reference."""
    import base64
    return _b64(col, lambda b: base64.b64decode(b, validate=True), dt.binary)
