"""pyarrow <-> arrow_tpu_torch (counterpart of arrow_tpu/io/interop.py;
the arrow-pyarrow crate's role, arrow-pyarrow/src/lib.rs:88-96).

Host data enters and leaves the device here, and pyarrow is the outside
oracle of Arrow semantics the tests and chip_smoke.py hold the port to.
  - `column_from_pyarrow(arr, device)` / `table_from_pyarrow(batch,
    device)` bring every layout the reference takes onto `device`: one
    host pass over each buffer, one copy to the device.  utf8_view and
    binary_view normalise to the offset layout on the way in and keep
    their type; large_utf8 and large_binary keep int64 offsets.  Field
    metadata rides the schema, which is how the extension types of
    dtypes.py travel.
  - `column_to_pyarrow(col)` / `table_to_pyarrow(table)` copy each
    column to the host once (`hostio.to_host`) and build the pyarrow
    array from its buffers where the reference does.
pyarrow is imported inside the functions: `import arrow_tpu_torch` does
not need it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                           PrimitiveColumn, StringColumn, StructColumn,
                           from_numpy)
from ..core.table import Table
from ..errors import ArrowNotImplementedError
from .hostio import host, to_host
from .hostio import tensor as _tensor

__all__ = ["column_from_pyarrow", "column_to_pyarrow", "table_from_pyarrow",
           "table_to_pyarrow", "dtype_from_pyarrow", "dtype_to_pyarrow"]


_PAIRS: Optional[list] = None


def _pairs() -> list:
    """(pyarrow type, port type) for the types without parameters."""
    global _PAIRS
    if _PAIRS is None:
        import pyarrow as pa
        _PAIRS = [
            (pa.bool_(), dt.bool_), (pa.int8(), dt.int8),
            (pa.int16(), dt.int16), (pa.int32(), dt.int32),
            (pa.int64(), dt.int64), (pa.uint8(), dt.uint8),
            (pa.uint16(), dt.uint16), (pa.uint32(), dt.uint32),
            (pa.uint64(), dt.uint64), (pa.float16(), dt.float16),
            (pa.float32(), dt.float32), (pa.float64(), dt.float64),
            (pa.string(), dt.utf8), (pa.large_string(), dt.large_utf8),
            (pa.binary(), dt.binary), (pa.large_binary(), dt.large_binary),
            (pa.string_view(), dt.utf8_view),
            (pa.binary_view(), dt.binary_view),
            (pa.date32(), dt.date32), (pa.date64(), dt.date64),
            (pa.month_day_nano_interval(), dt.interval("month_day_nano")),
            (pa.null(), dt.null)]
    return _PAIRS


# ---- types (interop.py:48-198) --------------------------------------------

def _fields_from(t) -> list:
    return [dt.Field(t.field(i).name, dtype_from_pyarrow(t.field(i).type),
                     t.field(i).nullable) for i in range(t.num_fields)]


def dtype_from_pyarrow(t) -> dt.DataType:
    """The port's type of a pyarrow type; an extension type raises, as
    in the reference (its storage rides a field with metadata)."""
    import pyarrow as pa
    import pyarrow.lib as palib
    for p, d in _pairs():
        if t == p:
            return d
    ty = pa.types
    if ty.is_timestamp(t):
        return dt.timestamp(t.unit, t.tz)
    if ty.is_time32(t):
        return dt.time32(t.unit)
    if ty.is_time64(t):
        return dt.time64(t.unit)
    if ty.is_duration(t):
        return dt.duration(t.unit)
    if ty.is_decimal(t):
        return getattr(dt, str(t).split("(")[0])(t.precision, t.scale)
    if ty.is_fixed_size_binary(t):
        return dt.fixed_size_binary(t.byte_width)
    if ty.is_dictionary(t):
        return dt.dictionary(dtype_from_pyarrow(t.index_type),
                             dtype_from_pyarrow(t.value_type),
                             ordered=bool(t.ordered))
    for check, make in ((ty.is_list, dt.list_),
                        (ty.is_large_list, dt.large_list),
                        (ty.is_list_view, dt.list_view),
                        (ty.is_large_list_view, dt.large_list_view)):
        if check(t):
            return make(dtype_from_pyarrow(t.value_type))
    if ty.is_fixed_size_list(t):
        return dt.fixed_size_list(dtype_from_pyarrow(t.value_type),
                                  t.list_size)
    if ty.is_map(t):
        return dt.map_(dtype_from_pyarrow(t.key_type),
                       dtype_from_pyarrow(t.item_type))
    if ty.is_struct(t):
        return dt.struct(_fields_from(t))
    if ty.is_union(t):
        return dt.union(_fields_from(t),
                        "sparse" if t.mode == "sparse" else "dense",
                        t.type_codes)
    if ty.is_run_end_encoded(t):
        return dt.run_end_encoded(dtype_from_pyarrow(t.run_end_type),
                                  dtype_from_pyarrow(t.value_type))
    if ty.is_interval(t):
        # pyarrow has no Python constructor for the months and day-time
        # units: match the C++ type id
        units = {palib.Type_INTERVAL_MONTH_DAY_NANO: "month_day_nano",
                 palib.Type_INTERVAL_MONTHS: "year_month",
                 palib.Type_INTERVAL_DAY_TIME: "day_time"}
        if t.id in units:
            return dt.interval(units[t.id])
        raise ArrowNotImplementedError(f"interval type {t}")
    raise ArrowNotImplementedError(f"pyarrow type {t}")


def dtype_to_pyarrow(d: dt.DataType):
    """The pyarrow type of a port type; year_month and day_time intervals
    raise (pyarrow cannot build them from Python)."""
    import pyarrow as pa
    for p, q in _pairs():
        if q == d:
            return p
    n = d.name
    if n == "timestamp":
        return pa.timestamp(d.unit, d.tz)
    if n in ("time32", "time64", "duration"):
        return getattr(pa, n)(d.unit)
    if d.is_decimal:
        return getattr(pa, n)(d.precision, d.scale)
    if n == "fixed_size_binary":
        return pa.binary(d.list_size)
    if n == "interval":
        raise ArrowNotImplementedError(f"pyarrow cannot build {d!r}")
    if n == "dictionary":
        return pa.dictionary(dtype_to_pyarrow(d.index_type),
                             dtype_to_pyarrow(d.value_type),
                             ordered=bool(d.ordered))
    if n in ("list", "large_list", "list_view", "large_list_view"):
        make = {"list": pa.list_, "large_list": pa.large_list,
                "list_view": pa.list_view,
                "large_list_view": pa.large_list_view}[n]
        return make(dtype_to_pyarrow(d.value_type))
    if n == "fixed_size_list":
        return pa.list_(dtype_to_pyarrow(d.value_type), d.list_size)
    if n == "map":
        kv = d.value_type
        return pa.map_(dtype_to_pyarrow(kv.fields[0].dtype),
                       dtype_to_pyarrow(kv.fields[1].dtype))
    fields = [pa.field(f.name, dtype_to_pyarrow(f.dtype), f.nullable)
              for f in d.fields or ()]
    if n == "struct":
        return pa.struct(fields)
    if n == "union":
        make = pa.sparse_union if d.mode == "sparse" else pa.dense_union
        return make(fields, list(d.type_ids))
    if n == "run_end_encoded":
        return pa.run_end_encoded(dtype_to_pyarrow(d.index_type),
                                  dtype_to_pyarrow(d.value_type))
    raise ArrowNotImplementedError(f"dtype {d}")


# ---- pyarrow -> device (interop.py:203-404) --------------------------------

def _raw(a, i: int, np_dtype, count: int) -> np.ndarray:
    """The first `count` items of buffer `i` (a read-only view)."""
    return np.frombuffer(a.buffers()[i], np_dtype)[:count]


def column_from_pyarrow(arr, device: DeviceLike) -> Column:
    """A pyarrow array (chunked arrays are combined) as a port column on
    `device`."""
    import pyarrow as pa
    import pyarrow.compute as pc
    dev = resolve_device(device)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = arr.type
    ldt = dtype_from_pyarrow(t)
    if ldt.is_null:
        return NullColumn(len(arr), dev)
    valid = arr.is_valid().to_numpy(zero_copy_only=False) \
        if arr.null_count else None
    if ldt.is_primitive and ldt.name != "interval":
        storage = arr
        if ldt.is_temporal:             # dates, times, timestamps, durations
            storage = arr.cast(pa.from_numpy_dtype(ldt.storage_numpy()))
        if arr.null_count:
            storage = pc.fill_null(storage, False if ldt.is_boolean
                                   else 0.0 if ldt.is_floating else 0)
        vals = storage.to_numpy(zero_copy_only=False)
        return from_numpy(vals.astype(ldt.to_numpy(), copy=False), valid,
                          ldt, dev)
    a = arr if arr.offset == 0 else pa.concat_arrays([arr])
    n = len(a)
    mask = None if valid is None else _tensor(valid, dev)
    from ..core import nested as nd
    if ldt.is_string or ldt.is_binary and ldt.name != "fixed_size_binary":
        if ldt.name in ("utf8_view", "binary_view"):
            # views normalise to the offset layout; the type is kept
            a = a.cast(pa.string() if ldt.is_string else pa.binary())
            if a.offset != 0:
                a = pa.concat_arrays([a])
        odt = np.int64 if ldt.name in ("large_utf8", "large_binary") \
            else np.int32
        offs = _raw(a, 1, odt, n + 1)
        data = _raw(a, 2, np.uint8, int(offs[-1])) \
            if a.buffers()[2] is not None else np.zeros(0, np.uint8)
        return StringColumn(_tensor(offs, dev), _tensor(data, dev), ldt, mask)
    if ldt.name == "fixed_size_binary":
        w = t.byte_width
        return nd.FixedSizeBinaryColumn(
            _tensor(_raw(a, 1, np.uint8, n * w).reshape(n, w), dev), mask)
    if ldt.name in ("decimal128", "decimal256"):
        k = 2 if ldt.name == "decimal128" else 4
        return nd.DecimalColumn(_tensor(_raw(a, 1, np.int64, n * k)
                                        .reshape(n, k), dev), ldt, mask)
    if ldt.name in ("decimal32", "decimal64") or ldt.unit == "year_month":
        raw = _raw(a, 1, ldt.storage_numpy(), n)
        return PrimitiveColumn(_tensor(raw, dev), ldt, mask)
    if ldt.unit == "day_time":
        # [i32 days][i32 millis] -> days << 32 | millis (dtypes.py)
        raw = _raw(a, 1, np.dtype([("d", "<i4"), ("ms", "<i4")]), n)
        packed = (raw["d"].astype(np.int64) << 32) \
            | (raw["ms"].astype(np.int64) & 0xFFFFFFFF)
        return PrimitiveColumn(_tensor(packed, dev), ldt, mask)
    if ldt.unit == "month_day_nano":
        raw = _raw(a, 1, np.dtype([("m", "<i4"), ("d", "<i4"),
                                   ("n", "<i8")]), n)
        return nd.IntervalMDNColumn(*(_tensor(raw[p], dev)
                                      for p in ("m", "d", "n")), mask)
    if ldt.is_dictionary:
        idx = arr.indices
        if idx.null_count:
            idx = pc.fill_null(idx, 0)
        return from_numpy(idx.to_numpy(zero_copy_only=False), valid,
                          device=dev, ordered=bool(ldt.ordered),
                          dictionary=column_from_pyarrow(arr.dictionary, dev))
    if ldt.name in ("list", "large_list"):
        odt = np.int64 if ldt.name == "large_list" else np.int32
        return ListColumn(_tensor(_raw(a, 1, odt, n + 1), dev),
                          column_from_pyarrow(a.values, dev), mask,
                          large=ldt.name == "large_list")
    if ldt.name in ("list_view", "large_list_view"):
        odt = np.int64 if ldt.name == "large_list_view" else np.int32
        return nd.ListViewColumn(_tensor(_raw(a, 1, odt, n), dev),
                                 _tensor(_raw(a, 2, odt, n), dev),
                                 column_from_pyarrow(a.values, dev), mask,
                                 ldt)
    if ldt.name == "fixed_size_list":
        return nd.FixedSizeListColumn(column_from_pyarrow(a.values, dev),
                                      t.list_size, mask)
    if ldt.name == "map":
        entries = StructColumn((column_from_pyarrow(a.keys, dev),
                                column_from_pyarrow(a.items, dev)),
                               ldt.value_type.fields)
        return nd.MapColumn(_tensor(_raw(a, 1, np.int32, n + 1), dev),
                            entries, mask)
    if ldt.name == "struct":
        return StructColumn(tuple(column_from_pyarrow(arr.field(i), dev)
                                  for i in range(t.num_fields)),
                            ldt.fields, mask)
    if ldt.name == "union":
        children = [column_from_pyarrow(a.field(i), dev)
                    for i in range(t.num_fields)]
        offs = None if t.mode == "sparse" \
            else _tensor(_raw(a, 2, np.int32, n), dev)
        return nd.UnionColumn(_tensor(_raw(a, 1, np.int8, n), dev), offs,
                              children, ldt.fields, ldt.type_ids)
    if ldt.name == "run_end_encoded":
        return nd.RunEndColumn(column_from_pyarrow(a.run_ends, dev).values,
                               column_from_pyarrow(a.values, dev), n)
    raise ArrowNotImplementedError(f"ingest of {t}")


# ---- device -> pyarrow (interop.py:409-520) --------------------------------

def _vbuf(col):
    """The validity as a pyarrow bitmap buffer, or None."""
    import pyarrow as pa
    if col.validity is None:
        return None
    return pa.py_buffer(np.packbits(host(col.validity), bitorder="little"))


def _mask_arg(col):
    return None if col.validity is None else ~host(col.validity)


def column_to_pyarrow(col: Column):
    """A port column as a pyarrow array: each tensor copied to the host
    once."""
    return _to_pyarrow(to_host(col))


def _to_pyarrow(col: Column):
    """column_to_pyarrow of a host column."""
    import pyarrow as pa
    from ..core import nested as nd
    pa_type = dtype_to_pyarrow(col.dtype)
    buf = lambda a: pa.py_buffer(np.ascontiguousarray(a))
    if isinstance(col, NullColumn):
        return pa.nulls(len(col))
    if isinstance(col, PrimitiveColumn):
        if col.dtype.is_decimal:
            return pa.Array.from_buffers(pa_type, len(col), [
                _vbuf(col), buf(host(col.values))])
        if col.dtype.is_temporal:
            return pa.array(host(col.values), mask=_mask_arg(col)) \
                .cast(pa_type)
        return pa.array(col.to_numpy(), type=pa_type, mask=_mask_arg(col))
    if isinstance(col, StringColumn):
        view = col.dtype.name in ("utf8_view", "binary_view")
        storage = (pa.string() if col.dtype.is_string else pa.binary()) \
            if view else pa_type
        out = pa.Array.from_buffers(storage, len(col), [
            _vbuf(col), buf(host(col.offsets)), buf(host(col.data))])
        return out.cast(pa_type) if view else out
    if isinstance(col, DictionaryColumn):
        codes = pa.array(host(col.codes).view(
            col.dtype.index_type.to_numpy()), mask=_mask_arg(col))
        return pa.DictionaryArray.from_arrays(
            codes, _to_pyarrow(col.values),
            ordered=bool(col.dtype.ordered))
    if isinstance(col, nd.ListViewColumn):
        large = col.dtype.name == "large_list_view"
        m = _mask_arg(col)
        return (pa.LargeListViewArray if large else pa.ListViewArray) \
            .from_arrays(host(col.offsets), host(col.sizes),
                         _to_pyarrow(col.child),
                         mask=None if m is None else pa.array(m))
    if isinstance(col, ListColumn):
        large = col.dtype.name == "large_list"
        child = _to_pyarrow(col.child)
        out = (pa.LargeListArray if large else pa.ListArray).from_arrays(
            pa.array(host(col.offsets)), child)
        if col.validity is not None:
            out = pa.Array.from_buffers(out.type, len(col), [
                _vbuf(col), out.buffers()[1]], children=[child])
        return out
    if isinstance(col, StructColumn):
        children = [_to_pyarrow(c) for c in col.children]
        out = pa.StructArray.from_arrays(children,
                                         [f.name for f in col.fields])
        if col.validity is not None:
            out = pa.Array.from_buffers(out.type, len(col), [_vbuf(col)],
                                        children=children)
        return out
    if isinstance(col, nd.FixedSizeBinaryColumn):
        return pa.Array.from_buffers(pa_type, len(col), [
            _vbuf(col), buf(host(col.data))])
    if isinstance(col, nd.DecimalColumn):
        return pa.Array.from_buffers(pa_type, len(col), [
            _vbuf(col), buf(host(col.limbs))])
    if isinstance(col, nd.IntervalMDNColumn):
        raw = np.zeros(len(col), np.dtype([("m", "<i4"), ("d", "<i4"),
                                           ("n", "<i8")]))
        raw["m"], raw["d"], raw["n"] = (host(col.months), host(col.days),
                                        host(col.nanos))
        return pa.Array.from_buffers(pa_type, len(col), [_vbuf(col),
                                                         buf(raw)])
    if isinstance(col, nd.FixedSizeListColumn):
        return pa.Array.from_buffers(pa_type, len(col), [_vbuf(col)],
                                     children=[_to_pyarrow(col.child)])
    if isinstance(col, nd.MapColumn):
        keys, items = _to_pyarrow(col.keys), _to_pyarrow(
            col.items)
        # the entries carry the map's own struct type (a non-null key)
        entries = pa.Array.from_buffers(
            pa.struct([pa_type.key_field, pa_type.item_field]), len(keys),
            [None], children=[keys, items])
        return pa.Array.from_buffers(pa_type, len(col), [
            _vbuf(col), buf(host(col.offsets))], children=[entries])
    if isinstance(col, nd.UnionColumn):
        bufs = [None, buf(host(col.type_ids))]
        if col.offsets is not None:
            bufs.append(buf(host(col.offsets)))
        return pa.Array.from_buffers(pa_type, len(col), bufs, children=[
            _to_pyarrow(c) for c in col.children])
    if isinstance(col, nd.RunEndColumn):
        return pa.RunEndEncodedArray.from_arrays(
            pa.array(host(col.run_ends)), _to_pyarrow(col.values),
            pa_type)
    raise ArrowNotImplementedError(f"export of {type(col).__name__}")


# ---- tables (interop.py:525-551) --------------------------------------------

def table_from_pyarrow(batch, device: DeviceLike) -> Table:
    """A pyarrow Table (chunks combined) or RecordBatch as a port Table
    on `device`, its fields' names, nullability and metadata kept."""
    import pyarrow as pa
    if isinstance(batch, pa.Table):
        batch = batch.combine_chunks()
    cols = [column_from_pyarrow(batch.column(i), device)
            for i in range(batch.num_columns)]

    def text(x):
        return x.decode() if isinstance(x, bytes) else x

    fields = tuple(dt.Field(f.name, dtype_from_pyarrow(f.type), f.nullable,
                            metadata=tuple(sorted(
                                (text(k), text(v))
                                for k, v in (f.metadata or {}).items())))
                   for f in batch.schema)
    return Table(cols, dt.Schema(fields))


def table_to_pyarrow(table: Table):
    """A port Table as a pyarrow RecordBatch, its fields' nullability and
    metadata kept."""
    import pyarrow as pa
    arrays = [column_to_pyarrow(c) for c in table.columns]
    fields = [pa.field(f.name, a.type, f.nullable,
                       metadata=dict(f.metadata) if f.metadata else None)
              for f, a in zip(table.schema.fields, arrays)]
    return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))
