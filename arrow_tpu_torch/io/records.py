"""Row-oriented Parquet record API (parquet/src/record/; counterpart of
arrow_tpu/io/records.py).

The reference's `RowIter` / `Row` / `Field` accessor surface
(record/reader.rs:689 RowIter::from_file, record/api.rs:49 Row,
api.rs:144-182 typed getters, api.rs:111 to_json_value): iterate a
parquet file row by row with type-checked accessors and a JSON value
bridge.  Batches decode columnarly through the native reader
(io/parquet_native.py) and are viewed row-wise host-side — the
columnar decode stays the hot path; this API is the ergonomic shell.
Batches are read onto the caller's `device` and each copied to the
host once for its rows.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, Iterator, List as _ListT, Optional, Sequence

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..errors import ArrowTypeError
from . import hostio

__all__ = ["Row", "List", "Map", "RowIter", "read_records"]

_INT_GETTERS = {
    "get_byte": ("int8",), "get_short": ("int16",), "get_int": ("int32",),
    "get_long": ("int64", "timestamp", "duration", "time64"),
    "get_ubyte": ("uint8",), "get_ushort": ("uint16",),
    "get_uint": ("uint32",), "get_ulong": ("uint64",),
}


class Row:
    """One record: ordered (name, value, dtype) triples (api.rs:49)."""

    def __init__(self, names: Sequence[str], values: Sequence[Any],
                 dtypes: Sequence[dt.DataType]):
        self._names = list(names)
        self._values = list(values)
        self._dtypes = list(dtypes)

    def __len__(self):
        return len(self._names)

    def get_column_iter(self):
        """(name, value) pairs (api.rs:101 RowColumnIter)."""
        return iter(zip(self._names, self._values))

    def _at(self, i: int):
        return self._values[i], self._dtypes[i]

    def _typed(self, i: int, names, what: str):
        v, d = self._at(i)
        if d.name not in names:
            raise ArrowTypeError(f"cannot access {d!r} as {what}")
        return v

    def get_bool(self, i: int) -> bool:
        return self._typed(i, ("bool",), "bool")

    def get_float16(self, i: int) -> float:
        return self._typed(i, ("float16",), "float16")

    def get_float(self, i: int) -> float:
        return self._typed(i, ("float32",), "float")

    def get_double(self, i: int) -> float:
        return self._typed(i, ("float64",), "double")

    def get_timestamp_millis(self, i: int) -> int:
        v, d = self._at(i)
        if d.name != "timestamp" or d.unit != "ms":
            raise ArrowTypeError(f"cannot access {d!r} as timestamp_millis")
        return v

    def get_timestamp_micros(self, i: int) -> int:
        v, d = self._at(i)
        if d.name != "timestamp" or d.unit != "us":
            raise ArrowTypeError(f"cannot access {d!r} as timestamp_micros")
        return v

    def get_decimal(self, i: int):
        v, d = self._at(i)
        if not d.is_decimal:
            raise ArrowTypeError(f"cannot access {d!r} as decimal")
        return v

    def get_string(self, i: int) -> str:
        v, d = self._at(i)
        if not d.is_string:
            raise ArrowTypeError(f"cannot access {d!r} as string")
        return v

    def get_bytes(self, i: int) -> bytes:
        v, d = self._at(i)
        if not (d.is_binary or d.is_string):
            raise ArrowTypeError(f"cannot access {d!r} as bytes")
        return v.encode() if isinstance(v, str) else v

    def get_group(self, i: int) -> "Row":
        v, d = self._at(i)
        if d.name != "struct":
            raise ArrowTypeError(f"cannot access {d!r} as group")
        return Row([f.name for f in d.fields],
                   [None if v is None else v.get(f.name)
                    for f in d.fields],
                   [f.dtype for f in d.fields])

    def get_list(self, i: int) -> "List":
        v, d = self._at(i)
        if d.name not in ("list", "large_list", "fixed_size_list"):
            raise ArrowTypeError(f"cannot access {d!r} as list")
        return List([] if v is None else v, d.value_type)

    def get_map(self, i: int) -> "Map":
        v, d = self._at(i)
        if d.name != "map":
            raise ArrowTypeError(f"cannot access {d!r} as map")
        kv = d.value_type
        return Map([] if v is None else v,
                   kv.fields[0].dtype, kv.fields[1].dtype)

    def to_json_value(self) -> Dict[str, Any]:
        """api.rs:111: {name: json} with base64 bytes, stringly
        decimals/temporals."""
        return {n: _field_json(v, d) for n, v, d in
                zip(self._names, self._values, self._dtypes)}

    def __repr__(self):
        inner = ", ".join(f"{n}: {v!r}" for n, v in self.get_column_iter())
        return "{" + inner + "}"

    def __eq__(self, other):
        return isinstance(other, Row) and self._names == other._names \
            and self._values == other._values


def _make_int_getter(name, dnames):
    def getter(self, i):
        return self._typed(i, dnames, name[4:])
    getter.__name__ = name
    return getter


for _n, _d in _INT_GETTERS.items():
    setattr(Row, _n, _make_int_getter(_n, _d))


class List:
    """api.rs:308."""

    def __init__(self, elements, value_dtype: dt.DataType):
        self.elements = list(elements)
        self.value_dtype = value_dtype

    def __len__(self):
        return len(self.elements)

    def __getitem__(self, i):
        return self.elements[i]


class Map:
    """api.rs:456."""

    def __init__(self, entries, key_dtype, item_dtype):
        self.entries = [tuple(e) for e in entries]
        self.key_dtype = key_dtype
        self.item_dtype = item_dtype

    def __len__(self):
        return len(self.entries)

    def keys(self):
        return [k for k, _ in self.entries]

    def values(self):
        return [v for _, v in self.entries]


def _field_json(v, d: dt.DataType):
    if v is None:
        return None
    n = d.name
    if d.is_decimal:
        return str(v)
    if n in ("timestamp", "date32", "date64", "time32", "time64"):
        # reference renders temporals as strings (api.rs convert_*)
        from ..core.column import NullColumn
        from ..utils.display import ArrayFormatter
        return ArrayFormatter(NullColumn(0, "cpu"))._fmt(v, d)
    if d.is_binary:
        return base64.b64encode(v if isinstance(v, bytes)
                                else bytes(v)).decode()
    if n == "struct":
        return {f.name: _field_json(None if v is None else v.get(f.name),
                                    f.dtype) for f in d.fields}
    if n in ("list", "large_list", "fixed_size_list"):
        return [_field_json(e, d.value_type) for e in v]
    if n == "map":
        kv = d.value_type
        return {str(_field_json(k, kv.fields[0].dtype)):
                _field_json(x, kv.fields[1].dtype) for k, x in v}
    if n == "float16":
        return float(v)
    return v


class RowIter:
    """Iterate a parquet file's records (record/reader.rs:689).

    Decodes columnar batches through the native reader, then yields
    host-side Row views; `projection` narrows columns, `batch_size`
    bounds memory (with_batch_size, reader.rs:759); batches are decoded
    onto `device`."""

    def __init__(self, path, projection: Optional[Sequence[str]] = None,
                 batch_size: int = 65536, *, device: DeviceLike):
        self.device = resolve_device(device)
        self.path = path
        self.projection = list(projection) if projection else None
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[Row]:
        from .parquet_io import ParquetReaderBuilder
        b = ParquetReaderBuilder(self.path, device=self.device)
        if self.projection:
            b = b.with_projection(self.projection)
        b = b.with_batch_size(self.batch_size)
        for table in b.build():
            names = [f.name for f in table.schema.fields]
            dtypes = [f.dtype for f in table.schema.fields]
            cols = [c.to_pylist() for c in hostio.to_host(table).columns]
            for i in range(len(table)):
                yield Row(names, [c[i] for c in cols], dtypes)

    @classmethod
    def from_file(cls, path, projection=None, *,
                  device: DeviceLike) -> "RowIter":
        return cls(path, projection, device=device)


def read_records(path, projection: Optional[Sequence[str]] = None,
                 limit: Optional[int] = None, *,
                 device: DeviceLike) -> _ListT[Row]:
    out = []
    for row in RowIter(path, projection, device=device):
        out.append(row)
        if limit is not None and len(out) >= limit:
            break
    return out
