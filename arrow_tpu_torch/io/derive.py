"""Record <-> dataclass derive (the parquet_derive role; counterpart of
arrow_tpu/io/derive.py).

The reference's parquet_derive proc-macros generate per-struct
ParquetRecordWriter / ParquetRecordReader impls; the Python analog
derives the Arrow schema from dataclass type hints at runtime:

    @dataclass
    class Trade:
        id: int
        px: float
        sym: Optional[str]

    write_records("t.parquet", trades)                       # list[Trade]
    back = read_records("t.parquet", Trade, device="cuda")   # list[Trade]

Supported hints: int (int64), float (float64), bool, str, bytes,
datetime.date (date32), datetime.datetime (timestamp[us]),
Optional[...] of those, List[...] of those, and nested dataclasses
(struct).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import typing
from typing import List, Optional, Sequence, Type

from .. import dtypes as dt
from ..config import DeviceLike
from ..core.table import Table
from ..errors import ArrowTypeError

__all__ = ["derive_schema", "records_to_table", "table_to_records",
           "write_records", "read_records"]

_SIMPLE = {
    int: dt.int64, float: dt.float64, bool: dt.bool_, str: dt.utf8,
    bytes: dt.binary, _dt.date: dt.date32,
}


def _hint_to_dtype(hint) -> dt.DataType:
    if hint in _SIMPLE:
        return _SIMPLE[hint]
    if hint is _dt.datetime:
        return dt.timestamp("us")
    origin = typing.get_origin(hint)
    args = typing.get_args(hint)
    if origin is typing.Union:
        inner = [a for a in args if a is not type(None)]
        if len(inner) != 1:
            raise ArrowTypeError(f"unsupported union hint {hint}")
        return _hint_to_dtype(inner[0])
    if origin in (list, typing.List):
        return dt.list_(_hint_to_dtype(args[0]))
    if dataclasses.is_dataclass(hint):
        return dt.struct([
            dt.Field(f.name, _hint_to_dtype(f.type
                                            if not isinstance(f.type, str)
                                            else typing.get_type_hints(
                                                hint)[f.name]))
            for f in dataclasses.fields(hint)])
    raise ArrowTypeError(f"no arrow type for hint {hint}")


def _is_optional(hint) -> bool:
    return typing.get_origin(hint) is typing.Union and \
        type(None) in typing.get_args(hint)


def derive_schema(cls: Type) -> dt.Schema:
    """Arrow schema derived from a dataclass (the derive macro's output)."""
    if not dataclasses.is_dataclass(cls):
        raise ArrowTypeError(f"{cls} is not a dataclass")
    hints = typing.get_type_hints(cls)
    fields = []
    for f in dataclasses.fields(cls):
        h = hints[f.name]
        fields.append(dt.Field(f.name, _hint_to_dtype(h),
                               nullable=_is_optional(h)))
    return dt.Schema(tuple(fields))


def records_to_table(records: Sequence, cls: Optional[Type] = None, *,
                     device: DeviceLike) -> Table:
    """ParquetRecordWriter analog: rows of one dataclass -> Table on
    `device`."""
    if cls is None:
        if not records:
            raise ArrowTypeError("empty records and no class given")
        cls = type(records[0])
    schema = derive_schema(cls)
    cols = {}
    for f in dataclasses.fields(cls):
        vals = [getattr(r, f.name) for r in records]
        vals = [dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                else v for v in vals]
        cols[f.name] = vals
    import pyarrow as pa
    from .interop import table_from_pyarrow, dtype_to_pyarrow
    arrays = {name: pa.array(vals, dtype_to_pyarrow(
        schema.field(name).dtype)) for name, vals in cols.items()}
    batch = pa.record_batch(list(arrays.values()),
                            names=list(arrays.keys()))
    t = table_from_pyarrow(batch, device)
    return Table(t.columns, schema)


def _rebuild(v, h):
    """Recursively reconstruct typed values from plain dicts/lists
    (nested dataclasses at any depth, dataclasses inside List[...])."""
    base = h
    if _is_optional(h):
        base = [a for a in typing.get_args(h)
                if a is not type(None)][0]
    if v is None:
        return None
    if dataclasses.is_dataclass(base) and isinstance(v, dict):
        hints = typing.get_type_hints(base)
        return base(**{f.name: _rebuild(v.get(f.name), hints[f.name])
                       for f in dataclasses.fields(base)})
    origin = typing.get_origin(base)
    if origin in (list, typing.List) and isinstance(v, list):
        (arg,) = typing.get_args(base) or (None,)
        if arg is not None:
            return [_rebuild(x, arg) for x in v]
    return v


def table_to_records(table: Table, cls: Type) -> List:
    """ParquetRecordReader analog: Table -> rows of the dataclass."""
    data = table.to_pydict()
    hints = typing.get_type_hints(cls)
    n = table.num_rows
    out = []
    for i in range(n):
        kwargs = {f.name: _rebuild(data[f.name][i], hints[f.name])
                  for f in dataclasses.fields(cls)}
        out.append(cls(**kwargs))
    return out


def write_records(path, records: Sequence, cls: Optional[Type] = None,
                  **kw) -> None:
    """#[derive(ParquetRecordWriter)] + write (parquet_derive); the
    table is built on the host, where the writer reads it."""
    from .parquet_io import write_parquet
    write_parquet(path, records_to_table(records, cls, device="cpu"), **kw)


def read_records(path, cls: Type, *, device: DeviceLike) -> List:
    """#[derive(ParquetRecordReader)] + read, through `device`."""
    from .parquet_io import read_parquet
    return table_to_records(read_parquet(path, device=device), cls)
