"""Table: a schema-tagged bundle of equal-length columns on one device
(counterpart of arrow_tpu/core/table.py; record_batch.rs:202).  A torch
pytree node: its columns are the children, its schema the structure."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

from torch.utils import _pytree as pytree

from .. import dtypes as dt
from ..config import DeviceLike
from ..errors import ArrowInvalid, SchemaError
from .column import Column, column as make_column, from_numpy
from .equal import columns_equal

__all__ = ["Table", "RecordBatch"]


class Table:
    """Named, equal-length columns (RecordBatch::try_new semantics,
    record_batch.rs:241: verifies column count and row-length
    agreement)."""

    def __init__(self, columns: Sequence[Column], schema: dt.Schema,
                 *, _validated: bool = False):
        columns = tuple(columns)
        if not _validated:
            if len(columns) != len(schema.fields):
                raise SchemaError(
                    f"{len(columns)} columns vs {len(schema.fields)} fields")
            lengths = {len(c) for c in columns}
            if len(lengths) > 1:
                raise ArrowInvalid(f"column lengths differ: {lengths}")
        self.columns = columns
        self.schema = schema

    @staticmethod
    def from_pydict(data: Dict[str, object],
                    schema: Optional[dt.Schema] = None, *,
                    device: DeviceLike = None) -> "Table":
        """Columns from lists, numpy arrays or Columns, on `device`
        (arrow_tpu/core/table.py:54)."""
        cols, fields = [], []
        for i, (name, raw) in enumerate(data.items()):
            want = schema.fields[i].dtype if schema is not None else None
            col = make_column(raw, dtype=want, device=device)
            cols.append(col)
            fields.append(dt.Field(name, col.dtype,
                                   nullable=col.validity is not None))
        return Table(cols, schema or dt.Schema(tuple(fields)))

    @staticmethod
    def from_numpy_columns(columns: Mapping[str, Mapping[str, object]], *,
                           device: DeviceLike = None) -> "Table":
        """Columns from plain numpy buffers: name -> keyword arguments of
        `core.column.from_numpy` (values, validity, dtype, dictionary)."""
        cols, fields = [], []
        for name, spec in columns.items():
            col = from_numpy(device=device, **spec)
            cols.append(col)
            fields.append(dt.Field(name, col.dtype,
                                   nullable=col.validity is not None))
        return Table(cols, dt.Schema(tuple(fields)))

    @staticmethod
    def from_pyarrow(batch, *, device: DeviceLike = None) -> "Table":
        """A pyarrow Table or RecordBatch on `device` (io/interop.py)."""
        from ..io.interop import table_from_pyarrow
        return table_from_pyarrow(batch, device)

    def __arrow_c_array__(self, requested_schema=None):
        """The Arrow PyCapsule protocol: the table as a struct array (the
        RecordBatch convention), so `pa.record_batch(t)` takes it
        (io/cdata.py; arrow_tpu/core/table.py:150-160)."""
        from ..io.cdata import export_table
        return export_table(self)

    def __arrow_c_stream__(self, requested_schema=None):
        """The PyCapsule stream protocol: `pa.table(t)` takes the table
        as a stream of one batch."""
        from ..io.cdata import export_stream
        return export_stream([self])

    def to_pyarrow(self):
        """The table as a pyarrow RecordBatch (io/interop.py)."""
        from ..io.interop import table_to_pyarrow
        return table_to_pyarrow(self)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    @property
    def column_names(self) -> List[str]:
        return self.schema.names

    def column(self, i) -> Column:
        if isinstance(i, str):
            return self.columns[self.schema.index_of(i)]
        return self.columns[i]

    def __getitem__(self, i) -> Column:
        return self.column(i)

    def __len__(self) -> int:
        return self.num_rows

    def equals(self, other) -> bool:
        """RecordBatch PartialEq (arrow_tpu/core/table.py:95-114): the
        fields' names, types, nullability and metadata, the schema's
        metadata, then every column logically equal, on the columns'
        device with one host sync for the whole table (core/equal.py)."""
        if self is other:
            return True
        if not isinstance(other, Table):
            return False
        if len(self.schema.fields) != len(other.schema.fields):
            return False
        if sorted(self.schema.metadata) != sorted(other.schema.metadata):
            return False
        for f, g in zip(self.schema.fields, other.schema.fields):
            if (f.name, f.dtype, f.nullable) != (g.name, g.dtype,
                                                 g.nullable):
                return False
            if sorted(f.metadata) != sorted(g.metadata):
                return False
        return columns_equal(list(zip(self.columns, other.columns)))

    def select(self, names_or_indices) -> "Table":
        """The columns named or numbered, in that order: the same column
        objects under a projected schema."""
        idx = [self.schema.index_of(i) if isinstance(i, str) else i
               for i in names_or_indices]
        return Table(tuple(self.columns[i] for i in idx),
                     self.schema.project(idx), _validated=True)

    def set_column(self, i: int, field: dt.Field, col: Column) -> "Table":
        """Column i replaced by `col` under `field`; `col` must be on the
        other columns' device."""
        self._check_device(col, skip=i)
        cols = list(self.columns)
        fields = list(self.schema.fields)
        cols[i] = col
        fields[i] = field
        return Table(tuple(cols), dt.Schema(tuple(fields)))

    def append_column(self, name: str, col: Column) -> "Table":
        """`col` added last, nullable when it has a validity; it must be on
        the table's device."""
        self._check_device(col)
        return Table(self.columns + (col,),
                     dt.Schema(self.schema.fields + (
                         dt.Field(name, col.dtype,
                                  nullable=col.validity is not None),)))

    def drop_column(self, name: str) -> "Table":
        idx = self.schema.index_of(name)
        return self.select([i for i in range(self.num_columns) if i != idx])

    def rename_columns(self, names: Sequence[str]) -> "Table":
        fields = tuple(f.with_name(n)
                       for f, n in zip(self.schema.fields, names))
        return Table(self.columns, dt.Schema(fields), _validated=True)

    def _check_device(self, col: Column, skip: Optional[int] = None):
        devs = {c.device for i, c in enumerate(self.columns) if i != skip}
        if devs and devs != {col.device}:
            raise ArrowInvalid(
                f"a column on {col.device} in a table on "
                f"{sorted(str(d) for d in devs)}")

    def slice(self, offset: int, length: int) -> "Table":
        """Rows [offset, offset + length), sharing the columns' storage
        (arrow_tpu/core/table.py:145)."""
        return Table(tuple(c.slice(offset, length) for c in self.columns),
                     self.schema, _validated=True)

    def to_pydict(self):
        """(arrow_tpu/core/table.py:166)"""
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema.fields, self.columns)}

    def __repr__(self):
        cols = ", ".join(f"{f.name}: {f.dtype!r}" for f in self.schema.fields)
        return f"Table[{self.num_rows} rows]({cols})"


RecordBatch = Table


pytree.register_pytree_node(
    Table,
    lambda t: (list(t.columns), t.schema),
    lambda cols, schema: Table(cols, schema, _validated=True),
    serialized_type_name="arrow_tpu_torch.Table")
