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

    def __len__(self) -> int:
        return self.num_rows

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
