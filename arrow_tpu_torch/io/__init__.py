"""Interchange with the Arrow ecosystem (counterpart of arrow_tpu/io/):
pyarrow interop.  IPC, Parquet, CSV, JSON, Avro and Flight follow
(ROADMAP A8)."""

from .interop import (  # noqa: F401
    column_from_pyarrow, column_to_pyarrow,
    table_from_pyarrow, table_to_pyarrow,
    dtype_from_pyarrow, dtype_to_pyarrow,
)
