"""Interchange with the Arrow ecosystem (counterpart of arrow_tpu/io/):
pyarrow interop, the C Data Interface (`cdata`), Arrow IPC streams and
files (`ipc`) and Parquet (`parquet_io`, over `parquet_native` and
`parquet_writer`).  CSV, JSON, Avro and Flight follow (ROADMAP A8)."""

from .interop import (  # noqa: F401
    column_from_pyarrow, column_to_pyarrow,
    table_from_pyarrow, table_to_pyarrow,
    dtype_from_pyarrow, dtype_to_pyarrow,
)
from . import cdata  # noqa: F401
from . import ipc  # noqa: F401
from . import parquet_io  # noqa: F401
