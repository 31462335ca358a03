"""Interchange with the Arrow ecosystem (counterpart of arrow_tpu/io/):
pyarrow interop, the C Data Interface (`cdata`), Arrow IPC streams and
files (`ipc`), Parquet (`parquet_io`, over `parquet_native` and
`parquet_writer`), CSV, JSON, Avro, the integration-test JSON format
and Parquet records.  Flight and FlightSQL (`flight`, `flightsql`, over
the protobuf codec `pb`) need grpc and are imported where they are
used, as the reference's package does not export them either."""

from .interop import (  # noqa: F401
    column_from_pyarrow, column_to_pyarrow,
    table_from_pyarrow, table_to_pyarrow,
    dtype_from_pyarrow, dtype_to_pyarrow,
)
from . import cdata  # noqa: F401
from . import ipc  # noqa: F401
from . import csv  # noqa: F401
from . import json_io  # noqa: F401
from . import parquet_io  # noqa: F401
from . import avro  # noqa: F401
from . import integration_json  # noqa: F401
from . import records  # noqa: F401
