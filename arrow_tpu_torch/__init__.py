"""arrow_tpu_torch: the PyTorch and CUDA port of arrow_tpu.

Columns and tables hold torch tensors on one explicit device.  Every
TPU kernel of the reference becomes a CUDA kernel for Hopper (sm_90a)
in csrc/, built at first use; beside each sits its plain PyTorch
version, which CPU tensors take.  The JAX package is the reference the
port is tested against; this package imports neither it nor JAX.

The top level holds what the reference's does (arrow_tpu/__init__.py):
the types, errors, column classes, Scalar, Table, Tensor, `fuse`, the
memory pools, `builders`, the display and timing helpers, and
`compute`, every kernel flat.  pyarrow interop is `arrow_tpu_torch.io`.
"""

from . import dtypes
from .dtypes import (  # noqa: F401
    DataType, Field, Schema, ExtensionType,
    null, bool_, int8, int16, int32, int64,
    uint8, uint16, uint32, uint64, float16, float32, float64,
    utf8, large_utf8, utf8_view, binary, large_binary, binary_view,
    fixed_size_binary, date32, date64,
    timestamp, time32, time64, duration, interval,
    decimal32, decimal64, decimal128, decimal256,
    dictionary, list_, large_list, struct, fixed_size_list, map_,
    union, run_end_encoded,
    uuid, json_, bool8, fixed_shape_tensor, opaque,
)
from .errors import (  # noqa: F401
    ArrowError, ArrowTypeError, ArrowInvalid, ArrowNotImplementedError,
    ArithmeticOverflow, DivideByZero, CastError, ParseError,
)
from .core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                          PrimitiveColumn, StringColumn, StructColumn, column,
                          from_numpy)
from .core.nested import (  # noqa: F401
    FixedSizeListColumn, FixedSizeBinaryColumn, MapColumn,
    UnionColumn, RunEndColumn, DecimalColumn, IntervalMDNColumn,
)
from .core.datum import Scalar, scalar
from .core.table import RecordBatch, Table
from .core.tensor import Tensor  # noqa: F401
from .fuse import fuse  # noqa: F401
from .core.pool import (  # noqa: F401
    MemoryPool, TrackingMemoryPool, MemoryReservation,
    column_memory_size, table_memory_size,
)
from .core import builders  # noqa: F401
from .utils.display import (  # noqa: F401
    FormatOptions, ArrayFormatter, pretty_format_table,
    pretty_format_columns,
)
from .utils.trace import op_timer, timings, OpTimings  # noqa: F401
from . import compute  # noqa: F401

__version__ = "0.1.0"

__all__ = ["dtypes", "Column", "PrimitiveColumn", "StringColumn",
           "DictionaryColumn", "ListColumn", "StructColumn", "NullColumn",
           "column", "from_numpy", "Scalar", "scalar", "Table",
           "RecordBatch", "compute", "builders", "fuse", "Tensor",
           "op_timer", "timings", "OpTimings"]
