"""arrow_tpu_torch: the PyTorch and CUDA port of arrow_tpu.

Columns and tables hold torch tensors on one explicit device.  Every
TPU kernel of the reference becomes a CUDA kernel for Hopper (sm_90a)
in csrc/, built at first use; beside each sits its plain PyTorch
version, which CPU tensors take.  The JAX package is the reference the
port is tested against; this package imports neither it nor JAX.
"""

from . import dtypes
from .core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                          PrimitiveColumn, StringColumn, StructColumn, column,
                          from_numpy)
from .core.datum import Scalar, scalar
from .core.table import Table

__all__ = ["dtypes", "Column", "PrimitiveColumn", "StringColumn",
           "DictionaryColumn", "ListColumn", "StructColumn", "NullColumn",
           "column", "from_numpy", "Scalar", "scalar", "Table"]
