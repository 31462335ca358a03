"""Tensor (counterpart of arrow_tpu/core/tensor.py; arrow src/tensor.rs):
a dense n-dimensional value container over one device tensor, with
shape, strides, dimension names, the row/column-major predicates and
the pyarrow interchange."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..errors import ArrowInvalid

__all__ = ["Tensor"]


class Tensor:
    def __init__(self, data: torch.Tensor,
                 dim_names: Optional[Sequence[str]] = None):
        if not isinstance(data, torch.Tensor):
            raise ArrowInvalid("Tensor wraps a torch.Tensor on its device")
        self.data = data.contiguous()
        if dim_names is not None and len(dim_names) != self.data.dim():
            raise ArrowInvalid("dim_names length != ndim")
        self.dim_names = tuple(dim_names) if dim_names is not None else None

    @property
    def dtype(self) -> dt.DataType:
        return dt.from_numpy_dtype(dt.torch_dtype_name(self.data.dtype))

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.dim()

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def strides(self) -> Tuple[int, ...]:
        """Row-major byte strides."""
        item = self.data.element_size()
        return tuple(s * item for s in self.data.stride())

    def dim_name(self, i: int) -> Optional[str]:
        return None if self.dim_names is None else self.dim_names[i]

    def is_contiguous(self) -> bool:
        return True

    def is_row_major(self) -> bool:
        return True

    def is_column_major(self) -> bool:
        return self.ndim <= 1

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def to_pyarrow(self):
        import pyarrow as pa
        return pa.Tensor.from_numpy(self.to_numpy(), dim_names=list(
            self.dim_names) if self.dim_names else None)

    @staticmethod
    def from_pyarrow(t, *, device) -> "Tensor":
        """A pyarrow Tensor on `device`."""
        from ..config import resolve_device
        names = list(t.dim_names) if t.dim_names else None
        return Tensor(torch.from_numpy(np.array(t.to_numpy())).to(
            resolve_device(device)), names)

    def __repr__(self):
        names = f", dim_names={self.dim_names}" if self.dim_names else ""
        return f"Tensor(shape={self.shape}, dtype={self.dtype!r}{names})"
