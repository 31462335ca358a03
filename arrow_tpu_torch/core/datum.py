"""Datum: scalar-vs-array broadcasting for kernel arguments
(counterpart of arrow_tpu/core/datum.py; arrow-array/src/scalar.rs:78).

A scalar is a 0-d tensor of its type's storage (numeric, bool and
temporal types alike; a utf8, dictionary or decimal scalar keeps its
Python value, a decimal's a `decimal.Decimal` as the reference's
reductions give it).  A scalar on
the host meets a column on the card as a one-element fill on that
device, expanded without copying: no copy from host memory, so a
pipeline that builds scalars from Python values can be captured by
`fuse`.  Scalar is a torch pytree node: its tensor is the leaf.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import dtypes as dt
from ..errors import ArrowTypeError
from ..utils.trace import to_host
from . import validity as vd
from .column import Column, PrimitiveColumn

__all__ = ["Scalar", "Datum", "scalar", "as_datum", "broadcast_pair"]


def _host_valued(dtype: dt.DataType) -> bool:
    return dtype.is_string or dtype.is_dictionary or dtype.is_decimal \
        or not dtype.is_single_tensor


class Scalar:
    """A single (possibly null) value with a logical type.  `value` is a
    0-d tensor of the type's storage dtype (the Python value, or None
    when null, for utf8, dictionary, decimal and nested types); the null
    flag is `valid` / `as_py()`."""

    def __init__(self, value, dtype: dt.DataType, valid: bool = True):
        if _host_valued(dtype):
            value = value if valid else None
        elif not isinstance(value, torch.Tensor):
            host = np.asarray(0 if not valid else value, dtype=dtype.to_numpy())
            value = torch.from_numpy(
                host.reshape(1).view(dtype.storage_numpy())).reshape(())
        self.value = value
        self.dtype = dtype
        self.valid = valid

    def as_py(self):
        """Host value (None when null)."""
        if not self.valid:
            return None
        if _host_valued(self.dtype):
            return self.value
        return to_host("scalar.as_py", self.value).numpy().view(
            self.dtype.to_numpy()).item()

    def __repr__(self):
        return f"Scalar<{self.dtype!r}>({self.as_py()})"


pytree.register_pytree_node(
    Scalar,
    lambda x: ([x.value], (x.dtype, x.valid)),
    lambda leaves, ctx: Scalar(leaves[0], *ctx),
    serialized_type_name="arrow_tpu_torch.Scalar")

Datum = Union[Column, Scalar]


def scalar(value, dtype: Optional[dt.DataType] = None) -> Scalar:
    if value is None:
        if dtype is None:
            raise ArrowTypeError("null scalar requires a dtype")
        return Scalar(0, dtype, valid=False)
    if dtype is None:
        if isinstance(value, (bool, np.bool_)):
            dtype = dt.bool_
        elif isinstance(value, (int, np.integer)):
            dtype = dt.int64
        elif isinstance(value, (float, np.floating)):
            dtype = dt.float64
        else:
            raise ArrowTypeError(f"cannot infer scalar dtype for {type(value)}")
    return Scalar(value, dtype)


def as_datum(x) -> Datum:
    """Columns and scalars pass through; Python numbers become scalars.
    Arrays must be built into columns first, on an explicit device."""
    if isinstance(x, (Column, Scalar)):
        return x
    if isinstance(x, (bool, int, float, np.generic)) or x is None:
        return scalar(x)
    raise ArrowTypeError(
        f"expected a Column or a scalar, got {type(x)}; build a column "
        "with an explicit device first")


def broadcast_pair(lhs: Datum, rhs: Datum
                   ) -> Tuple[torch.Tensor, torch.Tensor, vd.Mask, int,
                              dt.DataType, dt.DataType]:
    """Resolve (lhs, rhs) datums to equal-length value tensors + joint mask.

    Returns (l_values, r_values, joint_validity, length, l_dtype, r_dtype)
    (arrow-arith/src/arity.rs:29-305 length/broadcast rules); scalar
    nullness folds into the mask.
    """
    lhs, rhs = as_datum(lhs), as_datum(rhs)
    if isinstance(lhs, Scalar) and isinstance(rhs, Scalar):
        raise ArrowTypeError("at least one side must be a Column")
    col = lhs if isinstance(lhs, Column) else rhs
    n, device = len(col), col.device
    if isinstance(lhs, Column) and isinstance(rhs, Column):
        if len(lhs) != len(rhs):
            raise ArrowTypeError(f"length mismatch: {len(lhs)} vs {len(rhs)}")
        if lhs.device != rhs.device:
            raise ArrowTypeError(
                f"device mismatch: {lhs.device} vs {rhs.device}")

    def parts(x):
        if isinstance(x, Scalar):
            vals = x.value
            if vals.device != device:        # a fill, not a host copy
                vals = torch.full((), vals.item(), dtype=vals.dtype,
                                  device=device)
            vals = vals.expand(n)
            mask = None if x.valid else torch.zeros((n,), dtype=torch.bool,
                                                    device=device)
            return vals, mask, x.dtype
        if not isinstance(x, PrimitiveColumn):
            raise ArrowTypeError(
                f"binary kernel expects primitive columns, got {type(x)}")
        return x.values, x.validity, x.dtype

    lv, lm, ldt = parts(lhs)
    rv, rm, rdt = parts(rhs)
    return lv, rv, vd.union(lm, rm), n, ldt, rdt
