"""Kernel templates (counterpart of arrow_tpu/ops/arity.py;
arrow-arith/src/arity.rs:29-305): union the null buffers once, then run a
branch-free value expression.  Checked variants compute an elementwise
error tensor; the caller syncs the flag and raises."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import dtypes as dt
from ..core.column import PrimitiveColumn
from ..config import in_fused_region
from ..core.datum import Datum, broadcast_pair
from ..errors import ArrowError

__all__ = ["unary", "binary", "binary_with_flag", "check_flag"]


def unary(col: PrimitiveColumn, fn: Callable,
          out_dtype: Optional[dt.DataType] = None) -> PrimitiveColumn:
    """Apply fn over values; validity passes through (arity.rs `unary`)."""
    out = fn(col.values)
    return PrimitiveColumn(out, out_dtype or col.dtype, col.validity,
                           _canonical=col.validity is None)


def binary(lhs: Datum, rhs: Datum, fn: Callable,
           out_dtype: Optional[dt.DataType] = None,
           require_same_type: bool = True) -> PrimitiveColumn:
    """Binary kernel: joint validity = union, values = fn(l, r)."""
    lv, rv, mask, _, ldt, rdt = broadcast_pair(lhs, rhs)
    if require_same_type and ldt != rdt:
        raise ArrowError(
            f"binary kernel type mismatch: {ldt!r} vs {rdt!r} "
            "(cast first, as in the reference)")
    out = fn(lv, rv)
    return PrimitiveColumn(out, out_dtype or ldt, mask,
                           _canonical=mask is None)


def binary_with_flag(lhs: Datum, rhs: Datum, fn: Callable,
                     out_dtype: Optional[dt.DataType] = None,
                     require_same_type: bool = True
                     ) -> Tuple[PrimitiveColumn, torch.Tensor]:
    """Checked binary kernel (arity.rs try_binary): fn returns
    (values, elementwise_error).  Errors on null slots are ignored.
    Returns (column, 0-d bool error flag on the device)."""
    lv, rv, mask, _, ldt, rdt = broadcast_pair(lhs, rhs)
    if require_same_type and ldt != rdt:
        raise ArrowError(f"binary kernel type mismatch: {ldt!r} vs {rdt!r}")
    out, err = fn(lv, rv)
    if mask is not None:
        err = torch.logical_and(err, mask)
    return PrimitiveColumn(out, out_dtype or ldt, mask,
                           _canonical=mask is None), err.any()


def check_flag(flag: torch.Tensor, exc_type, message: str) -> None:
    """Sync point of the eager API: raise if the error flag fired.
    Inside a captured pipeline (`fuse` on the card) the check is skipped
    and checked ops behave as wrapping, as in the reference's fused
    regions (arity.py:66-77)."""
    if in_fused_region():
        return
    if bool(flag):
        raise exc_type(message)
