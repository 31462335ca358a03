"""Whole-array reductions (counterpart of arrow_tpu/ops/aggregate.py;
arrow-arith/src/aggregate.rs): `sum_` and `count`.

  - nulls are skipped; empty or all-null input -> null scalar
  - `sum_` wraps on integer overflow in the column's own type (unsigned
    sums wrap on their signed storage: the same bits mod 2^width)
  - float sums are IEEE; their order is torch's, not XLA's
"""

from __future__ import annotations

import torch

from ..core import validity as vd
from ..core.column import Column, PrimitiveColumn
from ..core.datum import Scalar
from ..errors import ArrowTypeError

__all__ = ["sum_", "count"]


def sum_(col: PrimitiveColumn) -> Scalar:
    """Wrapping sum (aggregate.rs sum_array)."""
    if not col.dtype.is_numeric:
        raise ArrowTypeError(f"sum of {col.dtype!r}")
    if count(col) == 0:
        return Scalar(0, col.dtype, valid=False)
    vals = vd.canonicalize(col.values, col.validity)   # nulls -> 0
    return Scalar(torch.sum(vals, dtype=vals.dtype), col.dtype)


def count(col: Column) -> int:
    """Non-null count."""
    return len(col) - col.null_count
