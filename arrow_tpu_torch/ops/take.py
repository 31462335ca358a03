"""take: gather rows by an index column (counterpart of
arrow_tpu/ops/take.py: take, _gather_validity and the primitive and
dictionary arms of _take_impl, take.py:35-150).

  primitive   -> values gather + validity gather (take.rs:408,434)
  dictionary  -> codes gather, dictionary shared (take.rs take_dict)

Out-of-range indices clamp, as the reference's unchecked mode does;
`check_bounds=True` verifies and raises instead.  Null indices give null
outputs; null slots stay canonical zeros.  Other layouts join with
ROADMAP A7.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import Column, DictionaryColumn, PrimitiveColumn
from ..errors import ArrowInvalid, ArrowNotImplementedError

__all__ = ["take"]


def _indices(indices: Union[PrimitiveColumn, torch.Tensor]) -> PrimitiveColumn:
    if isinstance(indices, torch.Tensor):
        indices = PrimitiveColumn(
            indices, dt.from_numpy_dtype(dt.torch_dtype_name(indices.dtype)))
    if not isinstance(indices, PrimitiveColumn) or \
            not indices.dtype.is_integer:
        raise ArrowInvalid("take indices must be an integer column")
    return indices


def take(values: Column, indices, *, check_bounds: bool = False) -> Column:
    """values[indices] (take.rs:86); indices: an integer PrimitiveColumn
    or tensor on the values' device."""
    indices = _indices(indices)
    n = len(values)
    idx = indices.values.to(torch.int64)
    if check_bounds:
        bad = ((idx < 0) | (idx >= n)) & indices.is_valid_mask()
        if bool(bad.any()):
            raise ArrowInvalid(f"take index out of bounds 0..{n}")
    idx = idx.clamp(0, max(n - 1, 0))
    if isinstance(values, PrimitiveColumn):
        return PrimitiveColumn(values.values[idx], values.dtype,
                               _gather_validity(values, idx, indices))
    if isinstance(values, DictionaryColumn):
        return DictionaryColumn(values.codes[idx], values.values,
                                _gather_validity(values, idx, indices),
                                ordered=bool(values.dtype.ordered))
    raise ArrowNotImplementedError(
        f"take of {type(values).__name__} joins with ROADMAP A7")


def _gather_validity(values: Column, idx: torch.Tensor,
                     indices: PrimitiveColumn) -> vd.Mask:
    """out valid = indices valid AND values[idx] valid (take.rs take_bits)."""
    out = None if values.validity is None else values.validity[idx]
    return vd.union(out, indices.validity)
