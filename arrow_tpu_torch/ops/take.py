"""take: gather rows by an index column (counterpart of
arrow_tpu/ops/take.py: take, take_table, _gather_validity, _take_bytes and
the primitive, dictionary and null arms of _take_impl, take.py:35-269).

  primitive   -> values gather + validity gather (take.rs:408,434)
  dictionary  -> codes gather, dictionary shared (take.rs take_dict)
  string      -> new offsets from a cumsum of the gathered lengths, a
                 byte map from a scatter and a cumsum, and a byte gather,
                 on the device; reading the total byte count is the one
                 host sync (take.py:178-198)
  null        -> a null column of the indices' length

Out-of-range indices clamp, as the reference's unchecked mode does;
`check_bounds=True` verifies and raises instead (one host sync).  Null
indices give null outputs; null slots stay canonical zeros.  Unsigned
indices (uint32 on int32 storage) read as their logical values.  Other
layouts join with ROADMAP A7.3.
"""

from __future__ import annotations

from typing import Union

import torch

from .. import dtypes as dt
from ..config import sync_guard
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, NullColumn,
                           PrimitiveColumn, StringColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError

__all__ = ["take", "take_table"]


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
    idx = dt.widen(indices.values, indices.dtype)
    if check_bounds:
        sync_guard("take(check_bounds=True)")
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
    if isinstance(values, StringColumn):
        return _take_strings(values, idx, indices)
    if isinstance(values, NullColumn):
        return NullColumn(idx.shape[0], idx.device)
    raise ArrowNotImplementedError(
        f"take of {type(values).__name__} joins with ROADMAP A7.3")


def _gather_validity(values: Column, idx: torch.Tensor,
                     indices: PrimitiveColumn) -> vd.Mask:
    """out valid = indices valid AND values[idx] valid (take.rs take_bits)."""
    out = None if values.validity is None else values.validity[idx]
    return vd.union(out, indices.validity)


def _take_strings(values: StringColumn, idx: torch.Tensor,
                  indices: PrimitiveColumn) -> StringColumn:
    """Variable-width gather on the device (_take_bytes,
    take.py:178-198).  Each output byte's source index grows by one
    along a row and jumps to the row's start where the row begins (the
    jumps of empty rows add up to the next row's), so a scatter of the
    jumps and a cumsum give the byte map."""
    offs = values.offsets
    starts = offs.index_select(0, idx).to(torch.int64)
    ends = offs.index_select(0, idx + 1).to(torch.int64)
    new_offs = torch.zeros(idx.shape[0] + 1, dtype=torch.int64,
                           device=idx.device)
    torch.cumsum(ends - starts, 0, out=new_offs[1:])
    total = int(new_offs[-1])              # the one host sync
    # int32 maps while the bytes fit: half the traffic
    ix = torch.int32 if max(total, values.data.shape[0]) < 2 ** 31 \
        else torch.int64
    prev_end = torch.cat([ends.new_ones(1), ends[:-1]])
    step = torch.ones(total + 1, dtype=ix, device=idx.device)
    step.index_add_(0, new_offs[:-1], (starts - prev_end).to(ix))
    src = torch.cumsum(step[:total], 0, dtype=ix)
    return StringColumn(new_offs.to(offs.dtype),
                        values.data.index_select(0, src), values.dtype,
                        _gather_validity(values, idx, indices))


def take_table(table: Table, indices, *, check_bounds: bool = False) -> Table:
    """take_record_batch (take.rs:964): one index column over every
    column of the batch."""
    indices = _indices(indices)
    return Table(tuple(take(c, indices, check_bounds=check_bounds)
                       for c in table.columns), table.schema,
                 _validated=True)
