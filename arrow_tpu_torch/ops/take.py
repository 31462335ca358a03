"""take: gather rows by an index column (counterpart of
arrow_tpu/ops/take.py: take, take_table, _gather_validity, _take_bytes and
the primitive, dictionary and null arms of _take_impl, take.py:35-269).

  primitive   -> values gather + validity gather (take.rs:408,434)
  dictionary  -> codes gather, dictionary shared (take.rs take_dict)
  string      -> offsets rebuilt and bytes gathered on the host, where
                 the port keeps strings (the indices come to the host)
  null        -> a null column of the indices' length

Out-of-range indices clamp, as the reference's unchecked mode does;
`check_bounds=True` verifies and raises instead (one host sync).  Null
indices give null outputs; null slots stay canonical zeros.  Unsigned
indices (uint32 on int32 storage) read as their logical values.  Other
layouts join with ROADMAP A7.
"""

from __future__ import annotations

from typing import Union

import numpy as np
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
    or tensor (on the values' device, or anywhere for a StringColumn)."""
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
        f"take of {type(values).__name__} joins with ROADMAP A7")


def _gather_validity(values: Column, idx: torch.Tensor,
                     indices: PrimitiveColumn) -> vd.Mask:
    """out valid = indices valid AND values[idx] valid (take.rs take_bits)."""
    out = None if values.validity is None else values.validity[idx]
    return vd.union(out, indices.validity)


def _take_strings(values: StringColumn, idx: torch.Tensor,
                  indices: PrimitiveColumn) -> StringColumn:
    """Variable-width gather on the host (_take_bytes, take.py:178-198)."""
    host = idx.cpu()
    h = host.numpy()
    offs = values.offsets.numpy().astype(np.int64)
    starts = offs[h]
    lens = offs[h + 1] - starts
    new_offs = np.zeros(len(h) + 1, np.int64)
    np.cumsum(lens, out=new_offs[1:])
    src = np.repeat(starts - new_offs[:-1], lens) + \
        np.arange(int(new_offs[-1]), dtype=np.int64)
    data = torch.from_numpy(values.data.numpy()[src])
    validity = None if values.validity is None else values.validity[host]
    if indices.validity is not None:
        validity = vd.union(validity, indices.validity.cpu())
    return StringColumn(torch.from_numpy(new_offs.astype(
        values.offsets.numpy().dtype)), data, values.dtype, validity)


def take_table(table: Table, indices, *, check_bounds: bool = False) -> Table:
    """take_record_batch (take.rs:964): one index column over every
    column of the batch."""
    indices = _indices(indices)
    return Table(tuple(take(c, indices, check_bounds=check_bounds)
                       for c in table.columns), table.schema,
                 _validated=True)
