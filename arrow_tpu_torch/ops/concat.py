"""concat: append columns and tables (counterpart of
arrow_tpu/ops/concat.py: concat and concat_tables, concat.py:39-202,
238-249).

One torch.cat per buffer.  Primitive columns, and dictionary columns
that share one dictionary object, are covered; every other layout, and
dictionaries that would need merging, join with ROADMAP A7.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core import validity as vd
from ..core.column import Column, DictionaryColumn, PrimitiveColumn
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError, ArrowTypeError

__all__ = ["concat", "concat_tables"]


def _concat_masks(cols: Sequence[Column]) -> vd.Mask:
    if all(c.validity is None for c in cols):
        return None
    return torch.cat([c.is_valid_mask() for c in cols])


def concat(cols: Sequence[Column]) -> Column:
    """concat (concat.rs:371)."""
    if not cols:
        raise ArrowInvalid("concat of zero arrays")
    if len({c.dtype for c in cols}) != 1:
        raise ArrowTypeError(
            f"concat type mismatch: {[c.dtype for c in cols]}")
    c0 = cols[0]
    if len(cols) == 1:
        return c0
    if isinstance(c0, PrimitiveColumn):
        return PrimitiveColumn(torch.cat([c.values for c in cols]),
                               c0.dtype, _concat_masks(cols),
                               _canonical=True)
    if isinstance(c0, DictionaryColumn) and \
            all(c.values is c0.values for c in cols[1:]):
        return DictionaryColumn(torch.cat([c.codes for c in cols]),
                                c0.values, _concat_masks(cols),
                                _canonical=True,
                                ordered=bool(c0.dtype.ordered))
    what = "dictionaries that differ" if isinstance(c0, DictionaryColumn) \
        else type(c0).__name__
    raise ArrowNotImplementedError(f"concat of {what} joins with ROADMAP A7")


def concat_tables(tables: Sequence[Table]) -> Table:
    """concat_batches (concat.rs:470); the first table's schema."""
    if not tables:
        raise ArrowInvalid("concat of zero tables")
    t0 = tables[0]
    for t in tables[1:]:
        if t.schema.names != t0.schema.names:
            raise ArrowInvalid("schema mismatch in concat_tables")
    cols = tuple(concat([t.columns[i] for t in tables])
                 for i in range(len(t0.columns)))
    return Table(cols, t0.schema, _validated=True)
