"""filter: select rows where a boolean predicate is true (counterpart of
arrow_tpu/ops/filter.py; arrow-select/src/filter.rs).

    keep = predicate_values AND predicate_validity   (prep_null_mask,
                                                      filter.rs:116)
    count = popcount(keep)                            (filter.rs:111)
    one K1 launch sequence compacts every buffer of the batch

`FilterPredicate` is computed once and reused across all columns of a
batch (FilterBuilder::optimize, filter.rs:171-189), and every value and
validity buffer of a batch rides ONE compaction (kernels/compact.py).
The eager API syncs the popcount (one scalar); `filter_static` /
`filter_static_multi` return full-length outputs and a device count
without a sync.  Layouts that need `take` (strings, nested) join with
ROADMAP A7 and raise here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import sync_guard
from ..core.column import Column, DictionaryColumn, PrimitiveColumn
from ..core.datum import as_datum
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..kernels.compact import compact

__all__ = ["FilterPredicate", "compact_by_mask", "filter", "filter_table",
           "filter_static", "filter_static_multi"]


class FilterPredicate:
    """Precomputed selection, reusable across columns (FilterBuilder,
    filter.rs:202,223)."""

    def __init__(self, predicate: Column):
        if not isinstance(predicate, PrimitiveColumn) \
                or not predicate.dtype.is_boolean:
            raise ArrowInvalid("filter predicate must be boolean")
        keep = predicate.values
        if predicate.validity is not None:
            keep = torch.logical_and(keep, predicate.validity)
        self.keep = keep.contiguous()
        sync_guard("filter")
        self.count = int(keep.sum())     # host sync: one scalar


def _predicate(predicate) -> FilterPredicate:
    return predicate if isinstance(predicate, FilterPredicate) \
        else FilterPredicate(as_datum(predicate))


def compact_by_mask(keep: torch.Tensor, count: int, *arrays: torch.Tensor):
    """Every array's kept rows, in order, `count` rows each: one K1
    launch sequence for the whole batch (filter.py:80)."""
    outs, _ = compact(keep, arrays, out_cap=count)
    return tuple(outs)


def _layout_error(c: Column) -> ArrowNotImplementedError:
    return ArrowNotImplementedError(
        f"filter of {type(c).__name__} needs take (ROADMAP A7)")


def filter(values: Column, predicate) -> Column:
    """filter kernel (filter.rs:143)."""
    pred = _predicate(predicate)
    if len(values) != pred.keep.shape[0]:
        raise ArrowInvalid("filter length mismatch")
    if isinstance(values, PrimitiveColumn):
        data = values.values
    elif isinstance(values, DictionaryColumn):
        data = values.codes
    else:
        raise _layout_error(values)
    ins = (data,) if values.validity is None else (data, values.validity)
    outs = compact_by_mask(pred.keep, pred.count, *ins)
    validity = None if values.validity is None else outs[1]
    if isinstance(values, PrimitiveColumn):
        return PrimitiveColumn(outs[0], values.dtype, validity,
                               _canonical=True)
    return DictionaryColumn(outs[0], values.values, validity,
                            _canonical=True,
                            ordered=bool(values.dtype.ordered))


def filter_table(table: Table, predicate) -> Table:
    """filter_record_batch (filter.rs:171): one predicate, all columns,
    every buffer of the batch in ONE compaction."""
    pred = _predicate(predicate)
    buffers = []
    for c in table.columns:
        if isinstance(c, PrimitiveColumn):
            buffers.append(c.values)
        elif isinstance(c, DictionaryColumn):
            buffers.append(c.codes)
        else:
            raise _layout_error(c)
        if c.validity is not None:
            buffers.append(c.validity)
    outs = iter(compact_by_mask(pred.keep, pred.count, *buffers))
    cols = []
    for c in table.columns:
        vals = next(outs)
        validity = None if c.validity is None else next(outs)
        if isinstance(c, PrimitiveColumn):
            cols.append(PrimitiveColumn(vals, c.dtype, validity,
                                        _canonical=True))
        else:
            cols.append(DictionaryColumn(vals, c.values, validity,
                                         _canonical=True,
                                         ordered=bool(c.dtype.ordered)))
    return Table(tuple(cols), table.schema, _validated=True)


def filter_static(values: torch.Tensor, keep: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shape-static compaction (filter.py:169): (compacted, valid_len),
    kept rows packed at the front in order, rows past valid_len
    unspecified, valid_len a 0-d int64 device tensor; no host sync."""
    (out,), count = compact(keep, (values,))
    return out, count


def filter_static_multi(keep: torch.Tensor, *arrays: torch.Tensor):
    """filter_static over several aligned arrays sharing ONE compaction
    (filter.py:183).  Returns (tuple_of_compacted, valid_len)."""
    outs, count = compact(keep, arrays)
    return tuple(outs), count
