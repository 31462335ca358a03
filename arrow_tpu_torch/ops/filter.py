"""filter: select rows where a boolean predicate is true (counterpart of
arrow_tpu/ops/filter.py; arrow-select/src/filter.rs).

    keep = predicate_values AND predicate_validity   (prep_null_mask,
                                                      filter.rs:116)
    count = popcount(keep)                            (filter.rs:111)
    one K1 launch sequence compacts every buffer of the batch

`FilterPredicate` is computed once and reused across all columns of a
batch (FilterBuilder::optimize, filter.rs:171-189), and every value and
validity buffer of a batch rides ONE compaction (kernels/compact.py).
The fixed-width buffers are those of primitive (decimal32/64
included) and dictionary columns and interval[month_day_nano]'s three
planes.  Every other layout -- string, list, large list, map, struct,
fixed-size list and binary, decimal128/256, union, run-end, list view --
is taken (ops/take.py, its range gather for the offsets layouts) by the
kept rows' positions, which that same compaction emits; the reference
takes them by its `pred.indices` (filter.py:103-166).  A null column
takes the count.  The eager API syncs the popcount (one scalar);
`filter_static` / `filter_static_multi` return full-length outputs and
a device count without a sync.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import dtypes as dt
from ..core.column import (Column, DictionaryColumn, NullColumn,
                           PrimitiveColumn)
from ..core.datum import as_datum
from ..core.nested import IntervalMDNColumn
from ..core.table import Table
from ..errors import ArrowInvalid
from ..kernels.compact import compact
from ..utils.trace import span, to_host
from .take import take

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
        # host sync: one scalar
        self.count = int(to_host("filter", keep.sum(), guard=True))
        self._indices = None

    @property
    def indices(self) -> PrimitiveColumn:
        """The kept rows' positions, int32 in row order (filter.py:62-67),
        made once: one K1 launch on the card (its positions alone, `count`
        rows), `compact_plain` on the CPU.  Past 2^31 rows int32
        positions raise, as K1's do."""
        if self._indices is None:
            (pos,), _ = compact(self.keep, (), out_cap=self.count,
                                positions=torch.int32)
            self._indices = PrimitiveColumn(pos, dt.int32, _canonical=True)
        return self._indices


def _predicate(predicate) -> FilterPredicate:
    return predicate if isinstance(predicate, FilterPredicate) \
        else FilterPredicate(as_datum(predicate))


def compact_by_mask(keep: torch.Tensor, count: int, *arrays: torch.Tensor):
    """Every array's kept rows, in order, `count` rows each: one K1
    launch sequence for the whole batch (filter.py:80)."""
    outs, _ = compact(keep, arrays, out_cap=count)
    return tuple(outs)


def _fixed(c: Column):
    """The fixed-width buffers of a column the compaction carries, then
    its validity; None for a layout taken by the positions."""
    if isinstance(c, PrimitiveColumn):
        data = (c.values,)
    elif isinstance(c, DictionaryColumn):
        data = (c.codes,)
    elif isinstance(c, IntervalMDNColumn):
        data = (c.months, c.days, c.nanos)
    else:
        return None
    return data if c.validity is None else data + (c.validity,)


def _rebuild(c: Column, outs) -> Column:
    """Column `c`'s kept rows from its compacted buffers (`outs` yields
    them in _fixed's order)."""
    if isinstance(c, PrimitiveColumn):
        vals = next(outs)
        return PrimitiveColumn(vals, c.dtype, None if c.validity is None
                               else next(outs), _canonical=True)
    if isinstance(c, DictionaryColumn):
        codes = next(outs)
        return DictionaryColumn(codes, c.values, None if c.validity is None
                                else next(outs), _canonical=True,
                                ordered=bool(c.dtype.ordered))
    planes = (next(outs), next(outs), next(outs))
    return IntervalMDNColumn(*planes, None if c.validity is None
                             else next(outs))


def _filter_columns(columns, pred: FilterPredicate):
    """Every column's kept rows, from ONE K1 launch over the batch's
    fixed-width buffers, with the kept rows' positions when another
    layout is taken by them (filter.py:103-166)."""
    fixed = [_fixed(c) for c in columns]
    buffers = [b for f in fixed if f is not None for b in f]
    gathered = any(f is None and not isinstance(c, NullColumn)
                   for c, f in zip(columns, fixed))
    outs = iter(())
    if buffers or gathered:
        outs, _ = compact(pred.keep, buffers, out_cap=pred.count,
                          positions=torch.int64 if gathered else None)
        outs = iter(outs)
    cols = [None if f is None else _rebuild(c, outs)
            for c, f in zip(columns, fixed)]
    positions = next(outs, None)
    for i, c in enumerate(columns):
        if isinstance(c, NullColumn):
            cols[i] = NullColumn(pred.count, c.device)
        elif cols[i] is None:
            cols[i] = take(c, PrimitiveColumn(positions, dt.int64))
    return cols


def filter(values: Column, predicate) -> Column:
    """filter kernel (filter.rs:143)."""
    pred = _predicate(predicate)
    if len(values) != pred.keep.shape[0]:
        raise ArrowInvalid("filter length mismatch")
    return _filter_columns([values], pred)[0]


def filter_table(table: Table, predicate) -> Table:
    """filter_record_batch (filter.rs:171): one predicate, all columns,
    every fixed-width buffer of the batch and the positions the string
    columns need in ONE compaction."""
    with span("op.filter", rows=table.num_rows):
        pred = _predicate(predicate)
        return Table(tuple(_filter_columns(table.columns, pred)),
                     table.schema, _validated=True)


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
