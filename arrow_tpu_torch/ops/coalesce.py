"""BatchCoalescer: a streaming re-chunker of batches (counterpart of
arrow_tpu/ops/coalesce.py; arrow-select/src/coalesce.rs:132).

Operators emit batches of varying row counts (filters shrink, joins
grow); the coalescer re-chunks the stream into batches of a fixed
target size through `concat_tables`, the last one partial.
`push_batch_with_filter` filters a batch before it joins the stream
(coalesce.rs:201).
"""

from __future__ import annotations

from typing import List, Optional

from ..core.table import Table
from ..errors import ArrowInvalid
from .concat import concat_tables
from .filter import FilterPredicate, filter_table

__all__ = ["BatchCoalescer"]


class BatchCoalescer:
    def __init__(self, target_batch_size: int):
        if target_batch_size <= 0:
            raise ArrowInvalid("target_batch_size must be positive")
        self.target = target_batch_size
        self._buffered: List[Table] = []
        self._rows = 0
        self._completed: List[Table] = []

    def _merged(self) -> Table:
        return concat_tables(self._buffered) if len(self._buffered) > 1 \
            else self._buffered[0]

    def push_batch(self, batch: Table) -> None:
        if batch.num_rows == 0:
            return
        self._buffered.append(batch)
        self._rows += batch.num_rows
        while self._rows >= self.target:
            merged = self._merged()
            rest = merged.slice(self.target, merged.num_rows - self.target)
            self._completed.append(merged.slice(0, self.target))
            self._buffered = [rest] if rest.num_rows else []
            self._rows = rest.num_rows

    def push_batch_with_filter(self, batch: Table, predicate) -> None:
        """The batch's rows where `predicate` holds (coalesce.rs:201)."""
        pred = predicate if isinstance(predicate, FilterPredicate) \
            else FilterPredicate(predicate)
        if pred.count == 0:
            return
        self.push_batch(filter_table(batch, pred))

    def finish(self) -> None:
        """Flush the partial tail batch."""
        if self._rows:
            self._completed.append(self._merged())
            self._buffered = []
            self._rows = 0

    def next_completed_batch(self) -> Optional[Table]:
        if self._completed:
            return self._completed.pop(0)
        return None

    def has_completed_batch(self) -> bool:
        return bool(self._completed)
