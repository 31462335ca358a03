"""Sorts, rank and partition (counterpart of arrow_tpu/ops/sort.py:41-404;
arrow-ord/src/sort.rs, rank.rs, partition.rs).

Every sort is the key encoding of ops/row_format.py and stable radix
passes over its packed words (`torch.sort(stable=True)`), so ties keep
their input order; floats sort by their total order with -0.0 tied to
+0.0 and NaN above +inf (below -inf when descending).

  sort_to_indices, lexsort_to_indices   uint32 indices (int32 storage,
                                        at most 2**31 rows)
  sort, lexsort, sort_table             key columns are decoded from the
                                        sorted keys (row_format
                                        decode_sorted_group); a float key
                                        column is gathered and its NaNs
                                        written canonical, as the
                                        reference's decode writes them;
                                        other columns ride a gather
  limit                                 the first `limit` rows of the
                                        stable order (the reference's
                                        top_k breaks ties the same way)
  rank                                  'max' method, 1-based, uint32 in
                                        int32 storage; the run starts
                                        come from K1 as positions alone,
                                        with no host sync
  partition                             K1 compacts the positions of the
                                        change mask; one sync for the
                                        count (the reference: np.nonzero
                                        on the host)

Every key kind of ops/row_format.py sorts: decimal limb keys, run-end
columns by their decoded rows, and lists, structs, maps, fixed-size
lists and binaries and interval[month_day_nano] by their host comparator
ranks.  Such a column does not decode from its keys (a decimal's
one-word key has no top limb, a rank no value): it rides the gather, as
in the reference (sort.py:95-113).  partition raises on them, as the
reference's value key does.

The reference's `_PAYLOAD_CROSSOVER` (sort.py:236) is a measurement on
the TPU and has no counterpart: every non-key column rides a gather.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..core.column import Column, DictionaryColumn, PrimitiveColumn
from ..core.table import Table
from ..errors import ArrowInvalid
from ..kernels.compact import compact
from . import row_format as rf
from .row_format import SortOptions
from .strings import device_table
from .take import take
from ..utils.trace import span, to_host

__all__ = ["SortOptions", "SortColumn", "sort_to_indices", "sort",
           "lexsort_to_indices", "lexsort", "sort_table", "rank",
           "partition", "partition_mask", "Partitions"]

_MAX_ROWS = 2 ** 31                # uint32 indices on int32 storage


@dataclass
class SortColumn:
    """arrow-ord SortColumn (sort.rs:709)."""
    column: Column
    options: SortOptions = SortOptions()


def _indices(cols: Sequence[Column], opts: Sequence[SortOptions],
             limit: Optional[int]) -> PrimitiveColumn:
    if len(cols[0]) > _MAX_ROWS:
        raise ArrowInvalid(f"sort indices of {len(cols[0])} rows exceed "
                           f"uint32 on int32 storage (2**31)")
    idx = rf.lexsort_indices_fused(cols, opts, limit)
    return PrimitiveColumn(idx.to(torch.int32), dt.uint32)


def sort_to_indices(col: Column, options: SortOptions = SortOptions(),
                    limit: Optional[int] = None) -> PrimitiveColumn:
    """Indices that sort `col` (sort.rs:219)."""
    return _indices([col], [options], limit)


def lexsort_to_indices(columns: Sequence[SortColumn],
                       limit: Optional[int] = None) -> PrimitiveColumn:
    """Multi-column sort indices (sort.rs:779); the first column is the
    primary key."""
    if not columns:
        raise ArrowInvalid("lexsort of zero columns")
    if len({len(c.column) for c in columns}) != 1:
        raise ArrowInvalid("lexsort column length mismatch")
    with span("op.sort"):
        return _indices([c.column for c in columns],
                        [c.options for c in columns], limit)


def _decodable(col: Column) -> bool:
    """Whether sort output decodes from the sorted keys (sort.py:61-69)."""
    if isinstance(col, DictionaryColumn):
        return True
    d = col.dtype
    return isinstance(col, PrimitiveColumn) and \
        (d.is_numeric or d.is_boolean or d.is_temporal) and \
        d.name != "interval"


def _inverse_slots(ranks: np.ndarray, is_null: np.ndarray) -> np.ndarray:
    """rank -> the FIRST valid dictionary slot holding it (sort.py:92-104):
    dense ranks repeat where dictionary values do."""
    valid = np.nonzero(~is_null)[0]
    inv = np.zeros(max(len(ranks), 1), np.int64)
    inv[ranks.astype(np.int64)[valid][::-1]] = valid[::-1]
    return inv


def _decode(col: Column, opt: SortOptions, group: Sequence[rf.SortKey],
            values: Sequence[torch.Tensor], order: torch.Tensor) -> Column:
    """One sorted key column from its sorted keys (floats: a gather)."""
    kind = rf.key_kind(col)
    part = rf.key_parts(col)
    has_null = rf.group_has_null_key(kind, part)
    if kind == "float":
        validity = None if not has_null else \
            values[0] == (1 if opt.nulls_first else 0)
        v = col.values[order]
        nan = torch.full((), float("nan"), dtype=v.dtype, device=v.device)
        v = torch.where(torch.isnan(v), nan, v)
        return PrimitiveColumn(v, col.dtype, validity)
    bits = [k.bits for k in group]
    if kind == "dict":
        inv = None
        if part[1] is not None:                  # codes are not ranks
            ranks, is_null = rf.dictionary_value_ranks(col.values)
            inv = device_table(col.values, ("inv_slots",), col.device,
                               lambda: _inverse_slots(ranks, is_null))
        codes, validity = rf.decode_sorted_group(
            kind, opt, has_null, values, bits, col.dtype, col.codes.dtype,
            inv)
        return DictionaryColumn(codes, col.values, validity, _canonical=True,
                                ordered=bool(col.dtype.ordered))
    vals, validity = rf.decode_sorted_group(
        kind, opt, has_null, values, bits, col.dtype, col.values.dtype)
    return PrimitiveColumn(vals, col.dtype, validity, _canonical=True)


def _sorted_columns(cols: Sequence[Column], opts: Sequence[SortOptions],
                    limit: Optional[int]
                    ) -> Tuple[List[Optional[Column]], torch.Tensor]:
    """(each decodable column sorted, None for the others; the order as
    int64), from one sort of every column's keys."""
    groups = rf.encode_key_groups(cols, opts)
    keys = [k for g in groups for k in g]
    device = keys[0].values.device if keys else cols[0].device
    order, values = rf.sorted_key_values(keys, len(cols[0]), device, limit)
    out, i = [], 0
    for col, opt, group in zip(cols, opts, groups):
        vals, i = values[i:i + len(group)], i + len(group)
        out.append(_decode(col, opt, group, vals, order)
                   if _decodable(col) else None)
    return out, order


def sort(col: Column, options: SortOptions = SortOptions(),
         limit: Optional[int] = None) -> Column:
    """sort kernel (sort.rs:57)."""
    if _decodable(col):
        return _sorted_columns([col], [options], limit)[0][0]
    return take(col, sort_to_indices(col, options, limit))


def lexsort(columns: Sequence[SortColumn],
            limit: Optional[int] = None) -> List[Column]:
    if all(_decodable(c.column) for c in columns):
        return _sorted_columns([c.column for c in columns],
                               [c.options for c in columns], limit)[0]
    idx = lexsort_to_indices(columns, limit)
    return [take(c.column, idx) for c in columns]


def sort_table(table: Table, by: Sequence[Tuple[str, SortOptions]],
               limit: Optional[int] = None) -> Table:
    """Sort a batch by the named columns (sort.py:162-233): a key column
    is decoded from the sorted keys (its first place in `by` decides its
    options), every other column rides one gather by the order."""
    by = list(by)
    cols = [table.column(name) for name, _ in by]
    opts = [opt for _, opt in by]
    if not any(_decodable(c) for c in cols):
        return Table(tuple(take(c, _indices(cols, opts, limit))
                           for c in table.columns), table.schema,
                     _validated=True)
    decoded, order = _sorted_columns(cols, opts, limit)
    first = {}
    for (name, _), col in zip(by, decoded):
        if col is not None:
            first.setdefault(name, col)
    return Table(tuple(first[name] if name in first else take(c, order)
                       for name, c in zip(table.column_names,
                                          table.columns)),
                 table.schema, _validated=True)


def rank(col: Column, options: SortOptions = SortOptions()) -> torch.Tensor:
    """'max'-method 1-based rank (rank.rs:54): equal values share the
    highest of their ranks; nulls rank by their sort position.  uint32
    values in an int32 tensor on the column's device."""
    n = len(col)
    if n > _MAX_ROWS:
        raise ArrowInvalid(f"rank of {n} rows exceeds uint32 on int32 "
                           f"storage (2**31)")
    keys = rf.encode_keys([col], options=[options])
    device = keys[0].values.device if keys else col.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    order, words = rf.sort_keys(keys, n, device)
    start = torch.zeros((n,), dtype=torch.bool, device=device)
    start[0] = True
    for w in words:
        start[1:] |= w[1:] != w[:-1]
    # K1: each run's first sorted position; a run's max rank is the
    # next run's start (n for the last run)
    (starts,), runs = compact(start, (), positions=torch.int64)
    nxt = torch.cumsum(start, 0)                       # run id + 1
    ranks = torch.where(nxt >= runs, n, starts[nxt.clamp(max=n - 1)])
    out = torch.empty((n,), dtype=torch.int32, device=device)
    out[order] = ranks.to(torch.int32)
    return out


@dataclass
class Partitions:
    """Consecutive equal-row ranges (partition.rs:127)."""
    boundaries: np.ndarray          # sorted positions, 0 and n included

    def ranges(self) -> List[Tuple[int, int]]:
        b = self.boundaries
        return [(int(b[i]), int(b[i + 1])) for i in range(len(b) - 1)]

    def __len__(self):
        return len(self.boundaries) - 1


def partition_mask(columns: Sequence[Column]) -> torch.Tensor:
    """Run-start mask on the device: out[i] is true iff row i differs
    from row i - 1 (out[0] true); nulls compare equal (partition.rs:156).
    No host sync."""
    if not columns:
        raise ArrowInvalid("partition of zero columns")
    change = _partition_change(columns)
    if change is None:
        return torch.zeros((0,), dtype=torch.bool, device=columns[0].device)
    head = torch.ones((1,), dtype=torch.bool, device=change.device)
    return torch.cat([head, change])


def partition(columns: Sequence[Column]) -> Partitions:
    """Boundaries between consecutive distinct rows (partition.rs:156).
    K1 gives the change positions; their count is the one sync."""
    if not columns:
        raise ArrowInvalid("partition of zero columns")
    n = len(columns[0])
    change = _partition_change(columns)
    if change is None:
        return Partitions(np.array([0]))
    (pos,), count = compact(change, (), positions=torch.int64)
    kept = int(to_host("partition", count, guard=True))
    inner = to_host("partition", pos[:kept]).numpy() + 1
    return Partitions(np.concatenate([[0], inner, [n]]))


def _partition_change(columns: Sequence[Column]) -> Optional[torch.Tensor]:
    """Shifted-neq change mask of length n - 1 (true where row i + 1
    differs from row i), None for no rows.  Floats compare natively with
    a NaN class (-0.0 equals +0.0, NaNs are equal); every other type by
    its value key (sort.py:381-404)."""
    n = len(columns[0])
    if n == 0:
        return None
    change = None
    for col in columns:
        if isinstance(col, PrimitiveColumn) and col.dtype.is_floating:
            v = col.values.to(torch.float64)
            isnan = torch.isnan(v)
            v = torch.where(isnan, 0.0, v)
            vneq = (v[1:] != v[:-1]) | (isnan[1:] != isnan[:-1])
            validity = col.validity
        else:
            key, validity = rf.encode_value_key(col)
            vneq = key[1:] != key[:-1]
        if validity is not None:
            both = validity[1:] & validity[:-1]
            vneq = torch.where(both, vneq, validity[1:] != validity[:-1])
        change = vneq if change is None else change | vneq
    return change.contiguous()
