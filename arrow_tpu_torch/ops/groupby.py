"""Grouped aggregation over dictionary-encoded keys (counterpart of the
dictionary-keyed plan of arrow_tpu/ops/groupby.py: group_by ->
_dictionary_fast_path -> _fast_agg_stage, groupby.py:100-132,311-350,
465-627).

  1. combined key code = mixed-radix digit stack over (dict size + 1)
     per key; the extra digit encodes null (groupby.py:328-350)
  2. every aggregate in ONE pass of kernel K2 (kernels/groupagg.py);
     no row sort
  3. the <= G_MAX group-sized results are ordered like the reference's
     general path: by dictionary value rank, nulls first, first key most
     significant; unoccupied combinations are dropped (groupby.py:616-627)

Aggregate null semantics (SQL/DataFusion): sum/min/max/mean skip nulls
and a group with no valid input yields null; count counts valid rows;
count_all counts rows.

The reference's other plans (general sort discovery, perfect binning,
packed sort, chunking) join with ROADMAP A5: keys that are not
dictionaries, dictionaries with null or duplicate values, more than
G_MAX combined groups and aggregates K2 does not cover raise
ArrowNotImplementedError here.  The reference's _FAST_AGG_CHUNK split
(a v5e HBM bound) is not copied: K2 holds no limb planes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..kernels.groupagg import G_MAX, MinMaxCol, SumCol, grouped_aggregate

__all__ = ["group_by", "AggSpec", "dictionary_value_ranks"]

_AGG_OPS = ("sum", "count", "count_all", "min", "max", "mean")


@dataclass(frozen=True)
class AggSpec:
    column: str
    op: str          # sum | count | count_all | min | max | mean
    name: Optional[str] = None

    @property
    def out_name(self) -> str:
        return self.name or f"{self.column}_{self.op}"


def _agg_dtype(src: dt.DataType, op: str) -> dt.DataType:
    if op in ("count", "count_all"):
        return dt.int64
    if op == "mean":
        return dt.float64
    return src


def _agg_supported(src: Column, op: str) -> bool:
    """Whether K2 covers this (column, op) (groupby.py:311-325)."""
    if op in ("count", "count_all"):
        return True
    if not isinstance(src, PrimitiveColumn):
        return False
    d = src.dtype
    if op in ("min", "max"):
        return d.is_integer or d.name in ("float32", "float16")
    return d.is_integer and op in ("sum", "mean")


def dictionary_value_ranks(values: Column) -> Tuple[np.ndarray, np.ndarray]:
    """Dense ranks of a dictionary's values, on the host (row_format.py:92).
    Returns (ranks uint64, is_null bool) per dictionary slot; equal values
    share a rank; strings rank by their UTF-8 bytes."""
    if isinstance(values, StringColumn):
        lst = values.to_pylist()
        is_null = np.array([v is None for v in lst], dtype=bool)
        keys = sorted({v.encode() for v in lst if v is not None})
        rank_of = {k: i for i, k in enumerate(keys)}
        ranks = np.array([0 if v is None else rank_of[v.encode()]
                          for v in lst], dtype=np.uint64)
        return ranks, is_null
    if isinstance(values, PrimitiveColumn):
        vals = values.to_numpy()
        is_null = ~values.is_valid_mask().cpu().numpy()
        ranks = np.zeros(len(vals), np.uint64)
        if (~is_null).any():
            _, inv = np.unique(vals[~is_null], return_inverse=True)
            ranks[~is_null] = inv.astype(np.uint64)
        return ranks, is_null
    raise ArrowNotImplementedError(f"dictionary of {type(values).__name__}")


def _unsupported(what: str) -> ArrowNotImplementedError:
    return ArrowNotImplementedError(
        f"group_by: {what} needs a group_by plan the port does not have yet "
        "(ROADMAP A5)")


def _fast_agg_stage(sizes: Sequence[int], g_total: int, key_parts,
                    sum_cols: Sequence[SumCol], mm_cols: Sequence[MinMaxCol],
                    decode: bool = True):
    """Mixed-radix combined codes, then one K2 pass (groupby.py:330).
    decode=False keeps min/max as undecoded u64 order keys, so partials
    of chunks can merge exactly (the role of groupby.py:387-407)."""
    combined = None
    for (codes, validity), size in zip(key_parts, sizes):
        digit = codes.to(torch.int32)
        if validity is not None:
            digit = torch.where(validity, digit, size)
        combined = digit if combined is None \
            else combined * (size + 1) + digit
    return grouped_aggregate(combined.contiguous(), g_total,
                             sum_cols=sum_cols, mm_cols=mm_cols,
                             decode=decode)


def group_by(table: Table, keys: Sequence[str],
             aggs: Sequence[AggSpec]) -> Table:
    """GROUP BY dictionary keys with per-column aggregates; one output row
    per occupied key combination, in ascending value order of the first
    key, nulls first (the reference's deterministic group order)."""
    for a in aggs:
        if a.op not in _AGG_OPS:
            raise ArrowInvalid(f"unknown aggregate {a.op}")
    key_cols = [table.column(k) for k in keys]
    if not key_cols or not all(isinstance(c, DictionaryColumn)
                               for c in key_cols):
        raise _unsupported("keys that are not dictionary-encoded")
    sizes = [len(c.values) for c in key_cols]
    g_total = int(np.prod([s + 1 for s in sizes]))
    if g_total > G_MAX:
        raise _unsupported(f"{g_total} combined key codes (> {G_MAX})")
    # the code domain assumes distinct non-null values per slot
    # (groupby.py:486-501)
    ranks = []
    for c in key_cols:
        r, is_null = dictionary_value_ranks(c.values)
        if is_null.any() or len(np.unique(r)) != len(r):
            raise _unsupported("dictionaries with null or repeated values")
        ranks.append(r)
    for a in aggs:
        if not _agg_supported(table.column(a.column), a.op):
            raise _unsupported(f"{a.op} over {table.column(a.column).dtype!r}")

    # slot planning (groupby.py:517-552): slot 0 counts rows (occupancy
    # and count_all) with no value column behind it
    sum_cols: List[SumCol] = [SumCol(None)]
    sum_slot = {None: 0}
    mm_cols: List[MinMaxCol] = []
    mm_slot = {}

    def count_slot(src, name):
        key = ("cnt", name)
        if key not in sum_slot:
            sum_slot[key] = len(sum_cols)
            sum_cols.append(SumCol(None, src.validity))

    for a in aggs:
        src = table.column(a.column)
        if a.op == "count":
            count_slot(src, a.column)
        elif a.op in ("sum", "mean"):
            key = ("sum", a.column)
            if key not in sum_slot:
                sum_slot[key] = len(sum_cols)
                sum_cols.append(SumCol(src.values, src.validity, src.dtype))
        elif a.op in ("min", "max"):
            key = ("mm", a.column)
            if key not in mm_slot:
                mm_slot[key] = len(mm_cols)
                mm_cols.append(MinMaxCol(src.values, src.validity, src.dtype,
                                         want_min=False, want_max=False))
                if src.validity is not None:
                    # empty-group masking needs per-group valid counts
                    count_slot(src, a.column)
            if a.op == "min":
                mm_cols[mm_slot[key]].want_min = True
            else:
                mm_cols[mm_slot[key]].want_max = True

    sums, counts, mms = _fast_agg_stage(
        sizes, g_total, [(c.codes, c.validity) for c in key_cols],
        sum_cols, mm_cols)
    occupancy = counts[0]
    device = occupancy.device

    # group-sized key digits and their order, on the host (<= G_MAX)
    gids = np.arange(g_total)
    stride = g_total
    digits, order_keys = [], []
    for size, r in zip(sizes, ranks):
        stride //= size + 1
        digit = (gids // stride) % (size + 1)
        digits.append(digit)
        # null digit sorts first; values by rank
        order_keys.append(np.append(r.astype(np.int64) + 1, 0)[digit])
    order = np.lexsort(order_keys[::-1])
    occupied = (occupancy > 0).cpu().numpy()   # host sync (cardinality)
    sel = torch.from_numpy(order[occupied[order]]).to(device)

    out_cols: List[Column] = []
    fields = [table.schema.field(k) for k in keys]
    for c, size, digit in zip(key_cols, sizes, digits):
        is_null = digit == size
        codes_g = torch.from_numpy(np.where(is_null, 0, digit)) \
            .to(device=device, dtype=c.codes.dtype)
        mask = torch.from_numpy(~is_null).to(device)
        out_cols.append(DictionaryColumn(codes_g[sel], c.values, mask[sel],
                                         _canonical=True,
                                         ordered=bool(c.dtype.ordered)))

    for a in aggs:
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        if a.op in ("count", "count_all"):
            cnt = occupancy if a.op == "count_all" \
                else counts[sum_slot[("cnt", a.column)]]
            out_cols.append(PrimitiveColumn(cnt[sel], dt.int64))
            fields.append(dt.Field(a.out_name, dt.int64, nullable=False))
            continue
        if a.op in ("sum", "mean"):
            slot = sum_slot[("sum", a.column)]
            s, c = sums[slot], counts[slot]
        else:
            mn, mx = mms[mm_slot[("mm", a.column)]]
            c = counts[sum_slot[("cnt", a.column)]] \
                if ("cnt", a.column) in sum_slot else occupancy
        group_valid = c > 0
        group_mask = None if bool(group_valid.all()) else group_valid[sel]
        if a.op == "sum":
            vals = s.to(src.dtype.to_torch())
        elif a.op == "mean":
            vals = s.to(torch.float64) / c.clamp(min=1).to(torch.float64)
        else:
            vals = mn if a.op == "min" else mx
        out_cols.append(PrimitiveColumn(vals[sel], out_dt, group_mask))
        fields.append(dt.Field(a.out_name, out_dt))
    return Table(out_cols, dt.Schema(tuple(fields)))
