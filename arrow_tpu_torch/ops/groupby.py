"""Grouped aggregation (counterpart of arrow_tpu/ops/groupby.py).

Plans, tried in this order; each gives the reference's output:

  1. dictionary plan -- dictionary keys, at most G_MAX combined codes,
     dictionaries without null or repeated values, aggregates that K2
     covers: a mixed-radix code per row over (dict size + 1) digits per
     key, the extra digit for null, then ONE pass of kernel K2 and no
     sort (groupby.py:311-350,465-627)
  2. small-domain plan -- integer or bool keys whose combined range
     prod(kmax - kmin + 1 + has_null) is at most G_MAX, aggregates that
     K2 covers: digit = key - kmin with null as the top digit, the same
     single K2 pass; one key goes to K2 as it is, which computes the
     digit itself.  The reference bins these keys with sorts
     (_int_range_fast_path, groupby.py:1894-2102); the outputs are the
     same.
  3. sort plan -- everything else (groupby.py:271-307,1574-1602,
     2422-2597): key encode (ops/row_format.py) and a stable sort; run
     starts by a shifted compare; kernel K1 compacts each run's
     first-row index at the run starts and emits their positions, and
     reading its count is the plan's one sync; sums and counts by cumsum and
     boundary difference (exact for integers: wrapping addition is
     associative); min/max by K2 over the group ids (integers, and
     temporal columns by their storage integers, at most G_MAX groups)
     or by a secondary (group, class, value) sort; output keys gathered
     at each run's first row, so they keep their layout and type.  Past
     _SORT_AGG_CHUNK rows it runs chunk by chunk through
     GroupByAccumulator.  Decimal, run-end and host-ranked keys (lists,
     structs, maps, fixed-size lists and binaries, month_day_nano) take
     this plan (groupby.py:152-156): their keys are row_format's limb
     words, decoded rows and comparator ranks.

The <= G_MAX group-sized results of plans 1-2 are ordered like the sort
plan's: ascending, nulls first, first key most significant; unoccupied
combinations are dropped (groupby.py:616-627).

A string key is dictionary-encoded (ops/strings.py), so it takes the
dictionary plan and K2 like a dictionary key; its output keys are
decoded back to strings.  Min and max of strings and dictionaries
aggregate a uint64 rank proxy of the values and decode each group's
winning rank (_group_by_string_minmax, groupby.py:2131-2187).

Aggregate null semantics (SQL/DataFusion): sum/min/max/mean skip nulls
and a group with no valid input yields null; count counts valid rows;
count_all counts rows.  Float min/max order NaN above everything; float
sums are IEEE-honest (float_group_sums).
"""

from __future__ import annotations

import concurrent.futures
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..kernels.compact import compact
from ..kernels.groupagg import (G_MAX, MinMaxCol, SumCol, grouped_aggregate,
                                row_codes)
from . import row_format as rf
from .cast import cast
from .concat import concat_tables
from .row_format import KeyRange, SortKey, dictionary_value_ranks
from .strings import dictionary_decode, dictionary_encode
from .take import take
from ..utils.trace import annotate, span, to_host

__all__ = ["group_by", "AggSpec", "GroupByAccumulator", "segment_aggregate",
           "float_group_sums"]

_AGG_OPS = ("sum", "count", "count_all", "min", "max", "mean")
_SIGN = -(1 << 63)

# Rows the sort plan takes in one piece; past this, group_by streams
# chunks through GroupByAccumulator.  Sized for one 80 GB H100 from the
# plan's peak device memory measured on the card at config 4's shape
# (Int64 key, Int64 value, sum/count/min/max, 10M groups): 83-88 bytes a
# row beyond the 16-byte input at 125M-500M rows (46.1 GiB peak at
# 500M).  600M rows then peak near 58 GiB with their input, leaving
# about 20 GiB for the caller's other tensors (PERF.md, Findings).
_SORT_AGG_CHUNK = 600_000_000


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


def float_group_sums(contrib: torch.Tensor,
                     diff_fn: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
    """IEEE-honest float grouped sums on the cumsum + boundary-difference
    plan (groupby.py:58-86): non-finite contributions are zeroed out of
    the prefix sum and re-injected per group, so one NaN or infinity
    cannot poison later groups.  Any NaN -> NaN, +inf and -inf together
    -> NaN, else a lone infinity wins, else the finite sum.  contrib:
    f64 in group order, excluded rows zeroed; diff_fn: the per-group
    boundary difference."""
    finite = torch.isfinite(contrib)
    sums = diff_fn(torch.where(finite, contrib, 0.0))
    # host sync (the reference's cond)
    if bool(to_host("group_by.float_sums", finite.all())):
        return sums
    has_nan = diff_fn(torch.isnan(contrib).to(torch.int64)) > 0
    has_pinf = diff_fn((contrib == math.inf).to(torch.int64)) > 0
    has_ninf = diff_fn((contrib == -math.inf).to(torch.int64)) > 0
    sums = torch.where(has_pinf, math.inf, sums)
    sums = torch.where(has_ninf, -math.inf, sums)
    return torch.where(has_nan | (has_pinf & has_ninf), math.nan, sums)


# ---- entry point -----------------------------------------------------------

def group_by(table: Table, keys: Sequence[str],
             aggs: Sequence[AggSpec]) -> Table:
    """GROUP BY keys with per-column aggregates; one output row per
    distinct key combination, in ascending key order, nulls first, the
    first key most significant (the reference's deterministic order)."""
    with span("op.group_by"):
        return _group_by(table, keys, aggs, chunk=True)

def _group_by(table: Table, keys: Sequence[str], aggs: Sequence[AggSpec],
              chunk: bool) -> Table:
    """group_by; chunk=False keeps the sort plan in one piece, for the
    merges of GroupByAccumulator: their input is partial rows, which
    COMPACT_ROWS bounds, and chunking it again would not shrink it when
    the groups outnumber a chunk's rows."""
    for a in aggs:
        if a.op not in _AGG_OPS:
            raise ArrowInvalid(f"unknown aggregate {a.op}")
    if not keys:
        raise ArrowInvalid("group_by needs at least one key")
    str_mm = [i for i, a in enumerate(aggs) if a.op in ("min", "max")
              and isinstance(table.column(a.column),
                             (StringColumn, DictionaryColumn))]
    if str_mm and table.num_rows:
        annotate("op.group_by", plan="string_minmax")
        return _group_by_string_minmax(table, keys, aggs, str_mm, chunk)
    key_cols = [table.column(k) for k in keys]
    for c in key_cols:
        rf.key_kind(c)                    # raises on unions and nulls
    if table.num_rows == 0:
        annotate("op.group_by", plan="empty")
        return _empty_group_by(table, keys, aggs)
    if any(isinstance(c, StringColumn) for c in key_cols):
        annotate("op.group_by", plan="string_keys")
        return _group_by_string_keys(table, keys, aggs, chunk)
    for a in aggs:
        src = table.column(a.column)
        if a.op in ("sum", "mean") and not isinstance(src, PrimitiveColumn):
            raise ArrowNotImplementedError(
                f"group_by: {a.op} over {type(src).__name__}")

    out = _dictionary_plan(table, key_cols, keys, aggs)
    if out is not None:
        annotate("op.group_by", plan="dictionary")
        return out
    key_ranges, val_ranges = _range_scan(table, key_cols, aggs)
    out = _small_domain_plan(table, key_cols, keys, aggs, key_ranges)
    if out is not None:
        annotate("op.group_by", plan="small_domain")
        return out
    if chunk and table.num_rows > _SORT_AGG_CHUNK:
        annotate("op.group_by", plan="chunked")
        return _group_by_chunked(table, keys, aggs, table.num_rows)
    annotate("op.group_by", plan="sort")
    return _sort_plan(table, key_cols, keys, aggs, key_ranges, val_ranges)


def _group_by_string_keys(table: Table, keys, aggs, chunk: bool) -> Table:
    """group_by with each string key dictionary-encoded (its codes are its
    ranks, so the dictionary plan and K2 take it), the output keys
    decoded back to strings under the key's own field."""
    cols, fields = list(table.columns), list(table.schema.fields)
    encoded = []
    for k in dict.fromkeys(keys):
        i = table.schema.index_of(k)
        if isinstance(cols[i], StringColumn):
            cols[i] = dictionary_encode(cols[i])
            fields[i] = dt.Field(k, cols[i].dtype, fields[i].nullable)
            encoded.append(k)
    out = _group_by(Table(cols, dt.Schema(tuple(fields))), keys, aggs,
                    chunk)
    cols, fields = list(out.columns), list(out.schema.fields)
    for i, k in enumerate(keys):
        if k in encoded:
            cols[i] = dictionary_decode(cols[i])
            fields[i] = table.schema.field(k)
    return Table(cols, dt.Schema(tuple(fields)))


def _group_by_string_minmax(table: Table, keys, aggs, str_mm,
                            chunk: bool) -> Table:
    """MIN/MAX over string and dictionary columns
    (groupby.py:2131-2187): group the uint64 rank key of the values
    (row_format.encode_value_key: rank order is byte order) with every
    other aggregate, then map each group's winning rank back to a
    dictionary slot and take the value.  The recursive group_by sees
    only primitive sources, so K2 takes the min/max."""
    proxies = {}         # source column -> (proxy name, dictionary)
    cols, fields = list(table.columns), list(table.schema.fields)
    new_aggs = list(aggs)
    for i in str_mm:
        a = aggs[i]
        if a.column not in proxies:
            dcol = dictionary_encode(table.column(a.column))
            key, valid = rf.encode_value_key(dcol)
            pname = f"__strmm_{a.column}"
            cols.append(PrimitiveColumn(key, dt.uint64, valid))
            fields.append(dt.Field(pname, dt.uint64))
            proxies[a.column] = (pname, dcol)
        new_aggs[i] = AggSpec(proxies[a.column][0], a.op, a.out_name)
    res = _group_by(Table(cols, dt.Schema(tuple(fields))), keys, new_aggs,
                    chunk)
    out_cols, out_fields = list(res.columns), list(res.schema.fields)
    nkeys = len(keys)
    for i in str_mm:
        a = aggs[i]
        dcol = proxies[a.column][1]
        ranks, dict_null = dictionary_value_ranks(dcol.values)
        valid = np.nonzero(~dict_null)[0]
        nranks = int(ranks[valid].max()) + 1 if len(valid) else 0
        # rank -> the first valid slot holding it
        rank_to_slot = np.zeros(max(nranks, 1), np.int64)
        rank_to_slot[ranks[valid][::-1].astype(np.int64)] = valid[::-1]
        won = res.columns[nkeys + i]
        slots = torch.from_numpy(rank_to_slot).to(won.device)[
            won.values.clamp(0, max(nranks - 1, 0))]
        out = take(dcol.values, PrimitiveColumn(slots, dt.int64))
        out_cols[nkeys + i] = out.with_validity(won.validity)
        out_fields[nkeys + i] = dt.Field(a.out_name, out.dtype)
    return Table(tuple(out_cols), dt.Schema(tuple(out_fields)))


def _empty_group_by(table: Table, keys, aggs) -> Table:
    """The n == 0 result: empty keys and aggregates whose fields are all
    nullable, as the reference's _empty_agg gives them
    (groupby.py:115-124,2190-2197)."""
    out_cols: List[Column] = [table.column(k).slice(0, 0) for k in keys]
    fields = [table.schema.field(k) for k in keys]
    for a in aggs:
        src = table.column(a.column)
        out_dt = _agg_dtype(src.dtype, a.op)
        if out_dt.is_string or out_dt.name == "dictionary":
            if out_dt.name == "dictionary":
                out_dt = out_dt.value_type
            col = StringColumn.from_pylist([], out_dt, device=src.device)
        else:
            col = PrimitiveColumn(torch.zeros(0, dtype=out_dt.to_torch(),
                                              device=src.device), out_dt)
        out_cols.append(col)
        fields.append(dt.Field(a.out_name, out_dt))
    return Table(out_cols, dt.Schema(tuple(fields)))


# ---- range scan ------------------------------------------------------------

def _ordered_int64(values: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """int64 whose signed order is the value order of integer or bool
    storage (uint64 through the sign flip)."""
    if d.name == "uint64":
        return values ^ _SIGN
    return dt.widen(values, d)


def _scan(cols: Sequence[PrimitiveColumn]) -> List[KeyRange]:
    """Masked (min, max, has_null) of integer or bool columns on the
    device, with ONE host fetch (_bin_range_scan, groupby.py:2106-2130).
    An all-null column comes back with min > max."""
    if not cols:
        return []
    hi_id, lo_id = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min
    rows = []
    for c in cols:
        w = _ordered_int64(c.values, c.dtype)
        if c.validity is None:
            lo, hi = torch.aminmax(w)
            nul = torch.zeros((), dtype=torch.int64, device=w.device)
        else:
            lo = torch.where(c.validity, w, hi_id).amin()
            hi = torch.where(c.validity, w, lo_id).amax()
            nul = (~c.validity).any().to(torch.int64)
        rows.append(torch.stack([lo, hi, nul]))
    out = []
    got = to_host("group_by.range_scan", torch.stack(rows)).tolist()
    for c, (lo, hi, nul) in zip(cols, got):
        if c.dtype.name == "uint64":
            lo, hi = (lo ^ _SIGN) & ((1 << 64) - 1), \
                (hi ^ _SIGN) & ((1 << 64) - 1)
        out.append(KeyRange(lo, hi, bool(nul)))
    return out


def _is_int_or_bool(c: Column) -> bool:
    return isinstance(c, PrimitiveColumn) and \
        (c.dtype.is_integer or c.dtype.is_boolean)


def _range_scan(table: Table, key_cols, aggs):
    """Ranges of the integer and bool keys and of the integer min/max
    value columns (None elsewhere), in one scan."""
    mm = [c for c in dict.fromkeys(a.column for a in aggs
                                   if a.op in ("min", "max"))
          if _is_int_or_bool(table.column(c))]
    key_idx = [i for i, c in enumerate(key_cols) if _is_int_or_bool(c)]
    ranges = _scan([key_cols[i] for i in key_idx]
                   + [table.column(c) for c in mm])
    key_ranges: List[Optional[KeyRange]] = [None] * len(key_cols)
    for i, r in zip(key_idx, ranges):
        key_ranges[i] = r
    return key_ranges, dict(zip(mm, ranges[len(key_idx):]))


# ---- plans 1 and 2: one K2 pass over dense codes ---------------------------

@dataclass
class _Digits:
    """One key's dense codes for the K2 plans: digits codes - offset in
    [0, size) (codes of logical type `dtype`, None: the storage's own),
    null rows (where `validity` is False) take the digit `size`; `ranks`
    give the value order of the digits."""
    codes: torch.Tensor
    validity: Optional[torch.Tensor]
    size: int
    null_digit: bool
    ranks: np.ndarray
    offset: int = 0
    dtype: Optional[dt.DataType] = None

    @property
    def base(self) -> int:
        return self.size + self.null_digit


def _fast_agg_stage(bases: Sequence[int], g_total: int, key_parts,
                    sum_cols: Sequence[SumCol], mm_cols: Sequence[MinMaxCol],
                    decode: bool = True):
    """Mixed-radix combined codes, then one K2 pass (groupby.py:330).
    key_parts: (codes, validity, offset, dtype) per key; a digit is
    codes - offset, and null rows take the digit base - 1.  One key
    whose radix is the group count goes to K2 as it is: K2 computes the
    digits itself.  decode=False keeps min/max as undecoded u64 order
    keys, so partials of chunks can merge exactly (the role of
    groupby.py:387-407)."""
    if len(key_parts) == 1 and bases[0] == g_total:
        codes, validity, offset, dtype = key_parts[0]
        return grouped_aggregate(codes, g_total, sum_cols=sum_cols,
                                 mm_cols=mm_cols, decode=decode, base=offset,
                                 codes_valid=validity, codes_dtype=dtype)
    combined = None
    for (codes, validity, offset, dtype), base in zip(key_parts, bases):
        digit = row_codes(codes, base, offset, validity, dtype) \
            .to(torch.int32)
        combined = digit if combined is None else combined * base + digit
    return grouped_aggregate(combined.contiguous(), g_total,
                             sum_cols=sum_cols, mm_cols=mm_cols,
                             decode=decode)


def _dictionary_plan(table: Table, key_cols, keys, aggs) -> Optional[Table]:
    """Plan 1, or None when the inputs are outside its domain
    (_dictionary_fast_path, groupby.py:465-627)."""
    if not all(isinstance(c, DictionaryColumn) for c in key_cols):
        return None
    if math.prod(len(c.values) + 1 for c in key_cols) > G_MAX:
        return None
    if not all(_agg_supported(table.column(a.column), a.op) for a in aggs):
        return None
    parts = []
    for c in key_cols:
        # the code domain assumes distinct non-null values per slot
        # (groupby.py:486-501)
        r, is_null = dictionary_value_ranks(c.values)
        if is_null.any() or len(np.unique(r)) != len(r):
            return None
        parts.append(_Digits(c.codes, c.validity, len(c.values), True, r))

    def key_column(i, digit, is_null, sel):
        c = key_cols[i]
        codes = torch.from_numpy(np.where(is_null, 0, digit)).to(
            device=c.device, dtype=c.codes.dtype)
        mask = torch.from_numpy(~is_null).to(c.device)
        return DictionaryColumn(codes[sel], c.values, mask[sel],
                                _canonical=True,
                                ordered=bool(c.dtype.ordered))

    return _k2_plan(table, keys, aggs, parts, key_column)


def _small_domain_plan(table: Table, key_cols, keys, aggs,
                       key_ranges) -> Optional[Table]:
    """Plan 2, or None when a key is not an integer or bool, the combined
    domain exceeds G_MAX, or an aggregate is one K2 does not cover."""
    if not all(_is_int_or_bool(c) for c in key_cols):
        return None
    if not all(_agg_supported(table.column(a.column), a.op) for a in aggs):
        return None
    g_total, parts = 1, []
    for c, r in zip(key_cols, key_ranges):
        lo, hi = r.bounds
        g_total *= hi - lo + 1 + r.has_null
        if g_total > G_MAX:
            return None
        parts.append(_Digits(c.values, c.validity if r.has_null else None,
                             hi - lo + 1, r.has_null,
                             np.arange(hi - lo + 1), lo, c.dtype))

    def key_column(i, digit, is_null, sel):
        c, lo = key_cols[i], key_ranges[i].bounds[0]
        vals = np.array([0 if null else lo + int(x)
                         for x, null in zip(digit, is_null)],
                        dtype=c.dtype.to_numpy()).view(c.dtype.storage_numpy())
        mask = None if not is_null.any() else \
            torch.from_numpy(~is_null).to(c.device)[sel]
        return PrimitiveColumn(torch.from_numpy(vals).to(c.device)[sel],
                               c.dtype, mask, _canonical=True)

    return _k2_plan(table, keys, aggs, parts, key_column)


def _k2_plan(table: Table, keys, aggs, parts: Sequence[_Digits],
             key_column) -> Table:
    """Slot planning (groupby.py:517-552), one K2 pass, then the
    group-sized outputs in the sort plan's order.  key_column(i, digit,
    is_null, sel) builds key i's output from the host digits of every
    combination and the selection of occupied ones."""
    g_total = math.prod(p.base for p in parts)
    # slot 0 counts rows (occupancy and count_all) with no column behind it
    sum_cols: List[SumCol] = [SumCol(None)]
    sum_slot = {None: 0}
    mm_cols: List[MinMaxCol] = []
    mm_slot = {}

    def count_slot(src, name):
        """A column's count of valid rows: slot 0 when it has no
        validity, its sum slot's count when it has one, else a
        count-only slot."""
        if ("cnt", name) in sum_slot:
            return
        if src.validity is None:
            sum_slot[("cnt", name)] = 0
        elif ("sum", name) in sum_slot:
            sum_slot[("cnt", name)] = sum_slot[("sum", name)]
        else:
            sum_slot[("cnt", name)] = len(sum_cols)
            sum_cols.append(SumCol(None, src.validity))

    for a in aggs:                  # sum slots first: counts may share them
        src = table.column(a.column)
        if a.op in ("sum", "mean") and ("sum", a.column) not in sum_slot:
            sum_slot[("sum", a.column)] = len(sum_cols)
            sum_cols.append(SumCol(src.values, src.validity, src.dtype))
    for a in aggs:
        src = table.column(a.column)
        if a.op == "count":
            count_slot(src, a.column)
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
        [p.base for p in parts], g_total,
        [(p.codes, p.validity, p.offset, p.dtype) for p in parts], sum_cols,
        mm_cols)
    occupancy = counts[0]
    device = occupancy.device

    # group-sized key digits and their order, on the host (<= G_MAX)
    gids = np.arange(g_total)
    stride = g_total
    digits, nulls, order_keys = [], [], []
    for p in parts:
        stride //= p.base
        digit = (gids // stride) % p.base
        is_null = p.null_digit & (digit == p.size)
        digits.append(digit)
        nulls.append(is_null)
        # null digit sorts first; values by rank
        order_keys.append(np.append(p.ranks.astype(np.int64) + 1, 0)[digit])
    order = np.lexsort(order_keys[::-1])
    # host sync (cardinality)
    occupied = to_host("group_by.occupancy", occupancy > 0).numpy()
    sel = torch.from_numpy(order[occupied[order]]).to(device)

    out_cols: List[Column] = [key_column(i, d, z, sel)
                              for i, (d, z) in enumerate(zip(digits, nulls))]
    fields = [table.schema.field(k) for k in keys]
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
        group_valid = c[sel] > 0
        group_mask = None if bool(to_host(
            "group_by.group_valid", group_valid.all())) else group_valid
        if a.op == "sum":
            vals = s.to(src.dtype.to_torch())
        elif a.op == "mean":
            vals = s.to(torch.float64) / c.clamp(min=1).to(torch.float64)
        else:
            vals = mn if a.op == "min" else mx
        out_cols.append(PrimitiveColumn(vals[sel], out_dt, group_mask))
        fields.append(dt.Field(a.out_name, out_dt))
    return Table(out_cols, dt.Schema(tuple(fields)))


# ---- plan 3: the sort plan -------------------------------------------------

def _key_domain(key_cols, key_ranges) -> Optional[int]:
    """An upper bound on the number of distinct keys (None: unbounded)."""
    dom = 1
    for c, r in zip(key_cols, key_ranges):
        if r is not None:
            lo, hi = r.bounds
            dom *= hi - lo + 1 + r.has_null
        elif isinstance(c, DictionaryColumn):
            dom *= len(c.values) + 1
        else:
            return None
    return dom


def _discover(key_cols, key_ranges, n: int):
    """Key encode, stable sort and run starts (_discover_stage,
    groupby.py:271-307): (order, run_start, cap) -- the key order, the
    run-start mask in that order, and a proven bound on the group count
    for K1's out_cap (groupby.py:1841)."""
    device = key_cols[0].device
    order, words = rf.sort_keys(rf.encode_keys(key_cols, key_ranges), n,
                                device)
    neq = torch.zeros(n - 1, dtype=torch.bool, device=device)
    for w in words:
        neq |= w[1:] != w[:-1]
    del words
    run_start = torch.cat([torch.ones(1, dtype=torch.bool, device=device),
                           neq])
    domain = _key_domain(key_cols, key_ranges)
    return order, run_start, n if domain is None else min(domain, n)


def _sort_stage(key_cols, key_ranges, n: int):
    """Group discovery with the K1 run-start stage
    (groupby.py:1574-1602): (order, run_start, starts, first_idx), where
    starts are each group's first position in key order and first_idx
    its first row."""
    order, run_start, cap = _discover(key_cols, key_ranges, n)
    (first_idx, starts), count = compact(run_start, [order], out_cap=cap,
                                         positions=torch.int64)
    # the plan's one sync (output cardinality)
    num_groups = int(to_host("group_by.groups", count))
    return order, run_start, starts[:num_groups], first_idx[:num_groups]


def _sort_plan(table: Table, key_cols, keys, aggs, key_ranges,
               val_ranges) -> Table:
    n = table.num_rows
    order, run_start, starts, first_idx = _sort_stage(key_cols, key_ranges,
                                                      n)
    G = starts.shape[0]
    device = starts.device
    nxt = torch.cat([starts[1:], starts.new_full((1,), n)])
    counts_all = nxt - starts
    ends = nxt - 1

    def diff_sums(contrib):
        """Per-group sums by cumsum and boundary difference
        (groupby.py:2445-2450)."""
        end = torch.cumsum(contrib, 0)[ends]
        return end - torch.cat([end.new_zeros(1), end[:-1]])

    sorted_cols, valid_counts = {}, {}

    def sorted_col(name):
        """(values, validity) in key order; values None for non-primitive
        columns (count only)."""
        if name not in sorted_cols:
            src = table.column(name)
            vs = src.values[order] if isinstance(src, PrimitiveColumn) \
                else None
            ms = None if src.validity is None else src.validity[order]
            sorted_cols[name] = (vs, ms)
        return sorted_cols[name]

    def nonnull(name):
        if name not in valid_counts:
            ms = sorted_col(name)[1]
            valid_counts[name] = counts_all if ms is None \
                else diff_sums(ms.to(torch.int64))
        return valid_counts[name]

    # min/max of integers, and of dates, times, timestamps and durations
    # by their storage integers (MinMaxCol's dtype None), over at most
    # G_MAX groups: one K2 pass over the group ids (groupby.py:2528-2557)
    def k2_type(c):
        d = table.column(c).dtype
        return d if d.is_integer else None

    k2_names = [c for c in dict.fromkeys(a.column for a in aggs
                                         if a.op in ("min", "max"))
                if G <= G_MAX and isinstance(table.column(c), PrimitiveColumn)
                and (table.column(c).dtype.is_integer
                     or (table.column(c).dtype.is_temporal
                         and table.column(c).dtype.name != "interval"))]
    k2_mm = {}
    if k2_names:
        gid = (torch.cumsum(run_start, 0, dtype=torch.int32) - 1)
        want = {(a.column, a.op) for a in aggs}
        mm_cols = [MinMaxCol(*sorted_col(c), k2_type(c),
                             want_min=(c, "min") in want,
                             want_max=(c, "max") in want) for c in k2_names]
        _, _, mms = grouped_aggregate(gid, G, mm_cols=mm_cols)
        k2_mm = dict(zip(k2_names, mms))
        del gid

    minmax_sorted = {}

    def sorted_minmax(name):
        """Rows re-ordered by (group, class, value): each group's min sits
        at its first position, its max at first + nonnull - 1; class
        orders valid < NaN < null (groupby.py:2476-2524)."""
        if name not in minmax_sorted:
            vs, ms = sorted_col(name)
            d = table.column(name).dtype
            gid = torch.cumsum(run_start, 0, dtype=torch.int64) - 1
            skeys = [SortKey(gid, (G - 1).bit_length())]
            cls = None
            if d.is_floating:
                isnan = torch.isnan(vs)
                cls = isnan.to(torch.int64)
                if ms is not None:
                    cls = torch.where(ms, cls, 2)
                venc, bits = rf.float_order_key(torch.where(isnan, 0.0, vs))
                skeys.append(SortKey(cls, 2))
            else:
                venc, bits = rf.int_order_key(vs, d, val_ranges.get(name))
                if ms is not None:
                    skeys.append(SortKey((~ms).to(torch.int64), 1))
                    venc = torch.where(ms, venc, 0)
            skeys.append(SortKey(venc, bits))
            perm = rf.lexsort_order(skeys, n, device)
            minmax_sorted[name] = (vs, perm, cls)
        return minmax_sorted[name]

    def pick(name, pos):
        vs, perm, cls = sorted_minmax(name)
        row = perm[pos]
        v = vs[row]
        if cls is not None:
            v = torch.where(cls[row] == 1, math.nan, v)
        return v

    outs = []
    for a in aggs:
        if a.op == "count_all":
            outs.append((counts_all, None))
            continue
        if a.op == "count":
            outs.append((nonnull(a.column), None))
            continue
        src = table.column(a.column)
        cnt = nonnull(a.column)
        gvalid = cnt > 0
        if a.op in ("sum", "mean"):
            vs, ms = sorted_col(a.column)
            contrib = vs if ms is None else torch.where(ms, vs, 0)
            if src.dtype.is_floating:
                wide = float_group_sums(contrib.to(torch.float64), diff_sums)
            else:
                wide = diff_sums(dt.widen(contrib, src.dtype))
            if a.op == "mean":
                # divide the WIDE sum: narrowing first wraps int8/16/32
                # group sums (groupby.py:2583-2590)
                outs.append((wide.to(torch.float64)
                             / cnt.clamp(min=1).to(torch.float64), gvalid))
            else:
                outs.append((wide.to(src.dtype.to_torch()), gvalid))
        elif a.column in k2_mm:
            mn, mx = k2_mm[a.column]
            outs.append((mn if a.op == "min" else mx, gvalid))
        elif a.op == "min":
            outs.append((pick(a.column, starts), gvalid))
        else:
            outs.append((pick(a.column, starts + cnt.clamp(min=1) - 1),
                         gvalid))
    del sorted_cols, minmax_sorted, order, run_start

    flags = [g.all() for _, g in outs if g is not None]
    flags = iter(to_host("group_by.group_valid", torch.stack(flags))
                 .tolist() if flags else [])
    out_cols: List[Column] = [take(c, first_idx) for c in key_cols]
    fields = [table.schema.field(k) for k in keys]
    for a, (vals, gvalid) in zip(aggs, outs):
        out_dt = _agg_dtype(table.column(a.column).dtype, a.op)
        mask = None if gvalid is None or next(flags) else gvalid
        out_cols.append(PrimitiveColumn(vals, out_dt, mask))
        fields.append(dt.Field(a.out_name, out_dt,
                               nullable=a.op not in ("count", "count_all")))
    return Table(out_cols, dt.Schema(tuple(fields)))


# ---- streaming two-level aggregation ---------------------------------------

class GroupByAccumulator:
    """Streaming two-level grouped aggregation (groupby.py:2207-2397):
    each update() chunk aggregates locally with decomposed aggregates
    (mean -> sum + count), the small per-chunk group tables accumulate
    (re-compacted by a partial merge when they grow past COMPACT_ROWS),
    and finalize() runs one final merge (sum/count -> sum, min -> min,
    max -> max).  Integer sums stay exact (wrapping addition is
    associative); float partial sums are in the source type, as in the
    reference.  The input of a 500M-row x 10M-group aggregate never has
    to be resident: chunks stream through."""

    # Partial rows kept before a partial merge.  The merge's peak device
    # memory, measured on an 80 GB H100 over config 4's four 125M-row
    # partials (40M rows), is 172 bytes a partial row beyond the
    # partials themselves (about 45 bytes a row): 200M rows peak near
    # 40 GiB, beside one chunk of the sort plan (PERF.md, Findings).
    COMPACT_ROWS = 200_000_000

    _MAX_IN_FLIGHT = 2

    def __init__(self, keys: Sequence[str], aggs: Sequence[AggSpec]):
        self.keys = list(keys)
        self.aggs = list(aggs)
        self._parts: List[Table] = []
        self._part_rows = 0
        self._plan = None       # built from the first chunk's dtypes
        self._pool = None
        self._futs: List[concurrent.futures.Future] = []

    def _build_plan(self, table: Table):
        partial_specs: List[AggSpec] = []
        merge_plan = []   # (out_name, kind, part names...)
        seen = {}
        wide_specs = {}
        src_dtypes = {}

        def add_partial(col, op):
            if (col, op) not in seen:
                seen[(col, op)] = f"__p{len(partial_specs)}"
                partial_specs.append(AggSpec(col, op, seen[(col, op)]))
            return seen[(col, op)]

        def mean_source(colname):
            # mean needs the TRUE sum: partial sums come in the source
            # type, so narrow ints, bools and f16/f32 widen first
            d = table.column(colname).dtype
            if d.name in ("int64", "uint64", "float64"):
                return colname
            wname = f"__wide_{colname}"
            wide_specs[wname] = (
                colname, dt.float64 if d.is_floating else dt.int64)
            return wname

        for a in self.aggs:
            src_dtypes[a.column] = table.column(a.column).dtype
            if a.op == "mean":
                s = add_partial(mean_source(a.column), "sum")
                c = add_partial(a.column, "count")
                merge_plan.append((a.out_name, "mean", s, c))
            elif a.op in ("count", "count_all"):
                merge_plan.append((a.out_name, "recount",
                                   add_partial(a.column, a.op)))
            else:
                merge_plan.append((a.out_name, a.op,
                                   add_partial(a.column, a.op)))
        self._plan = (partial_specs, merge_plan, wide_specs, src_dtypes)

    def _merge_specs(self) -> List[AggSpec]:
        """Partial-to-partial merge (keeps partial names): sums and counts
        add, min of mins, max of maxes."""
        return [AggSpec(p.out_name,
                        "sum" if p.op in ("sum", "count", "count_all")
                        else p.op, p.out_name)
                for p in self._plan[0]]

    def _widen(self, table: Table) -> Table:
        wide_specs = self._plan[2]
        if not wide_specs:
            return table
        extra = {nm: cast(table.column(src), d)
                 for nm, (src, d) in wide_specs.items()}
        return Table(
            tuple(table.columns) + tuple(extra.values()),
            dt.Schema(tuple(table.schema.fields)
                      + tuple(dt.Field(nm, c.dtype)
                              for nm, c in extra.items())))

    def update(self, chunk: Table) -> None:
        if self._plan is None:
            self._build_plan(chunk)
        part = group_by(self._widen(chunk), self.keys, self._plan[0])
        self._parts.append(part)
        self._part_rows += part.num_rows
        if self._part_rows > self.COMPACT_ROWS and len(self._parts) > 1:
            merged = _group_by(concat_tables(self._parts), self.keys,
                               self._merge_specs(), chunk=False)
            self._parts = [merged]
            self._part_rows = merged.num_rows

    def update_async(self, chunk: Table) -> None:
        """update() on one worker thread, so the caller can make the next
        chunk while this one's syncs are in flight; at most
        _MAX_IN_FLIGHT chunks are pending (groupby.py:2323-2341)."""
        if self._plan is None:
            # plan building reads dtypes only; done here so the worker
            # reads a finished plan
            self._build_plan(chunk)
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        while sum(not f.done() for f in self._futs) >= self._MAX_IN_FLIGHT:
            self._futs[0].result()
            self._futs = [f for f in self._futs if not f.done()]
        for f in self._futs:
            if f.done():
                f.result()          # surface worker exceptions eagerly
        self._futs = [f for f in self._futs if not f.done()]
        self._futs.append(self._pool.submit(self.update, chunk))

    def flush(self) -> None:
        """Wait for all pending async updates (re-raises their errors)."""
        try:
            for f in self._futs:
                f.result()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
            self._futs = []

    def finalize(self) -> Table:
        self.flush()
        if self._plan is None:
            raise ArrowInvalid("GroupByAccumulator saw no chunks")
        _, merge_plan, _, src_dtypes = self._plan
        merged = self._parts[0] if len(self._parts) == 1 \
            else concat_tables(self._parts)

        final_specs = []
        for name, kind, *pnames in merge_plan:
            if kind == "mean":
                final_specs.append(AggSpec(pnames[0], "sum", name + "#s"))
                final_specs.append(AggSpec(pnames[1], "sum", name + "#c"))
            elif kind == "recount":
                final_specs.append(AggSpec(pnames[0], "sum", name))
            else:
                final_specs.append(AggSpec(pnames[0], kind, name))
        out = _group_by(merged, self.keys, final_specs, chunk=False)

        out_cols = list(out.columns[:len(self.keys)])
        fields = [out.schema.field(k) for k in self.keys]
        for a, (name, kind, *_) in zip(self.aggs, merge_plan):
            out_dt = _agg_dtype(src_dtypes[a.column], a.op)
            if kind == "mean":
                s_col, c_col = out.column(name + "#s"), out.column(name + "#c")
                m = s_col.values.to(torch.float64) / \
                    c_col.values.clamp(min=1).to(torch.float64)
                gvalid = c_col.values > 0
                mask = None if bool(to_host("group_by.group_valid",
                                            gvalid.all())) else gvalid
                out_cols.append(PrimitiveColumn(m, dt.float64, mask))
                fields.append(dt.Field(name, dt.float64))
            elif kind == "recount":
                c = out.column(name)
                out_cols.append(PrimitiveColumn(
                    vd.canonicalize(c.values, c.validity), dt.int64,
                    _canonical=True))
                fields.append(dt.Field(name, dt.int64, nullable=False))
            elif isinstance(out.column(name), StringColumn):
                # min/max of strings: the reference's finalize reads
                # `.values` of this column and raises (ROADMAP C8)
                out_cols.append(out.column(name))
                fields.append(dt.Field(name, out.column(name).dtype))
            else:
                c = out.column(name)
                out_cols.append(PrimitiveColumn(
                    c.values.to(out_dt.to_torch()), out_dt, c.validity,
                    _canonical=True))
                fields.append(dt.Field(name, out_dt))
        return Table(tuple(out_cols), dt.Schema(tuple(fields)))


def _group_by_chunked(table: Table, keys, aggs, n: int) -> Table:
    """group_by over a resident table past _SORT_AGG_CHUNK rows: slices
    streamed through GroupByAccumulator (groupby.py:2400-2409)."""
    k = math.ceil(n / _SORT_AGG_CHUNK)
    q = math.ceil(n / k)
    acc = GroupByAccumulator(keys, aggs)
    for i in range(k):
        acc.update(table.slice(i * q, min(q, n - i * q)))
    return acc.finalize()


# ---- static-shape building block -------------------------------------------

def segment_aggregate(values: torch.Tensor, valid: torch.Tensor,
                      gid: torch.Tensor, num_groups: int, op: str,
                      dtype: Optional[dt.DataType] = None) -> torch.Tensor:
    """Segment reduction into a fixed number of groups with no host sync
    (groupby.py:2607-2625), for the distributed aggregate: index_add_ for
    count and sum, scatter_reduce_ for min and max; groups without a
    valid row hold the identity.  dtype: the logical type of `values`
    (needed for unsigned types on signed storage)."""
    idx = gid.to(torch.int64)
    if op in ("count", "count_all"):
        w = valid.to(torch.int64) if op == "count" \
            else torch.ones_like(idx)
        return torch.zeros(num_groups, dtype=torch.int64,
                           device=gid.device).index_add_(0, idx, w)
    if op == "sum":
        contrib = torch.where(valid, values, torch.zeros(
            (), dtype=values.dtype, device=values.device))
        return torch.zeros(num_groups, dtype=values.dtype,
                           device=gid.device).index_add_(0, idx, contrib)
    if op not in ("min", "max"):
        raise ArrowInvalid(f"unknown segment aggregate {op}")
    d = dtype or dt.from_numpy_dtype(dt.torch_dtype_name(values.dtype))
    flip = d.is_unsigned_integer and values.dtype != torch.uint8
    key = values
    if flip:                 # signed storage: order through the sign flip
        key = values ^ torch.iinfo(values.dtype).min
    if values.is_floating_point():
        ident = math.inf if op == "min" else -math.inf
    else:
        info = torch.iinfo(values.dtype)
        ident = info.max if op == "min" else info.min
    out = torch.full((num_groups,), ident, dtype=values.dtype,
                     device=gid.device)
    out.scatter_reduce_(0, idx, torch.where(valid, key, ident),
                        "amin" if op == "min" else "amax")
    return out ^ torch.iinfo(values.dtype).min if flip else out
