"""take: gather rows by an index column (counterpart of
arrow_tpu/ops/take.py:35-214; take.rs:86, per-layout dispatch take.rs:196).

  primitive   -> values gather + validity gather (take.rs:408,434); also
                 decimal32/64
  dictionary  -> codes gather, dictionary shared (take.rs take_dict)
  string, list, large list, map
              -> one range gather (`range_gather`): new offsets from a
                 cumsum of the gathered lengths, the source index of each
                 output byte or child row from a scatter of each row's
                 jump and a cumsum, on the device; reading the total is
                 the one host sync.  The reference builds that index on
                 the host with np.repeat (take.py:178-214).
  struct      -> each child taken by the same indices; the struct's mask
                 gathered and joined with the indices' (take.py:76-81)
  fixed-size list / binary, decimal128/256, interval[month_day_nano]
              -> a gather of each plane (a list's child by idx * k + j)
  list view   -> offsets and sizes gathered, the child shared
  union       -> type ids gathered; dense shares its children and gathers
                 its offsets, sparse takes every child
  run-end     -> logical rows mapped to runs (a searchsorted), equal
                 neighbours merged into the output's runs on the device
                 with one sync for their count (the reference merges on
                 the host, take.py:151-176); null indices raise
  null        -> a null column of the indices' length

Out-of-range indices clamp, as the reference's unchecked mode does;
`check_bounds=True` verifies and raises instead (one host sync).  Null
indices give null outputs and gather row 0 beneath, as in the
reference.  Unsigned indices (uint32 on int32 storage) read as their
logical values.  The reference's take of a large_list returns the
`list` type over int64 offsets (ROADMAP C9); here it stays large_list.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, ListColumn, NullColumn,
                           PrimitiveColumn, StringColumn, StructColumn)
from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                           FixedSizeListColumn, IntervalMDNColumn,
                           ListViewColumn, MapColumn, RunEndColumn,
                           UnionColumn)
from ..core.table import Table
from ..errors import ArrowInvalid
from ..utils.trace import span, to_host

__all__ = ["take", "take_table", "range_gather"]

# byte and row positions below this fit an int32 index (tests lower it
# to cover the int64 route without 2 GB of data)
INDEX32_LIMIT = 2 ** 31


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
        bad = ((idx < 0) | (idx >= n)) & indices.is_valid_mask()
        if bool(to_host("take(check_bounds=True)", bad.any(), guard=True)):
            raise ArrowInvalid(f"take index out of bounds 0..{n}")
    return _take(values, idx.clamp(0, max(n - 1, 0)), indices)


def _take(values: Column, idx: torch.Tensor,
          indices: PrimitiveColumn) -> Column:
    """values at the clamped int64 rows `idx`; the indices' validity
    rides in `indices`."""
    valid = _gather_validity(values, idx, indices)
    if isinstance(values, PrimitiveColumn):
        return PrimitiveColumn(values.values[idx], values.dtype, valid)
    if isinstance(values, DictionaryColumn):
        return DictionaryColumn(values.codes[idx], values.values, valid,
                                ordered=bool(values.dtype.ordered))
    if isinstance(values, StringColumn):
        offs, data = _gather_bytes(values.offsets, values.data, idx)
        return StringColumn(offs, data, values.dtype, valid)
    if isinstance(values, (ListColumn, MapColumn)):
        child = values.child if isinstance(values, ListColumn) \
            else values.entries
        offs, src = range_gather(values.offsets, idx, len(child))
        child = _take(child, src.to(torch.int64), _rows(src))
        if isinstance(values, MapColumn):
            return MapColumn(offs, child, valid)
        return ListColumn(offs, child, valid, values._large())
    if isinstance(values, NullColumn):
        return NullColumn(idx.shape[0], idx.device)
    if isinstance(values, StructColumn):
        kids = tuple(_take(c, idx, indices) for c in values.children)
        return StructColumn(kids, values.fields, valid)
    if isinstance(values, ListViewColumn):
        return ListViewColumn(values.offsets[idx], values.sizes[idx],
                              values.child, valid, values.dtype)
    if isinstance(values, FixedSizeBinaryColumn):
        return FixedSizeBinaryColumn(values.data[idx], valid)
    if isinstance(values, DecimalColumn):
        return DecimalColumn(values.limbs[idx], values.dtype, valid)
    if isinstance(values, IntervalMDNColumn):
        return IntervalMDNColumn(values.months[idx], values.days[idx],
                                 values.nanos[idx], valid)
    if isinstance(values, FixedSizeListColumn):
        # the child rows of the UNclamped index, then clamped to the
        # child, as the reference's clipping gather does (take.py:120-127)
        k = values.list_size
        raw = dt.widen(indices.values, indices.dtype)
        rows = (raw[:, None] * k + torch.arange(k, device=idx.device)
                ).reshape(-1).clamp(0, max(len(values.child) - 1, 0))
        return FixedSizeListColumn(_take(values.child, rows, _rows(rows)), k,
                                   valid)
    if isinstance(values, UnionColumn):
        tids = values.type_ids[idx]
        if values.offsets is None:
            return UnionColumn(tids, None, [_take(c, idx, indices)
                                            for c in values.children],
                               values.fields, values.ids)
        return UnionColumn(tids, values.offsets[idx], values.children,
                           values.fields, values.ids)
    if isinstance(values, RunEndColumn):
        return _take_run(values, idx, indices)
    raise ArrowInvalid(f"take of {type(values).__name__}")


def _rows(idx: torch.Tensor) -> PrimitiveColumn:
    """The row indices of a child's gather: no nulls."""
    return PrimitiveColumn(idx, dt.from_numpy_dtype(
        dt.torch_dtype_name(idx.dtype)))


def _gather_validity(values: Column, idx: torch.Tensor,
                     indices: PrimitiveColumn) -> vd.Mask:
    """out valid = indices valid AND values[idx] valid (take.rs take_bits)."""
    own = values.validity
    return vd.union(None if own is None else own[idx], indices.validity)


def range_gather(offsets: torch.Tensor, idx: torch.Tensor, limit: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows `idx` of an offsets layout (a string's bytes, a list's or
    a map's child rows) as (new offsets in `offsets`' dtype, the source
    position of each output element).  A source position grows by one
    along a row and jumps to the row's start where the row begins (the
    jumps of empty rows add up to the next row's), so a scatter of the
    jumps and a cumsum give the map; reading its length is the one host
    sync.  Positions are int32 while the output and the source (`limit`
    elements) fit in it, else int64."""
    starts, ends, new_offs = _row_ranges(offsets, idx)
    total = int(to_host("take.range_gather", new_offs[-1]))  # one sync
    return new_offs.to(offsets.dtype), _source_index(starts, ends, new_offs,
                                                     total, limit)


def _row_ranges(offsets: torch.Tensor, idx: torch.Tensor):
    """(int64 starts, ends, new offsets) of the rows `idx`."""
    starts = offsets.index_select(0, idx).to(torch.int64)
    ends = offsets.index_select(0, idx + 1).to(torch.int64)
    new_offs = torch.zeros(idx.shape[0] + 1, dtype=torch.int64,
                           device=idx.device)
    torch.cumsum(ends - starts, 0, out=new_offs[1:])
    return starts, ends, new_offs


def _source_index(starts, ends, new_offs, total: int, limit: int
                  ) -> torch.Tensor:
    """range_gather's map: the source position of each of the `total`
    output elements."""
    ix = torch.int32 if max(total, limit) < INDEX32_LIMIT else torch.int64
    prev_end = torch.cat([ends.new_ones(1), ends[:-1]])
    step = torch.ones(total + 1, dtype=ix, device=starts.device)
    step.index_add_(0, new_offs[:-1], (starts - prev_end).to(ix))
    return torch.cumsum(step[:total], 0, dtype=ix)


# output bytes a string take gathers at once: range_gather's source index
# and its step buffer take 8-16 bytes an output byte
GATHER_PIECE = 1 << 28


def _gather_bytes(offsets: torch.Tensor, data: torch.Tensor,
                  idx: torch.Tensor, total: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new offsets, bytes) of the string rows `idx`: one range gather
    (one host sync for the byte count, none when the caller knows it as
    `total`) up to GATHER_PIECE output bytes, else one a piece of rows
    holding about that many (a row longer than a piece is a piece),
    written into one output, with two more syncs for the piece bounds.
    Past 2^31 bytes int32 offsets raise."""
    starts, ends, new_offs = _row_ranges(offsets, idx)
    if total is None:
        total = int(to_host("take.string_bytes", new_offs[-1]))
    if offsets.dtype == torch.int32 and total > torch.iinfo(torch.int32).max:
        raise ArrowInvalid(f"{total} bytes overflow int32 offsets: use a "
                           "large string type")
    limit = data.shape[0]
    if total <= GATHER_PIECE:
        src = _source_index(starts, ends, new_offs, total, limit)
        return new_offs.to(offsets.dtype), data.index_select(0, src)
    targets = torch.arange(GATHER_PIECE, total, GATHER_PIECE,
                           device=idx.device)
    cuts = to_host("take.string_pieces", torch.searchsorted(
        new_offs[1:], targets, right=True)).tolist()
    rows = sorted({0, idx.shape[0], *cuts})
    bounds = to_host("take.string_pieces", new_offs[rows]).tolist()
    out = torch.empty(total, dtype=torch.uint8, device=data.device)
    for (a, b), (lo, hi) in zip(zip(rows, rows[1:]),
                                zip(bounds, bounds[1:])):
        src = _source_index(starts[a:b], ends[a:b], new_offs[a:b + 1] - lo,
                            hi - lo, limit)
        torch.index_select(data, 0, src, out=out[lo:hi])
    return new_offs.to(offsets.dtype), out


def _take_run(values: RunEndColumn, idx: torch.Tensor,
              indices: PrimitiveColumn) -> RunEndColumn:
    """take.rs take_run: each row's run, then equal neighbours merged
    into the output's runs, on the device; reading the run count is the
    one host sync (the reference merges on the host, take.py:151-176)."""
    if indices.validity is not None:
        raise ArrowInvalid("take on run-end arrays with null indices is "
                           "not supported; mask first")
    phys = values.row_to_run(idx)
    n = phys.shape[0]
    start = torch.ones(n, dtype=torch.bool, device=idx.device)
    start[1:] = phys[1:] != phys[:-1]
    starts = start.nonzero().squeeze(1)              # the one host sync
    run_ends = torch.cat([starts[1:], starts.new_full((1,), n)])[:n]
    rows = phys[starts].to(torch.int64)
    vals = _take(values.values, rows.clamp(0, max(values.num_runs - 1, 0)),
                 _rows(rows))
    return RunEndColumn(run_ends.to(values.run_ends.dtype), vals, n)


def take_table(table: Table, indices, *, check_bounds: bool = False) -> Table:
    """take_record_batch (take.rs:964): one index column over every
    column of the batch."""
    with span("op.take"):
        indices = _indices(indices)
        return Table(tuple(take(c, indices, check_bounds=check_bounds)
                           for c in table.columns), table.schema,
                     _validated=True)
