"""concat and interleave (counterpart of arrow_tpu/ops/concat.py:
concat, _concat_dictionaries_merged, concat_tables, interleave and
interleave_tables, concat.py:39-269).

One torch.cat per buffer, on the columns' device:
  null        -> a null column of the summed length
  primitive   -> values and validity concatenated
  string      -> each column's offsets shifted by the bytes before it
                 (on the device, no sync), the bytes concatenated
  dictionary  -> one shared values object: the codes concatenated, the
                 ordered flag kept; values that differ: the values
                 concatenated and each column's codes shifted into them
                 (repeated values stay repeated and the ordered flag is
                 dropped, as in the reference), or, when the combined
                 values pass the index type's range, the values
                 deduplicated in first-occurrence order and the codes
                 remapped (merge_dictionary_values, concat.rs:112)
  list, large list, map
              -> the children concatenated, each column's offsets shifted
                 by the child rows before it (on the device)
  struct, fixed-size list, sparse union
              -> each child concatenated (a union's type ids too)
  fixed-size binary, decimal128/256, interval[month_day_nano]
              -> each plane concatenated
  dense union -> the children concatenated, each column's offsets
                 shifted by its child's rows before it (per type id)
  run-end     -> the run ends shifted by the rows before them (runs that
                 meet at a seam stay separate, as in arrow-rs); a total
                 past the run-end type raises
  list view   -> the children concatenated, each column's offsets
                 shifted by the child rows before it, the sizes kept
The reference's concat of large lists returns the `list` type over
int64 offsets (ROADMAP C9); here it stays large_list.
interleave is a concat and one take by the flat row of each (array,
row) pair (interleave.rs:70).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
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
from ..errors import ArrowInvalid, ArrowTypeError
from .take import take

__all__ = ["concat", "concat_tables", "interleave", "interleave_tables"]


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
    if isinstance(c0, NullColumn):
        return NullColumn(sum(len(c) for c in cols), c0.device)
    if isinstance(c0, PrimitiveColumn):
        return PrimitiveColumn(torch.cat([c.values for c in cols]),
                               c0.dtype, _concat_masks(cols),
                               _canonical=True)
    if isinstance(c0, StringColumn):
        return _concat_strings(cols)
    if isinstance(c0, DictionaryColumn):
        return _concat_dictionaries(cols)
    mask = _concat_masks(cols)
    if isinstance(c0, (ListColumn, MapColumn)):
        kids = [c.child if isinstance(c, ListColumn) else c.entries
                for c in cols]
        offsets = _shifted_offsets([c.offsets for c in cols])
        if isinstance(c0, MapColumn):
            return MapColumn(offsets, concat(kids), mask)
        return ListColumn(offsets, concat(kids), mask, c0._large())
    if isinstance(c0, StructColumn):
        return StructColumn(_concat_children(cols), c0.fields, mask)
    if isinstance(c0, FixedSizeListColumn):
        return FixedSizeListColumn(concat([c.child for c in cols]),
                                   c0.list_size, mask)
    if isinstance(c0, FixedSizeBinaryColumn):
        return FixedSizeBinaryColumn(torch.cat([c.data for c in cols]), mask)
    if isinstance(c0, DecimalColumn):
        return DecimalColumn(torch.cat([c.limbs for c in cols]), c0.dtype,
                             mask)
    if isinstance(c0, IntervalMDNColumn):
        return IntervalMDNColumn(*(torch.cat([getattr(c, p) for c in cols])
                                   for p in ("months", "days", "nanos")),
                                 mask)
    if isinstance(c0, UnionColumn):
        return _concat_unions(cols)
    if isinstance(c0, RunEndColumn):
        return _concat_runs(cols)
    if isinstance(c0, ListViewColumn):
        base = np.cumsum([0] + [len(c.child) for c in cols[:-1]])
        odt = torch.int64 if c0.dtype.name == "large_list_view" \
            else torch.int32
        offsets = torch.cat([(c.offsets.to(torch.int64) + int(b)).to(odt)
                             for c, b in zip(cols, base)])
        return ListViewColumn(offsets, torch.cat([c.sizes for c in cols]),
                              concat([c.child for c in cols]), mask,
                              c0.dtype)
    raise ArrowTypeError(f"concat of {type(c0).__name__}")


def _concat_children(cols) -> tuple:
    return tuple(concat([c.children[i] for c in cols])
                 for i in range(len(cols[0].children)))


def _shifted_offsets(offsets) -> torch.Tensor:
    """(n+1,) offsets of consecutive columns as one, each shifted by the
    elements before it, on the device (no sync)."""
    ends = torch.stack([o[-1].to(torch.int64) for o in offsets])
    bases = torch.cumsum(ends, 0) - ends
    return torch.cat([offsets[0]] + [(o[1:] + b).to(offsets[0].dtype)
                                     for o, b in zip(offsets[1:], bases[1:])])


def _concat_strings(cols: Sequence[StringColumn]) -> StringColumn:
    """Offsets shifted by the byte counts before them, on the device."""
    return StringColumn(_shifted_offsets([c.offsets for c in cols]),
                        torch.cat([c.data for c in cols]), cols[0].dtype,
                        _concat_masks(cols))


def _concat_unions(cols: Sequence[UnionColumn]) -> UnionColumn:
    """Sparse: every child concatenated.  Dense: the children
    concatenated, each column's offsets shifted per type id by its
    child's rows in the columns before it (concat.py:146-165)."""
    c0 = cols[0]
    tids = torch.cat([c.type_ids for c in cols])
    children = _concat_children(cols)
    if c0.offsets is None:
        return UnionColumn(tids, None, children, c0.fields, c0.ids)
    shifted, bases = [], [0] * len(c0.children)
    for c in cols:
        shift = torch.zeros(len(c), dtype=c.offsets.dtype, device=c.device)
        for i, tid in enumerate(c.ids):
            shift = torch.where(c.type_ids == tid, bases[i], shift)
            bases[i] += len(c.children[i])
        shifted.append(c.offsets + shift)
    return UnionColumn(tids, torch.cat(shifted), children, c0.fields, c0.ids)


def _concat_runs(cols: Sequence[RunEndColumn]) -> RunEndColumn:
    """Run ends shifted by the rows before them (concat.py:167-181)."""
    base = np.cumsum([0] + [len(c) for c in cols])
    re_dt = cols[0].run_ends.dtype
    if base[-1] > torch.iinfo(re_dt).max:
        raise ArrowInvalid(f"run-end overflow: total length {base[-1]} "
                           f"exceeds {re_dt}")
    ends = torch.cat([(c.run_ends.to(torch.int64) + int(b)).to(re_dt)
                      for c, b in zip(cols, base)])
    return RunEndColumn(ends, concat([c.values for c in cols]),
                        int(base[-1]))


def _concat_dictionaries(cols: Sequence[DictionaryColumn]
                         ) -> DictionaryColumn:
    c0 = cols[0]
    if all(c.values is c0.values for c in cols[1:]):
        # one shared dictionary: concat the codes, keep the dictionary
        # and its ordered flag
        return DictionaryColumn(torch.cat([c.codes for c in cols]),
                                c0.values, _concat_masks(cols),
                                _canonical=True,
                                ordered=bool(c0.dtype.ordered))
    code_max = dt.integer_bounds(c0.dtype.index_type)[1]
    if sum(len(c.values) for c in cols) - 1 > code_max:
        return _concat_dictionaries_merged(cols, code_max)
    shifted, base = [], 0
    for c in cols:      # through int64: torch cannot add uint16/32 codes
        shifted.append((c.codes.to(torch.int64) + base).to(c.codes.dtype))
        base += len(c.values)
    return DictionaryColumn(torch.cat(shifted),
                            concat([c.values for c in cols]),
                            _concat_masks(cols))


def _first_occurrence(values: Column) -> np.ndarray:
    """For each slot of `values`, the slot of the first value equal to it
    (nulls equal each other), as the reference's dict of Python values
    gives it."""
    if isinstance(values, StringColumn):
        from .strings import _host_buffers
        from ..utils.hostcodec import intern_varlen
        codes, uniq = intern_varlen(*_host_buffers(values))
        key = codes.astype(np.int64)
        if values.validity is not None:
            key[~values.validity.cpu().numpy()] = -1
        _, first, inv = np.unique(key, return_index=True, return_inverse=True)
        return first[inv.reshape(-1)]
    # other value types: a host pass over the values, as the reference's
    seen, out = {}, []
    for i, v in enumerate(values.to_pylist()):
        out.append(seen.setdefault(v, i))
    return np.asarray(out, np.int64)


def _concat_dictionaries_merged(cols: Sequence[DictionaryColumn],
                                code_max: int) -> DictionaryColumn:
    """Deduplicate the combined values in first-occurrence order and remap
    each column's codes (concat.py:203-235, merge_dictionary_values,
    arrow-select/src/dictionary.rs:177): a host pass over the values
    only; the codes remap on the device."""
    values = concat([c.values for c in cols])
    first = _first_occurrence(values)
    keep = np.nonzero(first == np.arange(len(first)))[0]
    if len(keep) - 1 > code_max:
        raise ArrowInvalid(
            f"dictionary key space overflow: {len(keep)} merged values "
            f"exceed {cols[0].dtype.index_type!r}")
    new_code = np.empty(len(first), np.int64)
    new_code[keep] = np.arange(len(keep))
    remap = torch.from_numpy(new_code[first]).to(cols[0].device)
    merged = take(values, PrimitiveColumn(
        torch.from_numpy(keep).to(values.device), dt.int64))
    shifted, base = [], 0
    for c in cols:
        m = max(len(c.values), 1)
        local = remap[base:base + len(c.values)]
        local = local if len(local) else remap.new_zeros(1)
        shifted.append(local[c.codes.to(torch.int64).clamp(0, m - 1)]
                       .to(c.codes.dtype))
        base += len(c.values)
    return DictionaryColumn(torch.cat(shifted), merged, _concat_masks(cols))


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


def interleave(cols: Sequence[Column],
               indices: Sequence[Tuple[int, int]]) -> Column:
    """A column of the rows picked by (array index, row index) pairs
    (interleave.rs:70): a concat, then one take."""
    offsets = np.zeros(len(cols) + 1, np.int64)
    np.cumsum([len(c) for c in cols], out=offsets[1:])
    pairs = np.asarray(indices, np.int64).reshape(-1, 2)
    flat = offsets[pairs[:, 0]] + pairs[:, 1]
    merged = concat(list(cols)) if len(cols) > 1 else cols[0]
    return take(merged, PrimitiveColumn(
        torch.from_numpy(flat).to(merged.device), dt.int64))


def interleave_tables(tables: Sequence[Table],
                      indices: Sequence[Tuple[int, int]]) -> Table:
    """interleave_record_batch (interleave.rs:359)."""
    t0 = tables[0]
    cols = tuple(interleave([t.columns[i] for t in tables], indices)
                 for i in range(len(t0.columns)))
    return Table(cols, t0.schema, _validated=True)
