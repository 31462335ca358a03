"""Logical equality of columns and tables on their device (the port's
home for arrow_tpu/core/column.py:89-122, which lists both columns on
the host and compares the lists with `_py_equal`; upstream, arrow-rs's
arrow-data/src/equal/).

The answer is the reference's for every layout, computed where the
columns live:

  - The same type and length first (the reference's `!=` on types),
    else False with no device work.  Columns on two devices raise.
  - Nulls compare by position; the bits under a null slot never count.
  - Primitive, temporal, interval and decimal values compare by their
    storage bits: NaN equals NaN with the same payload, -0.0 differs
    from 0.0, as `struct.pack("<d")` tells them apart.  Where the
    reference's listing is not one-to-one on storage, it is followed:
    a float32 NaN is widened to float64, which sets its quiet bit (a
    signalling NaN equals the quiet NaN of the same payload);
    time64[ns] lists microseconds and date64 whole days, so values in
    the same microsecond or day are equal.  float16 widens exactly, and
    timestamps (zoned or not) and durations list exactly.
  - The six string types: equal lengths, then equal bytes, by one
    segmented compare of each byte of the first column with its partner
    in the second, the partners found as `ops/take.py::range_gather`
    builds its source index (the jumps scattered at the row starts, a
    cumsum), a piece of bytes at a time so that no temporary grows with
    the bytes; sliced columns are rebased by their offsets.
  - Dictionaries compare their decoded rows: two dictionaries built
    apart are equal when their rows are.  String dictionaries are given
    exact ids over both dictionaries' entries: a 64-bit hash, a sort,
    and every entry checked byte for byte against the first of its
    hash run.  Should two different entries share a hash, the check
    says so and that column is compared on the host instead.
  - Run-end columns compare their logical rows, each row's run in one
    against its run in the other, so runs split differently compare
    equal.
  - Lists, large lists, maps and fixed-size lists: row lengths, then
    the children under the valid rows, element against partner element;
    list views the same over their views (one more sync: the count of
    the elements to compare).
  - Structs compare their children under valid parent rows.
  - Unions compare on the host through `_py_equal`, as the reference
    does (ROADMAP A11: a device route is a follow-up); a null column
    compares its length.

One host sync per `column_equals` and per `columns_equal` (a table's): every
column's flag stays on the device until one copy reads them all, and
each column's temporaries are freed before the next column's work is
queued.  Only a union, a list view, a dictionary or run-end column of
nested values (taken by `ops/take.py`) or a hash collision reads more.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..errors import ArrowInvalid
from ..utils.bits import mix64
from .column import (Column, DictionaryColumn, ListColumn, NullColumn,
                     PrimitiveColumn, StringColumn, StructColumn, _py_equal)
from .nested import (DecimalColumn, FixedSizeBinaryColumn,
                     FixedSizeListColumn, IntervalMDNColumn, ListViewColumn,
                     MapColumn, RunEndColumn, UnionColumn)

__all__ = ["column_equals", "columns_equal"]

# bytes a string compare takes at once: its temporaries hold about 10
# bytes a byte of the piece (18 past 2^31 bytes)
PIECE = 1 << 28
DUMP = 1 << 20     # slots past a piece for the adds of rows outside it

_NULL_KEY = dt.storage_int(0x6E756C6C6E756C6C)   # the hash of a null entry
_GOLDEN = dt.storage_int(0x9E3779B97F4A7C15)


def column_equals(a: Column, b) -> bool:
    """`a.equals(b)`: one host sync (none when the types or lengths
    differ)."""
    if a is b:
        return True
    if not isinstance(b, Column):
        return False
    return columns_equal([(a, b)])


def columns_equal(pairs: Sequence[Tuple[Column, Column]]) -> bool:
    """Whether every pair of columns is equal, read with one host sync."""
    flags: List[torch.Tensor] = []
    read_at = []       # (pair, its flag's index, its collision flag's)
    for a, b in pairs:
        if a is b:
            continue
        if a.dtype != b.dtype or len(a) != len(b):
            return False
        if a.device != b.device:
            raise ArrowInvalid(f"equals over columns on two devices: "
                               f"{a.device} and {b.device}")
        if not len(a):
            continue
        collisions: List[torch.Tensor] = []
        i, j = len(flags), None
        flags.append(_rows(a, b, None, collisions).all())
        if collisions:
            j = len(flags)
            flags.append(torch.stack(collisions).any())
        read_at.append(((a, b), i, j))
    if not flags:
        return True
    dev = flags[0].device
    read = torch.stack([f.to(dev) for f in flags]).tolist()   # the one sync
    for (a, b), i, j in read_at:
        if j is not None and read[j]:      # a hash collision: on the host
            if not _py_equal(a.to_pylist(), b.to_pylist()):
                return False
        elif not read[i]:
            return False
    return True


# ---- per-row equality -------------------------------------------------------

def _rows(a: Column, b: Column, ib: Optional[torch.Tensor],
          collisions) -> torch.Tensor:
    """bool[len(a)]: row r of `a` equals row ib[r] of `b` (row r when
    `ib` is None); the columns have one type and `ib` lies in b."""
    n = len(a)
    if isinstance(a, NullColumn):
        return torch.ones(n, dtype=torch.bool, device=a.device)
    if isinstance(a, StringColumn):
        return _string_rows(a.offsets, a.data, a.validity, b.offsets, b.data,
                            b.validity, ib)
    if isinstance(a, DictionaryColumn):
        return _dictionary_rows(a, b, ib, collisions)
    if isinstance(a, (ListColumn, MapColumn)):
        return _list_rows(a, b, ib, collisions)
    if isinstance(a, FixedSizeListColumn):
        return _fixed_list_rows(a, b, ib, collisions)
    if isinstance(a, ListViewColumn):
        return _list_view_rows(a, b, ib, collisions)
    if isinstance(a, StructColumn):
        eq = torch.ones(n, dtype=torch.bool, device=a.device)
        for ca, cb in zip(a.children, b.children):
            eq &= _rows(ca, cb, ib, collisions)
        return _null_rule(a.validity, _at(b.validity, ib), eq)
    if isinstance(a, RunEndColumn):
        rows = torch.arange(n, device=a.device)
        return _pairs(a.values, _runs(a, rows), b.values,
                      _runs(b, rows if ib is None else ib), collisions)
    if isinstance(a, UnionColumn):
        left, right = a.to_pylist(), b.to_pylist()
        at = range(n) if ib is None else ib.tolist()
        return torch.tensor([_py_equal(x, right[j]) for x, j in zip(left, at)],
                            dtype=torch.bool, device=a.device)
    return _null_rule(a.validity, _at(b.validity, ib),
                      _fixed_equal(a, b, ib))


def _at(t: Optional[torch.Tensor], ib: Optional[torch.Tensor]):
    return t if t is None or ib is None else t.index_select(0, ib)


def _null_rule(va, vb, eq: torch.Tensor) -> torch.Tensor:
    """Rows equal when both are null, or both valid with equal values."""
    if va is None and vb is None:
        return eq
    if va is None:
        return vb & eq
    if vb is None:
        return va & eq
    return (va == vb) & (~va | eq)


def _key(values: torch.Tensor, d: dt.DataType) -> torch.Tensor:
    """Storage whose equality is the reference's equality of the listed
    values (module docstring)."""
    if d.name == "float16":
        return values.view(torch.int16)
    if d.name == "float32":
        bits = values.view(torch.int32)
        return torch.where(values.isnan(), bits | 0x400000, bits)
    if d.name == "float64":
        return values.view(torch.int64)
    if d.name == "time64" and d.unit == "ns":
        return torch.div(values, 1000, rounding_mode="floor")
    if d.name == "date64":
        return torch.div(values, 86_400_000, rounding_mode="floor")
    return values


def _fixed_equal(a: Column, b: Column, ib) -> torch.Tensor:
    """Values of the fixed-width layouts equal (validity aside)."""
    if isinstance(a, PrimitiveColumn):
        return _key(a.values, a.dtype) == _key(_at(b.values, ib), b.dtype)
    if isinstance(a, DecimalColumn):
        return (a.limbs == _at(b.limbs, ib)).all(1)
    if isinstance(a, FixedSizeBinaryColumn):
        return (a.data == _at(b.data, ib)).all(1)
    if isinstance(a, IntervalMDNColumn):
        return ((a.months == _at(b.months, ib)) & (a.days == _at(b.days, ib))
                & (a.nanos == _at(b.nanos, ib)))
    raise ArrowInvalid(f"equals: no rule for {type(a).__name__}")


_GATHERED = (PrimitiveColumn, DecimalColumn, FixedSizeBinaryColumn,
             IntervalMDNColumn, NullColumn)


def _gather(c: Column, idx: torch.Tensor) -> Column:
    """Rows `idx` of a fixed-width column, with no host read."""
    v = _at(c.validity, idx)
    if isinstance(c, PrimitiveColumn):
        return PrimitiveColumn(c.values[idx], c.dtype, v, _canonical=True)
    if isinstance(c, DecimalColumn):
        return DecimalColumn(c.limbs[idx], c.dtype, v)
    if isinstance(c, FixedSizeBinaryColumn):
        return FixedSizeBinaryColumn(c.data[idx], v)
    if isinstance(c, IntervalMDNColumn):
        return IntervalMDNColumn(c.months[idx], c.days[idx], c.nanos[idx], v)
    return NullColumn(idx.shape[0], c.device)


def _pairs(a: Column, ia: torch.Tensor, b: Column, ib: torch.Tensor,
           collisions) -> torch.Tensor:
    """bool[len(ia)]: row ia[i] of `a` equals row ib[i] of `b`, nulls
    included (null rows are equal)."""
    if isinstance(a, StringColumn):
        ids, base = _string_ids(a, b, collisions)
        return ids[ia] == ids[ib + base]
    if isinstance(a, _GATHERED):
        return _rows(_gather(a, ia), b, ib, collisions)
    from ..ops.take import take          # nested values: a device take
    return _rows(take(a, ia), b, ib, collisions)


# ---- offsets layouts --------------------------------------------------------

def _deltas(offs: torch.Tensor, size: int, target: torch.Tensor,
            ix: torch.dtype) -> torch.Tensor:
    """(size + 1,) map from each of an offsets layout's `size` items to
    `target[r] - offs[r]` of its row r, so that item j's partner is
    j + map[j]: the jumps between rows scattered at the row starts and a
    cumsum, as range_gather builds its source index.  Items outside
    every row get a stale value; callers count only items inside rows.
    The jumps wrap in `ix`; the sums come out exact."""
    delta = target - offs[:-1]
    jump = delta.clone()
    jump[1:] -= delta[:-1]
    step = torch.zeros(size + 1, dtype=ix, device=offs.device)
    step.index_add_(0, offs[:-1], jump.to(ix))
    return step.cumsum_(0)


def _segment_any(offs: torch.Tensor, hit: torch.Tensor,
                 ix: torch.dtype) -> torch.Tensor:
    """bool[n]: whether any item of row r (items offs[r]..offs[r+1]) is
    hit, from one cumsum of the hits."""
    sums = torch.zeros(hit.shape[0] + 1, dtype=ix, device=hit.device)
    torch.cumsum(hit, 0, dtype=ix, out=sums[1:])
    return sums[offs[1:]] != sums[offs[:-1]]


def _index_dtype(*sizes: int) -> torch.dtype:
    return torch.int32 if max(sizes) < 2 ** 31 - 1 else torch.int64


def _string_rows(oa, da, va, ob, db, vb, ib) -> torch.Tensor:
    """Row r of the first string layout against row ib[r] (r when None)
    of the second: equal lengths, then equal bytes."""
    oa, ob = oa.to(torch.int64), ob.to(torch.int64)
    la = oa[1:] - oa[:-1]
    sb, eb = (ob[:-1], ob[1:]) if ib is None else (ob[ib], ob[ib + 1])
    eq = la == eb - sb
    if da.numel() and db.numel():
        eq &= ~_byte_mismatch(oa, da, sb, db)
    return _null_rule(va, _at(vb, ib), eq)


def _byte_mismatch(oa, da, sb, db) -> torch.Tensor:
    """bool[n]: whether byte k of row r of `da` (k < its length) differs
    from byte sb[r] + k of `db`.  The bytes go a piece of PIECE at a
    time, so no temporary grows with the column's bytes: each byte's
    partner from the jumps between the two rows' starts scattered at the
    rows that start in the piece and summed (as range_gather builds its
    source index, the sum carried from piece to piece), the bytes
    compared, and the mismatches counted up to each offset in the piece
    (a second carried sum).  The rows outside a piece scatter into up
    to DUMP slots past it, spread so that their adds do not queue on
    one address."""
    size, nb, dev = da.numel(), db.numel(), da.device
    ix = _index_dtype(size, nb)
    width = min(PIECE, size)
    delta = sb - oa[:-1]
    jump = delta.clone()
    jump[1:] -= delta[:-1]
    jump = jump.to(ix)
    del delta
    offs = oa.to(ix)
    starts = offs[:-1]
    n = starts.shape[0]
    dump = min(DUMP, 1 << max(n - 1, 0).bit_length())
    spread = torch.arange(n, dtype=torch.int32,
                          device=dev).bitwise_and_(dump - 1).add_(width)
    before = torch.zeros(oa.shape[0], dtype=ix, device=dev)
    part = torch.zeros((), dtype=ix, device=dev)    # the carried sums
    seen = torch.zeros((), dtype=ix, device=dev)
    for s in range(0, size, PIECE):
        e = min(s + PIECE, size)
        w = e - s
        at = starts - s
        step = torch.zeros(width + dump, dtype=ix, device=dev)
        step.index_add_(0, torch.where((at >= 0) & (at < w), at, spread),
                        jump)
        q = step[:w]
        q[0] += part
        q.cumsum_(0)
        part = q[-1].clone()
        q.add_(torch.arange(s, e, dtype=ix, device=dev)).clamp_(0, nb - 1)
        miss = da[s:e] != db.index_select(0, q)
        del q, step
        count = torch.cumsum(miss, 0, dtype=ix).add_(seen)
        del miss
        seen = count[-1].clone()
        at = offs - s               # an offset in (s, e] reads the count
        here = (at > 0) & (at <= w)     # of the bytes before it
        got = count.index_select(0, at.sub_(1).clamp_(0, w - 1))
        before = torch.where(here, got, before)
        del count, got
    return before[1:] != before[:-1]


def _string_hash(offs: torch.Tensor, data: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    """int64 hash of each string row (null rows share _NULL_KEY): the
    mixed (byte, position) items summed per row, mixed with the length
    (splitmix64's finaliser, as the hash join mixes)."""
    n, size = offs.shape[0] - 1, data.numel()
    if size:
        k = torch.arange(size, device=data.device)
        k += _deltas(offs, size, torch.zeros_like(offs[:-1]),
                     torch.int64)[:size]
        items = mix64(data.to(torch.int64) | ((k + 1) << 8))
        del k
        sums = torch.zeros(size + 1, dtype=torch.int64, device=data.device)
        torch.cumsum(items, 0, out=sums[1:])
        del items
        total = sums[offs[1:]] - sums[offs[:-1]]
    else:
        total = torch.zeros(n, dtype=torch.int64, device=data.device)
    h = mix64(total ^ mix64(offs[1:] - offs[:-1] + _GOLDEN))
    return h if valid is None else torch.where(
        valid, h, torch.full_like(h, _NULL_KEY))


def _string_ids(a: StringColumn, b: StringColumn, collisions
                ) -> Tuple[torch.Tensor, int]:
    """Exact ids of the rows of two string columns joined (a's rows, one
    null row between, b's rows from the returned base): equal ids for
    equal rows.  Rows are sorted by hash and each is checked byte for
    byte against the first of its run; a failed check (two different
    strings, one hash) lands in `collisions`."""
    dev, la = a.device, len(a)
    offs = torch.cat([a.offsets.to(torch.int64),
                      b.offsets.to(torch.int64) + a.data.numel()])
    data = torch.cat([a.data, b.data])
    valid = torch.cat([a.is_valid_mask(),
                       torch.zeros(1, dtype=torch.bool, device=dev),
                       b.is_valid_mask()])
    h = _string_hash(offs, data, valid)
    m = h.shape[0]
    sorted_h, order = torch.sort(h, stable=True)
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = sorted_h[1:] != sorted_h[:-1]
    run = torch.cumsum(start, 0) - 1
    ids = torch.empty(m, dtype=torch.int64, device=dev).scatter_(0, order, run)
    pos = torch.arange(m, device=dev)
    first = torch.full((m,), m, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, run, pos, "amin")
    rep = torch.empty_like(order).scatter_(0, order, order[first[run]])
    same = _string_rows(offs, data, valid, offs, data, valid, rep)
    collisions.append(~same.all())
    return ids, la + 1


def _list_rows(a, b, ib, collisions) -> torch.Tensor:
    """Lists, large lists and maps: equal lengths, then each element of
    a valid row against its partner element in b."""
    oa, ob = a.offsets.to(torch.int64), b.offsets.to(torch.int64)
    ca, cb = (a.entries, b.entries) if isinstance(a, MapColumn) \
        else (a.child, b.child)
    sb, eb = (ob[:-1], ob[1:]) if ib is None else (ob[ib], ob[ib + 1])
    eq = oa[1:] - oa[:-1] == eb - sb
    m, mb = len(ca), len(cb)
    if m and mb:
        part = _deltas(oa, m, sb, torch.int64)[:m]
        part += torch.arange(m, device=part.device)
        el = _rows(ca, cb, part.clamp_(0, mb - 1), collisions)
        eq &= ~_segment_any(oa, ~el, torch.int64)
    return _null_rule(a.validity, _at(b.validity, ib), eq)


def _fixed_list_rows(a, b, ib, collisions) -> torch.Tensor:
    n, k = len(a), a.list_size
    eq = torch.ones(n, dtype=torch.bool, device=a.device)
    if n and k:
        part = None if ib is None else (
            ib[:, None] * k + torch.arange(k, device=a.device)).reshape(-1)
        eq = _rows(a.child, b.child, part, collisions).view(n, k).all(1)
    return _null_rule(a.validity, _at(b.validity, ib), eq)


def _list_view_rows(a, b, ib, collisions) -> torch.Tensor:
    """List views: equal sizes, then the views' elements pairwise.  The
    views may overlap or leave gaps, so the pairs are listed: their
    count is this layout's one more host sync."""
    va, vb = a.validity, _at(b.validity, ib)
    za, oa = a.sizes.to(torch.int64), a.offsets.to(torch.int64)
    zb = _at(b.sizes, ib).to(torch.int64)
    ob = _at(b.offsets, ib).to(torch.int64)
    eq = za == zb
    live = eq if va is None else eq & va
    live = live if vb is None else live & vb
    z = torch.where(live, za, 0)
    ends = torch.cumsum(z, 0)
    total = int(ends[-1])                # the list view's extra sync
    if total:
        starts = ends - z
        row = torch.zeros(total + 1, dtype=torch.int64, device=a.device)
        row.index_add_(0, ends, torch.ones_like(ends))
        row = row[:total].cumsum_(0)
        k = torch.arange(total, device=a.device) - starts[row]
        el = _pairs(a.child, oa[row] + k, b.child, ob[row] + k, collisions)
        bad = torch.zeros(len(a), dtype=torch.int64, device=a.device)
        bad.index_add_(0, row, (~el).to(torch.int64))
        eq &= bad == 0
    return _null_rule(va, vb, eq)


# ---- dictionaries and run-end columns ---------------------------------------

def _dictionary_rows(a, b, ib, collisions) -> torch.Tensor:
    """Decoded rows: a row is null where it or its dictionary entry is."""
    ca = a.codes.to(torch.int64)
    cb = _at(b.codes, ib).to(torch.int64)
    va = _entry_valid(a.validity, a.values, ca)
    vb = _entry_valid(_at(b.validity, ib), b.values, cb)
    if len(a.values) and len(b.values):
        eq = _pairs(a.values, ca.clamp(0, len(a.values) - 1), b.values,
                    cb.clamp(0, len(b.values) - 1), collisions)
    else:                           # an empty dictionary: every row null
        eq = torch.zeros(len(a), dtype=torch.bool, device=a.device)
    return _null_rule(va, vb, eq)


def _entry_valid(top, values: Column, codes: torch.Tensor):
    ev = values.validity
    if ev is None or not len(values):
        return top
    ev = ev[codes.clamp(0, len(values) - 1)]
    return ev if top is None else top & ev


def _runs(c: RunEndColumn, rows: torch.Tensor) -> torch.Tensor:
    return c.row_to_run(rows).to(torch.int64).clamp_(0, c.num_runs - 1)
