"""Hash join: inner, left, semi and anti (counterpart of
arrow_tpu/ops/join.py: join_indices, join and HashJoiner).

Keys: each pair of key columns is encoded into one shared order-key
domain, u64 bits in int64 storage (ops/row_format.py::encode_value_key;
string and dictionary keys through merged host ranks, ops/strings.py).
Several columns fold into one key through the splitmix mixer, and the
pairs are then verified column by column, so a mixer collision never
adds a match (join.py:41-104).

Plans, chosen as the reference chooses them (join.py:425-571):

  index  one key column whose build keys are unique and span at most
         min(2^27, max(2^22, 4 x build rows)) values: a dense table
         slot -> build row made by ONE scatter, with a duplicate check
         (the reference sorts twice to avoid XLA's scatter,
         join.py:170-215), probed by one gather
  merge  everything else: one stable sort of the build and probe keys
         together, (key - kmin, null class, side) packed into one word
         when the combined range is below 2^61 (join.py:218-261), else
         two stable passes (join.py:264-309).  Each probe row's match
         count and run start go back to probe order through the inverse
         permutation, and the pairs expand by repeat_interleave and one
         gather (the reference's sort + cummax expansion, join.py:312-372)

Kernel K1 (kernels/compact.py) does every compaction of the join: the
index plan's inner finish (the matched build rows, and the probe
positions emitted by the kernel: one launch, one count sync), the
semi, anti and left-unmatched row lists (the positions alone), the
merge plans' run starts (positions alone, no sync: they take the place
of the reference's cummax, join.py:245,294) and the collision check of
multi-key joins.

Output: probe order; left joins extend with -1 in place; the matches
of one probe row come in ascending build-row order (the reference
sorts unstably and leaves that order unspecified when build keys
repeat, ROADMAP C).  NULL keys match nothing.  Row ids are int32 in the
reference's plans (join.py:188,236,329-330): a build side, or the
probe side of a merge plan, of more than 2^31 rows raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import (Column, DictionaryColumn, PrimitiveColumn,
                           StringColumn)
from ..core.table import Table
from ..errors import ArrowInvalid
from ..kernels.compact import compact
from ..utils.bits import lsr, mix64
from ..utils.trace import annotate, span as trace_span, to_host
from .row_format import encode_value_key
from .strings import (_dict_slot_validity, dictionary_encode,
                      merged_string_ranks)
from .take import take

__all__ = ["join", "join_indices", "HashJoiner", "combined_keys"]

_HOWS = ("inner", "left", "semi", "anti")
_SIGN = -(1 << 63)                 # int64 bits of 1 << 63
_U64 = (1 << 64) - 1
_MAX_ROWS = 1 << 31
_MIX = dt.storage_int(0x9E3779B97F4A7C15)   # splitmix64 golden ratio


def _fold(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """One u64 key per row from several: exact for one column, a mixed
    hash for more (collisions possible: callers verify)."""
    if len(keys) == 1:
        return keys[0]
    key = torch.zeros_like(keys[0])
    for k in keys:
        key = mix64(key ^ (k + _MIX + (key << 6) + lsr(key, 2)))
    return key


def _device(*tables: Table) -> torch.device:
    """The device of the tables' tensors."""
    for t in tables:
        for c in t.columns:
            return c.device
    return torch.device("cpu")


def _check_rows(n: int, side: str) -> None:
    if n > _MAX_ROWS:
        raise ArrowInvalid(f"join: {n} {side} rows exceed the plans' 2^31 "
                           f"row ids")


# ---- keys --------------------------------------------------------------------

def _ranks_of(ranks: np.ndarray, d: DictionaryColumn) -> torch.Tensor:
    lut = torch.from_numpy(ranks.view(np.int64)).to(d.device)
    return lut[d.codes.to(torch.int64)]


def _co_encode(lcol: Column, rcol: Column):
    """Order keys of one pair of key columns in a shared domain
    (join.py:50-75): primitive keys by the global transform, string and
    dictionary keys by ranks over both sides' merged values."""
    if not any(isinstance(c, (StringColumn, DictionaryColumn))
               for c in (lcol, rcol)):
        lk, lv = encode_value_key(lcol)
        rk, rv = encode_value_key(rcol)
        return lk, lv, rk, rv
    dl, dr = dictionary_encode(lcol), dictionary_encode(rcol)
    if not (isinstance(dl.values, StringColumn)
            and isinstance(dr.values, StringColumn)):
        raise ArrowInvalid("string join keys require string dictionaries")
    lrank, rrank = merged_string_ranks(dl.values, dr.values)
    return (_ranks_of(lrank, dl), _dict_slot_validity(dl),
            _ranks_of(rrank, dr), _dict_slot_validity(dr))


def combined_keys(lcols: Sequence[Column], rcols: Sequence[Column]):
    """(lkey, lvalid, rkey, rvalid, lkeys, rkeys): one u64 key per row
    of each side over all key columns (join.py:78-104), the rows' key
    validity (None: all valid; a null in any key column is null) and
    the per-column keys the collision check compares."""
    lkeys, rkeys = [], []
    lvalid: vd.Mask = None
    rvalid: vd.Mask = None
    for lc, rc in zip(lcols, rcols):
        lk, lv, rk, rv = _co_encode(lc, rc)
        lkeys.append(lk)
        rkeys.append(rk)
        lvalid = vd.union(lvalid, lv)
        rvalid = vd.union(rvalid, rv)
    return _fold(lkeys), lvalid, _fold(rkeys), rvalid, lkeys, rkeys


def _minmax(key: torch.Tensor, valid: vd.Mask):
    """Signed (min, max) of key ^ SIGN over the valid rows: the u64 order
    of the keys; no valid row gives (int64 max, int64 min)."""
    s = key ^ _SIGN
    if valid is None:
        return torch.aminmax(s)
    i64 = torch.iinfo(torch.int64)
    return (torch.where(valid, s, i64.max).amin(),
            torch.where(valid, s, i64.min).amax())


def _to_u64(values: Sequence[torch.Tensor]) -> List[int]:
    """Scalars of the sign-flipped domain as u64 Python ints: one fetch."""
    got = to_host("join.key_range", torch.stack(list(values))).tolist()
    return [(v ^ _SIGN) & _U64 for v in got]


def _key_range_scan(lkey, lvalid, rkey, rvalid) -> List[int]:
    """[combined min, combined max, build min, build max] of the valid
    keys as u64 ints, one host fetch (join.py:155-167); with no valid
    key a min of 2^64 - 1 stands above a max of 0."""
    lo_l, hi_l = _minmax(lkey, lvalid)
    lo_r, hi_r = _minmax(rkey, rvalid)
    return _to_u64([torch.minimum(lo_l, lo_r), torch.maximum(hi_l, hi_r),
                    lo_r, hi_r])


# ---- index plan --------------------------------------------------------------

def _index_fits(span: int, n_r: int) -> bool:
    return 0 < span <= min(1 << 27, max(1 << 22, 4 * n_r))


def _index_build(rkey: torch.Tensor, rvalid: vd.Mask, kmin: int, span: int):
    """(table, dup): table[1 + s] is the build row whose key is kmin + s,
    -1 for none; slots 0 and span + 1 hold -1 for the probe keys below
    and above the range.  dup (a 0-d bool tensor) says two valid build
    rows share a key.  One scatter; a row that another overwrote finds
    that row in its slot."""
    n_r = rkey.shape[0]
    slot = rkey - dt.storage_int(kmin - 1)
    if rvalid is not None:
        slot = torch.where(rvalid, slot, 0)
    rows = torch.arange(n_r, dtype=torch.int32, device=rkey.device)
    table = torch.full((span + 2,), -1, dtype=torch.int32,
                       device=rkey.device)
    table[slot] = rows
    lost = table[slot] != rows
    if rvalid is not None:
        lost &= rvalid
    table[0] = -1
    return table, lost.any()


def _index_probe(lkey: torch.Tensor, lvalid: vd.Mask, table: torch.Tensor,
                 kmin: int) -> torch.Tensor:
    """The build row of each probe row (int32, -1: no match): one clamp
    and one gather (join.py:204-215).  key - (kmin - 1) wraps as int64,
    so a key below the range (by u64 order) lands at or below 0 and one
    above it at or past the last slot."""
    idx = (lkey - dt.storage_int(kmin - 1)).clamp_(0, table.shape[0] - 1)
    if lvalid is not None:
        idx = torch.where(lvalid, idx, 0)
    return table[idx]


def _indices_of_mask(mask: torch.Tensor) -> torch.Tensor:
    """The rows where `mask` holds, ascending, int64: K1 with the
    positions as its only output, one count sync."""
    (pos,), count = compact(mask, (), positions=torch.int64)
    return pos[:int(to_host("join.row_list", count))]


def _semi_anti(matched: torch.Tensor, how: str):
    idx = _indices_of_mask(matched if how == "semi" else ~matched)
    return idx, torch.full_like(idx, -1)


def _finish_index_join(ri32: torch.Tensor, how: str):
    """Join outputs from the index probe; every probe row has at most one
    match (join.py:375-406)."""
    if how == "left":
        li = torch.arange(ri32.shape[0], dtype=torch.int64,
                          device=ri32.device)
        return li, ri32.to(torch.int64)
    matched = ri32 >= 0
    if how == "inner":
        # one K1 launch: the matched build rows and their probe rows'
        # positions; its count is the join's one sync here
        (ri, li), count = compact(matched, (ri32,), positions=torch.int64)
        n = int(to_host("join.index_matches", count))
        return li[:n], ri[:n].to(torch.int64)
    return _semi_anti(matched, how)


# ---- merge plans -------------------------------------------------------------

def _merge_stage(lkey, lvalid, rkey, rvalid, kmin: int, kmax: int):
    """(matches per probe row, sorted position of its run's first row,
    the sorted order of [build rows, probe rows]): one sort of both
    sides' keys (join.py:218-309).  Equal keys form a run: its valid
    build rows first, in ascending row order (the sort is stable), then
    its valid probe rows; null rows sort behind the valid rows of the
    run they fall in, and count for nothing."""
    n_l, n_r = lkey.shape[0], rkey.shape[0]
    dev = lkey.device
    n = n_r + n_l
    valid = torch.cat([vd.make_mask(n_r, rvalid, dev),
                       vd.make_mask(n_l, lvalid, dev)])
    side = torch.arange(n, device=dev) >= n_r
    key = torch.cat([rkey, lkey])
    if kmin <= kmax and kmax - kmin < 1 << 61:
        # packed plan: (key - kmin, null class, side) in one word
        annotate("op.join", plan="packed merge")
        word = (torch.where(valid, key - dt.storage_int(kmin), 0) << 2) \
            | ((~valid).to(torch.int64) << 1) | side.to(torch.int64)
        if (kmax - kmin).bit_length() + 2 <= 31:
            word = word.to(torch.int32)
        word, order = torch.sort(word, stable=True)
        run = word >> 2
        new_run = run[1:] != run[:-1]
        del word, run
    else:
        # general plan: stable passes, (null class, side) then the key
        annotate("op.join", plan="general merge")
        tag = ((~valid).to(torch.uint8) << 1) | side.to(torch.uint8)
        order = torch.sort(tag, stable=True).indices
        skey, o2 = torch.sort((key ^ _SIGN)[order], stable=True)
        order = order[o2]
        new_run = skey[1:] != skey[:-1]
        del tag, skey, o2
    del key, side
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), new_run])
    del new_run
    # K1: the runs' first sorted positions (no sync); run ids by a cumsum
    (starts,), _ = compact(first, (), positions=torch.int64)
    run = torch.cumsum(first, 0) - 1
    del first
    is_build = ((order < n_r) & valid[order]).to(torch.int64)
    builds = torch.cumsum(is_build, 0)                # inclusive
    before = builds - is_build
    # back to probe order: each probe row's sorted position
    at = torch.empty_like(order)
    at[order] = torch.arange(n, device=dev)
    p = at[n_r:]
    start_l = starts[run[p]]
    counts = builds[p] - before[start_l]
    if lvalid is not None:
        counts = torch.where(lvalid, counts, 0)
    return counts, start_l, order


def _expand(counts: torch.Tensor, start: torch.Tensor, order: torch.Tensor):
    """(probe rows, build rows) of every match, probe-ordered: one count
    sync, repeat_interleave and one gather (join.py:312-372)."""
    total = int(to_host("join.match_count", counts.sum()))
    dev = counts.device
    li = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts, output_size=total)
    first = torch.cumsum(counts, 0) - counts
    within = torch.arange(total, device=dev) - first[li]
    return li, order[start[li] + within]


def _no_rows(n_l: int, how: str, device):
    """Outputs when one side has no rows (join.py:434-442)."""
    if n_l and how in ("left", "anti"):
        li = torch.arange(n_l, dtype=torch.int64, device=device)
        return li, torch.full_like(li, -1)
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    return empty, empty


def _check_how(how: str) -> None:
    if how not in _HOWS:
        raise ArrowInvalid(f"unknown join type {how}")


def join_indices(left: Table, right: Table, on: Sequence[str],
                 how: str = "inner",
                 right_on: Optional[Sequence[str]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left row ids, right row ids) of the joined rows as int64 tensors
    on the tables' device; -1 marks the null-extended side of a left
    join.  Host syncs: the key range, the index plan's duplicate check,
    and the output size."""
    _check_how(how)
    right_on = right_on or on
    dev = _device(left, right)
    n_l, n_r = left.num_rows, right.num_rows
    if n_l == 0 or n_r == 0:
        annotate("op.join", plan="empty")
        return _no_rows(n_l, how, dev)
    _check_rows(n_r, "build")
    multi = len(on) > 1
    lkey, lvalid, rkey, rvalid, lkeys, rkeys = combined_keys(
        [left.column(c) for c in on], [right.column(c) for c in right_on])
    kmin, kmax, bmin, bmax = _key_range_scan(lkey, lvalid, rkey, rvalid)
    span = bmax - bmin + 1 if bmin <= bmax else 0
    if not multi and _index_fits(span, n_r):
        table, dup = _index_build(rkey, rvalid, bmin, span)
        if not bool(to_host("join.index_duplicates", dup)):
            annotate("op.join", plan="index")
            return _finish_index_join(
                _index_probe(lkey, lvalid, table, bmin), how)
        del table

    _check_rows(n_l, "probe")
    counts, start, order = _merge_stage(lkey, lvalid, rkey, rvalid,
                                        kmin, kmax)
    if how in ("semi", "anti") and not multi:
        return _semi_anti(counts > 0, how)
    li, ri = _expand(counts, start, order)
    del start, order
    collided = False
    if multi and li.shape[0]:
        # exact per-column compare against mixer collisions
        ok = None
        for lk, rk in zip(lkeys, rkeys):
            eq = lk[li] == rk[ri]
            ok = eq if ok is None else ok & eq
        n_ok = int(to_host("join.collisions", ok.sum()))
        if n_ok != li.shape[0]:
            (li, ri), _ = compact(ok, (li, ri), out_cap=n_ok)
            collided = True
    if how == "inner":
        return li, ri
    if multi and (collided or how != "left"):
        matched = torch.zeros(n_l, dtype=torch.bool, device=dev)
        matched[li] = True
    else:
        matched = counts > 0
    if how in ("semi", "anti"):
        return _semi_anti(matched, how)
    unmatched = _indices_of_mask(~matched)
    li = torch.cat([li, unmatched])
    ri = torch.cat([ri, torch.full_like(unmatched, -1)])
    order = torch.sort(li, stable=True).indices
    return li[order], ri[order]


class HashJoiner:
    """Build once, probe many: the streamed half of the join
    (join.py:574-719).  A single key column that is not a string or a
    dictionary, with unique build keys spanning at most _SPAN_CAP values,
    builds the index plan's table once; any other build side probes each
    chunk through join_indices (the merge plans).  Probe row ids are
    chunk-local."""

    # dense-table span cap: an int32 table of 2^28 slots is 1 GiB
    _SPAN_CAP = 1 << 28

    def __init__(self, right: Table, on: Sequence[str],
                 right_on: Optional[Sequence[str]] = None):
        self.right = right
        self.on = list(on)
        self.right_on = list(right_on or on)
        self._plan = "merge"               # until proven index-able
        self.table = None
        if right.num_rows == 0:
            self._plan = "empty"
            return
        _check_rows(right.num_rows, "build")
        rcols = [right.column(c) for c in self.right_on]
        if len(rcols) > 1 or isinstance(rcols[0],
                                        (StringColumn, DictionaryColumn)):
            return
        rkey, rvalid = encode_value_key(rcols[0])
        lo, hi = _to_u64(_minmax(rkey, rvalid))
        span = hi - lo + 1 if lo <= hi else 0
        if 0 < span <= self._SPAN_CAP:
            table, dup = _index_build(rkey, rvalid, lo, span)
            if not bool(to_host("join.index_duplicates", dup)):
                self.table, self.kmin, self._plan = table, lo, "index"

    def _probe(self, left: Table) -> torch.Tensor:
        key, valid = encode_value_key(left.column(self.on[0]))
        return _index_probe(key, valid, self.table, self.kmin)

    def probe_indices(self, left: Table, how: str = "inner"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(left row ids, right row ids) for one probe chunk."""
        _check_how(how)
        if self._plan == "empty" or left.num_rows == 0:
            return _no_rows(left.num_rows, how, _device(left, self.right))
        if self._plan == "merge":
            return join_indices(left, self.right, self.on, how,
                                self.right_on)
        return _finish_index_join(self._probe(left), how)

    def probe_count_device(self, left: Table
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(matched pairs, sum of the matched build row ids) as 0-d int64
        tensors on the device, without a host sync on the index plan: a
        streamed caller accumulates them and fetches once."""
        if self._plan != "index" or left.num_rows == 0:
            li, ri = self.probe_indices(left, "inner")
            return (torch.tensor(li.shape[0], dtype=torch.int64,
                                 device=li.device), ri.sum())
        ri = self._probe(left)
        return (ri >= 0).sum(), ri.clamp(min=0).sum(dtype=torch.int64)

    def probe_count(self, left: Table) -> Tuple[int, int]:
        """(matched pairs, checksum of the matched build row ids), with no
        pair materialised on the index plan; one host fetch."""
        cnt, chk = to_host("join.probe_count", torch.stack(
            list(self.probe_count_device(left)))).tolist()
        return cnt, chk


def join(left: Table, right: Table, on: Sequence[str], how: str = "inner",
         right_on: Optional[Sequence[str]] = None,
         suffix: str = "_right") -> Table:
    """Join two tables (join.py:722-746): the left columns, then the right
    columns that are not keys (nullable; a clashing name takes
    `suffix`).  Semi and anti joins return the left columns only."""
    with trace_span("op.join"):
        return _join(left, right, on, how, right_on, suffix)


def _join(left, right, on, how, right_on, suffix) -> Table:
    right_on_l = list(right_on or on)
    li, ri = join_indices(left, right, on, how, right_on)
    cols: List[Column] = [take(c, li) for c in left.columns]
    fields = list(left.schema.fields)
    if how in ("semi", "anti"):
        return Table(tuple(cols), dt.Schema(tuple(fields)), _validated=True)
    null_ext = ri < 0
    any_null = how == "left" and bool(to_host("join.left_nulls",
                                              null_ext.any()))
    r_idx = PrimitiveColumn(torch.where(null_ext, 0, ri), dt.int64,
                            ~null_ext if any_null else None)
    taken = set(left.schema.names)
    for f, c in zip(right.schema.fields, right.columns):
        if f.name in right_on_l:
            continue
        name = f.name if f.name not in taken else f.name + suffix
        cols.append(take(c, r_idx))
        fields.append(dt.Field(name, f.dtype, nullable=True))
    return Table(tuple(cols), dt.Schema(tuple(fields)), _validated=True)
