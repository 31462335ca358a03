"""Table versions: writes that touch only what a statement changes.

A `TableVersion` is one state of a table: its columns over buffers with
spare capacity, its row count, and an optional live mask (False at the
rows a DELETE removed).  Versions of one table share their buffers.  A
write makes a new version and leaves the old one as it was:

- an append writes the new rows into the buffers' tails, past the
  newest version's rows; a reader of an older version never reads past
  its own row count.  Where a buffer is full it grows to at least twice
  its size, as arrow-rs `MutableBuffer::reserve` does
  (arrow-buffer/src/buffer/mutable.rs), copying the rows it holds (a
  table registered from a plain `Table` has no spare room, so its first
  append grows it);
- a delete publishes a new live mask, as Delta Lake's and Iceberg v2's
  delete vectors do; no column is rewritten, and the deleted rows stay
  in the buffers (no compaction);
- a statement that makes a table anew (CREATE TABLE, UPDATE) gives a
  version over its own columns.

Strings append their offsets and bytes, a dictionary column its codes,
mapping the new rows' dictionary onto the table's (words it lacks are
appended to the dictionary, which grows like any buffer).  Other
layouts (nested, decimal128, ...) concatenate on append: a copy.

A version's rows are `table` (every row written, deleted ones too) and
`live`; `visible()` filters them.  `sql.execute_sql` reads a version
directly: the live mask is one more conjunct of the table's filter.

Only one writer may derive versions from a table at a time (the buffers'
tails are shared): the Flight SQL server holds a write lock per table
(io/flightsql.py).  Recorded (utils/trace.py), each write is a
`table.write` span (`table`, `rows_added`, `rows_deleted`, `bytes`: the
bytes written into the buffers plus those the version allocates); the
counters `tables.versions`, `tables.bytes_written` and `tables.regrows`
add them up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import dtypes as dt
from .core.column import (Column, DictionaryColumn, NullColumn,
                          PrimitiveColumn, StringColumn)
from .core.table import Table
from .errors import ArrowInvalid
from .utils.trace import count, span, to_host

__all__ = ["Delta", "TableVersion", "GROWTH"]

GROWTH = 2           # a full buffer grows to at least this many times its size


@dataclass(frozen=True)
class Delta:
    """What one statement changes in one table (sql.execute_sql_update):
    rows to `append` after the table's rows; `delete`, a bool tensor over
    the table's rows as the statement read them (True: deleted), with
    `deleted` such rows (counted on the host); or the whole `table` anew
    (`derived`: made by CREATE TABLE ... AS from the statement's
    snapshot); or `drop`."""
    append: Optional[Table] = None
    delete: Optional[torch.Tensor] = None
    deleted: int = 0
    table: Optional[Table] = None
    derived: bool = False
    drop: bool = False


def _reserve(buf: torch.Tensor, used: int, need: int
             ) -> Tuple[torch.Tensor, int]:
    """`buf` when it holds `need` elements, else a buffer of at least
    GROWTH times its size holding its first `used`; the bytes
    allocated."""
    if need <= buf.shape[0]:
        return buf, 0
    out = torch.empty(max(need, GROWTH * buf.shape[0]), dtype=buf.dtype,
                      device=buf.device)
    out[:used].copy_(buf[:used])
    return out, out.numel() * out.element_size()


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _column_bytes(col) -> int:
    """The bytes of every tensor a column holds, its children's too."""
    n = 0
    for v in vars(col).values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(x, torch.Tensor):
                n += _nbytes(x)
            elif isinstance(x, Column):
                n += _column_bytes(x)
    return n


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host: a `readback` where it is on a
    card."""
    return (t if t.device.type == "cpu" else
            to_host("table.write", t)).contiguous().numpy()


def _bounds(col: StringColumn) -> Tuple[int, int]:
    """A string column's first and last offsets."""
    return tuple(_host(col.offsets[[0, -1]]).tolist()) if len(col) \
        else (0, 0)


def _raw(col: Column) -> Optional[tuple]:
    """A dictionary's values as host arrays, to compare without decoding:
    (rows, offsets from 0 or None, bytes or values, validity or None);
    None for a layout the dictionary append does not map."""
    valid = None if col.validity is None else _host(col.validity)
    if isinstance(col, StringColumn):
        offs = _host(col.offsets).astype(np.int64)
        data = _host(col.data)[offs[0]:offs[-1]] if len(col) else \
            np.zeros(0, np.uint8)
        return len(col), offs - offs[0], data, valid
    if isinstance(col, PrimitiveColumn) and not col.dtype.is_temporal:
        return len(col), None, _host(col.values), valid
    return None


def _prefix(new: tuple, have: tuple) -> bool:
    """Whether the values `new` are the first values of `have`, in order,
    bit for bit (`_raw` forms)."""
    n, offs, data, valid = new
    if n > have[0] or (offs is not None and not np.array_equal(
            offs, have[1][:n + 1])):
        return False
    if not np.array_equal(data, have[2][:len(data)]):
        return False
    ok = np.ones(n, bool) if valid is None else valid[:n]
    mine = np.ones(n, bool) if have[3] is None else have[3][:n]
    return bool(np.array_equal(ok, mine))


def _words(col: Column) -> list:
    """A dictionary's values as Python values (a layout `_raw` reads)."""
    ok = None if col.validity is None else _host(col.validity).tolist()
    if isinstance(col, StringColumn):
        offs, data = _host(col.offsets).tolist(), _host(col.data).tobytes()
        text = col.dtype.is_string
        return [None if ok is not None and not ok[i]
                else data[offs[i]:offs[i + 1]].decode() if text
                else data[offs[i]:offs[i + 1]] for i in range(len(col))]
    return [None if ok is not None and not ok[i] else v
            for i, v in enumerate(_host(col.values).tolist())]


class _Write:
    """What one append cost: bytes written into buffers, bytes of the
    buffers it allocated, buffers that grew."""

    def __init__(self):
        self.written = self.allocated = self.regrows = 0

    def grew(self, allocated: int) -> None:
        if allocated:
            self.allocated += allocated
            self.regrows += 1

    @staticmethod
    def put(dst: torch.Tensor, src: torch.Tensor) -> None:
        """dst[:] = src; host rows go into a card's buffer from pinned
        memory, queued on the stream, so the host does not wait for the
        card's earlier work (a copy from pageable memory does)."""
        if src.device.type == "cpu" and dst.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=src.is_pinned())


class _Validity:
    """A growable validity mask (None while every row is valid)."""

    @staticmethod
    def append(buf, n: int, new: Optional[torch.Tensor], k: int,
               w: _Write, device) -> Optional[torch.Tensor]:
        if buf is None and new is None:
            return None
        if buf is None:
            buf = torch.ones(max(n + k, GROWTH * n), dtype=torch.bool,
                             device=device)
            w.grew(buf.numel())
        else:
            buf, a = _reserve(buf, n, n + k)
            w.grew(a)
        if new is None:
            buf[n:n + k] = True
        else:
            w.put(buf[n:n + k], new)
            w.written += k
        return buf


class _State:
    """One column of one version: `view()` its rows, `append(col, w)` the
    state of the next version, `capacity` the rows it can hold."""
    rows: int
    capacity: int

    def view(self) -> Column:
        raise NotImplementedError

    def append(self, col: Column, w: _Write) -> "_State":
        raise NotImplementedError


class _Wrapped(_State):
    """A column as it was registered: no spare room, read as itself.  Its
    first append turns it into a growable state (a growth)."""

    def __init__(self, col: Column):
        self.col, self.rows, self.capacity = col, len(col), len(col)

    def view(self) -> Column:
        return self.col

    def append(self, col: Column, w: _Write) -> _State:
        return _growable(self.col, w).append(col, w)


def _growable(col: Column, w: _Write) -> _State:
    """A growable state over a plain column's rows (they are copied when
    the first append finds no room)."""
    if isinstance(col, PrimitiveColumn):
        return _Primitive(col.dtype, col.values, col.validity, len(col))
    if isinstance(col, StringColumn):
        lo, hi = _bounds(col)
        offs, data = col.offsets, col.data[lo:hi]
        if lo:
            offs = offs - lo
            w.grew(_nbytes(offs))
        return _String(col.dtype, offs, data, col.validity, len(col),
                       hi - lo)
    if isinstance(col, DictionaryColumn):
        return _Dictionary.over(col)
    if isinstance(col, NullColumn):
        return _Null(len(col), col.device)
    return _Concat(col)


class _Primitive(_State):
    def __init__(self, dtype, values, validity, rows):
        self.dtype, self.values, self.validity = dtype, values, validity
        self.rows, self.capacity = rows, values.shape[0]
        self._view = None

    def view(self) -> Column:
        if self._view is None:
            n = self.rows
            self._view = PrimitiveColumn(
                self.values[:n], self.dtype,
                None if self.validity is None else self.validity[:n],
                _canonical=True)
        return self._view

    def append(self, col: Column, w: _Write) -> _State:
        n, k = self.rows, len(col)
        values, a = _reserve(self.values, n, n + k)
        w.grew(a)
        w.put(values[n:n + k], col.values)
        w.written += _nbytes(col.values)
        validity = _Validity.append(self.validity, n, col.validity, k, w,
                                    values.device)
        return _Primitive(self.dtype, values, validity, n + k)


class _String(_State):
    """Offsets (rows + 1, absolute into `data`) and bytes, each with its
    own spare room; `nbytes` the bytes this version's rows use."""

    def __init__(self, dtype, offsets, data, validity, rows, nbytes):
        self.dtype, self.offsets, self.data = dtype, offsets, data
        self.validity, self.rows, self.nbytes = validity, rows, nbytes
        self.capacity = offsets.shape[0] - 1
        self._view = None

    def view(self) -> Column:
        if self._view is None:
            n = self.rows
            self._view = StringColumn(
                self.offsets[:n + 1], self.data[:self.nbytes], self.dtype,
                None if self.validity is None else self.validity[:n])
        return self._view

    def append(self, col: Column, w: _Write) -> _State:
        n, k = self.rows, len(col)
        lo, hi = _bounds(col)
        nb = self.nbytes + hi - lo
        if self.offsets.dtype == torch.int32 and \
                nb > torch.iinfo(torch.int32).max:
            raise ArrowInvalid(f"{nb} bytes overflow int32 offsets of "
                               f"{self.dtype!r}: use a large string type")
        data, a = _reserve(self.data, self.nbytes, nb)
        w.grew(a)
        w.put(data[self.nbytes:nb], col.data[lo:hi])
        offsets, a = _reserve(self.offsets, n + 1, n + 1 + k)
        w.grew(a)
        w.put(offsets[n + 1:n + 1 + k], (col.offsets[1:].to(torch.int64)
                                        + (self.nbytes - lo))
             .to(offsets.dtype))
        w.written += hi - lo + k * offsets.element_size()
        validity = _Validity.append(self.validity, n, col.validity, k, w,
                                    data.device)
        return _String(self.dtype, offsets, data, validity, n + k, nb)


class _Dictionary(_State):
    """Codes and validity growable, the dictionary a state of its own.
    New rows over another dictionary are mapped onto this one: each of
    their words to its first slot here, words it lacks appended.  The
    ordered flag is dropped then, as concatenating two dictionaries
    drops it (ops/concat.py)."""

    def __init__(self, codes: _Primitive, values: _State, ordered: bool,
                 words: Optional[list] = None, raw: Optional[tuple] = None):
        self.codes, self.values_state = codes, values
        self.ordered, self._words, self._raw = ordered, words, raw
        self.rows, self.capacity = codes.rows, codes.capacity
        self._view = None

    @classmethod
    def over(cls, col: DictionaryColumn) -> "_Dictionary":
        index = dt.from_numpy_dtype(dt.torch_dtype_name(col.codes.dtype))
        return cls(_Primitive(index, col.codes, col.validity, len(col)),
                   _Wrapped(col.values), col.ordered)

    def view(self) -> Column:
        if self._view is None:
            c = self.codes.view()
            self._view = DictionaryColumn(c.values, self.values_state.view(),
                                          c.validity, _canonical=True,
                                          ordered=self.ordered)
        return self._view

    def append(self, col: Column, w: _Write) -> _State:
        mine = self.view()
        index = self.codes.dtype
        if col.values is mine.values:       # the same dictionary object
            codes = self.codes.append(PrimitiveColumn(
                col.codes, index, col.validity, _canonical=True), w)
            return _Dictionary(codes, self.values_state, self.ordered,
                               self._words, self._raw)
        if self._raw is None:
            self._raw = _raw(mine.values)
        new_raw = _raw(col.values)
        if self._raw is None or new_raw is None:
            return _Concat(mine).append(col, w)
        if _prefix(new_raw, self._raw):  # the same words first: codes as sent
            codes = self.codes.append(PrimitiveColumn(
                col.codes.to(self.codes.values.dtype), index, col.validity,
                _canonical=True), w)
            return _Dictionary(codes, self.values_state, False, self._words,
                               self._raw)
        if self._words is None:
            self._words = _words(self.values_state.view())
        have = self._words
        slot: Dict[object, int] = {}
        for i, v in enumerate(have):
            slot.setdefault(v, i)
        words, remap = list(have), []
        for v in _words(col.values):
            if v not in slot:
                slot[v] = len(words)
                words.append(v)
            remap.append(slot[v])
        if len(words) - 1 > dt.integer_bounds(index)[1]:
            raise ArrowInvalid(f"dictionary key space overflow: {len(words)}"
                               f" values exceed {index!r}")
        values = self.values_state
        if len(words) > len(have):
            from .core.column import column as make_col
            values = values.append(make_col(
                words[len(have):], mine.values.dtype, device=col.device), w)
        if remap:
            table = torch.tensor(remap, dtype=torch.int64)
            if col.device.type != "cpu":
                from .io.hostio import to_device
                table = to_device(table, col.device)
            mapped = table[col.codes.to(torch.int64).clamp(0,
                                                          len(remap) - 1)]
            if col.validity is not None:
                mapped = torch.where(col.validity, mapped, 0)
        else:
            mapped = torch.zeros(len(col), dtype=torch.int64,
                                 device=col.device)
        codes = self.codes.append(PrimitiveColumn(
            mapped.to(self.codes.values.dtype), index, col.validity,
            _canonical=True), w)
        return _Dictionary(codes, values, False, words)


class _Null(_State):
    def __init__(self, rows, device):
        self.rows = self.capacity = rows
        self.device = device

    def view(self) -> Column:
        return NullColumn(self.rows, self.device)

    def append(self, col: Column, w: _Write) -> _State:
        return _Null(self.rows + len(col), self.device)


class _Concat(_State):
    """A layout without a growable state: an append concatenates (a copy
    of the rows; counted as a growth)."""

    def __init__(self, col: Column):
        self.col, self.rows, self.capacity = col, len(col), len(col)

    def view(self) -> Column:
        return self.col

    def append(self, col: Column, w: _Write) -> _State:
        from .io.hostio import to_device
        from .ops.concat import concat
        out = concat([self.col, to_device(col, self.col.device)])
        w.grew(_column_bytes(out))
        return _Concat(out)


class TableVersion:
    """One state of a table (see the module's docstring).  `table`: every
    row written, as views of the buffers; `live`: None, or a bool tensor
    over those rows, False where deleted; `deleted`: the rows it
    removes, counted on the host; `derived`: the commit number of the
    snapshot a CREATE TABLE ... AS read to make it, else None."""

    def __init__(self, schema: dt.Schema, states: List[_State], rows: int,
                 live_buf: Optional[torch.Tensor] = None, deleted: int = 0,
                 derived: Optional[int] = None,
                 table: Optional[Table] = None):
        self.schema, self._states, self.rows = schema, states, rows
        self._live_buf, self.deleted, self.derived = live_buf, deleted, \
            derived
        self._table = table

    @classmethod
    def of(cls, table: Table, derived: Optional[int] = None
           ) -> "TableVersion":
        """A version over a table's own columns: nothing copied."""
        return cls(table.schema, [_Wrapped(c) for c in table.columns],
                   table.num_rows, derived=derived, table=table)

    @property
    def table(self) -> Table:
        if self._table is None:
            self._table = Table(tuple(s.view() for s in self._states),
                                self.schema, _validated=True)
        return self._table

    @property
    def live(self) -> Optional[torch.Tensor]:
        return None if self._live_buf is None or not self.deleted \
            else self._live_buf[:self.rows]

    @property
    def num_rows(self) -> int:
        """The rows a reader sees."""
        return self.rows - self.deleted

    @property
    def column_names(self) -> List[str]:
        return [f.name for f in self.schema.fields]

    def visible(self) -> Table:
        """The rows a reader sees, as a plain table (a filter when rows
        were deleted)."""
        live = self.live
        if live is None:
            return self.table
        from .ops.filter import filter_table
        return filter_table(self.table, PrimitiveColumn(
            live, dt.bool_, _canonical=True))

    def _capacity(self) -> int:
        return max([self.rows] + [s.capacity for s in self._states])

    def apply(self, delta: Delta, name: str = "") -> "TableVersion":
        """The version after `delta` (not a drop); this one is left as it
        was."""
        w = _Write()
        added = delta.table.num_rows if delta.table is not None else \
            0 if delta.append is None else delta.append.num_rows
        with span("table.write", table=name, rows_added=added,
                  rows_deleted=delta.deleted) as s:
            if delta.table is not None:
                out = TableVersion.of(delta.table)
            elif delta.append is not None:
                out = self._append(delta.append, w)
            elif delta.delete is not None:
                out = self._delete(delta.delete, delta.deleted, w)
            else:
                out = self
            nbytes = w.written + w.allocated
            if s is not None:
                s.attrs["bytes"] = nbytes
        count("tables.versions")
        count("tables.bytes_written", nbytes)
        count("tables.regrows", w.regrows)
        return out

    def _append(self, add: Table, w: _Write) -> "TableVersion":
        if add.schema.names != self.schema.names or any(
                a.dtype != b.dtype for a, b in zip(add.schema.fields,
                                                   self.schema.fields)):
            raise ArrowInvalid("appended rows do not match the table's "
                               "schema")
        k = add.num_rows
        if not k:
            return self
        states = [s.append(c, w) for s, c in zip(self._states, add.columns)]
        live = self._live_buf
        if live is not None:
            live, a = _reserve(live, self.rows, self.rows + k)
            w.grew(a)
            live[self.rows:self.rows + k] = True
        return TableVersion(self.schema, states, self.rows + k, live,
                            self.deleted, self.derived)

    def _delete(self, delete: torch.Tensor, deleted: int,
                w: _Write) -> "TableVersion":
        if not deleted:
            return self
        m = delete.shape[0]
        if m > self.rows:
            raise ArrowInvalid(f"a delete over {m} rows of a version of "
                               f"{self.rows}")
        live = torch.empty(self._capacity(), dtype=torch.bool,
                           device=delete.device)
        w.grew(live.numel())
        if self.live is None:
            live[:self.rows] = True
        else:
            live[:self.rows] = self.live
        live[:m] &= ~delete
        return TableVersion(self.schema, self._states, self.rows, live,
                            self.deleted + deleted, self.derived,
                            self._table)
