"""CSV read/write — native typed parser (the arrow-csv role;
counterpart of arrow_tpu/io/csv.py).

Round-2 native rewrite: the indexing pass (RFC 4180 quotes) and every
typed field parser run in C (native/hostcodec.cpp csv_* functions) —
re-designing the reference's own typed parser rather than delegating to
Arrow C++:

  ReaderBuilder + schema inference   arrow-csv/src/reader/mod.rs:309,410
  push Decoder                       reader/mod.rs:555
  WriterBuilder                      arrow-csv/src/writer.rs:191

Inference probes each column with the typed parsers in the reference's
order (bool -> int64 -> float64 -> date32 -> timestamp -> utf8); a
column is a type iff every non-empty sampled field parses.

Parsing is host work on numpy buffers, one column per task of the file
layer's pool (`hostio.pool_map`); the reading thread places each
column's buffers on the caller's `device` once (`hostio.tensor`).  The
writer takes its host view of the table once (`hostio.to_host`).
Offsets take the string type's width: int64 under large_utf8 and
large_binary (the reference writes int32 there, ROADMAP C14).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import Column, PrimitiveColumn, StringColumn, offset_dtype
from ..core.table import Table
from ..errors import ArrowInvalid
from ..utils import hostcodec as nt
from . import hostio

__all__ = ["ReaderBuilder", "Decoder", "WriterBuilder", "read_csv",
           "write_csv", "infer_schema"]

_UNIT_SCALE = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}


def _as_bytes(source) -> bytes:
    if isinstance(source, bytes):
        return source
    if isinstance(source, str):
        if "\n" in source or "," in source and not _looks_path(source):
            return source.encode("utf-8")
        with open(source, "rb") as f:
            return f.read()
    if hasattr(source, "read"):
        data = source.read()
        return data.encode("utf-8") if isinstance(data, str) else data
    raise ArrowInvalid(f"cannot read CSV from {type(source)}")


def _looks_path(s: str) -> bool:
    import os
    return os.path.exists(s)


class _Indexed:
    """Field bounds for a CSV byte buffer."""

    def __init__(self, data: bytes, delimiter: str = ",",
                 quote: str = '"'):
        lib = nt.csv_lib()
        self.data = np.frombuffer(data, np.uint8)
        # exact-or-over field count: delimiters + newlines (+2 slack);
        # quoted delimiters only over-count, never under.  One SWAR C
        # pass (the old numpy compare+sum pair cost 2 full-buffer temps;
        # the older len/2 cap over-allocated ~5x and its first-touch
        # page faults dominated small parses).
        cap = max(int(lib.csv_count_seps(nt._u8(self.data),
                                         len(self.data),
                                         ord(delimiter))) + 2, 64)
        while True:
            starts = np.empty(cap, np.int64)
            ends = np.empty(cap, np.int64)
            escaped = np.empty(cap, np.uint8)
            nrows = np.zeros(1, np.int64)
            ncols = np.zeros(1, np.int64)
            nf = lib.csv_index(
                nt._u8(self.data), len(self.data),
                ord(delimiter), ord(quote),
                nt._i64p(starts), nt._i64p(ends), nt._u8(escaped), cap,
                nt._i64p(nrows), nt._i64p(ncols))
            if nf == -1:
                cap *= 2
                continue
            if nf == -2:
                raise ArrowInvalid(
                    "ragged CSV: rows have differing field counts")
            break
        self.n_fields = int(nf)
        self.n_rows = int(nrows[0])
        self.n_cols = int(ncols[0])
        self.starts = starts[:self.n_fields]
        self.ends = ends[:self.n_fields]
        self.escaped = escaped[:self.n_fields]

    def column_bounds(self, col: int, row0: int, nrows: int):
        # fields are laid out row-major: a strided view + one memcpy
        # beats a fancy-index gather (no 8B/row index array)
        lo = row0 * self.n_cols + col
        hi = (row0 + nrows) * self.n_cols
        return (np.ascontiguousarray(self.starts[lo:hi:self.n_cols]),
                np.ascontiguousarray(self.ends[lo:hi:self.n_cols]),
                np.ascontiguousarray(self.escaped[lo:hi:self.n_cols]))


def _try_parse(kind: str, data: np.ndarray, starts, ends,
               unit: str = "us"):
    """-> (values, valid) or None when some field fails to parse."""
    lib = nt.csv_lib()
    n = len(starts)
    valid = np.zeros(n, np.uint8)
    if kind == "int64":
        out = np.zeros(n, np.int64)
        bad = lib.csv_parse_i64(nt._u8(data), nt._i64p(starts),
                                nt._i64p(ends), n, nt._i64p(out),
                                nt._u8(valid))
    elif kind == "float64":
        out = np.zeros(n, np.float64)
        bad = lib.csv_parse_f64(nt._u8(data), nt._i64p(starts),
                                nt._i64p(ends), n, nt._f64p(out),
                                nt._u8(valid))
    elif kind == "bool":
        out = np.zeros(n, np.uint8)
        bad = lib.csv_parse_bool(nt._u8(data), nt._i64p(starts),
                                 nt._i64p(ends), n, nt._u8(out),
                                 nt._u8(valid))
        out = out.astype(np.bool_)
    elif kind in ("date32", "timestamp"):
        out = np.zeros(n, np.int64)
        scale = 86_400 * 1_000_000_000 if kind == "date32" \
            else _UNIT_SCALE[unit]
        bad = lib.csv_parse_timestamp(
            nt._u8(data), nt._i64p(starts), nt._i64p(ends), n, scale,
            1 if kind == "date32" else 0, nt._i64p(out), nt._u8(valid))
        if kind == "date32":
            out = out.astype(np.int32)
    else:
        raise ArrowInvalid(kind)
    if bad >= 0:
        return None
    return out, valid.astype(bool)


def _parse_column(idx: _Indexed, col: int, row0: int, nrows: int,
                  d: dt.DataType) -> tuple:
    """One column's host buffers (any thread): ("str", offsets, bytes)
    or ("prim", values, valid-or-None)."""
    starts, ends, escaped = idx.column_bounds(col, row0, nrows)
    name = d.name
    if name in ("utf8", "large_utf8", "binary", "large_binary"):
        lib = nt.csv_lib()
        offs = np.zeros(nrows + 1, np.int64)
        cap = int((ends - starts).sum()) + 1
        out = np.zeros(cap, np.uint8)
        lib.csv_extract(nt._u8(idx.data), nt._i64p(starts),
                        nt._i64p(ends), nt._u8(escaped), nrows,
                        ord('"'), nt._i64p(offs), nt._u8(out))
        # empty fields are empty strings, not null (reference behavior)
        return "str", offs, out[:int(offs[-1])]
    kind = {"bool": "bool", "int64": "int64", "int32": "int64",
            "int16": "int64", "int8": "int64", "uint8": "int64",
            "uint16": "int64", "uint32": "int64", "uint64": "int64",
            "float64": "float64", "float32": "float64",
            "date32": "date32", "timestamp": "timestamp"}.get(name)
    if kind is None:
        raise ArrowInvalid(f"CSV parse into {d!r} unsupported")
    r = _try_parse(kind, idx.data, starts, ends,
                   d.unit if name == "timestamp" else "us")
    if r is None:
        raise ArrowInvalid(f"column {col}: unparseable as {d!r}")
    vals, valid = r
    vals = vals.astype(d.to_numpy(), copy=False)
    return "prim", vals, None if valid.all() else valid


def _place(part: tuple, d: dt.DataType, dev: torch.device) -> Column:
    """A parsed column's buffers on `dev` (the reading thread)."""
    kind, a, b = part
    if kind == "str":
        offs = a.astype(dt.torch_dtype_name(offset_dtype(d)))
        return StringColumn(hostio.tensor(offs, dev), hostio.tensor(b, dev),
                            d)
    vals = a.view(dt.torch_dtype_name(d.to_torch()))
    mask = None if b is None else hostio.tensor(b, dev)
    return PrimitiveColumn(hostio.tensor(vals, dev), d, mask,
                           _canonical=mask is None)


_INFER_ORDER = ("bool", "int64", "float64", "date32", "timestamp")
_INFER_DT = {"bool": dt.bool_, "int64": dt.int64, "float64": dt.float64,
             "date32": dt.date32, "timestamp": dt.timestamp("us")}


def _infer_column(idx: _Indexed, col: int, row0: int, nrows: int,
                  sample: int) -> dt.DataType:
    m = min(nrows, sample)
    starts, ends, _ = idx.column_bounds(col, row0, m)
    nonempty = starts < ends
    if not nonempty.any():
        return dt.utf8
    for kind in _INFER_ORDER:
        if _try_parse(kind, idx.data, starts, ends) is not None:
            return _INFER_DT[kind]
    return dt.utf8


def _header_names(idx: _Indexed) -> List[str]:
    data = idx.data.tobytes()
    names = []
    for c in range(idx.n_cols):
        i = c    # row 0, column c
        s, e = int(idx.starts[i]), int(idx.ends[i])
        text = data[s:e].decode("utf-8")
        if idx.escaped[i]:
            text = text.replace('""', '"')
        names.append(text)
    return names


def infer_schema(source, max_records: Optional[int] = 1000,
                 has_header: bool = True, delimiter: str = ",") \
        -> dt.Schema:
    """Schema inference (reader/mod.rs:410 infer_schema)."""
    idx = _Indexed(_as_bytes(source), delimiter)
    row0 = 1 if has_header else 0
    nrows = idx.n_rows - row0
    names = _header_names(idx) if has_header else \
        [f"column_{i + 1}" for i in range(idx.n_cols)]
    sample = max_records if max_records is not None else nrows
    return dt.Schema(tuple(
        dt.Field(names[c], _infer_column(idx, c, row0, nrows, sample))
        for c in range(idx.n_cols)))


def read_csv(source, schema: Optional[dt.Schema] = None,
             has_header: bool = True, delimiter: str = ",",
             projection=None, *, device: DeviceLike) -> Table:
    """A CSV file, text or bytes as a Table on `device`.  `projection`
    (reader/mod.rs with_projection): names or column indices to parse —
    unselected columns are never typed/parsed."""
    dev = resolve_device(device)
    nt.csv_lib()          # loaded here, before the pool's threads start
    data = _as_bytes(source)
    idx = _Indexed(data, delimiter)
    row0 = 1 if has_header else 0
    nrows = idx.n_rows - row0
    if has_header:
        names = _header_names(idx)
    else:
        names = [f"column_{i + 1}" for i in range(idx.n_cols)]
    sel = range(idx.n_cols)
    if projection is not None:
        sel = [names.index(p) if isinstance(p, str) else int(p)
               for p in projection]
    if schema is None:
        fields = [dt.Field(names[c],
                           _infer_column(idx, c, row0, nrows, 1000))
                  for c in sel]
    else:
        by_name = {f.name: f for f in schema.fields}
        fields = [by_name.get(names[c], dt.Field(names[c], dt.utf8))
                  for c in sel]
    # typed parsers are C calls that release the interpreter lock: one
    # task per column on the file layer's pool, numpy out
    parts = hostio.pool_map(
        lambda cf: _parse_column(idx, cf[0], row0, nrows, cf[1].dtype),
        list(zip(sel, fields)))
    cols = tuple(_place(p, f.dtype, dev) for p, f in zip(parts, fields))
    return Table(cols, dt.Schema(tuple(fields)))


@dataclass
class ReaderBuilder:
    """Builder-pattern reader (reader/mod.rs:309); batches on `device`."""
    device: DeviceLike = None
    schema: Optional[dt.Schema] = None
    has_header: bool = True
    delimiter: str = ","
    batch_size: int = 65536
    projection: Optional[Sequence] = None    # names or indices

    def build(self, source) -> List[Table]:
        t = read_csv(source, self.schema, self.has_header,
                     self.delimiter, self.projection, device=self.device)
        return [t.slice(i, min(self.batch_size, t.num_rows - i))
                for i in range(0, max(t.num_rows, 1), self.batch_size)
                if t.num_rows]

    def build_decoder(self) -> "Decoder":
        return Decoder(self)


class Decoder:
    """Push-based CSV decoder (reader/mod.rs:555): feed byte chunks,
    flush() parses all completed lines."""

    def __init__(self, builder: ReaderBuilder):
        self._b = builder
        self._buf = bytearray()
        self._header: Optional[bytes] = None

    def decode(self, data: bytes) -> None:
        self._buf.extend(data)

    def flush(self) -> Optional[Table]:
        nl = self._buf.rfind(b"\n")
        if nl < 0:
            return None
        complete = bytes(self._buf[:nl + 1])
        del self._buf[:nl + 1]
        if self._b.has_header:
            if self._header is None:
                head_end = complete.find(b"\n")
                self._header = complete[:head_end + 1]
                complete = complete[head_end + 1:]
                if not complete:
                    return None
            complete = self._header + complete
        return read_csv(complete, self._b.schema, self._b.has_header,
                        self._b.delimiter, device=self._b.device)


@dataclass
class WriterBuilder:
    """CSV writer (writer.rs:191) — vectorized host formatting: numpy
    U-dtype astype for numerics (same text as ryu/itoa shortest forms),
    vectorized RFC 4180 quoting, one np.char.add row join."""
    include_header: bool = True
    delimiter: str = ","

    def write(self, sink, table: Table) -> None:
        table = hostio.to_host(table)
        own = isinstance(sink, str)
        out = open(sink, "wb") if own else sink
        try:
            if self.include_header:
                out.write((self.delimiter.join(
                    _quote(n, self.delimiter)
                    for n in table.column_names) + "\n").encode())
            if table.num_rows == 0 or not table.columns:
                return
            cols = [np.ascontiguousarray(
                        _format_column_vec(c, self.delimiter))
                    for c in table.columns]
            import ctypes
            lib = nt.csv_lib()
            n = table.num_rows
            widths = np.array([c.dtype.itemsize for c in cols], np.int64)
            ptrs = (ctypes.c_void_p * len(cols))(
                *[c.ctypes.data for c in cols])
            buf = np.zeros(int(n * (widths.sum() + len(cols))), np.uint8)
            total = lib.csv_join_rows(
                len(cols), ctypes.cast(ptrs, ctypes.POINTER(
                    ctypes.c_void_p)), nt._i64p(widths), n,
                ord(self.delimiter), nt._u8(buf))
            out.write(buf[:int(total)].tobytes())
        finally:
            if own:
                out.close()


def _quote(v: str, delim: str) -> str:
    if any(ch in v for ch in (delim, '"', "\n", "\r")):
        return '"' + v.replace('"', '""') + '"'
    return v


def _apply_quotes(a: np.ndarray, need: np.ndarray) -> np.ndarray:
    """Quote+escape the rows flagged in `need` (S-dtype array)."""
    if need.any():
        esc = np.char.replace(a[need], b'"', b'""')
        quoted = np.char.add(np.char.add(b'"', esc), b'"')
        if quoted.dtype.itemsize > a.dtype.itemsize:
            a = a.astype(f"S{quoted.dtype.itemsize}")
        a[need] = quoted
    return a


def _quote_vec(a: np.ndarray, delim: bytes) -> np.ndarray:
    """RFC 4180 quoting over an S-dtype byte array, touching only the
    rows that need it."""
    need = np.char.find(a, delim) >= 0
    for ch in (b'"', b"\n", b"\r"):
        need |= np.char.find(a, ch) >= 0
    return _apply_quotes(a, need)


def _bytes_cells_raw(offs: np.ndarray, data: np.ndarray,
                     quote_delim: Optional[bytes] = None) -> np.ndarray:
    """(offsets, bytes) -> S-width array (no per-row Python).  With
    `quote_delim`, RFC 4180 quoting is applied (the need-mask computes
    on the byte matrix — one uint8 compare pass, not 4 np.char.finds)."""
    lens = offs[1:] - offs[:-1]
    n = len(lens)
    w = max(int(lens.max()) if n else 1, 1)
    if not len(data):
        return np.zeros(n, f"S{w}")
    idx = np.minimum(offs[:-1, None] + np.arange(w), len(data) - 1)
    m = np.where(np.arange(w) < lens[:, None], data[idx],
                 np.uint8(0)).astype(np.uint8, copy=False)
    a = np.ascontiguousarray(m).view(f"S{w}").ravel()
    if quote_delim is not None:
        need = ((m == ord(quote_delim)) | (m == 34) | (m == 10)
                | (m == 13)).any(axis=1)
        a = _apply_quotes(a, need)
    return a


def _bytes_cells(col) -> np.ndarray:
    """StringColumn -> S-width array straight from the offsets/bytes
    tensors."""
    return _bytes_cells_raw(hostio.host(col.offsets).astype(np.int64),
                            hostio.host(col.data))


def _format_column_vec(col: Column, delim: str) -> np.ndarray:
    """One S-dtype cell-bytes array per column (nulls -> empty;
    writer.rs formatting semantics).  Numerics format via numpy's
    shortest-repr astype (the ryu/itoa text), strings slice out of the
    UTF-8 buffer, dictionaries format per distinct value then gather."""
    from ..core.column import (DictionaryColumn, PrimitiveColumn,
                               StringColumn)
    valid = None if col.validity is None else hostio.host(col.validity)
    d = col.dtype
    bdelim = delim.encode()
    if isinstance(col, PrimitiveColumn) and d.name == "bool":
        a = np.where(hostio.host(col.values), b"true", b"false")
    elif isinstance(col, PrimitiveColumn) and d.is_integer \
            and d.name != "uint64":     # u64 > i64 max would overflow
        vals = np.ascontiguousarray(hostio.values(col)
                                    .astype(np.int64, copy=False))
        n = len(vals)
        w = 21 if n == 0 else max(
            len(str(int(vals.min()))), len(str(int(vals.max()))), 1)
        a = np.zeros(n * w, np.uint8)
        nt.csv_lib().csv_format_i64(nt._i64p(vals), n, w, nt._u8(a))
        a = a.view(f"S{w}")
        if valid is not None:
            a = np.where(valid, a, b"")
        return a
    elif isinstance(col, PrimitiveColumn) and d.name in ("float32",
                                                         "float64",
                                                         "uint64"):
        a = hostio.values(col).astype("S32")
        # numerics never contain delim/quote/newlines -> no quoting
        if valid is not None:
            a = np.where(valid, a, b"")
        return a
    elif isinstance(col, PrimitiveColumn) and (
            d.name == "timestamp" and d.tz is None or d.name == "date32"):
        # C civil-calendar formatter emits the display.rs ISO form
        # (T separator, unit-width fractional digits) ~100x faster than
        # np.datetime64 astype('U')
        vals = np.ascontiguousarray(hostio.host(col.values)
                                    .astype(np.int64, copy=False))
        n = len(vals)
        if d.name == "date32":
            scale, frac, w = 1, -1, 18      # slack for huge/neg years
        else:
            scale = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[d.unit]
            frac = {"s": 0, "ms": 3, "us": 6, "ns": 9}[d.unit]
            # int64 seconds reach ~12-digit years: sign+12+15 chars
            w = 32 + (frac + 1 if frac else 0)
        a = np.zeros(n * w, np.uint8)
        nt.csv_lib().csv_format_timestamp(nt._i64p(vals), n, scale,
                                          frac, w, nt._u8(a))
        a = a.view(f"S{w}")
        if valid is not None:
            a = np.where(valid, a, b"")
        return a
    elif isinstance(col, StringColumn) \
            and d.name in ("binary", "large_binary", "binary_view"):
        # the reference hex-encodes binary cells (display.rs Binary arm,
        # writer.rs test expects 486f6d6572) — also NUL-safe for S dtype
        offs = hostio.host(col.offsets).astype(np.int64)
        data = hostio.host(col.data)
        hexmap = np.frombuffer(b"0123456789abcdef", np.uint8)
        data2 = np.empty(len(data) * 2, np.uint8)
        data2[0::2] = hexmap[data >> 4]
        data2[1::2] = hexmap[data & 0x0F]
        a = _bytes_cells_raw(offs * 2, data2)
    elif isinstance(col, StringColumn) and d.name != "fixed_size_binary":
        a = _bytes_cells_raw(hostio.host(col.offsets).astype(np.int64),
                             hostio.host(col.data), bdelim)
    elif isinstance(col, DictionaryColumn) \
            and col.values.dtype.is_string:
        per_value = _bytes_cells_raw(
            hostio.host(col.values.offsets).astype(np.int64),
            hostio.host(col.values.data), bdelim)
        codes = np.clip(hostio.host(col.codes), 0,
                        max(len(per_value) - 1, 0))
        a = per_value[codes] if len(per_value) else \
            np.zeros(len(col), "S1")
        vv = col.values.validity
        if vv is not None:
            slot = hostio.host(vv)[codes]
            valid = slot if valid is None else (valid & slot)
    else:
        # temporals/decimals/nested: ArrayFormatter per row
        from ..utils.display import ArrayFormatter, FormatOptions
        fmt = ArrayFormatter(col, FormatOptions(null=""))
        vals = col.to_pylist()
        u = np.asarray(["" if v is None else fmt.value(i)
                        for i, v in enumerate(vals)], dtype="U")
        if len(u) == 0:
            u = np.zeros(0, "U1")
        a = _quote_vec(np.char.encode(u, "utf-8"), bdelim)
    if valid is not None:
        a = np.where(valid, a, b"")
    return a


def write_csv(sink_or_path, table: Table, include_header: bool = True):
    WriterBuilder(include_header=include_header).write(sink_or_path, table)
