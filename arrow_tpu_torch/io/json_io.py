"""JSON read/write (the arrow-json role) — native tape reader
(counterpart of arrow_tpu/io/json_io.py).

Reader: a C tape tokenizer (native/hostcodec.cpp json_tape, the
arrow-json reader/tape.rs re-design) turns the byte buffer into a flat
token tape; column assembly walks the tape with numpy (records, keys,
and value tokens located by vectorized depth/prefix arithmetic), reusing
the CSV typed parsers for numbers/timestamps and the C unescaper for
strings.  Supports line-delimited and JSON-array inputs, nested structs
and lists of primitives; `schema` casts the assembled columns.  Writer:
LineDelimited and JsonArray formats (writer/mod.rs:154,171).
pyarrow appears nowhere in this path.

The tape and every column's buffers are built on the host; each buffer
goes onto the caller's `device` once (`hostio.tensor`).  The writer
takes its host view of the table once (`hostio.to_host`).
"""

from __future__ import annotations

import io as _io
import json
import math
from typing import Iterable, List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import (Column, ListColumn, NullColumn,
                           PrimitiveColumn, StringColumn, StructColumn)
from ..core.table import Table
from ..errors import ArrowInvalid
from ..utils import hostcodec as nt
from . import hostio

__all__ = ["read_json", "read_json_objects", "write_json", "WriterBuilder"]


class _Tape:
    def __init__(self, data: bytes, device: torch.device):
        self.dev = device
        self.raw = np.frombuffer(data, np.uint8)
        self.types, self.starts, self.ends, self.escs = nt.json_tape(data)
        delta = np.zeros(len(self.types), np.int64)
        delta[(self.types == 0) | (self.types == 2)] = 1
        delta[(self.types == 1) | (self.types == 3)] = -1
        self.depth_after = np.cumsum(delta)
        self.depth_before = self.depth_after - delta
        self._match = None

    def match(self) -> np.ndarray:
        """Matching-close token index for every container open."""
        if self._match is None:
            m = np.full(len(self.types), -1, np.int64)
            stack = []
            for i, t in enumerate(self.types):
                if t in (0, 2):
                    stack.append(i)
                elif t in (1, 3):
                    m[stack.pop()] = i
            self._match = m
        return self._match

    def text(self, i: int) -> str:
        return self.raw[self.starts[i]:self.ends[i]].tobytes() \
            .decode("utf-8")


def _mask(tape: _Tape, valid: np.ndarray):
    return None if valid.all() else hostio.tensor(valid, tape.dev)


def _prim(tape: _Tape, vals: np.ndarray, d: dt.DataType,
          valid: np.ndarray) -> PrimitiveColumn:
    mask = _mask(tape, valid)
    return PrimitiveColumn(hostio.tensor(vals, tape.dev), d, mask,
                           _canonical=mask is None)


def _strings_from_tokens(tape: _Tape, toks: np.ndarray,
                         present: np.ndarray) -> StringColumn:
    sel = toks[present]
    offs_u, data_u = nt.json_unescape(tape.raw, tape.starts[sel],
                                      tape.ends[sel], tape.escs[sel])
    n = len(toks)
    lens = np.zeros(n, np.int64)
    lens[present] = offs_u[1:] - offs_u[:-1]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return StringColumn(hostio.tensor(offs.astype(np.int32), tape.dev),
                        hostio.tensor(data_u, tape.dev), dt.utf8,
                        _mask(tape, present))


def _column_from_tokens(tape: _Tape, toks: np.ndarray) -> Column:
    """Build a column from per-row value-token indices (-1 = missing)."""
    n = len(toks)
    present = toks >= 0
    if not present.any():
        return NullColumn(n, tape.dev)
    ttypes = np.where(present, tape.types[np.maximum(toks, 0)], 9)
    is_null = (ttypes == 9) | ~present
    val = ~is_null

    kinds = set(np.unique(ttypes[val]).tolist())
    lib = nt.csv_lib()

    if kinds <= {6}:                       # numbers
        sel = toks[val]
        starts = np.ascontiguousarray(tape.starts[sel])
        ends = np.ascontiguousarray(tape.ends[sel])
        m = len(starts)
        out_i = np.zeros(m, np.int64)
        ok = np.zeros(m, np.uint8)
        bad = lib.csv_parse_i64(nt._u8(tape.raw), nt._i64p(starts),
                                nt._i64p(ends), m, nt._i64p(out_i),
                                nt._u8(ok))
        if bad < 0:
            full = np.zeros(n, np.int64)
            full[val] = out_i
            return _prim(tape, full, dt.int64, val)
        out_f = np.zeros(m, np.float64)
        bad = lib.csv_parse_f64(
            nt._u8(tape.raw), nt._i64p(starts), nt._i64p(ends), m,
            nt._f64p(out_f), nt._u8(ok))
        if bad >= 0:
            raise ArrowInvalid("unparseable JSON number")
        full = np.zeros(n, np.float64)
        full[val] = out_f
        return _prim(tape, full, dt.float64, val)

    if kinds <= {7, 8}:                    # booleans
        full = np.zeros(n, np.bool_)
        full[val] = ttypes[val] == 7
        return _prim(tape, full, dt.bool_, val)

    if kinds <= {5}:                       # strings
        # inference keeps strings as Utf8 (arrow-rs infer_json_schema
        # semantics); a user schema converts via cast (utf8->timestamp)
        return _strings_from_tokens(tape, toks, val)

    if kinds <= {0}:                       # nested objects -> struct
        return _struct_from_tokens(tape, toks, val)

    if kinds <= {2}:                       # arrays -> list
        return _list_from_tokens(tape, toks, val)

    # mixed scalars: raw token text as utf8
    return _strings_from_tokens(tape, toks, val)


def _struct_from_tokens(tape: _Tape, toks: np.ndarray,
                        val: np.ndarray) -> Column:
    match = tape.match()
    opens = toks[val]
    names: List[str] = []
    by_name = {}
    # keys directly inside each object: depth == depth(open)+1
    for row, o in zip(np.nonzero(val)[0], opens):
        end = match[o]
        d = tape.depth_after[o]
        k = o + 1
        while k < end:
            if tape.types[k] == 4 and tape.depth_before[k] == d:
                name = tape.text(k)
                if name not in by_name:
                    by_name[name] = np.full(len(toks), -1, np.int64)
                    names.append(name)
                by_name[name][row] = k + 1
            k += 1
    children = tuple(_column_from_tokens(tape, by_name[nm])
                     for nm in names)
    fields = tuple(dt.Field(nm, c.dtype) for nm, c in zip(names, children))
    if not names:
        children = (NullColumn(len(toks), tape.dev),)
        fields = (dt.Field("", dt.null),)
    return StructColumn(children, fields, _mask(tape, val))


def _list_from_tokens(tape: _Tape, toks: np.ndarray,
                      val: np.ndarray) -> Column:
    match = tape.match()
    elem_toks = []
    counts = np.zeros(len(toks), np.int64)
    for row, o in zip(np.nonzero(val)[0], toks[val]):
        end = match[o]
        d = tape.depth_after[o]
        k = o + 1
        cnt = 0
        while k < end:
            if tape.depth_before[k] == d and tape.types[k] != 4:
                if tape.types[k] in (0, 2):
                    elem_toks.append(k)
                    k = match[k] + 1
                    cnt += 1
                    continue
                elem_toks.append(k)
                cnt += 1
            k += 1
        counts[row] = cnt
    offsets = np.zeros(len(toks) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    child = _column_from_tokens(
        tape, np.asarray(elem_toks, np.int64)
        if elem_toks else np.zeros(0, np.int64))
    return ListColumn(hostio.tensor(offsets.astype(np.int32), tape.dev),
                      child, _mask(tape, val))


def _as_bytes(source) -> bytes:
    if isinstance(source, bytes):
        return source
    if isinstance(source, str):
        stripped = source.lstrip()
        if stripped.startswith("{") or stripped.startswith("["):
            return source.encode("utf-8")
        with open(source, "rb") as f:
            return f.read()
    if hasattr(source, "read"):
        data = source.read()
        return data.encode("utf-8") if isinstance(data, str) else data
    raise ArrowInvalid(f"cannot read JSON from {type(source)}")


def read_json(source, schema: Optional[dt.Schema] = None, *,
              device: DeviceLike) -> Table:
    """Line-delimited JSON (or a JSON array of objects) -> Table on
    `device`.  Malformed bytes raise ArrowInvalid, never raw stdlib
    errors."""
    from ..errors import malformed_guard
    dev = resolve_device(device)
    data = _as_bytes(source)
    with malformed_guard("JSON input"):
        return _read_json_impl(data, schema, dev)


def _read_json_impl(data: bytes, schema: Optional[dt.Schema],
                    dev: torch.device) -> Table:
    tape = _Tape(data, dev)
    types, db = tape.types, tape.depth_before
    # records: top-level objects, or objects at depth 1 of one top array
    rec = (types == 0) & (db == 0)
    if not rec.any() and len(types) and types[0] == 2:
        rec = (types == 0) & (db == 1)
    rec_starts = np.nonzero(rec)[0]
    n = len(rec_starts)
    key_depth = tape.depth_after[rec_starts[0]] if n else 1
    key_pos = np.nonzero((types == 4) & (db == key_depth))[0]
    rec_of_key = np.searchsorted(rec_starts, key_pos, side="right") - 1
    names: List[str] = []
    cols = {}
    if len(key_pos):
        # group the key tokens by their bytes in one native interning
        # pass (codes in first-seen order; the reference hashes a
        # fixed-width byte matrix of every key): one host decode per
        # column, not per token
        starts = tape.starts[key_pos]
        lens = tape.ends[key_pos] - starts
        offs = np.zeros(len(key_pos) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        packed = np.zeros(max(int(offs[-1]), 1), np.uint8)
        nt.gather_ranges(tape.raw, starts, lens, offs[:-1], packed)
        codes, _ = nt.intern_varlen(offs, packed[:int(offs[-1])])
        order = np.argsort(codes, kind="stable")
        bounds = np.concatenate([[0], np.cumsum(np.bincount(codes))])
        for uid in range(len(bounds) - 1):     # first-seen order
            sel = order[bounds[uid]:bounds[uid + 1]]
            name = tape.text(int(key_pos[sel[0]]))
            toks = np.full(n, -1, np.int64)
            toks[rec_of_key[sel]] = key_pos[sel] + 1
            cols[name] = toks
            names.append(name)
    columns = tuple(_column_from_tokens(tape, cols[nm]) for nm in names)
    fields = tuple(dt.Field(nm, c.dtype) for nm, c in zip(names, columns))
    t = Table(columns, dt.Schema(fields))
    if schema is not None:
        # the schema drives the output (reader/mod.rs:298 builds the
        # decoder tree from the schema): fields absent from the data
        # become null columns, data keys absent from the schema are
        # ignored (non-strict mode), order follows the schema
        from ..ops.cast import cast
        by = {f.name: (f, c) for f, c in zip(t.schema.fields, t.columns)}
        out_cols, out_fields = [], []
        for tgt in schema.fields:
            got = by.get(tgt.name)
            c = got[1] if got is not None else NullColumn(t.num_rows, dev)
            if tgt.dtype != c.dtype:
                c = cast(c, tgt.dtype)
            out_cols.append(c)
            out_fields.append(dt.Field(tgt.name, c.dtype, tgt.nullable))
        t = Table(tuple(out_cols), dt.Schema(tuple(out_fields)))
    return t


def read_json_objects(objs: Iterable[dict],
                      schema: Optional[dt.Schema] = None, *,
                      device: DeviceLike) -> Table:
    """Decode from python mappings (the serde::Serialize decode path,
    reader/mod.rs:177) — serialized through the same native tape."""
    resolve_device(device)
    payload = "\n".join(json.dumps(o) for o in objs)
    if not payload:
        return Table((), dt.Schema(()))
    return read_json(payload.encode("utf-8"), schema, device=device)


class WriterBuilder:
    """writer/mod.rs: LineDelimited (default) or JsonArray; nulls
    explicit or omitted."""

    def __init__(self, format: str = "lines", explicit_nulls: bool = False):
        if format not in ("lines", "array"):
            raise ArrowInvalid("format must be 'lines' or 'array'")
        self.format = format
        self.explicit_nulls = explicit_nulls

    def _rows(self, table: Table) -> List[dict]:
        d = table.to_pydict()
        names = list(d.keys())
        rows = []
        for i in range(table.num_rows):
            row = {}
            for n in names:
                v = d[n][i]
                if v is None and not self.explicit_nulls:
                    continue
                row[n] = _json_value(v, table.schema.field(n).dtype)
            rows.append(row)
        return rows

    def write(self, sink, table: Table) -> None:
        table = hostio.to_host(table)
        if self.format == "lines":
            fast = _write_lines_vec(table, self.explicit_nulls)
            if fast is not None:
                sink.write(fast)
                return
        rows = self._rows(table)
        if self.format == "array":
            sink.write(json.dumps(rows).encode())
        else:
            for r in rows:
                sink.write(json.dumps(r).encode() + b"\n")

    def write_str(self, table: Table) -> str:
        buf = _io.BytesIO()
        self.write(buf, table)
        return buf.getvalue().decode()


def _json_value(v, d: Optional[dt.DataType] = None):
    """JSON value for one cell, recursively (writer/encoder.rs arms):
    binary/fsb -> hex strings (encoder.rs:782), temporal -> ISO strings,
    decimal -> number when exactly representable else digit string,
    NaN/inf -> null (JSON has neither; the reference errors).  `d` (the
    cell's dtype) disambiguates map-vs-list so an empty map renders as
    {} like the reference's unconditional MapEncoder (encoder.rs:755)."""
    import datetime
    import decimal
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return None
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, datetime.time):
        return v.isoformat()
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).hex()
    if isinstance(v, decimal.Decimal):
        f = float(v)
        return f if decimal.Decimal(repr(f)) == v else str(v)
    name = d.name if d is not None else None
    if d is not None and d.is_dictionary:
        return _json_value(v, d.value_type)
    if name == "map" and isinstance(v, (list, tuple)):
        vf = d.value_type.fields[1]
        return {str(k): _json_value(x, vf.dtype) for k, x in v}
    if isinstance(v, dict):
        fmap = {f.name: f.dtype for f in d.fields} if name == "struct" \
            else {}
        return {k: _json_value(x, fmap.get(k)) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        if name in ("list", "large_list", "list_view", "large_list_view",
                    "fixed_size_list"):
            return [_json_value(x, d.value_type) for x in v]
        if len(v) and isinstance(v[0], tuple) and len(v[0]) == 2:
            # dtype-less call: map entries still render as an object
            try:
                return {str(k): _json_value(x) for k, x in v}
            except (TypeError, ValueError):
                pass
        return [_json_value(x) for x in v]
    return v


def _json_fragments(col, name: str, explicit: bool):
    """'"name":value' S-array for one flat column, or None when the
    type needs the slow path.  Empty cell = field omitted; explicit
    nulls render '"name":null'."""
    from ..core.column import (DictionaryColumn, PrimitiveColumn,
                               StringColumn)
    from .csv import _bytes_cells_raw
    prefix = json.dumps(name).encode() + b":"
    nullfrag = prefix + b"null" if explicit else b""
    d = col.dtype
    valid = None if col.validity is None else hostio.host(col.validity)

    def string_frags(scol):
        offs = hostio.host(scol.offsets).astype(np.int64)
        data = hostio.host(scol.data)
        lens = offs[1:] - offs[:-1]
        cells = _bytes_cells_raw(offs, data)
        m = len(cells)
        # rows needing JSON escaping (controls, quote, backslash) or
        # containing NUL-adjacent risk (trailing NUL is unrepresentable
        # in S dtype) go through json.dumps
        if len(data):
            risky = (data < 0x20) | (data == 0x22) | (data == 0x5C)
            # per-cell any via prefix-sum over the byte buffer
            csum = np.concatenate([[0], np.cumsum(risky)])
            need = (csum[offs[1:]] - csum[offs[:-1]]) > 0
        else:
            need = np.zeros(m, bool)
        a = np.char.add(np.char.add(prefix + b'"', cells), b'"')
        if need.any():
            py = scol.to_pylist()
            frags = [prefix + json.dumps(py[int(i)]).encode()
                     for i in np.nonzero(need)[0]]
            w = max(max(len(f) for f in frags), a.dtype.itemsize)
            if w > a.dtype.itemsize:
                a = a.astype(f"S{w}")
            a[need] = np.array(frags, dtype=f"S{w}")
        return a

    if isinstance(col, PrimitiveColumn) and d.name == "bool":
        a = np.where(hostio.host(col.values), prefix + b"true",
                     prefix + b"false")
    elif isinstance(col, PrimitiveColumn) and d.is_integer:
        a = np.char.add(prefix, hostio.values(col).astype("S21"))
    elif isinstance(col, PrimitiveColumn) and d.name in ("float32",
                                                         "float64"):
        vals = hostio.host(col.values)
        a = np.char.add(prefix, vals.astype("S32"))
        fin = np.isfinite(vals)
        if not fin.all():         # JSON has no NaN/inf -> null
            a = np.where(fin, a, nullfrag)
    elif isinstance(col, PrimitiveColumn) and (
            d.name == "timestamp" and d.tz is None or d.name == "date32"):
        # C civil-calendar ISO text == encoder.rs unit-width output
        # ("2018-11-13T17:11:10.011375" for us)
        vals = np.ascontiguousarray(hostio.host(col.values)
                                    .astype(np.int64, copy=False))
        m = len(vals)
        if d.name == "date32":
            scale, frac, w = 1, -1, 18
        else:
            scale = {"s": 1, "ms": 10**3, "us": 10**6,
                     "ns": 10**9}[d.unit]
            frac = {"s": 0, "ms": 3, "us": 6, "ns": 9}[d.unit]
            w = 32 + (frac + 1 if frac else 0)
        cells = np.zeros(m * w, np.uint8)
        nt.csv_lib().csv_format_timestamp(nt._i64p(vals), m, scale,
                                          frac, w, nt._u8(cells))
        a = np.char.add(np.char.add(prefix + b'"',
                                    cells.view(f"S{w}")), b'"')
    elif isinstance(col, StringColumn) and d.name in ("utf8",
                                                      "large_utf8"):
        a = string_frags(col)
    elif isinstance(col, DictionaryColumn) \
            and col.values.dtype.name in ("utf8", "large_utf8"):
        per_value = string_frags(col.values)
        codes = np.clip(hostio.host(col.codes), 0,
                        max(len(per_value) - 1, 0))
        a = per_value[codes] if len(per_value) else \
            np.zeros(len(col), "S1")
        vv = col.values.validity
        if vv is not None:
            slot = hostio.host(vv)[codes]
            valid = slot if valid is None else (valid & slot)
    else:
        return None
    if valid is not None:
        a = np.where(valid, a, nullfrag)
    return a


def _write_lines_vec(table: Table, explicit: bool) -> Optional[bytes]:
    """Vectorized LineDelimited writer for flat tables: S-matrix
    fragments + one C assembly pass (json_join_rows).  None -> caller
    falls back to the per-row path (nested/temporal columns)."""
    import ctypes
    if table.num_rows == 0:
        return None
    frags = []
    for f, c in zip(table.schema.fields, table.columns):
        a = _json_fragments(c, f.name, explicit)
        if a is None:
            return None
        frags.append(np.ascontiguousarray(a))
    lib = nt.csv_lib()
    n = table.num_rows
    widths = np.array([a.dtype.itemsize for a in frags], np.int64)
    ptrs = (ctypes.c_void_p * len(frags))(
        *[a.ctypes.data for a in frags])
    buf = np.zeros(int(n * (widths.sum() + len(frags) + 3)), np.uint8)
    total = lib.json_join_rows(
        len(frags), ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        nt._i64p(widths), n, nt._u8(buf))
    return buf[:int(total)].tobytes()


def write_json(sink, table: Table, format: str = "lines"):
    WriterBuilder(format).write(sink, table)
