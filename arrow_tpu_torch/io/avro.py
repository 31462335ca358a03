"""Avro -> Table reader (the arrow-avro role: decode-only, SURVEY.md §2.3;
counterpart of arrow_tpu/io/avro.py).

Object-container-file reader built from the Avro 1.11 spec: magic
'Obj\\x01', metadata map (avro.schema JSON + avro.codec), 16-byte sync
marker, then blocks of (row_count, byte_size, payload, sync).

r2 coverage (arrow-avro codec.rs / reader/block.rs parity): nested
records (struct), arrays (list), maps, fixed, enums, ["null", T]
unions; logical types date/time-millis/time-micros/timestamp-millis/
timestamp-micros/uuid; codecs null/deflate/snappy/zstandard/bzip2/xz (native
hostcodec codec + CRC32 check); reader-vs-writer schema resolution
(field defaults, int->long->float->double and string<->bytes
promotions).  Column batches build host-side, then upload to device.

r3: decode is COLUMNAR-native — the schema compiles to a flat node
program and hostcodec.cpp avro_decode_block walks each block in C
(measure + fill passes) emitting per-node value/length/count/valid
buffers; assembly is vectorized numpy (arrow-avro reader/record.rs
role).  Measured 39x vs the per-row path on a 200K-row nested file
(int/string/list/struct, deflate).  Per-row fallback remains for
multi-branch unions, named type refs, and reader-schema resolution.

Decoding and assembly are host numpy; each assembled buffer goes onto
the caller's `device` once (`hostio.tensor`, in `_assemble` and
`_build_column`).  The writer takes its host view of the table once
(`hostio.to_host`).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           PrimitiveColumn, StringColumn, StructColumn,
                           column, offset_dtype)
from ..core.nested import (FixedSizeBinaryColumn, IntervalMDNColumn,
                           MapColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..utils import hostcodec as nt
from . import hostio

__all__ = ["read_avro", "write_avro", "ReaderBuilder"]

_MAGIC = b"Obj\x01"


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ArrowInvalid("truncated avro data")
        self.pos += n
        return b

    def vlq_long(self) -> int:
        """zig-zag varint (the reference's vlq, arrow-avro reader/vlq.rs)."""
        shift = 0
        acc = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def string(self) -> bytes:
        return self.read(self.vlq_long())


def _read_header(cur: _Cursor):
    if cur.read(4) != _MAGIC:
        raise ArrowInvalid("not an avro object container file")
    meta = {}
    while True:
        n = cur.vlq_long()
        if n == 0:
            break
        if n < 0:  # negative count: size prefix follows
            cur.vlq_long()
            n = -n
        for _ in range(n):
            k = cur.string().decode()
            v = cur.string()
            meta[k] = v
    sync = cur.read(16)
    return meta, sync


def _decode_value(cur: _Cursor, schema):
    if isinstance(schema, list):  # union
        idx = cur.vlq_long()
        branch = schema[idx]
        return _decode_value(cur, branch)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: _decode_value(cur, f["type"])
                    for f in schema["fields"]}
        if t == "enum":
            return schema["symbols"][cur.vlq_long()]
        if t == "array":
            out = []
            while True:
                n = cur.vlq_long()
                if n == 0:
                    break
                if n < 0:          # negative count: byte size follows
                    cur.vlq_long()
                    n = -n
                for _ in range(n):
                    out.append(_decode_value(cur, schema["items"]))
            return out
        if t == "map":
            out = []
            while True:
                n = cur.vlq_long()
                if n == 0:
                    break
                if n < 0:
                    cur.vlq_long()
                    n = -n
                for _ in range(n):
                    k = cur.string().decode()
                    out.append((k, _decode_value(cur, schema["values"])))
            return out
        if t == "fixed":
            return cur.read(schema["size"])
        schema = t
    if schema == "null":
        return None
    if schema == "boolean":
        return cur.read(1) != b"\x00"
    if schema in ("int", "long"):
        return cur.vlq_long()
    if schema == "float":
        return struct.unpack("<f", cur.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", cur.read(8))[0]
    if schema == "string":
        return cur.string().decode()
    if schema == "bytes":
        return cur.string()
    raise ArrowNotImplementedError(f"avro type {schema}")


_AVRO_TO_DT = {"boolean": dt.bool_, "int": dt.int32, "long": dt.int64,
               "float": dt.float32, "double": dt.float64,
               "string": dt.utf8, "bytes": dt.binary}


_LOGICAL_DT = {
    "date": dt.date32, "time-millis": dt.time32("ms"),
    "time-micros": dt.time64("us"),
    "timestamp-millis": dt.timestamp("ms"),
    "timestamp-micros": dt.timestamp("us"),
    "local-timestamp-millis": dt.timestamp("ms"),
    "local-timestamp-micros": dt.timestamp("us"),
    "timestamp-nanos": dt.timestamp("ns"),
    "local-timestamp-nanos": dt.timestamp("ns"),
    "uuid": dt.utf8,
}


def _field_dtype(schema) -> dt.DataType:
    if isinstance(schema, list):
        non_null = [s for s in schema if s != "null"]
        if len(non_null) != 1:
            raise ArrowNotImplementedError("multi-branch avro union")
        return _field_dtype(non_null[0])
    if isinstance(schema, dict):
        lt = schema.get("logicalType")
        if lt in _LOGICAL_DT:
            return _LOGICAL_DT[lt]
        if lt == "decimal":
            # bytes/fixed big-endian two's-complement unscaled int
            # (codec.rs:215 Codec::Decimal -> Decimal128/256)
            p = schema["precision"]
            s = schema.get("scale", 0)
            return dt.decimal128(p, s) if p <= 38 else dt.decimal256(p, s)
        if lt == "duration" and schema.get("type") == "fixed" \
                and schema.get("size") == 12:
            # three little-endian u32: months, days, millis
            # (codec.rs:228 -> Interval(MonthDayNano))
            return dt.interval("month_day_nano")
        t = schema["type"]
        if t == "enum":
            return dt.dictionary(dt.int32, dt.utf8)
        if t == "array":
            return dt.list_(_field_dtype(schema["items"]))
        if t == "map":
            return dt.map_(dt.utf8, _field_dtype(schema["values"]))
        if t == "record":
            return dt.struct([dt.Field(f["name"],
                                       _field_dtype(f["type"]))
                              for f in schema["fields"]])
        if t == "fixed":
            return dt.fixed_size_binary(schema["size"])
        return _field_dtype(t)
    if schema in _AVRO_TO_DT:
        return _AVRO_TO_DT[schema]
    raise ArrowNotImplementedError(f"avro type {schema}")


def _mask(valid, dev: torch.device):
    return None if all(valid) else hostio.tensor(np.asarray(valid, bool),
                                                 dev)


def _build_column(vals, d: dt.DataType, dev: torch.device) -> Column:
    """Recursive host-side assembly via the engine's builders, on
    `dev`."""
    if d.name in ("decimal128", "decimal256") and any(
            isinstance(v, bytes) for v in vals):
        import decimal as _dec
        vals = [None if v is None else
                _dec.Decimal(int.from_bytes(v, "big", signed=True))
                .scaleb(-d.scale) for v in vals]
    if d.name == "interval" and d.unit == "month_day_nano" and any(
            isinstance(v, bytes) for v in vals):
        vals = [None if v is None else
                (int.from_bytes(v[0:4], "little"),
                 int.from_bytes(v[4:8], "little"),
                 int.from_bytes(v[8:12], "little") * 1_000_000)
                for v in vals]
    if d.is_dictionary:
        from ..ops.strings import dictionary_encode
        return dictionary_encode(StringColumn.from_pylist(
            ["" if v is None else v for v in vals], device=dev))
    if d.name == "list":
        offs = [0]
        flat = []
        valid = []
        for v in vals:
            if v is None:
                valid.append(False)
            else:
                flat.extend(v)
                valid.append(True)
            offs.append(len(flat))
        child = _build_column(flat, d.value_type, dev)
        return ListColumn(hostio.tensor(np.asarray(offs, np.int32), dev),
                          child, _mask(valid, dev))
    if d.name == "map":
        offs = [0]
        keys: List[str] = []
        items = []
        valid = []
        for v in vals:
            if v is None:
                valid.append(False)
            else:
                for k, it in v:
                    keys.append(k)
                    items.append(it)
                valid.append(True)
            offs.append(len(keys))
        kcol = StringColumn.from_pylist(keys, device=dev)
        icol = _build_column(items, d.value_type.fields[1].dtype, dev)
        entries = StructColumn((kcol, icol), d.value_type.fields)
        return MapColumn(hostio.tensor(np.asarray(offs, np.int32), dev),
                         entries, _mask(valid, dev))
    if d.name == "struct":
        valid = [v is not None for v in vals]
        children = tuple(
            _build_column([None if v is None else v.get(f.name)
                           for v in vals], f.dtype, dev)
            for f in d.fields)
        return StructColumn(children, tuple(d.fields), _mask(valid, dev))
    if d.name == "fixed_size_binary":
        from ..core.builders import FixedSizeBinaryBuilder
        b = FixedSizeBinaryBuilder(d.list_size, device=dev)
        for v in vals:
            b.append(v)
        return b.finish()
    return column(vals, dtype=d, device=dev)


def _resolve_value(v, writer_schema, reader_schema):
    """Schema resolution promotions (arrow-avro codec.rs resolution):
    int->long->float->double, string<->bytes."""
    wd = writer_schema if isinstance(writer_schema, str) else None
    rd = reader_schema if isinstance(reader_schema, str) else None
    if v is None or wd is None or rd is None or wd == rd:
        return v
    if wd in ("int", "long") and rd in ("long", "float", "double"):
        return float(v) if rd in ("float", "double") else int(v)
    if wd == "float" and rd == "double":
        return v
    if wd == "string" and rd == "bytes":
        return v.encode("utf-8")
    if wd == "bytes" and rd == "string":
        return v.decode("utf-8")
    return v


def read_avro(source, batch_size: Optional[int] = None,
              reader_schema: Optional[dict] = None, *,
              device: DeviceLike) -> Table:
    """An Avro object container file as a Table on `device`.
    reader_schema: optional Avro schema dict for reader-vs-writer
    resolution (missing fields take their defaults; promoted types
    convert).  Malformed container bytes raise ArrowInvalid (the
    reference's ParseError role), never raw stdlib errors."""
    dev = resolve_device(device)
    if isinstance(source, str):
        with open(source, "rb") as f:
            data = f.read()
    elif isinstance(source, bytes):
        data = source
    else:
        data = source.read()
    from ..errors import malformed_guard
    with malformed_guard("avro container"):
        return _read_avro_impl(data, reader_schema, dev)


class _Unsupported(Exception):
    pass


_PRIM_KIND = {"null": 0, "boolean": 1, "int": 2, "long": 2, "float": 3,
              "double": 4, "string": 5, "bytes": 5}


def _compile_program(schema):
    """Flatten the writer schema into the hostcodec node program (kind
    table in native/hostcodec.cpp avro_decode_block).  Returns
    (prog_arrays, root_spec) where root_spec mirrors the schema tree
    with per-node buffer ids for vectorized assembly.  Raises
    _Unsupported for shapes only the per-row fallback handles
    (multi-branch unions, named type references)."""
    kinds: List[int] = []
    extras: List[int] = []
    cstarts: List[int] = []
    ccounts: List[int] = []
    cidx: List[int] = []

    def add(kind, ex=0, children=(), sch=None):
        i = len(kinds)
        kinds.append(kind)
        extras.append(ex)
        cstarts.append(len(cidx))
        ccounts.append(len(children))
        cidx.extend(c["nid"] for c in children)
        return {"nid": i, "kind": kind, "children": list(children),
                "schema": sch}

    def node_of(s):
        if isinstance(s, list):
            non_null = [x for x in s if x != "null"]
            if len(s) != 2 or len(non_null) != 1:
                raise _Unsupported(s)
            child = node_of(non_null[0])
            return add(11, s.index("null"), (child,), s)
        if isinstance(s, dict):
            t = s["type"]
            if t == "record":
                ch = tuple(node_of(f["type"]) for f in s["fields"])
                return add(8, 0, ch, s)
            if t == "enum":
                return add(7, 0, (), s)
            if t == "array":
                return add(9, 0, (node_of(s["items"]),), s)
            if t == "map":
                k = add(5, 0, (), "string")
                v = node_of(s["values"])
                return add(10, 0, (k, v), s)
            if t == "fixed":
                return add(6, s["size"], (), s)
            if isinstance(t, (dict, list)):
                return node_of(t)
            if t in _PRIM_KIND:
                return add(_PRIM_KIND[t], 0, (), t)
            raise _Unsupported(t)
        if s in _PRIM_KIND:
            return add(_PRIM_KIND[s], 0, (), s)
        raise _Unsupported(s)

    root = node_of(schema)
    prog = (np.asarray(kinds, np.uint8), np.asarray(extras, np.int32),
            np.asarray(cstarts, np.int32), np.asarray(ccounts, np.int32),
            np.asarray(cidx, np.int32) if cidx else np.zeros(0, np.int32),
            root["nid"])
    return prog, root


def _node_buffers(kind: int, extra: int, cnt: int, nbyt: int):
    """Allocate the (values, lengths) buffers one node needs for a fill
    pass with `cnt` occurrences / `nbyt` varlen bytes."""
    if kind in (1, 11):
        return np.zeros(cnt, np.uint8), None
    if kind in (2, 7, 9, 10):
        return np.zeros(cnt, np.int64), None
    if kind in (3, 4):
        return np.zeros(cnt, np.float64), None
    if kind == 5:
        return np.zeros(nbyt, np.uint8), np.zeros(cnt, np.int64)
    if kind == 6:
        return np.zeros(cnt * extra, np.uint8), None
    return None, None                       # 0 null / 8 record


def _offsets_from_counts(counts: np.ndarray) -> np.ndarray:
    """Offsets of the counts: int32 while they fit, else int64."""
    offs = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    if offs[-1] < 2**31:
        offs = offs.astype(np.int32)
    return offs


def _assemble(spec, d: dt.DataType, n: int, mask: np.ndarray, bufs,
              dev: torch.device):
    """Vectorized column assembly from the native decoder's per-node
    buffers, each placed on `dev` once.  `mask` marks which of the n
    logical slots carry an encoded occurrence (in order); every column's
    validity is the mask (parent nulls propagate, matching the per-row
    builder's None handling)."""
    kind = spec["kind"]
    vals, lens = bufs[spec["nid"]]
    validity = None if bool(mask.all()) else hostio.tensor(mask, dev)

    def on(a: np.ndarray) -> torch.Tensor:
        return hostio.tensor(a, dev)

    if kind == 11:                          # ["null", T]
        newmask = np.zeros(n, bool)
        newmask[mask] = vals.view(bool)
        return _assemble(spec["children"][0], d, n, newmask, bufs, dev)
    if kind == 0:                           # null type
        return column([None] * n, dtype=d, device=dev)
    if kind == 1:                           # boolean
        out = np.zeros(n, bool)
        out[mask] = vals.view(bool)
        return PrimitiveColumn(on(out), d, validity, _canonical=True)
    if kind in (2, 3, 4):                   # int/long/float/double
        tgt = d.to_numpy()
        out = np.zeros(n, tgt)
        out[mask] = vals.astype(tgt)
        return PrimitiveColumn(on(out.view(dt.torch_dtype_name(d.to_torch()))),
                               d, validity, _canonical=True)
    if kind == 7:                           # enum -> dictionary
        symbols = spec["schema"]["symbols"]
        if len(vals) and (vals.min() < 0 or vals.max() >= len(symbols)):
            raise ArrowInvalid("avro enum index out of range")
        codes = np.zeros(n, np.int32)
        codes[mask] = vals.astype(np.int32)
        return DictionaryColumn(on(codes),
                                StringColumn.from_pylist(symbols, device=dev),
                                validity, _canonical=True)
    if kind == 5:                           # string/bytes (+decimal/uuid)
        if d.is_decimal:
            offs = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            raw = vals.tobytes()
            py: List = [None] * n
            for slot, s, e in zip(np.flatnonzero(mask), offs[:-1],
                                  offs[1:]):
                py[slot] = raw[s:e]
            return _build_column(py, d, dev)
        full = np.zeros(n, np.int64)
        full[mask] = lens
        offs = _offsets_from_counts(full)
        if offs.dtype != np.int32 and offset_dtype(d) == torch.int32:
            raise ArrowInvalid(f"{int(offs[-1])} bytes overflow the int32 "
                               f"offsets of {d!r}")
        return StringColumn(on(offs.astype(dt.torch_dtype_name(
            offset_dtype(d)))), on(vals), d, validity)
    if kind == 6:                           # fixed (+duration/decimal)
        w = int(spec["schema"]["size"])
        src = vals.reshape(-1, w)
        out = np.zeros((n, w), np.uint8)
        out[mask] = src
        if d.name == "interval":
            u32 = out.view("<u4")
            return IntervalMDNColumn(
                on(u32[:, 0].astype(np.int32)), on(u32[:, 1].astype(np.int32)),
                on(u32[:, 2].astype(np.int64) * 1_000_000), validity)
        if d.is_decimal:
            py = [bytes(out[i]) if mask[i] else None for i in range(n)]
            return _build_column(py, d, dev)
        return FixedSizeBinaryColumn(on(out), validity)
    if kind == 8:                           # record -> struct
        children = tuple(
            _assemble(cs, f.dtype, n, mask, bufs, dev)
            for cs, f in zip(spec["children"], d.fields))
        return StructColumn(children, tuple(d.fields), validity)
    if kind == 9:                           # array -> list
        counts = np.zeros(n, np.int64)
        counts[mask] = vals
        offs = _offsets_from_counts(counts)
        n_child = int(offs[-1])
        child = _assemble(spec["children"][0], d.value_type, n_child,
                          np.ones(n_child, bool), bufs, dev)
        return ListColumn(on(offs), child, validity)
    if kind == 10:                          # map
        counts = np.zeros(n, np.int64)
        counts[mask] = vals
        offs = _offsets_from_counts(counts)
        ne = int(offs[-1])
        emask = np.ones(ne, bool)
        kf, vf = d.value_type.fields
        kcol = _assemble(spec["children"][0], kf.dtype, ne, emask, bufs,
                         dev)
        vcol = _assemble(spec["children"][1], vf.dtype, ne, emask, bufs,
                         dev)
        entries = StructColumn((kcol, vcol), tuple(d.value_type.fields))
        return MapColumn(on(offs), entries, validity)
    raise ArrowInvalid(f"avro node kind {kind}")


def _read_columnar(cur: _Cursor, data: bytes, sync: bytes, codec: str,
                   schema, dev: torch.device) -> Optional[Table]:
    """Columnar native decode path: hostcodec avro_decode_block walks
    each block once per pass (measure + fill) emitting per-node
    value/length/count buffers; column assembly is vectorized numpy —
    no per-row Python (the arrow-avro reader/record.rs decode role).
    Returns None when the schema needs the per-row fallback."""
    try:
        prog, root = _compile_program(schema)
    except _Unsupported:
        return None
    kinds_a, extras_a = prog[0], prog[1]
    n_nodes = len(kinds_a)
    parts = [[] for _ in range(n_nodes)]
    lparts = [[] for _ in range(n_nodes)]
    total = 0
    for count, payload in _iter_blocks(cur, data, sync, codec):
        pos, occ, nb = nt.avro_decode_block(payload, count, prog, False)
        if pos != len(payload):
            raise ArrowInvalid("malformed avro block")
        vals = []
        lens = []
        for i in range(n_nodes):
            v, L = _node_buffers(int(kinds_a[i]), int(extras_a[i]),
                                 int(occ[i]), int(nb[i]))
            vals.append(v)
            lens.append(L)
        pos, _, _ = nt.avro_decode_block(payload, count, prog, True,
                                         vals, lens)
        if pos != len(payload):
            raise ArrowInvalid("malformed avro block")
        for i in range(n_nodes):
            if vals[i] is not None:
                parts[i].append(vals[i])
            if lens[i] is not None:
                lparts[i].append(lens[i])
        total += count
    bufs = []
    for i in range(n_nodes):
        ev, el = _node_buffers(int(kinds_a[i]), int(extras_a[i]), 0, 0)
        bufs.append((np.concatenate(parts[i]) if parts[i] else ev,
                     np.concatenate(lparts[i]) if lparts[i] else el))
    mask = np.ones(total, bool)
    cols = []
    out_fields = []
    for f_schema, cspec in zip(schema["fields"], root["children"]):
        dd = _field_dtype(f_schema["type"])
        col = _assemble(cspec, dd, total, mask, bufs, dev)
        cols.append(col)
        out_fields.append(dt.Field(f_schema["name"], col.dtype))
    return Table(tuple(cols), dt.Schema(tuple(out_fields)))


def _iter_blocks(cur: _Cursor, data: bytes, sync: bytes, codec: str):
    """Yield (row_count, decompressed_payload) per container block."""
    while cur.pos < len(data):
        count = cur.vlq_long()
        size = cur.vlq_long()
        payload = cur.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, wbits=-15)
        elif codec == "snappy":
            # snappy block + 4-byte big-endian CRC32 of the raw bytes
            crc = struct.unpack(">I", payload[-4:])[0]
            # snappy header carries the uncompressed length varint
            ulen = 0
            shift = 0
            for b in payload:
                ulen |= (b & 0x7F) << shift
                if not (b & 0x80):
                    break
                shift += 7
            payload = nt.snappy_decompress(payload[:-4], ulen).tobytes()
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ArrowInvalid("avro snappy block CRC mismatch")
        elif codec == "zstandard":
            import zstandard
            payload = zstandard.ZstdDecompressor().decompress(
                payload, max_output_size=max(len(payload) * 200, 1 << 20))
        elif codec == "bzip2":
            import bz2
            payload = bz2.decompress(payload)
        elif codec == "xz":
            import lzma
            payload = lzma.decompress(payload)
        elif codec != "null":
            raise ArrowNotImplementedError(f"avro codec {codec}")
        yield count, payload
        if cur.read(16) != sync:
            raise ArrowInvalid("avro sync marker mismatch")


def _read_avro_impl(data: bytes, reader_schema: Optional[dict],
                    dev: torch.device) -> Table:
    cur = _Cursor(data)
    meta, sync = _read_header(cur)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode() \
        if isinstance(meta.get("avro.codec", b"null"), bytes) \
        else meta.get("avro.codec", "null")
    if schema.get("type") != "record":
        raise ArrowNotImplementedError("top-level avro schema must be record")
    fields = schema["fields"]
    if reader_schema is None:
        t = _read_columnar(cur, data, sync, codec, schema, dev)
        if t is not None:
            return t
    rows: List[dict] = []
    for count, payload in _iter_blocks(cur, data, sync, codec):
        block = _Cursor(payload)
        for _ in range(count):
            rows.append({f["name"]: _decode_value(block, f["type"])
                         for f in fields})
    writer_by_name = {f["name"]: f for f in fields}
    out_fields_src = reader_schema["fields"] if reader_schema else fields
    cols = []
    out_fields = []
    for f in out_fields_src:
        name = f["name"]
        d = _field_dtype(f["type"])
        wf = writer_by_name.get(name)
        if wf is None:
            if "default" in f:
                vals = [f["default"]] * len(rows)
            else:
                raise ArrowInvalid(
                    f"reader field {name!r} missing and has no default")
        else:
            vals = [r[name] for r in rows]
            if reader_schema is not None:
                vals = [_resolve_value(v, wf["type"], f["type"])
                        for v in vals]
        col = _build_column(vals, d, dev)
        cols.append(col)
        out_fields.append(dt.Field(name, col.dtype))
    return Table(tuple(cols), dt.Schema(tuple(out_fields)))


class ReaderBuilder:
    """arrow-avro ReaderBuilder (reader/mod.rs:195) shape; batches on
    `device`."""

    def __init__(self, batch_size: int = 65536, *, device: DeviceLike):
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def build(self, source) -> List[Table]:
        t = read_avro(source, device=self.device)
        if t.num_rows == 0:
            return [t]
        return [t.slice(i, min(self.batch_size, t.num_rows - i))
                for i in range(0, t.num_rows, self.batch_size)]


# ---------------------------------------------------------------------------
# Writer (beyond the reference: arrow-avro is decode-only — this engine
# writes the same object container format its reader consumes, so every
# IO format in the engine round-trips).
# ---------------------------------------------------------------------------

def _put_varint(out: bytearray, u: int) -> None:
    while u >= 0x80:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)


def _put_zz(out: bytearray, v: int) -> None:
    """zig-zag varint (inverse of _Cursor.vlq_long)."""
    _put_varint(out, ((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF)


def _put_bytes(out: bytearray, b: bytes) -> None:
    _put_zz(out, len(b))
    out += b


_DT_TO_AVRO = {"bool": "boolean", "int8": "int", "int16": "int",
               "int32": "int", "uint8": "int", "uint16": "int",
               "int64": "long", "uint32": "long", "uint64": "long",
               "float16": "float", "float32": "float",
               "float64": "double", "utf8": "string",
               "large_utf8": "string", "utf8_view": "string",
               "binary": "bytes", "large_binary": "bytes",
               "binary_view": "bytes", "duration": "long"}


def _dtype_to_avro(d: dt.DataType, name: str):
    """Arrow dtype -> Avro schema (inverse of _field_dtype)."""
    n = d.name
    if n == "null":
        return "null"
    if n == "date32":
        return {"type": "int", "logicalType": "date"}
    if n == "date64":                 # ms since epoch
        return {"type": "long", "logicalType": "timestamp-millis"}
    if n == "time32":
        if d.unit != "ms":
            raise ArrowNotImplementedError("avro time32 must be ms")
        return {"type": "int", "logicalType": "time-millis"}
    if n == "time64":
        if d.unit != "us":
            raise ArrowNotImplementedError("avro time64 must be us")
        return {"type": "long", "logicalType": "time-micros"}
    if n == "timestamp":
        lt = {"s": "timestamp-millis", "ms": "timestamp-millis",
              "us": "timestamp-micros", "ns": "timestamp-nanos"}[d.unit]
        return {"type": "long", "logicalType": lt}
    if d.is_decimal:
        return {"type": "bytes", "logicalType": "decimal",
                "precision": d.precision, "scale": d.scale}
    if n == "interval":
        if d.unit != "month_day_nano":
            raise ArrowNotImplementedError(
                "avro duration needs month_day_nano (cast first)")
        return {"type": "fixed", "name": f"{name}_duration", "size": 12,
                "logicalType": "duration"}
    if n == "fixed_size_binary":
        return {"type": "fixed", "name": f"{name}_fixed",
                "size": d.list_size}
    if n == "dictionary":             # decode: avro enums are closed sets
        return _dtype_to_avro(d.value_type, name)
    if n in ("list", "large_list", "fixed_size_list", "list_view",
             "large_list_view"):
        return {"type": "array",
                "items": _dtype_to_avro(d.value_type, name)}
    if n == "map":
        kf = d.value_type.fields[0].dtype
        if not kf.is_string:
            raise ArrowNotImplementedError("avro map keys must be string")
        return {"type": "map",
                "values": _dtype_to_avro(d.value_type.fields[1].dtype,
                                         name)}
    if n == "struct":
        return {"type": "record", "name": f"{name}_record",
                "fields": [{"name": f.name,
                            "type": _avro_field_type(f, f.name)}
                           for f in d.fields]}
    if n in _DT_TO_AVRO:
        return _DT_TO_AVRO[n]
    raise ArrowNotImplementedError(f"avro write of {d!r}")


def _avro_field_type(f: dt.Field, name: str):
    s = _dtype_to_avro(f.dtype, name)
    if f.nullable and s != "null":
        return ["null", s]
    return s


def _encode_value(out: bytearray, v, schema) -> None:
    """Inverse of _decode_value."""
    if isinstance(schema, list):      # ["null", T]
        if v is None:
            _put_zz(out, schema.index("null"))
            return
        idx = next(i for i, s in enumerate(schema) if s != "null")
        _put_zz(out, idx)
        _encode_value(out, v, schema[idx])
        return
    if isinstance(schema, dict):
        t = schema["type"]
        lt = schema.get("logicalType")
        if lt == "decimal":           # unscaled int -> minimal BE bytes
            u = int(v)
            nbytes = max((u.bit_length() + 8) // 8, 1)
            _put_bytes(out, u.to_bytes(nbytes, "big", signed=True))
            return
        if lt == "duration":          # (months, days, nanos) -> 3x u32 LE
            months, days, nanos = v
            if nanos % 1_000_000:
                raise ArrowNotImplementedError(
                    "avro duration stores milliseconds; nanos must be "
                    "a millisecond multiple")
            out += struct.pack("<III", months & 0xFFFFFFFF,
                               days & 0xFFFFFFFF,
                               (nanos // 1_000_000) & 0xFFFFFFFF)
            return
        if t == "record":
            for f in schema["fields"]:
                _encode_value(out, v.get(f["name"]), f["type"])
            return
        if t == "array":
            if v:
                _put_zz(out, len(v))
                for x in v:
                    _encode_value(out, x, schema["items"])
            _put_zz(out, 0)
            return
        if t == "map":
            items = v.items() if isinstance(v, dict) else v
            items = list(items)
            if items:
                _put_zz(out, len(items))
                for k, x in items:
                    _put_bytes(out, k.encode())
                    _encode_value(out, x, schema["values"])
            _put_zz(out, 0)
            return
        if t == "fixed":
            b = bytes(v)
            if len(b) != schema["size"]:
                raise ArrowInvalid("fixed value width mismatch")
            out += b
            return
        schema = t
    if schema == "null":
        return
    if schema == "boolean":
        out.append(1 if v else 0)
        return
    if schema in ("int", "long"):
        iv = int(v)
        if not -2 ** 63 <= iv < 2 ** 63:
            raise ArrowInvalid(f"avro long overflow: {iv}")
        _put_zz(out, iv)
        return
    if schema == "float":
        out += struct.pack("<f", float(v))
        return
    if schema == "double":
        out += struct.pack("<d", float(v))
        return
    if schema == "string":
        _put_bytes(out, v.encode() if isinstance(v, str) else bytes(v))
        return
    if schema == "bytes":
        _put_bytes(out, bytes(v))
        return
    raise ArrowNotImplementedError(f"avro type {schema}")


def _avro_cell(v, d: dt.DataType):
    """to_pylist value -> avro-encodable value for dtype d."""
    if v is None:
        return None
    n = d.name
    if d.is_decimal:
        import decimal as _dec
        return int(_dec.Decimal(v).scaleb(d.scale))
    if n == "interval":
        if isinstance(v, dict):
            return (v.get("months", 0), v.get("days", 0),
                    v.get("nanoseconds", 0))
        months, days, nanos = v
        return (months, days, nanos)
    if n == "timestamp":
        import datetime as _dt2
        if isinstance(v, _dt2.datetime):
            if hasattr(v, "value"):            # pandas Timestamp: exact ns
                ns = int(v.value)
                return {"s": ns // 1_000_000, "ms": ns // 1_000_000,
                        "us": ns // 1_000, "ns": ns}[d.unit]
            epoch = _dt2.datetime(1970, 1, 1, tzinfo=v.tzinfo)
            us = (v - epoch) // _dt2.timedelta(microseconds=1)
            return {"s": us // 1_000, "ms": us // 1_000, "us": us,
                    "ns": us * 1_000}[d.unit]
        return int(v) * (1_000 if d.unit == "s" else 1)
    if n == "date32":
        import datetime as _dt2
        if isinstance(v, _dt2.date):
            return (v - _dt2.date(1970, 1, 1)).days
        return int(v)
    if n == "date64":
        import datetime as _dt2
        if isinstance(v, _dt2.datetime):
            return int((v - _dt2.datetime(1970, 1, 1))
                       // _dt2.timedelta(milliseconds=1))
        return int(v)
    if n in ("time32", "time64"):
        import datetime as _dt2
        if isinstance(v, _dt2.time):
            us = ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000 \
                + v.microsecond
            return us // 1_000 if n == "time32" else us
        return int(v)
    if n in ("list", "large_list", "fixed_size_list", "list_view",
             "large_list_view"):
        return [_avro_cell(x, d.value_type) for x in v]
    if n == "map":
        items = v.items() if isinstance(v, dict) else v
        vd_ = d.value_type.fields[1].dtype
        return [(k, _avro_cell(x, vd_)) for k, x in items]
    if n == "struct":
        return {f.name: _avro_cell(v.get(f.name), f.dtype)
                for f in d.fields}
    if n == "dictionary":
        return _avro_cell(v, d.value_type)
    return v


def write_avro(sink, table: Table, codec: str = "deflate",
               block_rows: int = 64_000) -> None:
    """Table -> Avro object container file (the format read_avro and
    arrow-avro consume).  codec: null | deflate | snappy | zstandard | bzip2 | xz."""
    import os as _os
    table = hostio.to_host(table)
    schema = {"type": "record", "name": "arrow_tpu",
              "fields": [{"name": f.name,
                          "type": _avro_field_type(f, f.name)}
                         for f in table.schema.fields]}
    out = bytearray()
    out += _MAGIC
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    _put_zz(out, len(meta))
    for k, v in meta.items():
        _put_bytes(out, k.encode())
        _put_bytes(out, v)
    _put_zz(out, 0)
    sync = _os.urandom(16)
    out += sync

    cols = [c.to_pylist() for c in table.columns]
    dts = [f.dtype for f in table.schema.fields]
    ftypes = [f["type"] for f in schema["fields"]]
    n = table.num_rows
    for start in range(0, n, block_rows):
        stop = min(start + block_rows, n)
        body = bytearray()
        for i in range(start, stop):
            for vals, d, ft in zip(cols, dts, ftypes):
                _encode_value(body, _avro_cell(vals[i], d), ft)
        payload = bytes(body)
        if codec == "deflate":
            co = zlib.compressobj(wbits=-15)
            payload = co.compress(payload) + co.flush()
        elif codec == "snappy":
            comp = nt.snappy_compress(payload)
            payload = comp + struct.pack(">I",
                                         zlib.crc32(bytes(body))
                                         & 0xFFFFFFFF)
        elif codec == "zstandard":
            import zstandard
            payload = zstandard.ZstdCompressor().compress(payload)
        elif codec == "bzip2":
            import bz2
            payload = bz2.compress(payload)
        elif codec == "xz":
            import lzma
            payload = lzma.compress(payload)
        elif codec != "null":
            raise ArrowNotImplementedError(f"avro codec {codec}")
        _put_zz(out, stop - start)
        _put_zz(out, len(payload))
        out += payload
        out += sync
    if n == 0:
        pass                            # header-only file is valid
    if isinstance(sink, str):
        with open(sink, "wb") as f:
            f.write(out)
    else:
        sink.write(bytes(out))
