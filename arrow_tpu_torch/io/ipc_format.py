"""Arrow IPC metadata + body encode/decode, hand-written (no pyarrow)
(counterpart of arrow_tpu/io/ipc_format.py).

Implements the flatbuffers tables of format/{Schema,Message,File}.fbs via
io/fb.py and the physical buffer layout of every column class.  This is
the engine's own wire/spill/checkpoint format; io/ipc.py layers framing,
stream/file formats, and the push decoder on top.

Re-designs arrow-ipc/src/writer.rs:477 (IpcDataGenerator::encoded_batch)
and arrow-ipc/src/reader.rs:638 (read_record_batch).  The in-memory
model is dense-mask columns on one device:
  - encode copies each batch to the host once (`hostio.to_host`), reads
    that view only (`hostio.host`) and packs validity bits there; the
    bytes equal the reference's.
  - decode reads each buffer as a zero-copy view of the body and copies
    it once onto the reader's `device` (io/hostio.py), so no column
    aliases the body.  Primitive columns go through the port's
    constructor, which zeroes null slots; unsigned types land on signed
    storage of the same width, view offsets on the type's width.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           NullColumn, PrimitiveColumn, StringColumn,
                           StructColumn)
from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                           FixedSizeListColumn, IntervalMDNColumn,
                           ListViewColumn, MapColumn, RunEndColumn,
                           UnionColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from .fb import Builder
from .fb import Table as FTable
from .hostio import host, pool_map, tensor, to_host

__all__ = [
    "write_schema_message", "read_schema", "encode_record_batch",
    "decode_record_batch", "encode_dictionary_batch", "parse_message",
    "collect_dictionary_fields", "MetadataV5", "COMPRESS_LZ4",
    "COMPRESS_ZSTD", "compress_buffer", "decompress_buffer",
]

MetadataV5 = 4          # MetadataVersion.V5
COMPRESS_LZ4 = 0        # CompressionType.LZ4_FRAME
COMPRESS_ZSTD = 1       # CompressionType.ZSTD

# Type union tags, in Schema.fbs union declaration order (NONE = 0)
(T_NULL, T_INT, T_FLOAT, T_BINARY, T_UTF8, T_BOOL, T_DECIMAL, T_DATE,
 T_TIME, T_TIMESTAMP, T_INTERVAL, T_LIST, T_STRUCT, T_UNION,
 T_FIXED_SIZE_BINARY, T_FIXED_SIZE_LIST, T_MAP, T_DURATION,
 T_LARGE_BINARY, T_LARGE_UTF8, T_LARGE_LIST, T_RUN_END_ENCODED,
 T_BINARY_VIEW, T_UTF8_VIEW, T_LIST_VIEW, T_LARGE_LIST_VIEW) = \
    range(1, 27)

# MessageHeader union tags
H_SCHEMA, H_DICTIONARY_BATCH, H_RECORD_BATCH = 1, 2, 3

_TIME_UNIT = {"s": 0, "ms": 1, "us": 2, "ns": 3}
_TIME_UNIT_INV = {v: k for k, v in _TIME_UNIT.items()}
_INTERVAL_UNIT = {"year_month": 0, "day_time": 1, "month_day_nano": 2}
_INTERVAL_UNIT_INV = {v: k for k, v in _INTERVAL_UNIT.items()}

_INT_TYPES = {
    "int8": (8, True), "int16": (16, True), "int32": (32, True),
    "int64": (64, True), "uint8": (8, False), "uint16": (16, False),
    "uint32": (32, False), "uint64": (64, False),
}
_INT_TYPES_INV = {v: k for k, v in _INT_TYPES.items()}


# ---------------------------------------------------------------------------
# Type encode (dtype -> flatbuffer Type union)
# ---------------------------------------------------------------------------

def _write_int_type(b: Builder, bits: int, signed: bool) -> int:
    b.start_table()
    b.add_scalar(0, "i32", bits)
    b.add_scalar(1, "bool", 1 if signed else 0)
    return b.end_table()


def _empty_table(b: Builder) -> int:
    b.start_table()
    return b.end_table()


def _write_type(b: Builder, d: dt.DataType) -> Tuple[int, int]:
    """-> (union tag, table offset)."""
    n = d.name
    if n == "null":
        return T_NULL, _empty_table(b)
    if n in _INT_TYPES:
        bits, signed = _INT_TYPES[n]
        return T_INT, _write_int_type(b, bits, signed)
    if n in ("float16", "float32", "float64"):
        prec = {"float16": 0, "float32": 1, "float64": 2}[n]
        b.start_table()
        b.add_scalar(0, "i16", prec)
        return T_FLOAT, b.end_table()
    if n == "bool":
        return T_BOOL, _empty_table(b)
    if n == "utf8":
        return T_UTF8, _empty_table(b)
    if n == "binary":
        return T_BINARY, _empty_table(b)
    if n == "large_utf8":
        return T_LARGE_UTF8, _empty_table(b)
    if n == "large_binary":
        return T_LARGE_BINARY, _empty_table(b)
    if n == "utf8_view":
        return T_UTF8_VIEW, _empty_table(b)
    if n == "binary_view":
        return T_BINARY_VIEW, _empty_table(b)
    if n == "fixed_size_binary":
        b.start_table()
        b.add_scalar(0, "i32", d.list_size)
        return T_FIXED_SIZE_BINARY, b.end_table()
    if d.is_decimal:
        bits = {"decimal32": 32, "decimal64": 64,
                "decimal128": 128, "decimal256": 256}[n]
        b.start_table()
        b.add_scalar(0, "i32", d.precision)
        b.add_scalar(1, "i32", d.scale)
        b.add_scalar(2, "i32", bits, default=128)
        return T_DECIMAL, b.end_table()
    if n == "date32":
        b.start_table()
        b.add_scalar(0, "i16", 0, default=1)   # DateUnit.DAY
        return T_DATE, b.end_table()
    if n == "date64":
        b.start_table()
        b.add_scalar(0, "i16", 1, default=1)   # MILLISECOND (default)
        return T_DATE, b.end_table()
    if n == "time32" or n == "time64":
        b.start_table()
        b.add_scalar(0, "i16", _TIME_UNIT[d.unit], default=1)
        b.add_scalar(1, "i32", 32 if n == "time32" else 64, default=32)
        return T_TIME, b.end_table()
    if n == "timestamp":
        tz_off = b.string(d.tz) if d.tz else None
        b.start_table()
        b.add_scalar(0, "i16", _TIME_UNIT[d.unit])
        b.add_offset(1, tz_off)
        return T_TIMESTAMP, b.end_table()
    if n == "duration":
        b.start_table()
        b.add_scalar(0, "i16", _TIME_UNIT[d.unit], default=1)
        return T_DURATION, b.end_table()
    if n == "interval":
        b.start_table()
        b.add_scalar(0, "i16", _INTERVAL_UNIT[d.unit])
        return T_INTERVAL, b.end_table()
    if n == "list":
        return T_LIST, _empty_table(b)
    if n == "large_list":
        return T_LARGE_LIST, _empty_table(b)
    if n == "list_view":
        return T_LIST_VIEW, _empty_table(b)
    if n == "large_list_view":
        return T_LARGE_LIST_VIEW, _empty_table(b)
    if n == "fixed_size_list":
        b.start_table()
        b.add_scalar(0, "i32", d.list_size)
        return T_FIXED_SIZE_LIST, b.end_table()
    if n == "struct":
        return T_STRUCT, _empty_table(b)
    if n == "map":
        b.start_table()
        return T_MAP, b.end_table()
    if n == "union":
        tids = b.vector_scalar("i32", list(d.type_ids))
        b.start_table()
        b.add_scalar(0, "i16", 0 if d.mode == "sparse" else 1)
        b.add_offset(1, tids)
        return T_UNION, b.end_table()
    if n == "run_end_encoded":
        return T_RUN_END_ENCODED, _empty_table(b)
    if n == "dictionary":
        # the Type in the Field is the VALUE type; dictionary is flagged
        # via the DictionaryEncoding table (Schema.fbs Field.dictionary)
        return _write_type(b, d.value_type)
    raise ArrowNotImplementedError(f"IPC write of type {d!r}")


def _type_children(d: dt.DataType) -> List[dt.Field]:
    """Child fields in the schema tree (Schema.fbs Field.children)."""
    n = d.name
    if n == "dictionary":
        return _type_children(d.value_type)
    if n in ("list", "large_list", "list_view", "large_list_view"):
        return [dt.Field("item", d.value_type, True)]
    if n == "fixed_size_list":
        return [dt.Field("item", d.value_type, True)]
    if n == "struct" or n == "union":
        return list(d.fields)
    if n == "map":
        entries = dt.struct([dt.Field("key", d.value_type.fields[0].dtype,
                                      False),
                             dt.Field("value",
                                      d.value_type.fields[1].dtype, True)])
        return [dt.Field("entries", entries, False)]
    if n == "run_end_encoded":
        return [dt.Field("run_ends", d.index_type, False),
                dt.Field("values", d.value_type, True)]
    return []


def _write_kvs(b: Builder, metadata) -> Optional[int]:
    if not metadata:
        return None
    offs = []
    for k, v in metadata:
        ko = b.string(k)
        vo = b.string(v)
        b.start_table()
        b.add_offset(0, ko)
        b.add_offset(1, vo)
        offs.append(b.end_table())
    return b.vector_offsets(offs)


def _finish_message(b: Builder, header_tag: int, header_off: int,
                    body_length: int) -> bytes:
    b.start_table()
    b.add_scalar(0, "i16", MetadataV5)
    b.add_scalar(1, "u8", header_tag)
    b.add_offset(2, header_off)
    b.add_scalar(3, "i64", body_length)
    return b.finish(b.end_table())


def collect_dictionary_fields(schema: dt.Schema) -> List[dt.Field]:
    """Preorder list of dictionary-typed fields (dict id = list index)."""
    out = []

    def walk(f: dt.Field):
        if f.dtype.name == "dictionary":
            out.append(f)
        for c in _type_children(f.dtype):
            walk(c)

    for f in schema.fields:
        walk(f)
    return out


def write_schema_message(schema: dt.Schema) -> bytes:
    """Schema message; dictionary ids are assigned by preorder counter,
    matching the order read_schema reports them."""
    b = Builder()
    sch_off = _write_schema_with_seq_ids(b, schema)
    return _finish_message(b, H_SCHEMA, sch_off, 0)


def _write_schema_with_seq_ids(b: Builder, schema: dt.Schema) -> int:
    counter = [0]

    def write_field(f: dt.Field) -> int:
        d = f.dtype
        dict_id = None
        if d.name == "dictionary":
            dict_id = counter[0]
            counter[0] += 1
        children = [write_field(c) for c in _type_children(d)]
        children_off = b.vector_offsets(children) if children else None
        tag, type_off = _write_type(b, d)
        dict_off = None
        if dict_id is not None:
            idx_bits, idx_signed = _INT_TYPES[d.index_type.name]
            idx_off = _write_int_type(b, idx_bits, idx_signed)
            b.start_table()
            b.add_scalar(0, "i64", dict_id)
            b.add_offset(1, idx_off)
            if d.ordered:              # Schema.fbs isOrdered (slot 2)
                b.add_scalar(2, "bool", 1)
            dict_off = b.end_table()
        name_off = b.string(f.name) if f.name is not None else None
        md_off = _write_kvs(b, getattr(f, "metadata", ()))
        b.start_table()
        b.add_offset(0, name_off)
        b.add_scalar(1, "bool", 1 if f.nullable else 0)
        b.add_scalar(2, "u8", tag)
        b.add_offset(3, type_off)
        b.add_offset(4, dict_off)
        b.add_offset(5, children_off)
        b.add_offset(6, md_off)
        return b.end_table()

    fields = [write_field(f) for f in schema.fields]
    fields_off = b.vector_offsets(fields)
    md_off = _write_kvs(b, getattr(schema, "metadata", ()))
    b.start_table()
    b.add_scalar(0, "i16", 0)
    b.add_offset(1, fields_off)
    b.add_offset(2, md_off)
    return b.end_table()


# ---------------------------------------------------------------------------
# Type decode (flatbuffer Field -> dtype)
# ---------------------------------------------------------------------------

def _read_int_type(t: FTable) -> dt.DataType:
    bits = t.scalar(0, "i32", 0)
    signed = t.scalar(1, "bool", False)
    return getattr(dt, _INT_TYPES_INV[(bits, bool(signed))])


def _read_field(ft: FTable, dict_ids: List[Tuple[int, dt.Field]]
                ) -> dt.Field:
    name = ft.string(0) or ""
    nullable = ft.scalar(1, "bool", False)
    tag = ft.scalar(2, "u8", 0)
    tt = ft.table(3)
    denc = ft.table(4)
    slot = None
    if denc is not None:
        # reserve this field's position BEFORE the children so dict_ids
        # lands in schema preorder — the order dictionary ordinals are
        # consumed during batch rebuild (writer.rs assigns ids preorder)
        slot = len(dict_ids)
        dict_ids.append((denc.scalar(0, "i64", 0), None))
    children = [_read_field(c, dict_ids) for c in ft.vector_tables(5)]
    md_tbl = ft.vector_tables(6)
    metadata = tuple((kv.string(0) or "", kv.string(1) or "")
                     for kv in md_tbl) if md_tbl else ()

    d = _decode_type(tag, tt, children)
    if denc is not None:
        idx_t = denc.table(1)
        index_type = _read_int_type(idx_t) if idx_t is not None else dt.int32
        d = dt.dictionary(index_type, d,
                          ordered=bool(denc.scalar(2, "bool", False)))
        f = dt.Field(name, d, bool(nullable), metadata)
        dict_ids[slot] = (dict_ids[slot][0], f)
        return f
    return dt.Field(name, d, bool(nullable), metadata)


def _subtree_dict_count(d: dt.DataType) -> int:
    """Dictionary fields in d's flatbuffer subtree, preorder, including
    beneath dictionary value types."""
    c = 1 if d.name == "dictionary" else 0
    return c + sum(_subtree_dict_count(f.dtype)
                   for f in _type_children(d))


def walk_dict_ids(dict_ids: List[Tuple[int, dt.Field]]) -> Dict[int, int]:
    """Ordinal -> dictionary id for a record-batch column walk: dict
    fields nested beneath another dictionary's VALUE type are skipped
    (their codes never appear in a record batch — only in that
    dictionary's own batch)."""
    out: Dict[int, int] = {}
    i = ordv = 0
    while i < len(dict_ids):
        did, f = dict_ids[i]
        out[ordv] = did
        ordv += 1
        i += 1 + _subtree_dict_count(f.dtype.value_type)
    return out


def values_dict_ids(dict_ids: List[Tuple[int, dt.Field]],
                    dict_id: int) -> Dict[int, int]:
    """Ordinal -> id map for decoding dictionary batch `dict_id`, whose
    VALUES may themselves contain dictionary columns: the preorder
    entries immediately after the field are its value-type descendants."""
    for pos, (did, f) in enumerate(dict_ids):
        if did == dict_id:
            cnt = _subtree_dict_count(f.dtype.value_type)
            return walk_dict_ids(dict_ids[pos + 1: pos + 1 + cnt])
    return {}


def _decode_type(tag: int, t: Optional[FTable],
                 children: List[dt.Field]) -> dt.DataType:
    if tag == T_NULL:
        return dt.null
    if tag == T_INT:
        return _read_int_type(t)
    if tag == T_FLOAT:
        return [dt.float16, dt.float32, dt.float64][t.scalar(0, "i16", 0)]
    if tag == T_BOOL:
        return dt.bool_
    if tag == T_UTF8:
        return dt.utf8
    if tag == T_BINARY:
        return dt.binary
    if tag == T_LARGE_UTF8:
        return dt.large_utf8
    if tag == T_LARGE_BINARY:
        return dt.large_binary
    if tag == T_UTF8_VIEW:
        return dt.utf8_view
    if tag == T_BINARY_VIEW:
        return dt.binary_view
    if tag == T_FIXED_SIZE_BINARY:
        return dt.fixed_size_binary(t.scalar(0, "i32", 0))
    if tag == T_DECIMAL:
        prec = t.scalar(0, "i32", 0)
        scale = t.scalar(1, "i32", 0)
        bits = t.scalar(2, "i32", 128)
        ctor = {32: dt.decimal32, 64: dt.decimal64,
                128: dt.decimal128, 256: dt.decimal256}[bits]
        return ctor(prec, scale)
    if tag == T_DATE:
        return dt.date32 if t.scalar(0, "i16", 1) == 0 else dt.date64
    if tag == T_TIME:
        unit = _TIME_UNIT_INV[t.scalar(0, "i16", 1)]
        bits = t.scalar(1, "i32", 32)
        return dt.time32(unit) if bits == 32 else dt.time64(unit)
    if tag == T_TIMESTAMP:
        return dt.timestamp(_TIME_UNIT_INV[t.scalar(0, "i16", 0)],
                            t.string(1))
    if tag == T_DURATION:
        return dt.duration(_TIME_UNIT_INV[t.scalar(0, "i16", 1)])
    if tag == T_INTERVAL:
        return dt.interval(_INTERVAL_UNIT_INV[t.scalar(0, "i16", 0)])
    if tag == T_LIST:
        return dt.list_(children[0].dtype)
    if tag == T_LARGE_LIST:
        return dt.large_list(children[0].dtype)
    if tag == T_LIST_VIEW:
        return dt.list_view(children[0].dtype)
    if tag == T_LARGE_LIST_VIEW:
        return dt.large_list_view(children[0].dtype)
    if tag == T_FIXED_SIZE_LIST:
        return dt.fixed_size_list(children[0].dtype,
                                  t.scalar(0, "i32", 0))
    if tag == T_STRUCT:
        return dt.struct(children)
    if tag == T_MAP:
        entries = children[0].dtype
        return dt.map_(entries.fields[0].dtype, entries.fields[1].dtype)
    if tag == T_UNION:
        mode = "sparse" if t.scalar(0, "i16", 0) == 0 else "dense"
        tids = t.vector_scalars(1, "i32") or list(range(len(children)))
        return dt.union(children, mode, tids)
    if tag == T_RUN_END_ENCODED:
        return dt.run_end_encoded(children[0].dtype, children[1].dtype)
    raise ArrowNotImplementedError(f"IPC read of Type tag {tag}")


def read_schema(meta: bytes
                ) -> Tuple[dt.Schema, List[Tuple[int, dt.Field]]]:
    """Parse a Schema message's metadata flatbuffer.

    -> (schema, [(dictionary id, field)] in preorder)."""
    msg = FTable.root(meta)
    tag = msg.scalar(1, "u8", 0)
    if tag != H_SCHEMA:
        raise ArrowInvalid(f"expected Schema message, got tag {tag}")
    sch = msg.table(2)
    dict_ids: List[Tuple[int, dt.Field]] = []
    fields = tuple(_read_field(f, dict_ids)
                   for f in sch.vector_tables(1))
    md_tbl = sch.vector_tables(2)
    metadata = tuple((kv.string(0) or "", kv.string(1) or "")
                     for kv in md_tbl) if md_tbl else ()
    return dt.Schema(fields, metadata), dict_ids


def parse_message(meta: bytes):
    """-> (header_tag, FTable of the Message, body_length)."""
    msg = FTable.root(meta)
    return (msg.scalar(1, "u8", 0), msg, msg.scalar(3, "i64", 0))


# ---------------------------------------------------------------------------
# Column -> buffers (flatten, preorder)
# ---------------------------------------------------------------------------

# largest value-byte span addressable by a view's i32 in-buffer offset;
# tests shrink it to exercise multi-buffer splitting without 2GB data
_VIEW_BUF_LIMIT = (1 << 31) - 64


def _validity_buffer(col: Column) -> Tuple[bytes, int]:
    """-> (packed bits or b'', null_count)."""
    if col.validity is None:
        return b"", 0
    mask = host(col.validity)
    # pack in C first, popcount the packed bits (32x less data than
    # count_nonzero over the bool mask; this fn was ~8% of a 2M-row
    # stream write)
    from ..utils import hostcodec as nt
    packed = nt.pack_bits(mask)
    nc = int(mask.size - nt.count_set_bits(packed, mask.size))
    if nc == 0:
        return b"", 0
    return packed.tobytes(), nc


class _Flattener:
    def __init__(self):
        self.nodes: List[Tuple[int, int]] = []
        self.buffers: List[bytes] = []
        self.variadic: List[int] = []

    def buf(self, b) -> None:
        if isinstance(b, np.ndarray):
            # keep a zero-copy view; sinks accept memoryview and the
            # array is alive via this list
            b = memoryview(np.ascontiguousarray(b)).cast("B")
        self.buffers.append(b)

    def walk(self, col: Column) -> None:
        n = len(col)
        d = col.dtype

        if isinstance(col, NullColumn):
            self.nodes.append((n, n))
            return

        if isinstance(col, DictionaryColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            self.buf(host(col.codes))
            return

        if isinstance(col, PrimitiveColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            vals = host(col.values)
            if d.name == "bool":
                self.buf(np.packbits(vals, bitorder="little").tobytes())
            elif d.name == "interval" and d.unit == "day_time":
                # engine i64 days<<32|ms -> wire [i32 days][i32 millis]
                # (little-endian i64 would put ms first on the wire)
                v64 = vals.astype(np.int64)
                pair = np.empty((len(v64), 2), np.int32)
                pair[:, 0] = (v64 >> 32).astype(np.int32)
                pair[:, 1] = (v64 & 0xFFFFFFFF).astype(np.uint32) \
                    .view(np.int32)
                self.buf(pair)
            else:
                self.buf(vals)
            return

        if isinstance(col, StringColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            if d.name in ("utf8_view", "binary_view"):
                # view layout: 16B views + one variadic data buffer;
                # built with vectorized gathers (no per-row Python)
                offs = host(col.offsets).astype(np.int64)
                data = np.concatenate([host(col.data),
                                       np.zeros(16, np.uint8)])
                lens = (offs[1:] - offs[:-1]).astype(np.int32)
                views = np.zeros((n, 16), np.uint8)
                views[:, 0:4] = lens.view(np.uint8).reshape(n, 4)
                # first up-to-12 bytes (short inline / long prefix)
                take = offs[:-1, None] + np.arange(12)
                gathered = data[np.minimum(take, len(data) - 1)]
                within = np.arange(12) < lens[:, None]
                gathered = np.where(within, gathered, 0)
                short = lens <= 12
                views[short, 4:16] = gathered[short]
                li = np.nonzero(~short)[0]
                if len(li) and int(offs[-1]) > _VIEW_BUF_LIMIT:
                    # >2GB of value bytes: i32 in-buffer offsets would
                    # wrap, so long values compact into MULTIPLE
                    # variadic buffers, none spanning the limit
                    # (byte_view_array.rs variadic buffer semantics)
                    llens = lens[li].astype(np.int64)
                    starts = np.empty(len(li), np.int64)
                    bufidx = np.empty(len(li), np.int32)
                    cuts = [0]
                    cur = b = 0
                    for k in range(len(li)):
                        if cur + llens[k] > _VIEW_BUF_LIMIT:
                            cuts.append(k)
                            b += 1
                            cur = 0
                        starts[k] = cur
                        bufidx[k] = b
                        cur += llens[k]
                    cuts.append(len(li))
                    views[li, 4:8] = gathered[li, :4]
                    views[li, 8:12] = bufidx.view(np.uint8).reshape(-1, 4)
                    views[li, 12:16] = starts.astype(np.int32) \
                        .view(np.uint8).reshape(-1, 4)
                    self.buf(vb)
                    self.buf(views)
                    pieces = [data[offs[i]:offs[i] + lens[i]] for i in li]
                    for bi in range(len(cuts) - 1):
                        self.buf(np.concatenate(
                            pieces[cuts[bi]:cuts[bi + 1]])
                            if cuts[bi + 1] > cuts[bi]
                            else np.zeros(0, np.uint8))
                    self.variadic.append(len(cuts) - 1)
                    return
                if len(li):
                    views[li, 4:8] = gathered[li, :4]
                    views[li, 8:12] = 0      # buffer index 0
                    views[li, 12:16] = offs[:-1][li].astype(np.int32) \
                        .view(np.uint8).reshape(-1, 4)
                self.buf(vb)
                self.buf(views)
                self.buf(data)
                self.variadic.append(1)
                return
            self.buf(vb)
            self.buf(host(col.offsets))
            self.buf(host(col.data))
            return

        if isinstance(col, FixedSizeBinaryColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            self.buf(host(col.data))
            return

        if isinstance(col, DecimalColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            limbs = host(col.limbs)           # (n, k) u64 little-endian
            self.buf(limbs)
            return

        if isinstance(col, IntervalMDNColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            raw = np.zeros(n, np.dtype([("m", "<i4"), ("d", "<i4"),
                                        ("ns", "<i8")]))
            raw["m"] = host(col.months)
            raw["d"] = host(col.days)
            raw["ns"] = host(col.nanos)
            self.buf(vb)
            self.buf(raw.tobytes())
            return

        if isinstance(col, (ListColumn, MapColumn)):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            offs = host(col.offsets)
            if d.name == "large_list":
                offs = offs.astype(np.int64)
            self.buf(offs)
            child = col.child if isinstance(col, ListColumn) else col.entries
            self.walk(child)
            return

        if isinstance(col, ListViewColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            offs, sizes = host(col.offsets), host(col.sizes)
            if d.name == "large_list_view":
                offs, sizes = offs.astype(np.int64), sizes.astype(np.int64)
            else:
                offs, sizes = offs.astype(np.int32), sizes.astype(np.int32)
            self.buf(offs)
            self.buf(sizes)
            self.walk(col.child)
            return

        if isinstance(col, FixedSizeListColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            self.walk(col.child)
            return

        if isinstance(col, StructColumn):
            vb, nc = _validity_buffer(col)
            self.nodes.append((n, nc))
            self.buf(vb)
            for c in col.children:
                self.walk(c)
            return

        if isinstance(col, UnionColumn):
            self.nodes.append((n, 0))
            self.buf(host(col.type_ids).astype(np.int8))
            if col.offsets is not None:
                self.buf(host(col.offsets).astype(np.int32))
            for c in col.children:
                self.walk(c)
            return

        if isinstance(col, RunEndColumn):
            self.nodes.append((n, 0))
            # run_ends child: non-nullable primitive
            re = host(col.run_ends)
            self.nodes.append((re.shape[0], 0))
            self.buf(b"")
            self.buf(re)
            self.walk(col.values)
            return

        raise ArrowNotImplementedError(
            f"IPC write of column {type(col).__name__}")


def compress_buffer(raw: bytes, codec: int) -> bytes:
    """BodyCompression.BUFFER framing (Message.fbs:58): i64 uncompressed
    length prefix + compressed bytes; -1 prefix = stored raw."""
    if len(raw) == 0:
        return b""
    if codec == COMPRESS_ZSTD:
        import zstandard
        comp = zstandard.ZstdCompressor().compress(raw)
    elif codec == COMPRESS_LZ4:
        from ..utils import hostcodec as _native
        comp = _native.lz4_frame_compress(raw)
    else:
        raise ArrowInvalid(f"unknown compression codec {codec}")
    if len(comp) >= len(raw):
        return struct.pack("<q", -1) + raw
    return struct.pack("<q", len(raw)) + comp


def decompress_buffer(raw: bytes, codec: int) -> bytes:
    if len(raw) == 0:
        return b""
    (ulen,) = struct.unpack_from("<q", raw, 0)
    body = raw[8:]
    if ulen == -1:
        return bytes(body)
    if codec == COMPRESS_ZSTD:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(
            body, max_output_size=ulen)
    if codec == COMPRESS_LZ4:
        from ..utils import hostcodec as _native
        return _native.lz4_frame_decompress(body, ulen)
    raise ArrowInvalid(f"unknown compression codec {codec}")


def _body_chunks(buffers: List[bytes], codec: Optional[int]):
    """-> (chunks, [(offset, length)]): each buffer 8-aligned, emitted
    as separate chunks so writers can stream them to the sink without
    assembling one monolithic body (a full extra memcpy at IPC sizes).
    Compressed buffers are compressed on the file layer's pool
    (`hostio.pool_map`); the bytes are those of one pass in order."""
    chunks: List[bytes] = []
    locs = []
    off = 0
    if codec is not None:
        buffers = pool_map(lambda raw: compress_buffer(raw, codec),
                           buffers)
    for raw in buffers:
        ln = len(raw)
        locs.append((off, ln))
        chunks.append(raw)
        pad = -ln % 8
        if pad:
            chunks.append(bytes(pad))
        off += ln + pad
    return chunks, locs


def _assemble_body(buffers: List[bytes], codec: Optional[int]
                   ) -> Tuple[bytes, List[Tuple[int, int]]]:
    """Pad each buffer to 8 bytes; -> (body, [(offset, length)])."""
    chunks, locs = _body_chunks(buffers, codec)
    return b"".join(chunks), locs


def _encode_batch_header(length: int, nodes, locs, variadic,
                         codec: Optional[int],
                         wrap: Optional[Tuple[int, bool]] = None) -> bytes:
    """Build a Message flatbuffer with a RecordBatch (or DictionaryBatch
    when wrap=(id, is_delta)) header."""
    b = Builder()
    nodes_raw = b"".join(struct.pack("<qq", ln, nc) for ln, nc in nodes)
    bufs_raw = b"".join(struct.pack("<qq", off, ln) for off, ln in locs)
    comp_off = None
    if codec is not None:
        b.start_table()
        b.add_scalar(0, "i8", codec, default=0)
        comp_off = b.end_table()
    var_off = b.vector_scalar("i64", variadic) if variadic else None
    bufs_off = b.vector_bytes(bufs_raw, len(locs), 8)
    nodes_off = b.vector_bytes(nodes_raw, len(nodes), 8)
    b.start_table()
    b.add_scalar(0, "i64", length)
    b.add_offset(1, nodes_off)
    b.add_offset(2, bufs_off)
    if codec is not None:
        b.add_offset(3, comp_off)
    b.add_offset(4, var_off)
    rb_off = b.end_table()
    if wrap is None:
        body_len = (locs[-1][0] + locs[-1][1] + (-locs[-1][1] % 8)) \
            if locs else 0
        return _finish_message(b, H_RECORD_BATCH, rb_off, body_len)
    dict_id, is_delta = wrap
    b.start_table()
    b.add_scalar(0, "i64", dict_id)
    b.add_offset(1, rb_off)
    b.add_scalar(2, "bool", 1 if is_delta else 0)
    db_off = b.end_table()
    body_len = (locs[-1][0] + locs[-1][1] + (-locs[-1][1] % 8)) \
        if locs else 0
    return _finish_message(b, H_DICTIONARY_BATCH, db_off, body_len)


def encode_record_batch(table: Table, codec: Optional[int] = None
                        ) -> Tuple[bytes, bytes]:
    """-> (metadata flatbuffer, body bytes) for a RecordBatch message
    (writer.rs:506 record_batch_to_bytes role)."""
    fl = _Flattener()
    for col in to_host(table).columns:
        fl.walk(col)
    body, locs = _assemble_body(fl.buffers, codec)
    meta = _encode_batch_header(table.num_rows, fl.nodes, locs,
                                fl.variadic, codec)
    return meta, body


def encode_record_batch_chunks(table: Table,
                               codec: Optional[int] = None):
    """encode_record_batch without body assembly: -> (metadata, chunk
    list) for writers that stream chunks straight to their sink."""
    fl = _Flattener()
    for col in to_host(table).columns:
        fl.walk(col)
    chunks, locs = _body_chunks(fl.buffers, codec)
    meta = _encode_batch_header(table.num_rows, fl.nodes, locs,
                                fl.variadic, codec)
    return meta, chunks


def encode_dictionary_batch(dict_id: int, values: Column,
                            codec: Optional[int] = None,
                            is_delta: bool = False) -> Tuple[bytes, bytes]:
    """Dictionary values array wrapped as a DictionaryBatch message
    (writer.rs:417 encode_dictionaries role)."""
    fl = _Flattener()
    fl.walk(to_host(values))
    body, locs = _assemble_body(fl.buffers, codec)
    meta = _encode_batch_header(len(values), fl.nodes, locs, fl.variadic,
                                codec, wrap=(dict_id, is_delta))
    return meta, body


# ---------------------------------------------------------------------------
# Buffers -> columns (decode)
# ---------------------------------------------------------------------------

class _Rebuilder:
    def __init__(self, meta_tbl: FTable, body: bytes,
                 dictionaries: Dict[int, Column],
                 dict_id_of: Dict[int, int], device):
        """meta_tbl: the RecordBatch table; dict_id_of maps preorder
        dictionary-field ordinal -> dictionary id; the columns are built
        on `device`."""
        self.dev = device
        self.rb = meta_tbl
        self.body = body
        self.nodes = meta_tbl.vector_structs(1, "<qq", 16)
        self.bufs = meta_tbl.vector_structs(2, "<qq", 16)
        comp = meta_tbl.table(3)
        self.codec = comp.scalar(0, "i8", 0) if comp is not None else None
        self.variadic = meta_tbl.vector_scalars(4, "i64")
        self.decompressed = None
        if self.codec is not None:
            # every buffer of the batch decompressed up front, in parallel
            self.decompressed = pool_map(
                lambda loc: decompress_buffer(body[loc[0]:loc[0] + loc[1]],
                                              self.codec), self.bufs)
        self.node_i = 0
        self.buf_i = 0
        self.var_i = 0
        self.dicts = dictionaries
        self.dict_ord = 0
        self.dict_id_of = dict_id_of

    def node(self) -> Tuple[int, int]:
        ln, nc = self.nodes[self.node_i]
        self.node_i += 1
        return ln, nc

    def raw_buf(self) -> bytes:
        off, ln = self.bufs[self.buf_i]
        self.buf_i += 1
        if self.decompressed is not None:
            return self.decompressed[self.buf_i - 1]
        return self.body[off:off + ln]

    def typed_buf(self, np_dtype, count: int) -> np.ndarray:
        raw = self.raw_buf()
        return np.frombuffer(raw, np_dtype, count)

    def validity(self, n: int, null_count: int):
        raw = self.raw_buf()
        if null_count == 0 or len(raw) == 0:
            return None
        bits = np.frombuffer(raw, np.uint8)
        mask = np.unpackbits(bits, count=n, bitorder="little") \
            .astype(np.bool_)
        return self.t(mask)

    def t(self, a: np.ndarray):
        """One copy of a host buffer onto the reader's device."""
        return tensor(a, self.dev)

    def read(self, d: dt.DataType) -> Column:
        n, nc = self.node()

        if d.name == "null":
            return NullColumn(n, self.dev)

        if d.name == "dictionary":
            v = self.validity(n, nc)
            codes = self.typed_buf(d.index_type.to_numpy(), n)
            dict_id = self.dict_id_of[self.dict_ord]
            self.dict_ord += 1
            values = self.dicts[dict_id]
            return DictionaryColumn(self.t(codes), values, v,
                                    ordered=bool(d.ordered))

        if d.name == "bool":
            v = self.validity(n, nc)
            raw = self.raw_buf()
            bits = np.frombuffer(raw, np.uint8)
            vals = np.unpackbits(bits, count=n, bitorder="little") \
                .astype(np.bool_)
            return PrimitiveColumn(self.t(vals), d, v,
                                   _canonical=v is None)

        if d.is_primitive or d.name in ("decimal32", "decimal64"):
            v = self.validity(n, nc)
            vals = self.typed_buf(np.dtype(d.to_numpy()), n)
            if d.name == "interval" and d.unit == "day_time":
                # wire: [i32 days][i32 millis] -> engine i64 days<<32|ms
                raw = vals.view(np.dtype([("d", "<i4"), ("ms", "<i4")]))
                vals = ((raw["d"].astype(np.int64) << 32)
                        | (raw["ms"].astype(np.int64) & 0xFFFFFFFF))
            return PrimitiveColumn(self.t(vals.view(d.storage_numpy())), d,
                                   v, _canonical=v is None)

        if d.name in ("utf8", "binary", "large_utf8", "large_binary"):
            v = self.validity(n, nc)
            wide = d.name.startswith("large")
            odt = np.int64 if wide else np.int32
            oraw = self.raw_buf()     # spec-legal: may be 0 bytes at n=0
            offs = np.frombuffer(oraw, odt, n + 1) if len(oraw) \
                else np.zeros(n + 1, odt)
            data = np.frombuffer(self.raw_buf(), np.uint8)
            nbytes = int(offs[-1]) if len(offs) else 0
            return StringColumn(self.t(offs), self.t(data[:nbytes]), d, v)

        if d.name in ("utf8_view", "binary_view"):
            v = self.validity(n, nc)
            views = self.typed_buf(np.uint8, n * 16).reshape(n, 16)
            nvar = self.variadic[self.var_i]
            self.var_i += 1
            datas = [np.frombuffer(self.raw_buf(), np.uint8)
                     for _ in range(nvar)]
            lens = views[:, 0:4].copy().view(np.int32).ravel()
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            out = np.zeros(int(offs[-1]), np.uint8)
            short = lens <= 12
            # short strings: vectorized scatter of the inline bytes
            if short.any():
                si = np.nonzero(short)[0]
                pos = offs[si, None] + np.arange(12)
                src_rows = views[si, 4:16]
                within = np.arange(12) < lens[si, None]
                out[pos[within]] = src_rows[within]
            for i in np.nonzero(~short)[0]:   # long strings only
                ln = int(lens[i])
                bi, bo = struct.unpack_from("<ii",
                                            views[i].tobytes(), 8)
                out[offs[i]:offs[i] + ln] = datas[bi][bo:bo + ln]
            return StringColumn.from_numpy(offs, out, None, d,
                                           device=self.dev).with_validity(v)

        if d.name == "fixed_size_binary":
            v = self.validity(n, nc)
            w = d.list_size
            data = self.typed_buf(np.uint8, n * w).reshape(n, w)
            return FixedSizeBinaryColumn(self.t(data), v)

        if d.name in ("decimal128", "decimal256"):
            v = self.validity(n, nc)
            k = 2 if d.name == "decimal128" else 4
            limbs = self.typed_buf(np.int64, n * k).reshape(n, k)
            return DecimalColumn(self.t(limbs), d, v)

        if d.name == "interval" and d.unit == "month_day_nano":
            v = self.validity(n, nc)
            raw = self.typed_buf(
                np.dtype([("m", "<i4"), ("d", "<i4"), ("ns", "<i8")]), n)
            return IntervalMDNColumn(self.t(raw["m"]),
                                     self.t(raw["d"]),
                                     self.t(raw["ns"]), v)

        if d.name in ("list", "large_list"):
            v = self.validity(n, nc)
            wide = d.name == "large_list"
            offs = self.typed_buf(np.int64 if wide else np.int32, n + 1)
            child = self.read(d.value_type)
            return ListColumn(self.t(offs), child, v,
                              large=wide)

        if d.name in ("list_view", "large_list_view"):
            v = self.validity(n, nc)
            wide = d.name == "large_list_view"
            offs = self.typed_buf(np.int64 if wide else np.int32, n)
            sizes = self.typed_buf(np.int64 if wide else np.int32, n)
            child = self.read(d.value_type)
            return ListViewColumn(self.t(offs),
                                  self.t(sizes), child, v, d)

        if d.name == "fixed_size_list":
            v = self.validity(n, nc)
            child = self.read(d.value_type)
            return FixedSizeListColumn(child, d.list_size, v)

        if d.name == "map":
            v = self.validity(n, nc)
            offs = self.typed_buf(np.int32, n + 1)
            entries_dt = d.value_type
            entries = self.read(entries_dt)
            return MapColumn(self.t(offs), entries, v)

        if d.name == "struct":
            v = self.validity(n, nc)
            children = tuple(self.read(f.dtype) for f in d.fields)
            return StructColumn(children, d.fields, v)

        if d.name == "union":
            tids = self.typed_buf(np.int8, n)
            offsets = None
            if d.mode == "dense":
                offsets = self.t(self.typed_buf(np.int32, n))
            children = [self.read(f.dtype) for f in d.fields]
            return UnionColumn(self.t(tids), offsets,
                               children, d.fields, d.type_ids)

        if d.name == "run_end_encoded":
            rn, _ = self.node()        # run_ends child node
            _ = self.raw_buf()         # run_ends validity (unused)
            re = self.typed_buf(np.dtype(d.index_type.to_numpy()), rn)
            values = self.read(d.value_type)
            return RunEndColumn(self.t(re), values, n)

        raise ArrowNotImplementedError(f"IPC read of {d!r}")


def decode_record_batch(schema: dt.Schema, meta: bytes, body: bytes,
                        dictionaries: Dict[int, Column],
                        dict_id_of: Dict[int, int], device) -> Table:
    """read_record_batch (arrow-ipc/src/reader.rs:638) equivalent: the
    columns on `device`."""
    tag, msg, _ = parse_message(meta)
    if tag != H_RECORD_BATCH:
        raise ArrowInvalid(f"expected RecordBatch message, got {tag}")
    rb = msg.table(2)
    r = _Rebuilder(rb, body, dictionaries, dict_id_of, device)
    cols = tuple(r.read(f.dtype) for f in schema.fields)
    return Table(cols, schema)


def decode_dictionary_batch(meta: bytes, body: bytes,
                            dict_fields: Dict[int, dt.Field],
                            dictionaries: Dict[int, Column],
                            dict_ids=None, *, device) -> int:
    """Parse a DictionaryBatch message and store/extend the dictionary
    (on `device`).  -> dictionary id.  `dict_ids` (the schema's preorder
    dictionary list) resolves dictionaries nested inside this batch's
    values."""
    tag, msg, _ = parse_message(meta)
    if tag != H_DICTIONARY_BATCH:
        raise ArrowInvalid(f"expected DictionaryBatch, got {tag}")
    db = msg.table(2)
    dict_id = db.scalar(0, "i64", 0)
    is_delta = db.scalar(2, "bool", False)
    rb = db.table(1)
    value_type = dict_fields[dict_id].dtype.value_type
    local = values_dict_ids(dict_ids, dict_id) if dict_ids else {}
    r = _Rebuilder(rb, body, dictionaries, local, device)
    values = r.read(value_type)
    if is_delta and dict_id in dictionaries:
        from ..ops.concat import concat
        values = concat([dictionaries[dict_id], values])
    dictionaries[dict_id] = values
    return dict_id
