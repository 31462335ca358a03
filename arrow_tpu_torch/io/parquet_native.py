"""Native Parquet reader: thrift footer, page decode, record assembly
(counterpart of arrow_tpu/io/parquet_native.py).

Re-designs (not ports) the reference's read path:

  footer/metadata     parquet/src/file/metadata/mod.rs:176 (thrift
                      compact parse via io/thrift.py)
  column chunk io     parquet/src/file/serialized_reader.rs:95
  page decoding       parquet/src/encodings/decoding.rs, rle.rs (hot
                      loops in native/hostcodec.cpp)
  level assembly      parquet/src/arrow/array_reader (def/rep levels ->
                      validity masks and list offsets)

Engine-specific design: pages decode into numpy host buffers on a
thread pool (`_decode_parallel`: pure numpy and the native page kernels,
which release the interpreter lock; the workers return numpy and never
touch a device), then `_assemble` copies each buffer of a column chunk
once onto the reader's `device` (one upload per buffer, not per page;
io/hostio.py); validity is the port's dense bool mask; dictionary-encoded
chunks can stay dictionary-encoded instead of being materialized.
Decimals stored as FLBA or BYTE_ARRAY decode in one vectorised pass to
the reference's limbs (`_be_limbs`).  A row selection or a predicate
keeps rows through `filter_table` on the device (K1 on a card).

Supported: all physical types, PLAIN / RLE_DICTIONARY / PLAIN_DICTIONARY
/ DELTA_BINARY_PACKED / DELTA_LENGTH_BYTE_ARRAY / DELTA_BYTE_ARRAY /
BYTE_STREAM_SPLIT encodings, v1+v2 data pages, snappy/gzip/zstd/lz4_raw
/uncompressed codecs, arbitrary nesting at any repetition depth
(list/struct/map, list<list<...>>), page index, bloom filters, and
AES_GCM_V1 modular encryption (encrypted footer, footer-key and
column-key modes; io/parquet_crypto.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           NullColumn, PrimitiveColumn, StringColumn,
                           StructColumn)
from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                           MapColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..utils import hostcodec as nt
from .hostio import pool_map, tensor
from .thrift import CompactReader

__all__ = ["ParquetFile", "read_parquet_native"]

_MAGIC = b"PAR1"
_MAGIC_ENCR = b"PARE"

# physical types (format.rs Type)
PT_BOOLEAN, PT_INT32, PT_INT64, PT_INT96, PT_FLOAT, PT_DOUBLE, \
    PT_BYTE_ARRAY, PT_FLBA = range(8)

# encodings
ENC_PLAIN, _, ENC_PLAIN_DICT, ENC_RLE, ENC_BIT_PACKED, \
    ENC_DELTA_BINARY_PACKED, ENC_DELTA_LENGTH_BA, ENC_DELTA_BA, \
    ENC_RLE_DICT, ENC_BYTE_STREAM_SPLIT = range(10)

# codecs
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_GZIP, CODEC_LZO, CODEC_BROTLI, \
    CODEC_LZ4, CODEC_ZSTD, CODEC_LZ4_RAW = range(8)

# page types
PAGE_DATA, PAGE_INDEX, PAGE_DICT, PAGE_DATA_V2 = range(4)

_PHYS_NP = {PT_INT32: np.int32, PT_INT64: np.int64,
            PT_FLOAT: np.float32, PT_DOUBLE: np.float64}


def _decompress(codec: int, data: bytes, ulen: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return data
    if codec == CODEC_SNAPPY:
        return nt.snappy_decompress(data, ulen)
    if codec == CODEC_GZIP:
        import zlib
        return zlib.decompress(data, 31)
    if codec == CODEC_ZSTD:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=ulen)
    if codec == CODEC_LZ4_RAW:
        n, out = nt.lz4_block_decompress(data, ulen)
        if n != ulen:
            raise ArrowInvalid("bad LZ4_RAW page")
        return out.tobytes()
    raise ArrowNotImplementedError(f"parquet codec {codec}")


# ---------------------------------------------------------------------------
# Schema tree
# ---------------------------------------------------------------------------

@dataclass
class SchemaNode:
    """One SchemaElement with resolved children (metadata/mod.rs schema
    tree role)."""
    name: str
    repetition: int            # 0 required, 1 optional, 2 repeated
    physical: Optional[int]    # None for groups
    type_length: int
    converted: Optional[int]
    logical: Optional[dict]    # {field_id: struct} of LogicalType
    scale: Optional[int]
    precision: Optional[int]
    children: List["SchemaNode"] = field(default_factory=list)
    # assigned during resolution
    max_def: int = 0
    max_rep: int = 0
    leaf_index: Optional[int] = None
    # exact Arrow dtype recovered from the embedded ARROW:schema
    # (advisory; schema/primitive.rs apply_hint)
    arrow_hint: Optional[dt.DataType] = None

    @property
    def is_leaf(self) -> bool:
        return self.physical is not None


def _project_fields(fields, columns):
    """Projection with nested STRUCT-branch selection (the
    ProjectionMask::leaves role, parquet/src/arrow/mod.rs): a plain
    name keeps the whole column; a dotted path like 'a.b.c' keeps only
    that branch of struct 'a' — sibling leaves are neither decoded nor
    assembled.  List/map subtrees are kept whole (their leaves are not
    independently addressable by name).  A name that is a top-level
    column's, dots and all, selects that column, as pyarrow does (the
    reference splits it as a path: ROADMAP C7.3)."""
    top = {f.name for f in fields}
    by_root: Dict[str, list] = {}
    for c in columns:
        parts = [c] if c in top else c.split(".")
        by_root.setdefault(parts[0], []).append(parts[1:])
    out = []
    for f in fields:
        paths = by_root.get(f.name)
        if paths is None:
            continue
        pf = _prune_node(f, paths)
        if pf is not None:
            out.append(pf)
    return out


def _prune_node(node: SchemaNode, paths):
    """Keep only the struct branches named by `paths` (each a list of
    remaining name segments); None when nothing matches beneath."""
    if any(len(p) == 0 for p in paths):
        return node                    # this exact node was requested
    if node.is_leaf:
        return None                    # path runs past a leaf
    ct = node.converted
    lt = node.logical or {}
    # converted: MAP=1, MAP_KEY_VALUE=2, LIST=3; LogicalType union
    # field ids: MAP=2, LIST=3 (STRING is 1 — not a group annotation)
    is_listmap = ct in (1, 2, 3) or 2 in lt or 3 in lt or (
        len(node.children) == 1 and node.children[0].repetition == 2
        and not node.children[0].is_leaf
        and node.children[0].name in ("list", "key_value", "array"))
    if is_listmap:
        return node                    # dotted pruning is struct-only
    by: Dict[str, list] = {}
    for p in paths:
        by.setdefault(p[0], []).append(p[1:])
    kept = []
    for ch in node.children:
        sub = by.get(ch.name)
        if sub is None:
            continue
        pc = _prune_node(ch, sub)
        if pc is not None:
            kept.append(pc)
    if not kept:
        return None
    if len(kept) == len(node.children) and all(
            k is c for k, c in zip(kept, node.children)):
        return node                    # nothing pruned anywhere below
    import dataclasses
    pruned = dataclasses.replace(node, children=kept)
    # the ARROW:schema hint describes the FULL struct; a pruned one
    # must fall back to the parquet-derived dtype
    pruned.arrow_hint = None
    return pruned


def _parse_schema(elems: List[dict]) -> SchemaNode:
    pos = [0]

    def take() -> SchemaNode:
        e = elems[pos[0]]
        pos[0] += 1
        node = SchemaNode(
            name=e.get(4, b"").decode("utf-8"),
            repetition=e.get(3, 0),
            physical=e.get(1),
            type_length=e.get(2, 0),
            converted=e.get(6),
            logical=e.get(10),
            scale=e.get(7),
            precision=e.get(8),
        )
        nch = e.get(5, 0) or 0
        if nch:
            node.physical = None
            node.children = [take() for _ in range(nch)]
        return node

    root = take()
    counter = [0]

    def resolve(n: SchemaNode, max_def: int, max_rep: int):
        if n.repetition == 1:
            max_def += 1
        elif n.repetition == 2:
            max_def += 1
            max_rep += 1
        n.max_def, n.max_rep = max_def, max_rep
        if n.is_leaf:
            n.leaf_index = counter[0]
            counter[0] += 1
        for c in n.children:
            resolve(c, max_def, max_rep)

    for c in root.children:
        resolve(c, 0, 0)
    return root


def _logical_dtype(n: SchemaNode) -> dt.DataType:
    """Leaf SchemaNode -> arrow dtype (schema/types.rs conversion role).
    An ARROW:schema hint validated at annotate time wins outright."""
    if n.arrow_hint is not None:
        return n.arrow_hint
    return _parquet_dtype(n)


def _parquet_dtype(n: SchemaNode) -> dt.DataType:
    p = n.physical
    lt = n.logical or {}
    ct = n.converted

    def decimal():
        prec, sc = n.precision or 38, n.scale or 0
        if 5 in lt:
            prec = lt[5].get(2, prec)
            sc = lt[5].get(1, sc)
        return dt.decimal128(prec, sc) if prec <= 38 \
            else dt.decimal256(prec, sc)

    if p == PT_BOOLEAN:
        return dt.bool_
    if p == PT_INT32:
        if 11 in lt:     # UNKNOWN: always-null (primitive.rs:194)
            return dt.null
        if 10 in lt:     # INTEGER
            bits = lt[10].get(1, 32)
            signed = lt[10].get(2, True)
            return getattr(dt, ("int" if signed else "uint") + str(bits))
        if 6 in lt or ct == 6:
            return dt.date32
        if 7 in lt:      # TIME
            return dt.time32("ms")
        if ct == 7:
            return dt.time32("ms")
        if 5 in lt or ct == 5:
            return decimal()
        if ct in (11, 12, 13):
            return {11: dt.uint8, 12: dt.uint16, 13: dt.uint32}[ct]
        if ct in (15, 16, 17):
            return {15: dt.int8, 16: dt.int16, 17: dt.int32}[ct]
        return dt.int32
    if p == PT_INT64:
        if 10 in lt:
            signed = lt[10].get(2, True)
            return dt.int64 if signed else dt.uint64
        if 8 in lt:      # TIMESTAMP
            unit = {1: "ms", 2: "us", 3: "ns"}[
                next(iter(lt[8].get(2, {1: {}})))]
            utc = lt[8].get(1, False)
            return dt.timestamp(unit, "UTC" if utc else None)
        if ct == 9:
            return dt.timestamp("ms")
        if ct == 10:
            return dt.timestamp("us")
        if 7 in lt:
            unit = {2: "us", 3: "ns"}.get(
                next(iter(lt[7].get(2, {2: {}}))), "us")
            return dt.time64(unit)
        if ct == 8:
            return dt.time64("us")
        if 5 in lt or ct == 5:
            return decimal()
        if ct == 14:
            return dt.uint64
        return dt.int64
    if p == PT_INT96:
        return dt.timestamp("ns")
    if p == PT_FLOAT:
        return dt.float32
    if p == PT_DOUBLE:
        return dt.float64
    if p == PT_BYTE_ARRAY:
        if 5 in lt or ct == 5:
            return decimal()
        if 1 in lt or 4 in lt or 12 in lt or ct in (0, 4, 19):
            return dt.utf8
        return dt.binary
    if p == PT_FLBA:
        if 5 in lt or ct == 5:
            return decimal()
        if 15 in lt:     # FLOAT16
            return dt.float16
        if ct == 21:     # INTERVAL: unit is ambiguous without a hint —
            # day_time, as the reference picks (primitive.rs:324)
            return dt.interval("day_time")
        return dt.fixed_size_binary(n.type_length)
    raise ArrowNotImplementedError(f"parquet physical type {p}")


def _apply_hint(p: dt.DataType, h: dt.DataType) -> dt.DataType:
    """Refine the parquet-derived dtype with the ARROW:schema hint when
    they are compatible (schema/primitive.rs:40 apply_hint)."""
    if h.name == "dictionary":
        hinted = _apply_hint(p, h.value_type)
        return h if hinted == h.value_type else hinted
    pn, hn = p.name, h.name
    if pn in ("int32", "int64") and hn == "timestamp":
        return h
    if pn == "int32" and hn == "time32":
        return h
    if pn == "int64" and hn in ("time64", "duration", "date64"):
        return h
    if pn == "date32" and hn == "date64":
        return h
    if pn == "timestamp" and hn == "timestamp":
        if p.unit == h.unit and h.tz is not None:
            return h
        if p.unit == "ns" and not p.tz:      # INT96: any resolution
            return h
        return p
    if pn == "utf8" and hn in ("large_utf8", "utf8_view"):
        return h
    if pn == "binary" and hn in ("utf8", "large_utf8", "utf8_view",
                                 "large_binary", "binary_view"):
        return h
    if pn == "interval" and hn == "interval" and \
            h.unit != "month_day_nano":
        return h
    if pn == "decimal128" and hn == "decimal256":
        return h
    if p.is_decimal and h.is_decimal and \
            (p.precision, p.scale) == (h.precision, h.scale):
        # width is a storage choice; the hint's width round-trips
        # (INT32/INT64-physical decimals read as decimal128 otherwise)
        return h
    return p


def _annotate_hints(root: SchemaNode, schema: dt.Schema) -> None:
    """Mark leaf SchemaNodes with the exact Arrow dtype from the file's
    embedded ARROW:schema (matched by name; advisory — incompatible
    hints are ignored, parquet schema stays authoritative)."""

    def node(n: SchemaNode, hint: dt.DataType):
        if n.is_leaf:
            try:
                base = _parquet_dtype(n)
            except ArrowNotImplementedError:
                return
            refined = _apply_hint(base, hint)
            if refined != base:
                n.arrow_hint = refined
            return
        lt = n.logical or {}
        ct = n.converted
        if 3 in lt or ct == 3:                      # LIST group
            if hint.name not in ("list", "large_list", "fixed_size_list",
                                 "list_view", "large_list_view"):
                return
            if hint.name != "list":    # structural refinement: the
                n.arrow_hint = hint    # built list casts to fsl/large/view
            mid = n.children[0]
            elem = mid.children[0] if mid.children else mid
            node(elem, hint.value_type)
            return
        if 2 in lt or ct in (1, 2):                 # MAP group
            if hint.name != "map":
                return
            kv = n.children[0]
            node(kv.children[0], hint.value_type.fields[0].dtype)
            node(kv.children[1], hint.value_type.fields[1].dtype)
            return
        if n.repetition == 2:                       # legacy repeated
            if hint.name in ("list", "large_list"):
                hint = hint.value_type
        if hint.name == "struct":
            by_name = {f.name: f.dtype for f in hint.fields}
            for c in n.children:
                hd = by_name.get(c.name)
                if hd is not None:
                    node(c, hd)

    by_name = {f.name: f.dtype for f in schema.fields}
    for c in root.children:
        hd = by_name.get(c.name)
        if hd is not None:
            node(c, hd)


def decode_embedded_arrow_schema(b64) -> dt.Schema:
    """ARROW:schema key-value metadata -> Schema (base64 of a
    length-framed IPC Schema message; schema/mod.rs:146)."""
    import base64
    raw = base64.b64decode(b64)
    if len(raw) > 8 and raw[:4] == b"\xff\xff\xff\xff":
        raw = raw[8:]
    from .ipc_format import read_schema
    return read_schema(raw)[0]


def _node_dtype(n: SchemaNode) -> dt.DataType:
    """Any SchemaNode -> arrow dtype (groups included)."""
    if n.is_leaf:
        return _logical_dtype(n)
    lt = n.logical or {}
    ct = n.converted
    if 3 in lt or ct == 3:           # LIST
        mid = n.children[0]
        elem = mid.children[0] if mid.children else mid
        return dt.list_(_node_dtype(elem))
    if 2 in lt or ct in (1, 2):      # MAP
        kv = n.children[0]
        return dt.map_(_node_dtype(kv.children[0]),
                       _node_dtype(kv.children[1]))
    if n.repetition == 2:            # legacy repeated group = list<struct>
        return dt.list_(dt.struct([dt.Field(c.name, _node_dtype(c),
                                            c.repetition != 0)
                                   for c in n.children]))
    return dt.struct([dt.Field(c.name, _node_dtype(c),
                               c.repetition != 0) for c in n.children])


# ---------------------------------------------------------------------------
# Page decode
# ---------------------------------------------------------------------------

@dataclass
class _LeafData:
    """Decoded column chunk for one leaf: flat (rep, def, values)."""
    node: SchemaNode
    defs: Optional[np.ndarray]         # uint32[n_slots] or None
    reps: Optional[np.ndarray]
    values: object                     # np array | (offsets, data) | dict form
    dictionary: Optional[object] = None   # decoded dict values
    indices: Optional[np.ndarray] = None  # dict indices (when kept encoded)


def _decode_plain(node: SchemaNode, data: bytes, count: int):
    p = node.physical
    if p in _PHYS_NP:
        return np.frombuffer(data, _PHYS_NP[p], count)
    if p == PT_BOOLEAN:
        bits = np.frombuffer(data, np.uint8)
        return np.unpackbits(bits, count=count,
                             bitorder="little").astype(np.bool_)
    if p == PT_BYTE_ARRAY:
        return nt.plain_byte_array_decode(data, count)
    if p == PT_FLBA:
        w = node.type_length
        return np.frombuffer(data, np.uint8, count * w).reshape(count, w)
    if p == PT_INT96:
        raw = np.frombuffer(data, np.uint8, count * 12).reshape(count, 12)
        nanos = raw[:, :8].copy().view(np.int64).ravel()
        jday = raw[:, 8:].copy().view(np.int32).ravel()
        return (jday.astype(np.int64) - 2440588) * 86400_000_000_000 \
            + nanos
    raise ArrowNotImplementedError(f"PLAIN decode of physical {p}")


def _decode_values(node: SchemaNode, enc: int, data: bytes, count: int,
                   dictionary):
    """-> values (np array or (offsets, data)), or ('dict', indices)."""
    if count == 0:
        return _empty_values(node)
    if enc == ENC_PLAIN:
        return _decode_plain(node, data, count)
    if enc in (ENC_PLAIN_DICT, ENC_RLE_DICT):
        bit_width = data[0]
        idx = nt.rle_bp_decode(data[1:], bit_width, count)
        return ("dict", idx)
    if enc == ENC_RLE:
        # RLE as a VALUES encoding: booleans (v2 pages), u32 length
        # prefix then the rle/bit-packed payload at bit width 1
        if node.physical != PT_BOOLEAN:
            raise ArrowNotImplementedError("RLE values for non-boolean")
        (ln,) = struct.unpack_from("<I", data, 0)
        return nt.rle_bp_decode(data[4:4 + ln], 1, count).astype(np.bool_)
    if enc == ENC_DELTA_BINARY_PACKED:
        vals, _ = nt.delta_binary_packed_decode(data, count)
        if node.physical == PT_INT32:
            return vals.astype(np.int32)
        return vals
    if enc == ENC_DELTA_LENGTH_BA:
        lens, consumed = nt.delta_binary_packed_decode(data, count)
        offsets = np.zeros(count + 1, np.int32)
        np.cumsum(lens, out=offsets[1:])
        payload = np.frombuffer(data, np.uint8,
                                int(offsets[-1]), consumed)
        return offsets, payload
    if enc == ENC_DELTA_BA:
        plens, c1 = nt.delta_binary_packed_decode(data, count)
        slens, c2 = nt.delta_binary_packed_decode(data[c1:], count)
        suffixes = data[c1 + c2: c1 + c2 + int(slens.sum())]
        return nt.delta_byte_array_build(plens, slens, suffixes)
    if enc == ENC_BYTE_STREAM_SPLIT:
        p = node.physical
        if p in (PT_FLOAT, PT_DOUBLE, PT_INT32, PT_INT64):
            w = {PT_FLOAT: 4, PT_INT32: 4, PT_DOUBLE: 8, PT_INT64: 8}[p]
            npdt = _PHYS_NP[p]
        elif p == PT_FLBA:
            w = node.type_length
            npdt = None
        else:
            raise ArrowNotImplementedError("BYTE_STREAM_SPLIT type")
        planes = np.frombuffer(data, np.uint8, w * count) \
            .reshape(w, count)
        inter = np.ascontiguousarray(planes.T)
        if npdt is None:
            return inter
        return inter.view(npdt).ravel()
    raise ArrowNotImplementedError(f"parquet encoding {enc}")


def _empty_values(node: SchemaNode):
    p = node.physical
    if p in _PHYS_NP:
        return np.zeros(0, _PHYS_NP[p])
    if p == PT_BOOLEAN:
        return np.zeros(0, np.bool_)
    if p in (PT_BYTE_ARRAY,):
        return np.zeros(1, np.int32), np.zeros(0, np.uint8)
    if p == PT_FLBA:
        return np.zeros((0, node.type_length), np.uint8)
    if p == PT_INT96:
        return np.zeros(0, np.int64)
    return np.zeros(0, np.int64)


# decode-skip observability (tests assert page-skip pushdown really
# skips: arrow_reader/selection.rs:100 ReadPlan role).  Incremented
# from the parallel chunk-decode pool, so the read-modify-write must be
# locked or counts drop under contention.
import threading as _threading

from ..utils import trace as _trace

_CTR_LOCK = _threading.Lock()
PAGES_DECODED = [0]
PAGES_SKIPPED = [0]


def _zero_values(node: SchemaNode, count: int):
    """Placeholder values for a SKIPPED page: shaped like a decoded page
    of `count` all-valid rows; the rows are dropped by the caller's
    RowSelection before anything reads them."""
    p = node.physical
    if p in _PHYS_NP:
        return np.zeros(count, _PHYS_NP[p])
    if p == PT_BOOLEAN:
        return np.zeros(count, np.bool_)
    if p == PT_BYTE_ARRAY:
        return np.zeros(count + 1, np.int32), np.zeros(0, np.uint8)
    if p == PT_FLBA:
        return np.zeros((count, node.type_length), np.uint8)
    return np.zeros(count, np.int64)


def _read_column_chunk(src, chunk_meta: dict, node: SchemaNode,
                       crypto=None, page_skip=None) -> _LeafData:
    """Decode every page of one column chunk (serialized_reader.rs:95 +
    column/reader.rs roles).  Fetches the chunk's byte range in ONE
    read (the async_reader per-chunk fetch granularity).

    crypto: (key, file_aad, rg_idx, col_idx) for encrypted chunks —
    page headers and bodies are separate GCM modules
    (serialized_reader.rs:750-795).

    page_skip: optional per-DATA-page keep flags (from the offset index
    + a RowSelection, selection.rs:100): pages whose flag is False skip
    decompression and value/level decode entirely — their slots fill
    with all-valid zero placeholders that the selection drops.  Flat
    (max_rep == 0) leaves only; headers still parse (a few bytes) to
    walk the page stream."""
    if 3 not in chunk_meta and -1 in chunk_meta:
        raise ArrowInvalid(
            f"cannot decrypt column {'.'.join(node.name.split())}: "
            f"{chunk_meta[-1]}")
    md = chunk_meta[3]                    # ColumnMetaData
    codec = md.get(4, 0)
    num_values = md.get(5, 0)
    data_off = md.get(9)
    dict_off = md.get(11)
    total = md.get(7)
    start = data_off if dict_off is None else min(data_off, dict_off)
    data = src.range(start, total) if not isinstance(src, (bytes,
                                                           bytearray)) \
        else src[start:start + total]
    pos = 0
    end = total

    dictionary = None
    defs = np.zeros(num_values, np.uint32) if node.max_def else None
    reps = np.zeros(num_values, np.uint32) if node.max_rep else None
    chunks = []                          # per-page values
    dict_idx_chunks = []
    slots_read = 0
    nonnull_read = 0
    # all-valid fast path: pages whose def stream is one const run of
    # max_def skip decode entirely; regions are backfilled only if a
    # later page breaks constness
    defs_all_const = True
    const_regions: list = []

    def _def_levels(payload, n):
        """Handle one page's def-level stream; -> nn (non-null count)."""
        nonlocal defs_all_const
        bw = _bit_width(node.max_def)
        if _is_const_max_run(payload, bw, n, node.max_def):
            if defs_all_const:
                const_regions.append((slots_read, n))
            else:
                defs[slots_read:slots_read + n] = node.max_def
            return n
        if defs_all_const:
            defs_all_const = False
            for s0, n0 in const_regions:
                defs[s0:s0 + n0] = node.max_def
            const_regions.clear()
        defs[slots_read:slots_read + n] = nt.rle_bp_decode(payload, bw,
                                                           n)
        return int((defs[slots_read:slots_read + n]
                    == node.max_def).sum())

    page_ord = 0
    data_ord = 0                         # DATA page ordinal (page_skip)
    while slots_read < num_values and pos < end:
        if crypto is not None:
            from .parquet_crypto import (decrypt_module, module_aad,
                                         M_DATAPAGE, M_DICTPAGE,
                                         M_DATAPAGE_HDR,
                                         M_DICTPAGE_HDR)
            key, faad, rgi, coli = crypto
            is_dict = dict_off is not None and (start + pos) == dict_off
            porq = None if is_dict else page_ord
            hb, pos = decrypt_module(
                key, data,
                module_aad(faad, M_DICTPAGE_HDR if is_dict
                           else M_DATAPAGE_HDR, rgi, coli, porq), pos)
            header = CompactReader(hb).read_struct()
            clen = header.get(3)
            body, _ = decrypt_module(
                key, data[pos:pos + clen],
                module_aad(faad, M_DICTPAGE if is_dict else M_DATAPAGE,
                           rgi, coli, porq))
            pos += clen
            if not is_dict:
                page_ord += 1
        else:
            r = CompactReader(data, pos)
            header = r.read_struct()
            clen = header.get(3)
            # zero-copy page body (a bytes slice would copy every page)
            body = memoryview(data)[r.pos: r.pos + clen]
            pos = r.pos + clen
        page_type = header.get(1)
        ulen = header.get(2)

        if page_type == PAGE_DICT:
            dph = header.get(7, {})
            dcount = dph.get(1, 0)
            raw = _decompress(codec, body, ulen)
            dictionary = _decode_plain(node, raw, dcount)
            continue
        if page_type in (PAGE_DATA, PAGE_DATA_V2) and page_skip is not None:
            dph = header.get(5 if page_type == PAGE_DATA else 8, {})
            n = dph.get(1, 0)
            keep = page_skip[data_ord] if data_ord < len(page_skip) \
                else True
            data_ord += 1
            if not keep:
                with _CTR_LOCK:
                    PAGES_SKIPPED[0] += 1
                _trace.count("parquet.pages_skipped")
                if node.max_def:
                    # same const-region bookkeeping as _def_levels'
                    # const fast path: pretend all-valid
                    if defs_all_const:
                        const_regions.append((slots_read, n))
                    else:
                        defs[slots_read:slots_read + n] = node.max_def
                chunks.append(("plain", _zero_values(node, n)))
                slots_read += n
                nonnull_read += n
                continue
            with _CTR_LOCK:
                PAGES_DECODED[0] += 1
            _trace.count("parquet.pages_decoded")
        if page_type == PAGE_DATA:
            dph = header.get(5, {})
            n = dph.get(1, 0)
            enc = dph.get(2, ENC_PLAIN)
            raw = _decompress(codec, body, ulen)
            off = 0

            def _v1_levels(raw, off, lvl_enc, max_lvl):
                bw = _bit_width(max_lvl)
                if lvl_enc == ENC_BIT_PACKED:
                    # deprecated legacy level encoding: MSB-first
                    # bit-packing, no length prefix (Encoding.BIT_PACKED)
                    ln = (n * bw + 7) // 8
                    return _bitpacked_levels(raw[off:off + ln],
                                             bw, n), off + ln
                (ln,) = struct.unpack_from("<I", raw, off)
                return nt.rle_bp_decode(raw[off + 4: off + 4 + ln],
                                        bw, n), off + 4 + ln

            if node.max_rep:
                lv, off = _v1_levels(raw, off, dph.get(4, ENC_RLE),
                                     node.max_rep)
                reps[slots_read:slots_read + n] = lv
            if node.max_def:
                lvl_enc = dph.get(3, ENC_RLE)
                if lvl_enc == ENC_RLE:
                    (lln,) = struct.unpack_from("<I", raw, off)
                    nn = _def_levels(raw[off + 4: off + 4 + lln], n)
                    off += 4 + lln
                else:
                    lv, off = _v1_levels(raw, off, lvl_enc,
                                         node.max_def)
                    if defs_all_const:
                        defs_all_const = False
                        for s0, n0 in const_regions:
                            defs[s0:s0 + n0] = node.max_def
                        const_regions.clear()
                    defs[slots_read:slots_read + n] = lv
                    nn = int((defs[slots_read:slots_read + n]
                              == node.max_def).sum())
            else:
                nn = n
            vals = _decode_values(node, enc, raw[off:], nn, dictionary)
        elif page_type == PAGE_DATA_V2:
            dph = header.get(8, {})
            n = dph.get(1, 0)
            enc = dph.get(4, ENC_PLAIN)
            dl_len = dph.get(5, 0)
            rl_len = dph.get(6, 0)
            compressed = dph.get(7, True)
            off = 0
            if node.max_rep:
                reps[slots_read:slots_read + n] = nt.rle_bp_decode(
                    body[off:off + rl_len], _bit_width(node.max_rep), n)
            off += rl_len
            if node.max_def:
                nn = _def_levels(body[off:off + dl_len], n)
            else:
                nn = n
            off += dl_len
            payload = body[off:]
            if compressed and codec != CODEC_UNCOMPRESSED:
                payload = _decompress(codec, payload,
                                      ulen - rl_len - dl_len)
            vals = _decode_values(node, enc, payload, nn, dictionary)
        else:
            continue                     # index page etc.

        if isinstance(vals, tuple) and isinstance(vals[0], str):
            dict_idx_chunks.append(vals[1])
            chunks.append(("dict", vals[1]))
        else:
            chunks.append(("plain", vals))
        slots_read += n
        nonnull_read += nn

    if (defs is not None and defs_all_const and const_regions
            and not node.max_rep):
        # every def page was a const run of max_def: the chunk has no
        # nulls and downstream treats it as required (defs=None)
        defs = None
    elif defs is not None and const_regions:
        for s0, n0 in const_regions:
            defs[s0:s0 + n0] = node.max_def
    ld = _LeafData(node, defs, reps, None, dictionary=dictionary)
    if dict_idx_chunks and len(dict_idx_chunks) == len(chunks):
        ld.indices = np.concatenate(dict_idx_chunks) \
            if len(dict_idx_chunks) > 1 else dict_idx_chunks[0]
    else:
        ld.values = _concat_values(node, chunks, dictionary)
    return ld


def _bit_width(v: int) -> int:
    return max(1, int(v).bit_length()) if v else 0


def _is_const_max_run(buf, bw: int, n: int, max_lvl: int) -> bool:
    """True iff an RLE/bit-packed level stream is exactly one RLE run of
    n copies of max_lvl — the all-valid page shape every writer emits.
    Lets the reader skip the O(n) decode + the == max_def pass."""
    v = 0
    shift = 0
    pos = 0
    ln = len(buf)
    while True:
        if pos >= ln:
            return False
        b = buf[pos]
        pos += 1
        v |= (int(b) & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    if (v & 1) or (v >> 1) != n:
        return False
    nb = (bw + 7) // 8
    if pos + nb > ln:
        return False
    return int.from_bytes(bytes(buf[pos:pos + nb]), "little") == max_lvl


def _bitpacked_levels(buf: bytes, bw: int, n: int) -> np.ndarray:
    """Deprecated Encoding.BIT_PACKED levels: values packed MSB-first
    with no length prefix (Encoding.thrift BIT_PACKED note; arrow-rs
    encodings/levels.rs legacy path)."""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8),
                         count=n * bw).reshape(n, bw)
    weights = (1 << np.arange(bw - 1, -1, -1)).astype(np.uint32)
    return bits.dot(weights).astype(np.uint32)


def _concat_values(node: SchemaNode, chunks, dictionary):
    """Merge per-page value arrays IN PAGE ORDER, materializing dict
    pages inline (writers fall back from dictionary to plain encoding
    mid-chunk when the dictionary overflows — dict pages come FIRST,
    so order must be preserved, column/writer/mod.rs fallback)."""
    mats = []
    for kind, payload in chunks:
        mats.append(_take_values(node, dictionary, payload)
                    if kind == "dict" else payload)
    if not mats:
        return _empty_values(node)
    if len(mats) == 1:
        return mats[0]
    if isinstance(mats[0], tuple):     # (offsets, data) byte arrays
        offs_list, data_list = zip(*mats)
        total = np.zeros(sum(len(o) - 1 for o in offs_list) + 1, np.int32)
        datas = []
        base = 0
        k = 1
        for o, d in mats:
            cnt = len(o) - 1
            total[k:k + cnt] = np.asarray(o[1:], np.int64) + base
            base += int(o[-1])
            k += cnt
            datas.append(np.asarray(d, np.uint8)[:int(o[-1])])
        return total, np.concatenate(datas) if datas \
            else np.zeros(0, np.uint8)
    return np.concatenate(mats)


def _take_values(node: SchemaNode, dictionary, idx: np.ndarray):
    if dictionary is None:
        raise ArrowInvalid("dictionary-encoded page without dictionary")
    if isinstance(dictionary, tuple):  # byte arrays
        offs, data = dictionary
        return nt.gather_varlen(np.asarray(offs, np.int64),
                                np.asarray(data, np.uint8),
                                np.asarray(idx, np.int64))
    return np.asarray(dictionary)[idx]


# ---------------------------------------------------------------------------
# Record assembly (leaf data -> port columns on the reader's device)
# ---------------------------------------------------------------------------

def _build_column(node: SchemaNode, leaf_map: Dict[int, _LeafData],
                  n_rows: int, as_dictionary: set,
                  axis_def: int = 0, axis_rep: int = 0, *, dev) -> Column:
    """Recursive column build from decoded leaves, on `dev`.

    axis_def/axis_rep: the def/rep thresholds defining the CURRENT axis
    (0/0 = row axis; mid.max_def/mid.max_rep = the element axis of the
    enclosing repeated group).  A leaf slot participates in this axis iff
    its def level >= axis_def; structs pass the axis through unchanged,
    repeated groups switch to the element axis.
    """
    if node.is_leaf:
        ld = leaf_map[node.leaf_index]
        return _build_leaf(node, ld, n_rows, node.name in as_dictionary,
                           axis_def, dev)

    lt = node.logical or {}
    ct = node.converted
    is_list = 3 in lt or ct == 3
    is_map = 2 in lt or ct in (1, 2)

    if is_list or is_map:
        mid = node.children[0]         # repeated group
        # list offsets from any descendant leaf's rep/def levels; works
        # at ANY repetition depth: the current axis is the slot subset
        # with def >= axis_def, entries start where rep <= axis_rep,
        # and an element of THIS list starts where def reaches the
        # repeated group's level and rep does not exceed it (deeper
        # repeats continue the same element)
        leaf = _first_leaf(mid)
        ld = leaf_map[leaf.leaf_index]
        defs = ld.defs
        reps = ld.reps
        if axis_def and defs is not None:
            sub = defs >= axis_def
            defs_s = defs[sub]
            reps_s = reps[sub] if reps is not None else None
        else:
            defs_s, reps_s = defs, reps
        n_slots = len(defs_s)
        new_rec = reps_s <= axis_rep if reps_s is not None \
            else np.ones(n_slots, bool)
        rec_of_slot = np.cumsum(new_rec) - 1
        list_def = node.max_def        # def >= this => list non-null
        elem_start = defs_s >= mid.max_def
        if reps_s is not None:
            elem_start = elem_start & (reps_s <= mid.max_rep)
        counts = np.bincount(rec_of_slot[elem_start], minlength=n_rows)
        offsets = np.zeros(n_rows + 1, np.int32)
        np.cumsum(counts, out=offsets[1:])
        validity = None
        if node.max_def > axis_def:    # an optional ancestor or self
            first_slot = np.zeros(n_rows, np.int64)
            first_slot[rec_of_slot[new_rec]] = np.nonzero(new_rec)[0]
            valid = defs_s[first_slot] >= list_def
            if not valid.all():
                validity = tensor(valid, dev)
        n_elems = int(offsets[-1])
        if is_map:
            kv = mid
            entries = StructColumn(
                tuple(_build_column(c, leaf_map, n_elems, as_dictionary,
                                    kv.max_def, kv.max_rep, dev=dev)
                      for c in kv.children),
                tuple(dt.Field(c.name, _node_dtype(c),
                               c.repetition != 0) for c in kv.children))
            return MapColumn(tensor(offsets, dev), entries, validity)
        elem = mid.children[0] if mid.children else mid
        child = _build_column(elem, leaf_map, n_elems, as_dictionary,
                              mid.max_def, mid.max_rep, dev=dev)
        out = ListColumn(tensor(offsets, dev), child, validity)
        if node.arrow_hint is not None:     # ARROW:schema said
            try:                            # fixed_size_list/large_list
                from ..ops.cast import cast, CastOptions
                # safe=False: a length mismatch raises (and we keep the
                # plain list) instead of masking rows
                return cast(out, node.arrow_hint, CastOptions(safe=False))
            except Exception:               # noqa: BLE001 — advisory
                pass
        return out

    # struct: children stay on the SAME axis
    children = tuple(_build_column(c, leaf_map, n_rows, as_dictionary,
                                   axis_def, axis_rep, dev=dev)
                     for c in node.children)
    validity = None
    if node.repetition == 1:
        leaf = _first_leaf(node)
        ld = leaf_map[leaf.leaf_index]
        if ld.defs is not None:
            defs = ld.defs
            on_axis = defs >= axis_def if axis_def else slice(None)
            defs_s = defs[on_axis]
            # one validity entry per axis ENTRY: when the struct holds a
            # repeated descendant, an entry spans several slots — keep
            # only entry starts (rep <= axis_rep)
            if ld.reps is not None:
                reps_s = ld.reps[on_axis]
                defs_s = defs_s[reps_s <= axis_rep]
            valid = defs_s >= node.max_def
            if not valid.all():
                validity = tensor(valid, dev)
    return StructColumn(children,
                        tuple(dt.Field(c.name, _node_dtype(c),
                                       c.repetition != 0)
                              for c in node.children), validity)


def _first_leaf(n: SchemaNode) -> SchemaNode:
    while not n.is_leaf:
        n = n.children[0]
    return n


def _build_leaf(node: SchemaNode, ld: _LeafData, n_rows: int,
                keep_dict: bool, axis_def: int, dev) -> Column:
    d = _logical_dtype(node)
    if d.name == "dictionary":         # ARROW:schema dictionary hint
        keep_dict = keep_dict or ld.indices is not None
        d = d.value_type
    defs = ld.defs
    # restrict slots to the current axis (the element axis of the
    # enclosing repeated group, when any)
    if axis_def and defs is not None:
        defs = defs[ld.defs >= axis_def]
    valid = None
    if defs is not None:
        # value present iff def == max_def: covers the leaf's own
        # optionality AND null ancestors (struct) between it and the axis
        valid_np = defs >= node.max_def
        if not valid_np.all():
            valid = valid_np
    n = n_rows

    if ld.indices is not None and keep_dict:
        idx_full = np.zeros(n, np.int32)
        mask = valid if valid is not None else np.ones(n, bool)
        idx_full[mask] = ld.indices.astype(np.int32)
        values_col = _values_to_column(node, ld.dictionary, d, dev)
        return DictionaryColumn(
            tensor(idx_full, dev), values_col,
            tensor(mask, dev) if valid is not None else None)

    values = ld.values
    if ld.indices is not None:
        values = _take_values(node, ld.dictionary, ld.indices)

    return _scatter_leaf(node, values, valid, n, d, dev)


_STRING_TYPES = ("utf8", "binary", "large_utf8", "large_binary",
                 "utf8_view", "binary_view")


def _strings(offs: np.ndarray, data, d: dt.DataType, vmask, dev
             ) -> StringColumn:
    """A string column of `d` from host offsets (narrowed or widened to
    the type's width; past int32 under a 32-bit type they raise) and
    bytes, copied onto `dev`."""
    want = np.int64 if d.name in ("large_utf8", "large_binary") \
        else np.int32
    offs = np.asarray(offs)
    if want == np.int32 and offs.dtype != np.int32 and len(offs) \
            and int(offs[-1]) > np.iinfo(np.int32).max:
        raise ArrowInvalid(f"{int(offs[-1])} bytes overflow the int32 "
                           f"offsets of {d!r}")
    return StringColumn(tensor(offs.astype(want, copy=False), dev),
                        tensor(np.asarray(data, np.uint8), dev), d, vmask)


def _values_to_column(node: SchemaNode, values, d: dt.DataType,
                      dev) -> Column:
    """Dictionary values -> port column (no nulls in parquet dicts)."""
    if isinstance(values, tuple):
        offs, data = values
        return _strings(offs, data, d if d.name in _STRING_TYPES
                        else dt.utf8, None, dev)
    return _scatter_leaf(node, values, None, len(values), d, dev)


def _scatter_leaf(node: SchemaNode, values, valid: Optional[np.ndarray],
                  n: int, d: dt.DataType, dev) -> Column:
    """Expand non-null values onto the n-slot axis and wrap as Column."""
    vmask = None if valid is None else tensor(valid, dev)

    if isinstance(values, tuple):      # byte arrays -> StringColumn
        offs, data = values
        offs = np.asarray(offs, np.int64)
        if d.is_decimal:
            return _decimal_from_bytes(offs, data, valid, n, d, dev)
        if valid is None:
            out_offs = offs
        else:
            lens = np.zeros(n, np.int64)
            lens[valid] = offs[1:] - offs[:-1]
            out_offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=out_offs[1:])
        return _strings(out_offs, data, d, vmask, dev)

    vals = np.asarray(values)
    if node.physical == PT_FLBA and vals.ndim == 2:
        if d.name == "float16":
            flat = vals.copy().view(np.float16).ravel()
            return _scatter_prim(flat, valid, n, d, vmask, dev)
        if d.is_decimal:
            return _decimal_from_flba(vals, valid, n, d, dev)
        if d.name == "interval":
            # FLBA(12) months/days/millis i32 LE
            # (arrow_writer/mod.rs:1252,1268)
            if d.unit == "year_month":
                months = np.ascontiguousarray(vals[:, :4]) \
                    .view("<i4").ravel()
                return _scatter_prim(months, valid, n, d, vmask, dev)
            days = np.ascontiguousarray(vals[:, 4:8]) \
                .view("<i4").ravel().astype(np.int64)
            mill = np.ascontiguousarray(vals[:, 8:12]) \
                .view("<u4").ravel().astype(np.int64)
            return _scatter_prim((days << 32) | mill, valid, n, d,
                                 vmask, dev)
        full = np.zeros((n, vals.shape[1]), np.uint8)
        full[valid if valid is not None else slice(None)] = vals
        return FixedSizeBinaryColumn(tensor(full, dev), vmask)
    if d.is_null:
        # INT32 + LogicalType UNKNOWN (always-null, primitive.rs:194)
        return NullColumn(n, dev)
    if d.name in ("decimal128", "decimal256"):
        # INT32/INT64-physical DECIMAL without a width hint reads as
        # decimal128 (primitive.rs:184): widen the ints into limbs
        k = 2 if d.name == "decimal128" else 4
        limbs = np.zeros((n, k), np.int64)
        rows = np.nonzero(valid)[0] if valid is not None else \
            np.arange(n)
        iv = vals.astype(np.int64)
        limbs[rows, 0] = iv
        sign_ext = np.where(iv < 0, np.int64(-1), np.int64(0))
        for j in range(1, k):
            limbs[rows, j] = sign_ext
        return DecimalColumn(tensor(limbs, dev), d, vmask)
    return _scatter_prim(vals, valid, n, d, vmask, dev)


def _scatter_prim(vals: np.ndarray, valid, n: int, d: dt.DataType,
                  vmask, dev) -> Column:
    target = d.to_numpy()
    if valid is None:
        out = vals.astype(target, copy=False)
    else:
        out = np.zeros(n, target)
        out[valid] = vals.astype(target, copy=False)
    return PrimitiveColumn(tensor(out.view(d.storage_numpy()), dev), d,
                           vmask, _canonical=vmask is None)


def _be_limbs(raw: np.ndarray, k: int) -> np.ndarray:
    """Big-endian two's complement values, one per row of the (m, w)
    uint8 matrix `raw`, as (m, k) little-endian 64-bit limbs (int64
    storage): one vectorised pass, the same limbs as the reference's
    per-value `int.from_bytes` (parquet_native.py:1133-1161).  A value
    wider than 8k bytes keeps its low 8k bytes, as the reference's
    `_int_to_limbs` masks."""
    m, w = raw.shape
    width = 8 * k
    le = raw[:, ::-1]                               # little endian
    if w >= width:
        out = np.ascontiguousarray(le[:, :width])
    else:
        neg = (raw[:, 0] >= 0x80) if w else np.zeros(m, bool)
        out = np.empty((m, width), np.uint8)
        out[:, :w] = le
        out[:, w:] = np.where(neg, np.uint8(0xFF), np.uint8(0))[:, None]
    return out.view("<i8").reshape(m, k)


def _limb_count(d: dt.DataType) -> int:
    return {"decimal256": 4, "decimal128": 2}.get(d.name, 1)


def _decimal_from_bytes(offs, data, valid, n, d, dev) -> Column:
    """Big-endian two's complement byte arrays -> decimal limbs: each
    value right-aligned in a matrix as wide as the longest, its sign
    byte filling the left (an empty value reads 0)."""
    k = _limb_count(d)
    data = np.asarray(data, np.uint8)
    lens = (offs[1:] - offs[:-1]).astype(np.int64)
    m = len(lens)
    w = int(lens.max()) if m else 0
    raw = np.zeros((m, w), np.uint8)
    if m and w:
        col = np.arange(w, dtype=np.int64)[None, :]
        pad = (w - lens)[:, None]
        inside = col >= pad
        src = offs[:-1, None] + col - pad
        gathered = data[np.clip(src, 0, max(len(data) - 1, 0))] \
            if len(data) else np.zeros((m, w), np.uint8)
        first = data[np.clip(offs[:-1], 0, max(len(data) - 1, 0))] \
            if len(data) else np.zeros(m, np.uint8)
        fill = np.where((lens > 0) & (first >= 0x80), np.uint8(0xFF),
                        np.uint8(0))
        raw = np.where(inside, gathered, fill[:, None]).astype(np.uint8)
    return _decimal_column(_be_limbs(raw, k), valid, n, d, dev)


def _decimal_from_flba(vals, valid, n, d, dev) -> Column:
    k = _limb_count(d)
    return _decimal_column(_be_limbs(np.asarray(vals, np.uint8), k), valid,
                           n, d, dev)


def _decimal_column(limbs: np.ndarray, valid, n, d, dev) -> Column:
    """Non-null limbs scattered onto the n rows (zeros under nulls).  A
    decimal32/64 stored as bytes (pyarrow's choice) takes its unscaled
    integers from the low limb; the reference cannot read it
    (ROADMAP C18)."""
    if d.name in ("decimal32", "decimal64"):
        vmask = None if valid is None else tensor(valid, dev)
        return _scatter_prim(limbs[:, 0].astype(d.storage_numpy()), valid,
                             n, d, vmask, dev)
    if valid is not None:
        full = np.zeros((n, limbs.shape[1]), np.int64)
        full[valid] = limbs
        limbs = full
    return DecimalColumn(tensor(limbs, dev), d,
                         tensor(valid, dev) if valid is not None else None)


# ---------------------------------------------------------------------------
# File reader
# ---------------------------------------------------------------------------

class _Source:
    """Byte-range access over bytes / paths / seekable files — the
    range-fetch abstraction of the reference's async reader
    (parquet/src/arrow/async_reader/mod.rs:712): lazy sources fetch the
    footer and only the projected column chunks."""

    def __init__(self, source):
        self._f = None
        self._buf = None
        self._ranged = None
        if isinstance(source, str):
            self._f = open(source, "rb")
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._buf = bytes(source)
        elif hasattr(source, "get_range") and hasattr(source, "size"):
            # pluggable remote range source (the ObjectStore role of
            # async_reader/store.rs): object with .size() -> int and
            # .get_range(offset, length) -> bytes; must be thread-safe
            # (the decode pool and prefetcher call it concurrently)
            self._ranged = source
        elif hasattr(source, "seek") and hasattr(source, "read"):
            self._f = source
        elif hasattr(source, "read"):
            self._buf = source.read()
        else:
            raise ArrowInvalid(f"cannot read parquet from {type(source)}")
        if self._f is not None:
            import threading
            self._lock = threading.Lock()
            self._f.seek(0, 2)
            self._size = self._f.tell()
        elif self._ranged is not None:
            self._size = int(self._ranged.size())
        else:
            self._size = len(self._buf)

    @property
    def size(self) -> int:
        return self._size

    def range(self, off: int, ln: int) -> bytes:
        if self._buf is not None:
            return self._buf[off:off + ln]
        if self._ranged is not None:
            return self._ranged.get_range(off, ln)
        with self._lock:    # seek+read must be atomic under threads
            self._f.seek(off)
            return self._f.read(ln)


class ParquetFile:
    """Native parquet file reader (ParquetRecordBatchReaderBuilder +
    SerializedFileReader roles).  Paths and seekable files are read
    LAZILY: only the footer and the projected column chunks are fetched
    (the async_reader/object-store access pattern).  Tables are built on
    `device`, which the metadata, statistics and bloom checks do not
    need; a read without one raises."""

    def __init__(self, source, device: DeviceLike = None, decryption=None):
        self._device = device
        self._src = _Source(source)
        self._decryption = decryption
        self._file_aad = b""
        self._footer_key = None
        size = self._src.size
        tail = self._src.range(max(size - 8, 0), 8)
        (flen,) = struct.unpack_from("<i", tail, 0)
        if tail[-4:] == _MAGIC_ENCR:
            # encrypted footer (metadata/reader.rs:902): the slice is
            # [FileCryptoMetaData thrift][GCM module over FileMetaData]
            if decryption is None:
                raise ArrowInvalid(
                    "parquet file has an encrypted footer; pass "
                    "decryption=FileDecryptionProperties(...)")
            from .parquet_crypto import (decrypt_module, module_aad,
                                         M_FOOTER)
            blob = self._src.range(size - 8 - flen, flen)
            r = CompactReader(blob)
            fcm = r.read_struct()
            algo = fcm.get(1, {})
            gcm = algo.get(1)
            if gcm is None:
                raise ArrowNotImplementedError(
                    "AES_GCM_CTR_V1 encrypted files")
            stored_prefix = gcm.get(1, b"") or b""
            aad_unique = gcm.get(2, b"") or b""
            prefix = stored_prefix or decryption.aad_prefix
            self._file_aad = prefix + aad_unique
            self._footer_key = decryption.resolve_footer(
                fcm.get(2, b"") or b"")
            footer, _ = decrypt_module(
                self._footer_key, blob,
                module_aad(self._file_aad, M_FOOTER), r.pos)
        elif tail[-4:] == _MAGIC:
            footer = self._src.range(size - 8 - flen, flen)
        else:
            raise ArrowInvalid("not a parquet file (bad magic)")
        self.metadata = CompactReader(footer).read_struct()
        self.root = _parse_schema(self.metadata[2])
        self.num_rows = self.metadata.get(3, 0)
        self.row_groups = self.metadata.get(4, [])
        self.created_by = (self.metadata.get(6) or b"").decode(
            "utf-8", "replace")
        if self._footer_key is not None or decryption is not None:
            self._decrypt_column_metadata()
        self.arrow_schema_hint: Optional[dt.Schema] = None
        raw = self.key_value_metadata().get("ARROW:schema")
        if raw is not None:
            try:
                self.arrow_schema_hint = decode_embedded_arrow_schema(
                    raw)
                _annotate_hints(self.root, self.arrow_schema_hint)
            except Exception:          # noqa: BLE001 — hint is advisory
                self.arrow_schema_hint = None

    def _chunk_crypto(self, chunk, col_ord: int):
        """(key, rg_unused, col_path) for an encrypted chunk, else
        None.  crypto_metadata union: 1 = footer key, 2 = column key."""
        cm = chunk.get(8)
        if cm is None:
            return None
        if 1 in cm:
            if self._footer_key is None:
                raise ArrowInvalid(
                    "column chunk is encrypted with the footer key; pass "
                    "decryption=FileDecryptionProperties to read it")
            return self._footer_key
        ck = cm[2]
        path = b".".join(ck.get(1, [])).decode()
        if self._decryption is None:
            raise ArrowInvalid(
                f"column chunk {path!r} is encrypted; pass "
                "decryption=FileDecryptionProperties to read it")
        return self._decryption.resolve_column(path, ck.get(2, b"")
                                               or b"")

    def _decrypt_column_metadata(self):
        """Materialize ColumnChunk.meta_data from
        encrypted_column_metadata (field 9) for column-key chunks
        (metadata/mod.rs from_encrypted_thrift role)."""
        from .parquet_crypto import decrypt_module, module_aad, M_COLMD
        for rg_idx, rg in enumerate(self.row_groups):
            for col_idx, chunk in enumerate(rg.get(1, [])):
                blob = chunk.get(9)
                if blob is None or 3 in chunk:
                    continue
                try:
                    key = self._chunk_crypto(chunk, col_idx)
                    md, _ = decrypt_module(
                        key, blob,
                        module_aad(self._file_aad, M_COLMD, rg_idx,
                                   col_idx))
                    chunk[3] = CompactReader(md).read_struct()
                except Exception as e:       # noqa: BLE001
                    # no key (or the wrong key) for this column: leave
                    # its metadata encrypted — reading OTHER columns
                    # still works; touching THIS one raises below
                    chunk[-1] = f"{type(e).__name__}: {e}"

    @property
    def schema(self) -> dt.Schema:
        return dt.Schema(tuple(
            dt.Field(c.name, _node_dtype(c), c.repetition != 0)
            for c in self.root.children))

    def key_value_metadata(self) -> Dict[str, bytes]:
        out = {}
        for kv in self.metadata.get(5, []) or []:
            out[kv.get(1, b"").decode("utf-8")] = kv.get(2)
        return out

    def _leaves(self) -> List[SchemaNode]:
        out = []

        def walk(n):
            if n.is_leaf:
                out.append(n)
            for c in n.children:
                walk(c)

        for c in self.root.children:
            walk(c)
        return out

    def _rg_plan(self, rg_index: int,
                 columns: Optional[Sequence[str]], selection=None):
        """(projected root fields, decode jobs).  A job is
        (leaf_index, chunk, leaf, crypto, page_skip) — independent, so
        chunks decode in parallel (the reference's multithreaded scan
        role; the C++ page kernels release the GIL).  selection: sorted
        disjoint (start, end) row intervals enabling page-skip decode
        via the offset index."""
        rg = self.row_groups[rg_index]
        leaves = self._leaves()
        chunks = rg.get(1, [])
        fields = self.root.children
        if columns is not None:
            fields = _project_fields(fields, columns)
        kept_leaf_ids = {leaf.leaf_index for f in fields
                         for leaf in _leaves_under(f)}
        jobs = []
        for li, (leaf, chunk) in enumerate(zip(leaves, chunks)):
            if leaf.leaf_index not in kept_leaf_ids:
                continue
            crypto = None
            if chunk.get(8) is not None:
                crypto = (self._chunk_crypto(chunk, li),
                          self._file_aad, rg_index, li)
            page_skip = None
            if selection is not None and not leaf.max_rep \
                    and crypto is None:
                page_skip = self._page_keep_flags(rg_index, li,
                                                  selection)
            jobs.append((leaf.leaf_index, chunk, leaf, crypto,
                         page_skip))
        return fields, jobs

    def _page_keep_flags(self, rg_index: int, li: int, intervals):
        """Per-DATA-page keep flags from the offset index: page i is
        kept iff [first_row_i, first_row_{i+1}) intersects any selected
        interval (selection.rs scan_ranges role).  None when the file
        has no offset index for this chunk."""
        chunk = self.row_groups[rg_index].get(1, [])[li]
        oi = self._offset_index_chunk(chunk, rg_index, li)
        if not oi:
            return None
        rg_rows = self.row_groups[rg_index].get(3, 0)
        firsts = [p[2] for p in oi]
        keep = []
        for i, fr in enumerate(firsts):
            end = firsts[i + 1] if i + 1 < len(firsts) else rg_rows
            keep.append(any(s < end and e > fr for s, e in intervals))
        return keep

    def _offset_index_chunk(self, md_chunk, rg_index, li):
        off = md_chunk.get(4)
        ln = md_chunk.get(5)
        if off is None or ln is None:
            return None
        blob = self._index_blob(md_chunk, rg_index, li, off, ln, 4)
        oi = CompactReader(blob).read_struct()
        return [(p.get(1, 0), p.get(2, 0), p.get(3, 0))
                for p in oi.get(1, [])]

    @property
    def device(self):
        """The device tables are read onto (raises when none was named)."""
        return resolve_device(self._device)

    def _assemble(self, rg_index: int, fields, leaf_map,
                  as_dictionary) -> Table:
        """The decoded chunks of one row group as a table on the device:
        each buffer copied there once, on the calling thread."""
        n_rows = self.row_groups[rg_index].get(3, 0)
        dev = self.device
        cols = tuple(_build_column(f, leaf_map, n_rows,
                                   set(as_dictionary), dev=dev)
                     for f in fields)
        schema = dt.Schema(tuple(dt.Field(f.name, c.dtype,
                                          f.repetition != 0)
                                 for f, c in zip(fields, cols)))
        return Table(cols, schema)

    def read_row_group(self, rg_index: int,
                       columns: Optional[Sequence[str]] = None,
                       as_dictionary: Sequence[str] = (),
                       selection=None) -> Table:
        """selection: optional sorted disjoint (start, end) row
        intervals (RowSelection).  With an offset index present, pages
        entirely outside the selection are NOT decoded
        (arrow_reader/mod.rs:736 ReadPlan); the returned table holds
        ONLY the selected rows either way."""
        resolve_device(self._device)      # no device named: raise first
        return self._place(rg_index, self._decode_row_group(
            rg_index, columns, selection), as_dictionary, selection)

    def _decode_row_group(self, rg_index: int, columns=None,
                          selection=None):
        """read_row_group's host half: the row group's chunks decoded
        into numpy, no tensor made, so any thread may run it (the scan's
        prefetch does).  -> (fields, {leaf index: decoded chunk})."""
        fields, jobs = self._rg_plan(rg_index, columns,
                                     selection=selection)
        results = _decode_parallel(self._src, jobs)
        return fields, {li: r for (li, *_), r in zip(jobs, results)}

    def _place(self, rg_index: int, decoded, as_dictionary=(),
               selection=None) -> Table:
        """read_row_group's device half, on the calling thread and its
        current stream: the decoded chunks as a table on the device, cut
        to the selection's rows."""
        dev = self.device
        t = self._assemble(rg_index, *decoded, as_dictionary)
        if selection is None:
            return t
        n = t.num_rows
        mask = np.zeros(n, np.bool_)
        for s, e in selection:
            mask[max(s, 0):min(e, n)] = True
        if mask.all():
            return t
        # the keep column on the table's device: K1 on a card
        from ..ops.filter import filter_table
        return filter_table(t, PrimitiveColumn(tensor(mask, dev),
                                               dt.bool_))

    def column_index(self, rg_index: int, column: str):
        """Parsed page-index ColumnIndex for one chunk
        (file/page_index/index.rs role): {null_pages, min_values,
        max_values, null_counts} or None when absent."""
        md_chunk = self._chunk_for(rg_index, column)
        if md_chunk is None:
            return None
        off = md_chunk.get(6)
        ln = md_chunk.get(7)
        if off is None or ln is None:
            return None
        blob = self._index_blob(md_chunk, rg_index, column, off, ln, 6)
        ci = CompactReader(blob).read_struct()
        return {
            "null_pages": [bool(b) for b in ci.get(1, [])],
            "min_values": ci.get(2, []),
            "max_values": ci.get(3, []),
            "boundary_order": ci.get(4, 0),
            "null_counts": ci.get(5, []),
        }

    def offset_index(self, rg_index: int, column: str):
        """Parsed OffsetIndex: [(offset, compressed_size,
        first_row_index)] per page, or None."""
        md_chunk = self._chunk_for(rg_index, column)
        if md_chunk is None:
            return None
        off = md_chunk.get(4)
        ln = md_chunk.get(5)
        if off is None or ln is None:
            return None
        blob = self._index_blob(md_chunk, rg_index, column, off, ln, 4)
        oi = CompactReader(blob).read_struct()
        return [(p.get(1, 0), p.get(2, 0), p.get(3, 0))
                for p in oi.get(1, [])]

    def _leaf_paths(self) -> List[str]:
        """Dotted path_in_schema per leaf, in leaf order."""
        out = []

        def walk(n, prefix):
            path = prefix + (n.name,)
            if n.is_leaf:
                out.append(".".join(path))
            for c in n.children:
                walk(c, path)

        for c in self.root.children:
            walk(c, ())
        return out

    def _leaf_index_for(self, column: str) -> Optional[int]:
        """Resolve a user-facing column reference to a leaf ordinal:
        exact dotted path first, then unique bare leaf name, then a root
        column name owning exactly one leaf (mirrors the writer's
        per-column property resolution)."""
        paths = self._leaf_paths()
        if column in paths:
            return paths.index(column)
        tails = [p.rsplit(".", 1)[-1] for p in paths]
        if tails.count(column) == 1:
            return tails.index(column)
        heads = [p.split(".", 1)[0] for p in paths]
        if heads.count(column) == 1:
            return heads.index(column)
        if column in tails or column in heads:
            raise ArrowInvalid(
                f"column reference {column!r} is ambiguous across leaves "
                f"{[p for p in paths if column in p.split('.')]}; use the "
                "dotted path")
        return None

    def _chunk_for(self, rg_index: int, column: str):
        li = self._leaf_index_for(column)
        if li is None:
            return None
        return self.row_groups[rg_index].get(1, [])[li]

    def _index_blob(self, md_chunk, rg_index, column, off, ln, which):
        """Fetch (and decrypt, for encrypted chunks) a page-index
        module; which=6 -> ColumnIndex, 4 -> OffsetIndex."""
        blob = self._src.range(off, ln)
        if md_chunk.get(8) is None:
            return blob
        from .parquet_crypto import (decrypt_module, module_aad,
                                     M_COLIDX, M_OFFIDX)
        coli = self._leaf_index_for(column)
        key = self._chunk_crypto(md_chunk, coli)
        mt = M_COLIDX if which == 6 else M_OFFIDX
        out, _ = decrypt_module(
            key, blob, module_aad(self._file_aad, mt, rg_index, coli))
        return out

    def bloom_filter_check(self, rg_index: int, column: str,
                           values) -> Optional[np.ndarray]:
        """Split-block bloom filter membership probe (the reference's
        sbbf, bloom_filter/mod.rs:176): True = value MAY be present in
        the row group, False = definitely absent.  None when the column
        chunk carries no bloom filter."""
        rg = self.row_groups[rg_index]
        leaves = self._leaves()
        li = self._leaf_index_for(column)
        if li is None:
            return None
        md = rg.get(1, [])[li].get(3, {})
        off = md.get(14)
        if off is None:
            return None
        blen = md.get(15)
        raw = self._src.range(off, blen if blen is not None
                              else 64 * 1024 + 32)
        r = CompactReader(raw)
        hdr = r.read_struct()
        nbytes = hdr.get(1, 0)
        if len(raw) < r.pos + nbytes:
            raw = self._src.range(off, r.pos + nbytes)
        bitset = np.frombuffer(raw, np.uint8, nbytes, r.pos)
        leaf = leaves[li]
        hashes = _value_hashes(leaf, values)
        if hashes is None:
            return None
        return nt.sbbf_check(bitset[:nbytes // 32 * 32], hashes)

    def prune_row_groups(self, column: str, value) -> List[int]:
        """Row groups that may contain `value` (bloom-filter pruning;
        groups without a filter are kept)."""
        keep = []
        for i in range(len(self.row_groups)):
            hit = self.bloom_filter_check(i, column, [value])
            if hit is None or bool(hit[0]):
                keep.append(i)
        return keep

    def read(self, columns: Optional[Sequence[str]] = None,
             as_dictionary: Sequence[str] = ()) -> Table:
        # one pool over EVERY (row group, column chunk) pair: small
        # row groups still saturate the cores
        dev = self.device
        if columns is not None:
            known = {c.name for c in self.root.children}
            missing = [c for c in columns if c not in known]
            if missing:
                raise ArrowInvalid(
                    f"projection references unknown column(s) {missing}; "
                    f"file has {sorted(known)}")
        plans = [self._rg_plan(i, columns)
                 for i in range(len(self.row_groups))]
        all_jobs = [j for _, jobs in plans for j in jobs]
        results = _decode_parallel(self._src, all_jobs)
        it = iter(results)
        parts = []
        for i, (fields, jobs) in enumerate(plans):
            leaf_map = {li: next(it) for li, *_ in jobs}
            parts.append(self._assemble(i, fields, leaf_map,
                                        as_dictionary))
        if not parts:                # zero row groups: empty table
            from ..core.column import column as make_col
            sch = self.schema
            if columns is not None:
                sch = dt.Schema(tuple(f for f in sch.fields
                                      if f.name in set(columns)))
            return Table(tuple(make_col([], f.dtype, device=dev)
                               for f in sch.fields), sch)
        if len(parts) == 1:
            return parts[0]
        from ..ops.concat import concat_tables
        return concat_tables(parts)


def _decode_parallel(src, jobs):
    """Decode column chunks on the file layer's pool (`hostio.pool_map`,
    ARROW_TPU_PARQUET_THREADS=0 decodes on the calling thread, =N caps).
    Safe because _read_column_chunk is pure numpy/C++ per chunk and the
    ctypes page kernels drop the GIL; the workers return host buffers
    only, and the copies to the device happen after, in `_assemble`.  A
    job is (leaf_index, chunk, leaf, crypto, page_skip)."""
    return pool_map(lambda j: _read_column_chunk(src, j[1], j[2], j[3],
                                                 page_skip=j[4]), jobs)


def _value_hashes(leaf: SchemaNode, values):
    """XXH64(seed 0) over each value's PLAIN encoding (the parquet bloom
    filter hash contract)."""
    import numpy as _np
    out = _np.zeros(len(values), _np.uint64)
    for i, v in enumerate(values):
        if isinstance(v, str):
            raw = v.encode("utf-8")
        elif isinstance(v, bytes):
            raw = v
        elif isinstance(v, (int, _np.integer)):
            width = 4 if leaf.physical == PT_INT32 else 8
            raw = int(v).to_bytes(width, "little", signed=True)
        elif isinstance(v, float):
            import struct as _st
            raw = _st.pack("<f" if leaf.physical == PT_FLOAT else "<d",
                           v)
        else:
            return None
        out[i] = nt.xxhash64(raw)
    return out


def _leaves_under(n: SchemaNode) -> List[SchemaNode]:
    if n.is_leaf:
        return [n]
    out = []
    for c in n.children:
        out.extend(_leaves_under(c))
    return out


def read_parquet_native(source, columns=None, as_dictionary=(),
                        decryption=None, *, device: DeviceLike = None
                        ) -> Table:
    """A whole file as one table on `device`."""
    from ..errors import malformed_guard
    resolve_device(device)
    with malformed_guard("parquet file"):
        return ParquetFile(source, device, decryption=decryption).read(
            columns, as_dictionary)
