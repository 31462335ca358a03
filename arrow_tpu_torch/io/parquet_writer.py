"""Native Parquet writer (thrift metadata + page encode, no pyarrow)
(counterpart of arrow_tpu/io/parquet_writer.py).

The read path (io/parquet_native.py) and this writer share the thrift codec
(io/thrift.py) and the C++ page kernels (RLE/bit-packed encode, PLAIN
byte-array encode, snappy).  Re-designs (not ports):

  ArrowWriter / properties   parquet/src/arrow/arrow_writer/mod.rs:131,
                             file/properties.rs:156
  page/chunk serialization   parquet/src/file/writer.rs,
                             column/writer/mod.rs
  def/rep level generation   parquet/src/arrow/arrow_writer/levels.rs
  bloom filters              parquet/src/bloom_filter/mod.rs (sbbf in
                             native/hostcodec.cpp, XXH64 keys)

Supported: bool/int/uint/float, timestamp/date32/time32/time64,
utf8/binary (+dictionary), fixed_size_binary, decimal128/256 (FLBA),
arbitrary nesting (struct/list/large_list/fixed_size_list/map at any
depth — vectorized Dremel level walk); v1 AND v2 data pages with
data_page_size splitting, PLAIN + RLE_DICTIONARY encodings,
snappy/zstd/gzip/uncompressed, min/max/null_count statistics, CRC32
page checksums, ColumnIndex/OffsetIndex page index, sorting-column
metadata, optional split-block bloom filters.  Unsupported types
(union/REE) raise (io/parquet_io.py names the column).

Columns may live on any device.  Each row group's slice of the table is
copied to the host once (`hostio.to_host`: one copy per buffer), and
every encoder, statistic and bloom filter of that row group reads the
host view; `_np` refuses a tensor that is still on a card.  The bytes
equal the reference's but for the footer's `created_by`.
"""

from __future__ import annotations

import copy
import io
import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           PrimitiveColumn, StringColumn, StructColumn)
from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                           FixedSizeListColumn, MapColumn)
from ..core.table import Table
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..utils import hostcodec as nt
from .hostio import host as _np, pool_map, to_host, values as _vals
from .thrift import (CompactWriter, T_BINARY, T_I16, T_I32, T_I64,
                     T_LIST, T_STRUCT, T_TRUE, T_I8)

__all__ = ["NativeParquetWriter", "write_parquet_native"]

_MAGIC = b"PAR1"
_MAGIC_ENCR = b"PARE"

PT_BOOLEAN, PT_INT32, PT_INT64, PT_INT96, PT_FLOAT, PT_DOUBLE, \
    PT_BYTE_ARRAY, PT_FLBA = range(8)

_CODEC_IDS = {"none": 0, "uncompressed": 0, "snappy": 1, "gzip": 2,
              "zstd": 6}


def _compress(codec: int, raw: bytes) -> bytes:
    if codec == 0:
        return raw
    if codec == 1:
        return nt.snappy_compress(raw)
    if codec == 2:
        co = zlib.compressobj(wbits=31)
        return co.compress(raw) + co.flush()
    if codec == 6:
        import zstandard
        return zstandard.ZstdCompressor().compress(raw)
    raise ArrowInvalid(f"codec {codec}")


# ---------------------------------------------------------------------------
# schema -> SchemaElements + leaf plan
# ---------------------------------------------------------------------------

class _Leaf:
    def __init__(self, path: List[str], d: dt.DataType, max_def: int,
                 max_rep: int):
        self.path = path
        self.dtype = d
        self.max_def = max_def
        self.max_rep = max_rep


def _logical_fields(d: dt.DataType):
    """(physical, type_length, converted, logical_struct_fields)."""
    n = d.name
    if n == "bool":
        return PT_BOOLEAN, None, None, None
    if n in ("int8", "int16", "int32", "uint8", "uint16", "uint32"):
        bits = {"int8": 8, "int16": 16, "int32": 32, "uint8": 8,
                "uint16": 16, "uint32": 32}[n]
        signed = not n.startswith("u")
        lt = [(10, T_STRUCT, [(1, T_I8, bits),
                              (2, T_TRUE, signed)])]
        if n == "int32":
            lt = None
        return PT_INT32, None, None, lt
    if n in ("int64", "uint64"):
        if n == "int64":
            return PT_INT64, None, None, None
        return PT_INT64, None, None, [(10, T_STRUCT,
                                       [(1, T_I8, 64),
                                        (2, T_TRUE, False)])]
    if n == "float16":
        # FLBA(2) + LogicalType FLOAT16 (schema/mod.rs:509)
        return PT_FLBA, 2, None, [(15, T_STRUCT, [])]
    if n == "float32":
        return PT_FLOAT, None, None, None
    if n == "float64":
        return PT_DOUBLE, None, None, None
    if n == "date32":
        return PT_INT32, None, 6, [(6, T_STRUCT, [])]
    if n == "date64":
        # no corresponding parquet type: plain INT64 (schema/mod.rs:551)
        return PT_INT64, None, None, None
    if n == "time32":
        if d.unit == "s":  # seconds not representable in TIME logical
            return PT_INT32, None, None, None
        return PT_INT32, None, 7, [(7, T_STRUCT,
                                    [(1, T_TRUE, True),
                                     (2, T_STRUCT, [(1, T_STRUCT, [])])])]
    if n == "time64":
        unit = 2 if d.unit == "us" else 3
        return PT_INT64, None, (8 if d.unit == "us" else None), \
            [(7, T_STRUCT, [(1, T_TRUE, True),
                            (2, T_STRUCT, [(unit, T_STRUCT, [])])])]
    if n == "timestamp":
        unit = {"ms": 1, "us": 2, "ns": 3}.get(d.unit)
        if unit is None:   # seconds: plain INT64 (schema/mod.rs:523)
            return PT_INT64, None, None, None
        conv = {1: 9, 2: 10}.get(unit)
        return PT_INT64, None, conv, \
            [(8, T_STRUCT, [(1, T_TRUE, bool(d.tz)),
                            (2, T_STRUCT, [(unit, T_STRUCT, [])])])]
    if n in ("utf8", "large_utf8", "utf8_view"):
        return PT_BYTE_ARRAY, None, 0, [(1, T_STRUCT, [])]
    if n in ("binary", "large_binary", "binary_view"):
        return PT_BYTE_ARRAY, None, None, None
    if n == "fixed_size_binary":
        return PT_FLBA, d.list_size, None, None
    if n == "null":
        # INT32 + LogicalType UNKNOWN (schema/mod.rs:444)
        return PT_INT32, None, None, [(11, T_STRUCT, [])]
    if n in ("decimal32", "decimal64"):
        # INT32/INT64 physical per the spec's precision rule
        # (schema/mod.rs:634-644)
        lt = [(5, T_STRUCT, [(1, T_I32, d.scale), (2, T_I32,
                                                   d.precision)])]
        return (PT_INT32 if n == "decimal32" else PT_INT64), None, 5, lt
    if n in ("decimal128", "decimal256"):
        lt = [(5, T_STRUCT, [(1, T_I32, d.scale), (2, T_I32,
                                                   d.precision)])]
        return PT_FLBA, 16 if n == "decimal128" else 32, 5, lt
    if n == "duration":
        # no parquet logical type: plain INT64, recovered via the
        # embedded ARROW:schema hint (schema/mod.rs:595)
        return PT_INT64, None, None, None
    if n == "interval":
        if d.unit == "month_day_nano":
            raise ArrowNotImplementedError(
                "parquet does not support nanosecond intervals")
        # FLBA(12) months/days/millis + ConvertedType INTERVAL
        # (schema/mod.rs:599)
        return PT_FLBA, 12, 21, None
    raise ArrowNotImplementedError(f"parquet write of {d!r}")


def _schema_elements(schema: dt.Schema):
    """-> (thrift SchemaElement field-lists incl. root, leaves)."""
    elems: List[list] = []
    leaves: List[_Leaf] = []

    def walk(name: str, d: dt.DataType, nullable: bool,
             path: List[str], max_def: int, max_rep: int,
             field_md: tuple = ()):
        rep = 1 if nullable else 0
        if nullable:
            max_def += 1
        if d.name == "struct":
            el = [(3, T_I32, rep), (4, T_BINARY, name),
                  (5, T_I32, len(d.fields))]
            if dict(field_md).get("ARROW:extension:name") == \
                    "arrow.variant":
                # LogicalType VARIANT (parquet.thrift VariantType,
                # union field 16; specification_version 1)
                el.append((10, T_STRUCT, [(16, T_STRUCT,
                                           [(1, T_I8, 1)])]))
            elems.append(el)
            for f in d.fields:
                walk(f.name, f.dtype, f.nullable, path + [name],
                     max_def, max_rep, f.metadata)
            return
        if d.name in ("list", "large_list", "fixed_size_list"):
            elems.append([(3, T_I32, rep), (4, T_BINARY, name),
                          (5, T_I32, 1), (6, T_I32, 3),   # LIST
                          (10, T_STRUCT, [(3, T_STRUCT, [])])])
            elems.append([(3, T_I32, 2), (4, T_BINARY, "list"),
                          (5, T_I32, 1)])
            walk("element", d.value_type, True,
                 path + [name, "list"], max_def + 1, max_rep + 1)
            return
        if d.name == "map":
            kv = d.value_type                 # {key, value} struct
            elems.append([(3, T_I32, rep), (4, T_BINARY, name),
                          (5, T_I32, 1), (6, T_I32, 1),   # MAP
                          (10, T_STRUCT, [(2, T_STRUCT, [])])])
            elems.append([(3, T_I32, 2), (4, T_BINARY, "key_value"),
                          (5, T_I32, 2)])
            walk("key", kv.fields[0].dtype, False,
                 path + [name, "key_value"], max_def + 1, max_rep + 1)
            walk("value", kv.fields[1].dtype, True,
                 path + [name, "key_value"], max_def + 1, max_rep + 1)
            return
        if d.name == "dictionary":
            walk(name, d.value_type, nullable, path, max_def - rep,
                 max_rep)
            return
        phys, tlen, conv, logical = _logical_fields(d)
        fields = [(1, T_I32, phys), (3, T_I32, rep),
                  (4, T_BINARY, name)]
        if tlen is not None:
            fields.insert(1, (2, T_I32, tlen))
        if conv is not None:
            fields.append((6, T_I32, conv))
        if d.is_decimal:
            fields.append((7, T_I32, d.scale))
            fields.append((8, T_I32, d.precision))
        if logical is not None:
            fields.append((10, T_STRUCT, logical))
        elems.append(fields)
        leaves.append(_Leaf(path + [name], d, max_def, max_rep))

    root = [(4, T_BINARY, "schema"), (5, T_I32, len(schema.fields))]
    elems.append(root)
    for f in schema.fields:
        walk(f.name, f.dtype, f.nullable, [], 0, 0, f.metadata)
    return elems, leaves


# ---------------------------------------------------------------------------
# column chunk encode
# ---------------------------------------------------------------------------

def _t(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor (no copy where it is contiguous)."""
    return torch.from_numpy(np.ascontiguousarray(a))


def _gather_leaf(c: Column, rows: np.ndarray) -> Column:
    """Host-side row gather for leaf column kinds (stays on the host —
    the writer never round-trips through the device)."""
    from ..core.column import NullColumn
    if isinstance(c, NullColumn):
        # null leaves write as INT32/Unknown pages with zero values
        # (schema/mod.rs:444); every row is null so the gather is empty
        return PrimitiveColumn(_t(np.zeros(len(rows), np.int32)), dt.int32)
    if len(rows) == len(c) and (
            len(rows) == 0 or (int(rows[0]) == 0
                               and int(rows[-1]) == len(c) - 1
                               and bool(np.all(np.diff(rows) == 1)))):
        return c
    if isinstance(c, StringColumn):
        offs2, data2 = nt.gather_varlen(
            _np(c.offsets).astype(np.int64), _np(c.data), rows)
        return StringColumn.from_numpy(offs2, data2, None, c.dtype,
                                       device="cpu")
    if isinstance(c, DictionaryColumn):
        return DictionaryColumn(_t(_np(c.codes)[rows]), c.values,
                                None, _canonical=True)
    if isinstance(c, DecimalColumn):
        return DecimalColumn(_t(_np(c.limbs)[rows]), c.dtype, None)
    if isinstance(c, FixedSizeBinaryColumn):
        return FixedSizeBinaryColumn(_t(_np(c.data)[rows]), None)
    return PrimitiveColumn(_t(_np(c.values)[rows]), c.dtype, None,
                           _canonical=True)


def _flatten_leaf(col: Column, nullable: bool):
    """-> [(leaf_values, defs i64|None, reps i64|None)] in schema leaf
    order (arrow_writer/levels.rs role, re-designed as a vectorized
    numpy Dremel walk).

    The walk carries (defs, reps, srow) on the current slot axis: srow
    maps each slot to a row of the current column, -1 where an ancestor
    is null/empty so the subtree contributes nothing.  List/map/
    fixed-size-list nodes expand the slot axis by per-row element
    counts (every parent slot keeps at least one child slot so level
    runs stay complete); leaves gather exactly the rows whose def
    reached max_def, so leaf values arrive compacted — no value mask.

    Flat leaves (the dominant case) shortcut the walk entirely."""
    if not isinstance(col, (StructColumn, ListColumn, MapColumn,
                            FixedSizeListColumn)):
        if not nullable:
            return [(col, None, None)]
        if col.validity is None:
            # nullable schema, zero nulls: the wire still needs a def-
            # level stream, but it is ONE constant RLE run — carry a
            # lazy marker instead of a materialized 8B/row plane
            return [(col, _ConstDefs(len(col)), None)]
        v = _np(col.validity)
        rows = np.nonzero(v)[0]
        return [(_gather_leaf(col, rows), v.astype(np.int64), None)]
    out = []

    def walk(c, f_nullable, defs, reps, srow, cur_def, cur_rep):
        live = srow >= 0
        if f_nullable:
            if c.validity is not None and len(c):
                v = _np(c.validity)
                ok = live & v[np.clip(srow, 0, len(c) - 1)]
            else:
                ok = live
            defs = np.where(ok, defs + 1, defs)
            srow = np.where(ok, srow, np.int64(-1))
            cur_def += 1
            live = ok
        if isinstance(c, StructColumn):
            for ch, f in zip(c.children, c.fields):
                walk(ch, f.nullable, defs.copy(), reps.copy(),
                     srow.copy(), cur_def, cur_rep)
            return
        if isinstance(c, (ListColumn, MapColumn, FixedSizeListColumn)):
            ns = len(defs)
            sr = np.clip(srow, 0, max(len(c) - 1, 0))
            if isinstance(c, FixedSizeListColumn):
                k = c.list_size
                counts = np.where(live, np.int64(k), np.int64(0))
                base = sr * k
            elif len(c) == 0:
                # an empty list column (every outer slot dead/empty)
                # has offsets == [0]; offs[sr + 1] would index past it
                # (np.where evaluates both branches)
                counts = np.zeros(ns, np.int64)
                base = np.zeros(ns, np.int64)
            else:
                offs = _np(c.offsets).astype(np.int64)
                counts = np.where(live, offs[sr + 1] - offs[sr],
                                  np.int64(0))
                base = offs[sr]
            exp = np.maximum(counts, 1)
            parent = np.repeat(np.arange(ns), exp)
            total = int(exp.sum())
            starts = np.zeros(ns, np.int64)
            if ns:
                np.cumsum(exp[:-1], out=starts[1:])
            pos = np.arange(total, dtype=np.int64) - starts[parent]
            has_elem = counts > 0
            new_reps = np.where(pos == 0, reps[parent],
                                np.int64(cur_rep + 1))
            new_defs = np.where(has_elem[parent], defs[parent] + 1,
                                defs[parent])
            child_row = np.where(has_elem[parent], base[parent] + pos,
                                 np.int64(-1))
            if isinstance(c, MapColumn):
                walk(c.keys, False, new_defs.copy(), new_reps.copy(),
                     child_row.copy(), cur_def + 1, cur_rep + 1)
                walk(c.items, True, new_defs, new_reps, child_row,
                     cur_def + 1, cur_rep + 1)
            else:
                walk(c.child, True, new_defs, new_reps, child_row,
                     cur_def + 1, cur_rep + 1)
            return
        # leaf: compact values to slots whose def reached max_def
        rows = srow[srow >= 0]
        leaf_c = _gather_leaf(c, rows)
        out.append((leaf_c, defs if cur_def else None,
                    reps if cur_rep else None))

    n = len(col)
    walk(col, nullable, np.zeros(n, np.int64), np.zeros(n, np.int64),
         np.arange(n, dtype=np.int64), 0, 0)
    return out


class _ConstDefs:
    """All-valid def levels for a flat nullable leaf: every slot's def
    is max_def.  Encodes as a single RLE run without ever materializing
    the level plane (arrow_writer/levels.rs fast path role)."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n


def _const_run_bytes(count: int, value: int, max_level: int) -> bytes:
    """RLE/bit-packed hybrid stream holding `count` copies of `value`."""
    bw = max(1, int(max_level).bit_length())
    nbytes = (bw + 7) // 8
    out = bytearray()
    _varint(out, count << 1)
    out += int(value).to_bytes(nbytes, "little")
    return bytes(out)


def _plain_values(c: Column, mask: Optional[np.ndarray]) -> bytes:
    """PLAIN-encode the non-null values of a leaf column."""
    d = c.dtype
    if isinstance(c, DictionaryColumn):
        raise AssertionError("dictionary handled by caller")
    if isinstance(c, StringColumn):
        offs = _np(c.offsets).astype(np.int64)
        data = _np(c.data)
        if mask is not None and not mask.all():
            keep = np.nonzero(mask)[0]
            offs2, data2 = nt.gather_varlen(offs, data, keep)
        else:
            offs2, data2 = offs, data
        return nt.plain_byte_array_encode(offs2, data2)
    if isinstance(c, FixedSizeBinaryColumn):
        vals = _np(c.data)
        if mask is not None and not mask.all():
            vals = vals[mask]
        return vals.tobytes()
    if isinstance(c, DecimalColumn):
        limbs = _np(c.limbs)
        if mask is not None and not mask.all():
            limbs = limbs[mask]
        # little-endian limbs -> big-endian two's complement (16B or 32B)
        w = limbs.shape[1] * 8
        le = limbs.astype("<u8").view(np.uint8).reshape(len(limbs), w)
        be = le[:, ::-1]
        return np.ascontiguousarray(be).tobytes()
    vals = _vals(c)
    if mask is not None and not mask.all():
        vals = vals[mask]
    if d.name == "bool":
        return np.packbits(vals.astype(bool),
                           bitorder="little").tobytes()
    if d.name == "interval":
        # FLBA(12): months/days/millis, each i32 LE
        # (arrow_writer/mod.rs:1252,1268)
        out = np.zeros((len(vals), 12), np.uint8)
        if d.unit == "year_month":
            out[:, :4] = vals.astype("<i4").view(np.uint8) \
                .reshape(-1, 4)
        else:                          # day_time: i64 days<<32 | millis
            v = vals.astype(np.int64)
            out[:, 4:8] = (v >> 32).astype("<i4").view(np.uint8) \
                .reshape(-1, 4)
            out[:, 8:12] = (v & 0xFFFFFFFF).astype("<u4") \
                .view(np.uint8).reshape(-1, 4)
        return out.tobytes()
    target = {"int8": np.int32, "int16": np.int32, "uint8": np.int32,
              "uint16": np.int32, "uint32": np.int32,
              "int32": np.int32, "date32": np.int32,
              "time32": np.int32,
              "uint64": np.int64}.get(d.name)
    if target is not None:
        vals = vals.astype(target, copy=False) \
            if d.name != "uint32" else vals.astype(np.uint32) \
            .view(np.int32)
        if d.name == "uint64":
            vals = vals.astype(np.uint64).view(np.int64)
    return np.ascontiguousarray(vals).tobytes()


# ---------------------------------------------------------------------------
# v2 value encoders (encodings/delta_bitpack_encoder + rle roles): the
# reference's PARQUET_2_0 fallback encodings (column/writer/mod.rs:1444)
# ---------------------------------------------------------------------------

def _varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(out: bytearray, v: int):
    _varint(out, ((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF
            if v < 0 else v << 1)


def delta_binary_packed_encode(vals: np.ndarray) -> bytes:
    """DELTA_BINARY_PACKED (block 128, 4 miniblocks of 32), vectorized:
    miniblocks grouped BY bit width and batch-packed with np.packbits."""
    n = len(vals)
    out = bytearray()
    _varint(out, 128)
    _varint(out, 4)
    _varint(out, n)
    if n == 0:
        _zigzag(out, 0)
        return bytes(out)
    v = vals.astype(np.int64, copy=False)
    _zigzag(out, int(v[0]))
    if n == 1:
        return bytes(out)
    # wrap-safe deltas in u64 arithmetic
    d = (v[1:].astype(np.uint64) - v[:-1].astype(np.uint64))
    nd = len(d)
    nblocks = (nd + 127) // 128
    pad = nblocks * 128 - nd
    d = np.concatenate([d, np.zeros(pad, np.uint64)])
    ds = d.view(np.int64).reshape(nblocks, 128)
    mins = ds.min(axis=1)
    adj = (ds.view(np.uint64)
           - mins.astype(np.uint64)[:, None]).reshape(nblocks, 4, 32)
    # padded tail positions must encode as 0 (delta == min_delta)
    if pad:
        flat = adj.reshape(-1)
        flat[nd:] = 0
        adj = flat.reshape(nblocks, 4, 32)
    # miniblock bit widths via exact bit_length on each miniblock max
    mx = adj.max(axis=2)
    bws = np.frompyfunc(lambda x: int(x).bit_length(), 1, 1)(mx) \
        .astype(np.int64)
    # how many miniblocks each block actually stores (last block may
    # stop early)
    vals_in_block = np.full(nblocks, 128, np.int64)
    vals_in_block[-1] = nd - (nblocks - 1) * 128
    mb_count = np.minimum((vals_in_block + 31) // 32, 4)
    # batch-pack per distinct width
    packed: dict = {}
    for bw in np.unique(bws):
        bw = int(bw)
        if bw == 0:
            continue
        ids = np.nonzero(bws == bw)
        sub = adj[ids]                      # (M, 32)
        bits = ((sub[:, :, None]
                 >> np.arange(bw, dtype=np.uint64)[None, None, :])
                & np.uint64(1)).astype(np.uint8)
        by = np.packbits(bits.reshape(len(sub), 32 * bw), axis=1,
                         bitorder="little")
        for k, (bi, mi) in enumerate(zip(*ids)):
            packed[(int(bi), int(mi))] = by[k].tobytes()
    for b in range(nblocks):
        _zigzag(out, int(mins[b]))
        mc = int(mb_count[b])
        wrow = [int(bws[b, m]) if m < mc else 0 for m in range(4)]
        out.extend(bytes(wrow))
        for m in range(mc):
            if wrow[m]:
                out.extend(packed[(b, m)])
    return bytes(out)


def _common_prefix_lens(offs: np.ndarray, data8: np.ndarray,
                        lens: np.ndarray) -> np.ndarray:
    """prefix[i] = length of the common prefix of value i with value
    i-1 (prefix[0] = 0), fully vectorized: one flat byte-compare over
    sum(min(len[i-1], len[i])) positions, then a per-segment
    first-mismatch via minimum.reduceat."""
    n = len(lens)
    pref = np.zeros(n, np.int64)
    if n <= 1:
        return pref
    m = np.minimum(lens[:-1], lens[1:]).astype(np.int64)   # pair p=(p,p+1)
    total = int(m.sum())
    if total == 0:
        return pref
    starts = np.zeros(n - 1, np.int64)
    np.cumsum(m[:-1], out=starts[1:])
    seg = np.repeat(np.arange(n - 1), m)
    pos = np.arange(total, dtype=np.int64) - starts[seg]
    off64 = offs.astype(np.int64, copy=False)
    eq = data8[off64[seg] + pos] == data8[off64[seg + 1] + pos]
    val = np.where(eq, np.int64(1) << 62, pos)
    nz = m > 0
    red = np.minimum.reduceat(val, starts[nz])
    pref[1:][nz] = np.minimum(red, m[nz])
    return pref


def delta_byte_array_encode(offs: np.ndarray, data: np.ndarray) -> bytes:
    """DELTA_BYTE_ARRAY (incremental encoding, encoding/mod.rs
    DeltaByteArrayEncoder role): real common-prefix compression against
    the previous value — prefix lengths + suffix lengths as
    DELTA_BINARY_PACKED, then the concatenated suffix bytes."""
    n = len(offs) - 1
    lens = (offs[1:] - offs[:-1]).astype(np.int64)
    data8 = np.asarray(data, np.uint8)
    pref = _common_prefix_lens(offs, data8, lens)
    sfx = lens - pref
    out = bytearray()
    out += delta_binary_packed_encode(pref)
    out += delta_binary_packed_encode(sfx)
    sfx_total = int(sfx.sum())
    if sfx_total:
        if int(pref.sum()) == 0:
            out += data8[:int(offs[-1])].tobytes()
        else:
            sstarts = np.zeros(n, np.int64)
            np.cumsum(sfx[:-1], out=sstarts[1:])
            seg = np.repeat(np.arange(n), sfx)
            pos = np.arange(sfx_total, dtype=np.int64) - sstarts[seg]
            src = offs.astype(np.int64)[seg] + pref[seg] + pos
            out += data8[src].tobytes()
    return bytes(out)


def delta_length_byte_array_encode(offs: np.ndarray,
                                   data: np.ndarray) -> bytes:
    """DELTA_LENGTH_BYTE_ARRAY: lengths as DELTA_BINARY_PACKED, then
    the raw concatenated bytes (encoding/mod.rs DeltaLengthByteArray)."""
    lens = (offs[1:] - offs[:-1]).astype(np.int64)
    return delta_binary_packed_encode(lens) \
        + np.asarray(data, np.uint8)[:int(offs[-1])].tobytes()


def rle_bool_encode(vals: np.ndarray) -> bytes:
    """RLE as a v2 VALUES encoding for booleans: u32 length prefix +
    RLE/bit-packed hybrid at bit width 1."""
    rle = nt.rle_bp_encode(vals.astype(np.uint32), 1)
    return struct.pack("<I", len(rle)) + rle


def _levels_bytes(levels: np.ndarray, max_level: int) -> bytes:
    bw = max(1, int(max_level).bit_length())
    rle = nt.rle_bp_encode(levels.astype(np.uint32), bw)
    return struct.pack("<I", len(rle)) + rle


# the top k bytes of a big-endian u64 word set, k = 0..8
_TOP_BYTES = np.array([((1 << 64) - 1) ^ ((1 << (64 - 8 * k)) - 1)
                       for k in range(9)], np.uint64)


def _minmax_strings(offs: np.ndarray, data: np.ndarray, sel=None):
    """Exact lexicographic (min, max) over varlen byte strings,
    vectorized: compare 64-byte zero-padded prefixes eight bytes at a
    time as big-endian u64 words, then break prefix ties (truncation or
    trailing NULs) by python-comparing only the tied rows.  A word is
    built only for the rows still tied after the words before it (the
    reference builds every row's 64 bytes at once; the result is the
    same)."""
    n = len(offs) - 1
    idx = np.arange(n) if sel is None else sel
    if len(idx) == 0:
        return None, None
    if len(data) == 0:
        return b"", b""              # every selected string is empty
    lens = offs[idx + 1] - offs[idx]
    L = min(int(lens.max()), 64) if len(lens) else 1
    L = max(L, 1)
    Lp = ((L + 7) // 8) * 8
    starts = offs[idx]
    windows = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([data, np.zeros(8, np.uint8)]), 8)

    def word(rows, b):
        """Bytes [8b, 8b + 8) of the rows, zero past each end, as u64."""
        st = np.minimum(starts[rows] + 8 * b, len(data))
        keep = np.clip(lens[rows] - 8 * b, 0, 8)
        w = np.ascontiguousarray(windows[st]).view(">u8").ravel()
        return w.astype(np.uint64) & _TOP_BYTES[keep]

    first = word(np.arange(len(idx)), 0)

    def reduce(best):
        sel = np.arange(len(idx))
        for b in range(Lp // 8):
            w = first[sel] if b == 0 else word(sel, b)
            target = best(w)
            sel = sel[w == target]
            if len(sel) == 1:
                break
        return sel

    def full(i):
        return data[offs[i]:offs[i + 1]].tobytes()

    gmin = idx[reduce(np.min)]
    gmax = idx[reduce(np.max)]
    if int(lens.max()) <= 64:
        # no truncation: tied rows differ only by trailing NULs, so the
        # shortest is the true min and the longest the true max (no
        # python loop even for constant columns)
        lmin = offs[gmin + 1] - offs[gmin]
        lmax = offs[gmax + 1] - offs[gmax]
        return (full(int(gmin[np.argmin(lmin)])),
                full(int(gmax[np.argmax(lmax)])))
    mn = min(full(int(i)) for i in gmin)
    mx = max(full(int(i)) for i in gmax)
    return mn, mx


def _stats_full(c: Column, mask):
    """(min_bytes, max_bytes, null_count, min_cmp, max_cmp): the PLAIN
    encodings plus Python-comparable values (page-index boundary order
    is decided in the column's LOGICAL order, not byte order)."""
    n = len(c)
    nulls = 0 if mask is None else int(n - mask.sum())
    try:
        if isinstance(c, StringColumn):
            offs = _np(c.offsets).astype(np.int64)
            data = _np(c.data)
            sel = np.nonzero(mask)[0] if mask is not None else None
            mn, mx = _minmax_strings(offs, data, sel)
            if mn is None:
                return None, None, nulls, None, None
            return mn, mx, nulls, mn, mx
        if isinstance(c, (FixedSizeBinaryColumn, DecimalColumn)):
            return None, None, nulls, None, None
        vals = _vals(c)
        if mask is not None:
            vals = vals[mask]
        if len(vals) == 0 or c.dtype.name in ("bool", "interval"):
            # INTERVAL's column order is UNDEFINED: no stats
            return None, None, nulls, None, None
        if c.dtype.name in ("float16", "float32", "float64"):
            # NaNs are excluded from min/max (parquet spec; arrow-rs
            # statistics.rs skips non-finite-orderable values)
            vals = vals[~np.isnan(vals)]
            if len(vals) == 0:
                return None, None, nulls, None, None
        mn, mx = vals.min(), vals.max()
        if c.dtype.name == "float16":
            return (np.float16(mn).tobytes(), np.float16(mx).tobytes(),
                    nulls, float(mn), float(mx))
        fmt = {"float32": "<f", "float64": "<d"}.get(
            c.dtype.name)
        if fmt:
            return struct.pack(fmt, mn), struct.pack(fmt, mx), nulls, \
                float(mn), float(mx)
        # integers PLAIN-encode at the physical width (INT32/INT64);
        # unsigned values reinterpret as the same-width bits so u32 >
        # INT32_MAX round-trips (spec: stats use the logical order,
        # stored as physical bytes)
        wide = c.dtype.to_numpy().itemsize > 4
        unsigned = c.dtype.name.startswith("uint")
        pdt = (np.uint64 if wide else np.uint32) if unsigned else \
            (np.int64 if wide else np.int32)
        return (pdt(int(mn)).tobytes(), pdt(int(mx)).tobytes(),
                nulls, int(mn), int(mx))
    except Exception:                      # noqa: BLE001
        return None, None, nulls, None, None


def _stats_bytes(c: Column, mask) -> Tuple[Optional[bytes],
                                           Optional[bytes], int]:
    """(min_value, max_value, null_count) PLAIN-encoded."""
    return _stats_full(c, mask)[:3]


def _crc32_i32(b: bytes) -> int:
    import zlib
    v = zlib.crc32(b) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _boundary_order(page_stats) -> int:
    """BoundaryOrder enum: 0 unordered, 1 ascending, 2 descending —
    computed over the non-null-page min/max sequences in the column's
    logical order (file/page_index/index.rs determine_boundary_order
    role)."""
    mins = [s[4] for s in page_stats if not s[3]]
    maxs = [s[5] for s in page_stats if not s[3]]
    if any(v is None for v in mins) or any(v is None for v in maxs):
        return 0
    if len(mins) <= 1:
        return 1
    if all(a <= b for a, b in zip(mins, mins[1:])) and \
            all(a <= b for a, b in zip(maxs, maxs[1:])):
        return 1
    if all(a >= b for a, b in zip(mins, mins[1:])) and \
            all(a >= b for a, b in zip(maxs, maxs[1:])):
        return 2
    return 0


def _rebase(cc: list, slot, base: int) -> None:
    """Move a detached chunk's file offsets by `base`: the chunk's own
    (ColumnChunk 2), its data, dictionary and bloom pages (ColumnMetaData
    9, 11, 14) and each page of its OffsetIndex."""
    for i, (fid, t, v) in enumerate(cc):
        if fid == 2:
            cc[i] = (fid, t, v + base)
        elif fid == 3:
            for j, (f2, t2, v2) in enumerate(v):
                if f2 in (9, 11, 14):
                    v[j] = (f2, t2, v2 + base)
    if slot is not None:
        for page in slot[2][0][2][1]:          # OffsetIndex page_locations
            page[0] = (1, T_I64, page[0][2] + base)


def _distinct_size(offs: np.ndarray, data: np.ndarray, limit: int) -> int:
    """The dictionary size estimate of a string chunk (4 bytes a distinct
    value and its bytes), interned on growing prefixes of the rows and
    returned as soon as it passes `limit`: a prefix's estimate never
    exceeds the whole's, so the comparison with `limit` is the whole's."""
    n, m = len(offs) - 1, 1 << 16
    while True:
        m = min(m, n)
        _, uniq = nt.intern_varlen(offs[:m + 1], data)
        est = len(uniq) * 4 + int((offs[uniq + 1] - offs[uniq]).sum())
        if est > limit or m == n:
            return est
        m *= 8


def _used_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """The distinct codes among `codes`, ascending (np.unique's result)
    from one counting pass over the k dictionary slots."""
    if len(codes) == 0:
        return np.zeros(0, np.int64)
    return np.flatnonzero(np.bincount(codes.astype(np.int64), minlength=k))


def _dict_page_stats(values_col, pcodes, n_nulls):
    """(min, max, nulls, all_null) over the distinct values a page's
    codes reference (byte-comparable UTF-8/binary ordering)."""
    if len(pcodes) == 0:
        return None, None, n_nulls, True, None, None
    try:
        uniq = _used_codes(pcodes, len(values_col))
        offs = _np(values_col.offsets).astype(np.int64)
        data = _np(values_col.data).tobytes()
        vals = [data[offs[i]:offs[i + 1]] for i in uniq]
        mn, mx = min(vals), max(vals)
        return mn, mx, n_nulls, False, mn, mx
    except Exception:                      # noqa: BLE001
        return None, None, n_nulls, False, None, None


def _encode_arrow_schema(schema: dt.Schema) -> str:
    """base64 of the length-prefixed IPC Schema message (the legacy
    4-byte-continuation framing arrow-rs/C++ both emit;
    schema/mod.rs:182 encode_arrow_schema)."""
    import base64
    from .ipc_format import write_schema_message
    fb = write_schema_message(schema)
    framed = b"\xff\xff\xff\xff" + struct.pack("<I", len(fb)) + fb
    return base64.b64encode(framed).decode()


def _strip_view_dtype(d: dt.DataType) -> dt.DataType:
    """list_view/large_list_view -> list/large_list, recursively.
    Parquet has no view layout (the reference rejects them,
    schema/mod.rs:717); this writer stores views as lists and the
    ARROW:schema hint restores the view dtype on read."""
    n = d.name
    if n == "list_view":
        return dt.list_(_strip_view_dtype(d.value_type))
    if n == "large_list_view":
        return dt.large_list(_strip_view_dtype(d.value_type))
    if n in ("list", "large_list"):
        inner = _strip_view_dtype(d.value_type)
        return d if inner == d.value_type else \
            (dt.large_list if n == "large_list" else dt.list_)(inner)
    if n == "fixed_size_list":
        inner = _strip_view_dtype(d.value_type)
        return d if inner == d.value_type else \
            dt.fixed_size_list(inner, d.list_size)
    if n == "struct":
        fields = tuple(dt.Field(f.name, _strip_view_dtype(f.dtype),
                                f.nullable) for f in d.fields)
        return d if fields == d.fields else dt.struct(fields)
    if n == "map":
        kv = d.value_type
        k2 = _strip_view_dtype(kv.fields[0].dtype)
        v2 = _strip_view_dtype(kv.fields[1].dtype)
        if (k2, v2) == (kv.fields[0].dtype, kv.fields[1].dtype):
            return d
        return dt.map_(k2, v2)
    return d


class NativeParquetWriter:
    def __init__(self, sink, schema: dt.Schema, compression="snappy",
                 dictionary_enabled: bool = True,
                 write_statistics: bool = True,
                 bloom_filter_columns: Sequence[str] = (),
                 row_group_size: int = 1 << 20,
                 data_page_size: Optional[int] = None,
                 data_page_version: str = "1.0",
                 write_page_index: bool = False,
                 write_page_checksum: bool = False,
                 sorting_columns: Optional[Sequence] = None,
                 encryption=None,
                 key_value_metadata: Optional[dict] = None,
                 store_schema: bool = True,
                 column_properties: Optional[dict] = None,
                 encoding: Optional[str] = None,
                 dictionary_page_size_limit: int = 1 << 20):
        self._own = isinstance(sink, str)
        self._out = open(sink, "wb") if self._own else sink
        self._arrow_schema = schema        # the embed keeps view dtypes
        stripped = tuple(dt.Field(f.name, _strip_view_dtype(f.dtype),
                                  f.nullable) for f in schema.fields)
        if stripped != tuple(schema.fields):
            schema = dt.Schema(stripped, metadata=schema.metadata)
        self.schema = schema
        self.encryption = encryption
        self._file_aad = b""
        if encryption is not None:
            if bloom_filter_columns:
                raise ArrowNotImplementedError(
                    "bloom filters on encrypted files")
            import os as _os
            self._aad_unique = _os.urandom(8)
            self._file_aad = encryption.aad_prefix + self._aad_unique
        self.codec = _CODEC_IDS[(compression or "none").lower()]
        self.dictionary_enabled = dictionary_enabled
        self.write_statistics = write_statistics
        # per-column overrides (file/properties.rs set_column_* roles):
        # {column-or-leaf-path: {compression, dictionary_enabled,
        #  write_statistics}}
        self.column_properties = dict(column_properties or {})
        # default VALUES encoding for every column without a per-column
        # override (properties.rs set_encoding); None = format defaults
        self.encoding = encoding
        self.dictionary_page_size_limit = dictionary_page_size_limit
        self.bloom_filter_columns = set(bloom_filter_columns)
        self.row_group_size = row_group_size
        self.data_page_size = data_page_size or (1 << 20)
        self.page_v2 = data_page_version in ("2.0", "2", 2)
        self.write_page_index = write_page_index
        self.write_page_checksum = write_page_checksum
        self.sorting_columns = sorting_columns
        self.key_value_metadata = key_value_metadata
        self.store_schema = store_schema
        self._elems, self._leaves = _schema_elements(schema)
        self._row_groups: List[list] = []
        # per chunk (footer order): (cc_fields_list, colidx_fields|None,
        # offidx_fields) — the index bodies are written at close() and
        # their offsets appended to the live cc lists before the footer
        self._index_slots: List[tuple] = []
        self._num_rows = 0
        self._pos = 0
        self._ck = None
        self._page_ord = 0
        self._emit(_MAGIC if encryption is None else _MAGIC_ENCR)

    def _emit(self, b: bytes):
        self._out.write(b)
        self._pos += len(b)

    def _col_prop(self, leaf: "_Leaf", key: str, default):
        """Per-column writer property: dotted leaf path wins, then the
        leaf name, then the top-level column (properties.rs per-column
        overrides most-specific-first resolution)."""
        for probe in (".".join(leaf.path), leaf.path[-1], leaf.path[0]):
            ov = self.column_properties.get(probe)
            if ov is not None and key in ov:
                return ov[key]
        return default

    def _crypto_for(self, leaf: _Leaf, rg_ord: int, col_ord: int):
        """Set the chunk crypto context: (key, mode, rg, col) or None
        (plaintext chunk / unencrypted file)."""
        self._ck = None
        self._page_ord = 0
        if self.encryption is None:
            return
        path = ".".join(leaf.path)
        key, mode = self.encryption.key_for(path)
        if key is None and path != leaf.path[-1]:
            key, mode = self.encryption.key_for(leaf.path[-1])
        if key is not None:
            self._ck = (key, mode, rg_ord, col_ord)

    def _encrypt_page(self, header_fields, body: bytes, mtype_hdr: int,
                      mtype_body: int, with_ordinal: bool):
        """Encrypt one page: header and body become separate GCM
        modules (ciphers.rs framing); the header's compressed size is
        patched to the ENCRYPTED body module length, which is what the
        reader is told to fetch (serialized_reader.rs:778)."""
        from .parquet_crypto import encrypt_module, module_aad
        key, _, rg, col = self._ck
        page = self._page_ord if with_ordinal else None
        body_mod = encrypt_module(
            key, body, module_aad(self._file_aad, mtype_body, rg, col,
                                  page))
        fields = [(fid, t, len(body_mod)) if fid == 3 else (fid, t, v)
                  for fid, t, v in header_fields]
        hdr = CompactWriter()
        hdr.write_struct_fields(fields)
        hdr_mod = encrypt_module(
            key, hdr.bytes(), module_aad(self._file_aad, mtype_hdr, rg,
                                         col, page))
        return hdr_mod + body_mod

    def write_table(self, table: Table):
        if self.schema.fields != tuple(self._arrow_schema.fields):
            # view columns store as lists (ARROW:schema restores)
            from ..ops.cast import cast as _cast
            cols = tuple(
                _cast(c, f.dtype) if c.dtype != f.dtype else c
                for c, f in zip(table.columns, self.schema.fields))
            table = Table(cols, self.schema, _validated=True)
        for start in range(0, table.num_rows, self.row_group_size):
            # the row group's buffers on the host, once
            self._write_row_group(to_host(
                table.slice(start, min(self.row_group_size,
                                       table.num_rows - start))))

    def _write_row_group(self, table: Table):
        chunks = []
        total_bytes = 0
        rg_ord = len(self._row_groups)
        jobs = [(leaf, *flat) for leaf, flat in zip(self._leaves, (
            flat for col, f in zip(table.columns, self.schema.fields)
            for flat in _flatten_leaf(col, f.nullable)))]
        if self.encryption is None:
            # the column chunks encode on the file layer's pool, each into
            # its own buffer from offset 0, and go out in order, their
            # offsets moved by where each lands: the bytes of one pass
            for cc, nbytes, body, slot in pool_map(
                    lambda job: self._detached_chunk(*job), jobs):
                _rebase(cc, slot, self._pos)
                self._emit(body)
                if slot is not None:
                    self._index_slots.append(slot)
                chunks.append(cc)
                total_bytes += nbytes
        else:
            # encrypted: one chunk after another, each module's AAD
            # naming its place
            for col_ord, (leaf, leaf_col, defs, reps) in enumerate(jobs):
                self._crypto_for(leaf, rg_ord, col_ord)
                cc, nbytes = self._write_chunk(leaf, leaf_col, defs, reps)
                chunks.append(cc)
                total_bytes += nbytes
        rg = [(1, T_LIST, (T_STRUCT, chunks)),
              (2, T_I64, total_bytes),
              (3, T_I64, table.num_rows),
              # ordinal (i16): readers use THIS, not the list position,
              # as the row-group ordinal in encryption module AADs
              (7, T_I16, rg_ord)]
        if self.sorting_columns:
            leaf_names = [lf.path[-1] for lf in self._leaves]
            sc = []
            for item in self.sorting_columns:
                name, desc = item[0], item[1]
                nulls_first = item[2] if len(item) > 2 else not desc
                sc.append([(1, T_I32, leaf_names.index(name)),
                           (2, T_TRUE, bool(desc)),
                           (3, T_TRUE, bool(nulls_first))])
            rg.append((4, T_LIST, (T_STRUCT, sc)))
        self._row_groups.append(rg)
        self._num_rows += table.num_rows

    def _detached_chunk(self, leaf: _Leaf, c: Column, defs, reps):
        """One unencrypted column chunk written into a buffer of its own
        as if the file began there: (its ColumnChunk fields, its
        compressed size, its bytes, its page-index slot or None)."""
        sub = copy.copy(self)
        sub._out, sub._pos, sub._index_slots = io.BytesIO(), 0, []
        sub._ck, sub._page_ord = None, 0
        cc, nbytes = sub._write_chunk(leaf, c, defs, reps)
        return cc, nbytes, sub._out.getvalue(), \
            sub._index_slots[0] if sub._index_slots else None

    def _page_ranges(self, leaf: _Leaf, c: Column, defs, reps):
        """Split a flat chunk's slot axis into page row ranges sized by
        data_page_size (file/properties.rs DEFAULT_PAGE_SIZE role).
        Repeated chunks stay one page (record-boundary splitting not
        needed at this engine's page-index granularity)."""
        n_slots = len(defs) if defs is not None else len(c)
        if leaf.max_rep or reps is not None or n_slots == 0:
            return [(0, n_slots)]
        nvals = len(c)
        if isinstance(c, StringColumn):
            total = int(_np(c.offsets)[-1]) + 4 * nvals
        elif isinstance(c, DictionaryColumn):
            total = 4 * nvals
        elif isinstance(c, DecimalColumn):
            total = _np(c.limbs).shape[1] * 8 * nvals
        elif isinstance(c, FixedSizeBinaryColumn):
            total = c.dtype.list_size * nvals
        else:
            total = max(c.dtype.to_numpy().itemsize, 1) * nvals
        per_slot = max(total, 1) / n_slots
        rows = max(1, int(self.data_page_size / per_slot))
        return [(s, min(n_slots, s + rows))
                for s in range(0, n_slots, rows)]

    def _emit_data_page(self, leaf: _Leaf, n_page: int, n_rows: int,
                        n_nulls: int, enc: int, rep_b: bytes,
                        def_b: bytes, values: bytes,
                        codec: Optional[int] = None):
        """Serialize one data page (v1 or v2) and return its
        (offset, compressed_size_incl_header)."""
        codec = self.codec if codec is None else codec
        off = self._pos
        encrypting = self._ck is not None
        if self.page_v2:
            comp_vals = _compress(codec, values)
            is_comp = codec != 0 and len(comp_vals) < len(values)
            body = rep_b + def_b + (comp_vals if is_comp else values)
            fields = [(1, T_I32, 3),
                      (2, T_I32, len(rep_b) + len(def_b) + len(values)),
                      (3, T_I32, len(body))]
            if self.write_page_checksum and not encrypting:
                fields.append((4, T_I32, _crc32_i32(body)))
            fields.append((8, T_STRUCT, [
                (1, T_I32, n_page), (2, T_I32, n_nulls),
                (3, T_I32, n_rows), (4, T_I32, enc),
                (5, T_I32, len(def_b)), (6, T_I32, len(rep_b)),
                (7, T_TRUE, is_comp)]))
        else:
            body = rep_b + def_b + values
            comp_body = _compress(codec, body)
            fields = [(1, T_I32, 0), (2, T_I32, len(body)),
                      (3, T_I32, len(comp_body))]
            if self.write_page_checksum and not encrypting:
                fields.append((4, T_I32, _crc32_i32(comp_body)))
            fields.append((5, T_STRUCT, [
                (1, T_I32, n_page), (2, T_I32, enc),
                (3, T_I32, 3), (4, T_I32, 3)]))
            body = comp_body
        if encrypting:
            from .parquet_crypto import M_DATAPAGE, M_DATAPAGE_HDR
            self._emit(self._encrypt_page(fields, body, M_DATAPAGE_HDR,
                                          M_DATAPAGE, True))
            self._page_ord += 1
        else:
            hdr = CompactWriter()
            hdr.write_struct_fields(fields)
            self._emit(hdr.bytes() + body)
        return off, self._pos - off

    def _encode_values(self, leaf: _Leaf, pc: Column):
        """(encoding id, encoded bytes) for one non-dictionary page.
        v1 pages are PLAIN; v2 pages use the reference's PARQUET_2_0
        fallbacks (column/writer/mod.rs:1444): RLE booleans,
        DELTA_BINARY_PACKED int32/64, DELTA_BYTE_ARRAY byte arrays.
        A per-column "encoding" override (set_column_encoding role)
        forces plain / delta_* / rle / byte_stream_split."""
        forced = self._col_prop(leaf, "encoding", self.encoding)
        if forced is not None:
            return self._encode_forced(leaf, pc, forced.lower())
        if self.page_v2:
            d = pc.dtype
            phys = _logical_fields(d)[0]
            if phys == PT_BOOLEAN:
                return 3, rle_bool_encode(_vals(pc))
            if phys in (PT_INT32, PT_INT64) and isinstance(
                    pc, PrimitiveColumn):
                vals = _vals(pc)
                if d.name == "uint32":
                    vals = vals.astype(np.uint32).view(np.int32)
                elif d.name == "uint64":
                    vals = vals.astype(np.uint64).view(np.int64)
                return 5, delta_binary_packed_encode(vals)
            if phys == PT_BYTE_ARRAY and isinstance(pc, StringColumn):
                return 7, delta_byte_array_encode(
                    _np(pc.offsets).astype(np.int64),
                    _np(pc.data))
        return 0, _plain_values(pc, None)

    def _encode_forced(self, leaf: _Leaf, pc: Column, e: str):
        d = pc.dtype
        phys = _logical_fields(d)[0]
        if e == "plain":
            return 0, _plain_values(pc, None)
        if e == "rle" and phys == PT_BOOLEAN:
            return 3, rle_bool_encode(_vals(pc))
        if e == "delta_binary_packed" and phys in (PT_INT32, PT_INT64) \
                and isinstance(pc, PrimitiveColumn):
            vals = _vals(pc)
            if d.name == "uint32":
                vals = vals.astype(np.uint32).view(np.int32)
            elif d.name == "uint64":
                vals = vals.astype(np.uint64).view(np.int64)
            return 5, delta_binary_packed_encode(vals)
        if e == "delta_byte_array" and phys == PT_BYTE_ARRAY \
                and isinstance(pc, StringColumn):
            return 7, delta_byte_array_encode(
                _np(pc.offsets).astype(np.int64),
                _np(pc.data))
        if e == "delta_length_byte_array" and phys == PT_BYTE_ARRAY \
                and isinstance(pc, StringColumn):
            return 6, delta_length_byte_array_encode(
                _np(pc.offsets).astype(np.int64),
                _np(pc.data))
        if e == "byte_stream_split" and phys in (PT_INT32, PT_INT64,
                                                 PT_FLOAT, PT_DOUBLE):
            plain = _plain_values(pc, None)
            w = 4 if phys in (PT_INT32, PT_FLOAT) else 8
            planes = np.frombuffer(plain, np.uint8).reshape(-1, w)
            return 9, np.ascontiguousarray(planes.T).tobytes()
        raise ArrowNotImplementedError(
            f"encoding {e!r} for physical type {phys} "
            f"({'.'.join(leaf.path)})")

    def _write_chunk(self, leaf: _Leaf, c: Column, defs, reps):
        """c arrives COMPACTED (len(c) == number of def==max_def slots);
        defs/reps live on the slot axis.  vpos maps a slot range to its
        value range."""
        comp_name = self._col_prop(leaf, "compression", None)
        codec = (self.codec if comp_name is None
                 else _CODEC_IDS[comp_name.lower()])
        n_slots = len(defs) if defs is not None else len(c)
        const_defs = isinstance(defs, _ConstDefs)
        if defs is not None and not const_defs:
            vpos = np.zeros(n_slots + 1, np.int64)
            np.cumsum(defs == leaf.max_def, out=vpos[1:])
        else:
            vpos = None                # identity: slot i == value i
        chunk_nulls = int(n_slots - len(c)) \
            if defs is not None and not const_defs else 0

        dict_on = self._col_prop(leaf, "dictionary_enabled",
                                 self.dictionary_enabled)
        if self._col_prop(leaf, "encoding", self.encoding) is not None:
            dict_on = False            # forced encoding bypasses dict
        if isinstance(c, DictionaryColumn) and not dict_on:
            # dictionary disabled (or encoding forced) for this column:
            # materialize so the override actually takes effect
            from ..ops.strings import dictionary_decode
            c = dictionary_decode(c)
        dict_col = isinstance(c, DictionaryColumn)
        use_dict = dict_col or (dict_on and isinstance(c, StringColumn))
        fresh_dict = None
        if use_dict:
            # dictionary_page_size_limit fallback (properties.rs:39
            # default 1 MB; column/writer/mod.rs falls back to the
            # value encodings when the accumulated dictionary passes
            # the limit): a high-cardinality chunk writes PLAIN instead
            # of emitting a multi-MB dictionary page
            limit = self._col_prop(leaf, "dictionary_page_size_limit",
                                   self.dictionary_page_size_limit)
            if dict_col:
                vc = c.values
                if isinstance(vc, StringColumn):
                    est = len(vc) * 4 + int(_np(vc.offsets)[-1])
                else:
                    est = len(vc) * 8
            else:
                # the distinct values' size, without sorting them; the
                # sorted dictionary is built only when it will be written
                est = _distinct_size(_np(c.offsets).astype(np.int64),
                                     _np(c.data), limit)
                if est <= limit:
                    from ..ops.strings import dictionary_encode
                    fresh_dict = dictionary_encode(c)
            if est > limit:
                if dict_col:
                    from ..ops.strings import dictionary_decode
                    c = dictionary_decode(c)
                    dict_col = False
                fresh_dict = None
                use_dict = False

        start_pos = self._pos
        dict_page_offset = None
        encodings = [0, 3]                 # PLAIN, RLE (levels)
        total_uncomp = 0

        # v2 pages carry levels without the u32 length prefix
        def levels_for_page(s, e):
            rep_b = def_b = b""
            if leaf.max_rep and reps is not None:
                lb = _levels_bytes(reps[s:e], leaf.max_rep)
                rep_b = lb[4:] if self.page_v2 else lb
            if leaf.max_def and defs is not None:
                if const_defs:
                    rle = _const_run_bytes(e - s, leaf.max_def,
                                           leaf.max_def)
                    lb = struct.pack("<I", len(rle)) + rle
                else:
                    lb = _levels_bytes(defs[s:e], leaf.max_def)
                def_b = lb[4:] if self.page_v2 else lb
            return rep_b, def_b

        page_locs = []      # (offset, comp_size, first_row_index)
        page_stats = []     # (min|None, max|None, null_count, all_null)

        if use_dict:
            if dict_col:
                codes = _np(c.codes)
                values_col = c.values
                # pre-encoded dictionaries may carry unused entries:
                # stats come from the USED values only
                stat_col = _gather_leaf(values_col,
                                        _used_codes(codes, len(values_col)))
            else:
                dcol = fresh_dict
                codes = _np(dcol.codes)
                values_col = dcol.values
                stat_col = values_col   # every entry used, by build
            dict_values_plain = _plain_values(values_col, None)
            bw = max(1, int(max(len(values_col) - 1, 1)).bit_length())
            comp = _compress(codec, dict_values_plain)
            fields = [(1, T_I32, 2), (2, T_I32, len(dict_values_plain)),
                      (3, T_I32, len(comp))]
            if self.write_page_checksum and self._ck is None:
                fields.append((4, T_I32, _crc32_i32(comp)))
            fields.append((7, T_STRUCT, [(1, T_I32, len(values_col)),
                                         (2, T_I32, 0)]))
            dict_page_offset = self._pos
            if self._ck is not None:
                from .parquet_crypto import (M_DICTPAGE,
                                             M_DICTPAGE_HDR)
                self._emit(self._encrypt_page(
                    fields, comp, M_DICTPAGE_HDR, M_DICTPAGE, False))
            else:
                hdr = CompactWriter()
                hdr.write_struct_fields(fields)
                self._emit(hdr.bytes() + comp)
            total_uncomp += len(dict_values_plain)
            data_page_offset = self._pos
            for s, e in self._page_ranges(leaf, c, defs, reps):
                pcodes = codes[s:e] if vpos is None \
                    else codes[vpos[s]:vpos[e]]
                idx_rle = bytes([bw]) + nt.rle_bp_encode(
                    pcodes.astype(np.uint32), bw)
                rep_b, def_b = levels_for_page(s, e)
                n_page = e - s
                n_nulls = 0 if defs is None or const_defs else \
                    int((defs[s:e] != leaf.max_def).sum())
                n_rows = int((reps[s:e] == 0).sum()) \
                    if leaf.max_rep and reps is not None else n_page
                o, sz = self._emit_data_page(
                    leaf, n_page, n_rows, n_nulls, 8, rep_b, def_b,
                    idx_rle, codec)
                page_locs.append((o, sz, s))
                total_uncomp += len(rep_b) + len(def_b) + len(idx_rle)
                if self.write_page_index and not leaf.max_rep:
                    page_stats.append(_dict_page_stats(
                        values_col, pcodes, n_nulls))
            encodings.append(8)            # RLE_DICTIONARY
        else:
            data_page_offset = self._pos
            for s, e in self._page_ranges(leaf, c, defs, reps):
                pc = c.slice(s, e - s) if vpos is None \
                    else c.slice(int(vpos[s]), int(vpos[e] - vpos[s]))
                n_page = e - s
                n_rows = int((reps[s:e] == 0).sum()) \
                    if leaf.max_rep and reps is not None else n_page
                enc_id, payload = self._encode_values(leaf, pc)
                if enc_id not in encodings:
                    encodings.append(enc_id)
                rep_b, def_b = levels_for_page(s, e)
                n_nulls = 0 if defs is None or const_defs else \
                    int((defs[s:e] != leaf.max_def).sum())
                o, sz = self._emit_data_page(
                    leaf, n_page, n_rows, n_nulls, enc_id, rep_b,
                    def_b, payload, codec)
                page_locs.append((o, sz, 0 if leaf.max_rep else s))
                total_uncomp += len(rep_b) + len(def_b) + len(payload)
                if self.write_page_index and not leaf.max_rep:
                    mn, mx, _, mnc, mxc = _stats_full(pc, None)
                    page_stats.append(
                        (mn, mx, n_nulls, n_nulls == n_page, mnc, mxc))

        total_comp = self._pos - start_pos
        total_uncomp = max(total_uncomp, total_comp)

        # bloom filter (sbbf over xxh64 of plain-encoded values);
        # resolve like _col_prop: dotted path, leaf name, root column
        bloom_offset = bloom_len = None
        if self.bloom_filter_columns.intersection(
                (".".join(leaf.path), leaf.path[-1], leaf.path[0])):
            bloom_offset, bloom_len = self._write_bloom(c, None)

        md = [(1, T_I32, _logical_fields(
                  c.dtype if not dict_col else c.values.dtype)[0]),
              (2, T_LIST, (T_I32, encodings)),
              (3, T_LIST, (T_BINARY, [p for p in leaf.path])),
              (4, T_I32, codec),
              (5, T_I64, n_slots),
              (6, T_I64, total_uncomp),
              (7, T_I64, total_comp),
              (9, T_I64, data_page_offset)]
        if dict_page_offset is not None:
            md.append((11, T_I64, dict_page_offset))
        if self._col_prop(leaf, "write_statistics",
                          self.write_statistics):
            # chunk min/max over the dictionary's USED values when dict-
            # encoded (5000 distinct beats 1M raw strings), else the
            # compacted column
            mn, mx, _ = _stats_bytes(stat_col if use_dict else c, None)
            st = [(3, T_I64, chunk_nulls)]
            if mn is not None:
                st.append((5, T_BINARY, mx))
                st.append((6, T_BINARY, mn))
            md.append((12, T_STRUCT, st))
        if bloom_offset is not None:
            md.append((14, T_I64, bloom_offset))
            md.append((15, T_I32, bloom_len))
        if self._ck is None:
            cc = [(2, T_I64, start_pos), (3, T_STRUCT, md)]
        else:
            from .parquet_crypto import (encrypt_module, module_aad,
                                         M_COLMD)
            key, mode, rg, col = self._ck
            if mode == "footer":
                # uniform encryption: metadata rides the (encrypted)
                # footer; crypto_metadata = ENCRYPTION_WITH_FOOTER_KEY
                cc = [(2, T_I64, start_pos), (3, T_STRUCT, md),
                      (8, T_STRUCT, [(1, T_STRUCT, [])])]
            else:
                # column key: ColumnMetaData leaves the footer and is
                # emitted as its own encrypted module (metadata/mod.rs
                # from_encrypted_thrift inverse)
                w = CompactWriter()
                w.write_struct_fields(md)
                km = self.encryption.column_key_metadata.get(
                    ".".join(leaf.path),
                    self.encryption.column_key_metadata.get(
                        leaf.path[-1], b""))
                ck_fields = [(1, T_LIST,
                              (T_BINARY, [p for p in leaf.path]))]
                if km:
                    ck_fields.append((2, T_BINARY, km))
                cc = [(2, T_I64, start_pos),
                      (8, T_STRUCT, [(2, T_STRUCT, ck_fields)]),
                      (9, T_BINARY, encrypt_module(
                          key, w.bytes(),
                          module_aad(self._file_aad, M_COLMD, rg,
                                     col)))]

        if self.write_page_index:
            colidx = None
            if page_stats and all(s[0] is not None or s[3]
                                  for s in page_stats):
                null_pages = [bool(s[3]) for s in page_stats]
                mins = [b"" if s[3] else s[0] for s in page_stats]
                maxs = [b"" if s[3] else s[1] for s in page_stats]
                colidx = [(1, T_LIST, (T_TRUE, null_pages)),
                          (2, T_LIST, (T_BINARY, mins)),
                          (3, T_LIST, (T_BINARY, maxs)),
                          (4, T_I32, _boundary_order(page_stats)),
                          (5, T_LIST,
                           (T_I64, [int(s[2]) for s in page_stats]))]
            offidx = [(1, T_LIST, (T_STRUCT, [
                [(1, T_I64, o), (2, T_I32, sz), (3, T_I64, fr)]
                for o, sz, fr in page_locs]))]
            self._index_slots.append((cc, colidx, offidx, self._ck))
        return cc, total_comp

    def _write_bloom(self, c: Column, mask):
        """Split-block bloom filter (bloom_filter/mod.rs): XXH64 seed 0
        over the PLAIN value encoding of each distinct value."""
        hashes = _bloom_hashes(c, mask)
        if hashes is None or len(hashes) == 0:
            return None, None
        nbits = max(64 * 8, int(len(hashes) * 10.5))
        num_blocks = max(1, (nbits + 255) // 256)
        bitset = np.zeros(num_blocks * 32, np.uint8)
        nt.sbbf_insert(bitset, hashes)
        hdr = CompactWriter()
        hdr.write_struct_fields([
            (1, T_I32, len(bitset)),
            (2, T_STRUCT, [(1, T_STRUCT, [])]),   # BLOCK
            (3, T_STRUCT, [(1, T_STRUCT, [])]),   # XXHASH
            (4, T_STRUCT, [(1, T_STRUCT, [])])])  # UNCOMPRESSED
        off = self._pos
        self._emit(hdr.bytes())
        self._emit(bitset.tobytes())
        return off, self._pos - off

    def close(self):
        # page index: every ColumnIndex, then every OffsetIndex, both
        # between the last row group and the footer
        # (file/page_index/index_writer.rs layout)
        def index_bytes(fields, ck, mtype):
            w = CompactWriter()
            w.write_struct_fields(fields)
            b = w.bytes()
            if ck is not None:
                from .parquet_crypto import encrypt_module, module_aad
                key, _, rg, col = ck
                b = encrypt_module(
                    key, b, module_aad(self._file_aad, mtype, rg, col))
            return b

        from .parquet_crypto import M_COLIDX, M_OFFIDX
        for cc, colidx, _, ck in self._index_slots:
            if colidx is None:
                continue
            b = index_bytes(colidx, ck, M_COLIDX)
            cc.append((6, T_I64, self._pos))
            cc.append((7, T_I32, len(b)))
            self._emit(b)
        for cc, _, offidx, ck in self._index_slots:
            b = index_bytes(offidx, ck, M_OFFIDX)
            cc.append((4, T_I64, self._pos))
            cc.append((5, T_I32, len(b)))
            self._emit(b)
            cc.sort(key=lambda f: f[0])

        w = CompactWriter()
        schema_elems = list(self._elems)
        # column_orders: TypeDefinedOrder per leaf (without it the
        # spec says min/max statistics are undefined and readers must
        # ignore them)
        orders = [[(1, T_STRUCT, [(1, T_STRUCT, [])])]
                  for _ in self._leaves]
        fmd = [
            (1, T_I32, 2),
            (2, T_LIST, (T_STRUCT, schema_elems)),
            (3, T_I64, self._num_rows),
            (4, T_LIST, (T_STRUCT, self._row_groups)),
            (6, T_BINARY, "arrow_tpu_torch native writer"),
            (7, T_LIST, (T_STRUCT, orders)),
        ]
        kvs = dict(self.key_value_metadata or {})
        if self.store_schema:
            # base64(len-framed IPC Schema message) under ARROW:schema:
            # exact Arrow type recovery on read (schema/mod.rs:182,
            # encode_arrow_schema)
            kvs["ARROW:schema"] = _encode_arrow_schema(self._arrow_schema)
        if kvs:
            fmd.insert(4, (5, T_LIST, (T_STRUCT,
                                       [[(1, T_BINARY, k),
                                         (2, T_BINARY, v)]
                                        for k, v in kvs.items()])))
        w.write_struct_fields(fmd)
        footer = w.bytes()
        if self.encryption is None:
            self._emit(footer)
            self._emit(struct.pack("<i", len(footer)))
            self._emit(_MAGIC)
        else:
            # encrypted-footer layout (metadata/reader.rs:902):
            # [FileCryptoMetaData (plaintext thrift)]
            # [GCM module over FileMetaData][combined len][PARE]
            from .parquet_crypto import (encrypt_module, module_aad,
                                         M_FOOTER)
            enc = self.encryption
            gcm = []
            if enc.aad_prefix and enc.store_aad_prefix:
                gcm.append((1, T_BINARY, enc.aad_prefix))
            gcm.append((2, T_BINARY, self._aad_unique))
            if enc.aad_prefix and not enc.store_aad_prefix:
                gcm.append((3, T_TRUE, True))
            fcm_fields = [(1, T_STRUCT, [(1, T_STRUCT, gcm)])]
            if enc.footer_key_metadata:
                fcm_fields.append((2, T_BINARY,
                                   enc.footer_key_metadata))
            cw = CompactWriter()
            cw.write_struct_fields(fcm_fields)
            tail = cw.bytes() + encrypt_module(
                enc.footer_key, footer,
                module_aad(self._file_aad, M_FOOTER))
            self._emit(tail)
            self._emit(struct.pack("<i", len(tail)))
            self._emit(_MAGIC_ENCR)
        if self._own:
            self._out.close()




def _bloom_hashes(c: Column, mask) -> Optional[np.ndarray]:
    if isinstance(c, DictionaryColumn):
        c = c.values
        mask = None
    if isinstance(c, StringColumn):
        offs = _np(c.offsets).astype(np.int64)
        data = _np(c.data).tobytes()
        sel = np.nonzero(mask)[0] if mask is not None \
            else np.arange(len(c))
        vals = {data[offs[i]:offs[i + 1]] for i in sel}
        out = np.zeros(len(vals), np.uint64)
        for i, v in enumerate(vals):
            out[i] = nt.xxhash64(v)
        return out
    if isinstance(c, PrimitiveColumn):
        vals = _vals(c)
        if mask is not None:
            vals = vals[mask]
        uniq = np.unique(vals)
        enc = {"int32": np.int32, "date32": np.int32,
               "int64": np.int64, "float32": np.float32,
               "float64": np.float64}.get(c.dtype.name)
        if enc is None and c.dtype.name == "timestamp":
            enc = np.int64
        if enc is None:
            return None
        raw = np.ascontiguousarray(uniq.astype(enc)).view(np.uint8)
        width = np.dtype(enc).itemsize
        out = np.zeros(len(uniq), np.uint64)
        for i in range(len(uniq)):
            out[i] = nt.xxhash64(raw[i * width:(i + 1) * width])
        return out
    return None


def write_parquet_native(sink, table: Table, compression="snappy",
                         dictionary_enabled=True,
                         bloom_filter_columns=(),
                         row_group_size=1 << 20, **kw):
    w = NativeParquetWriter(sink, table.schema, compression,
                            dictionary_enabled,
                            bloom_filter_columns=bloom_filter_columns,
                            row_group_size=row_group_size, **kw)
    w.write_table(table)
    w.close()
