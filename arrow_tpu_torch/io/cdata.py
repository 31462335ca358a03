"""Arrow C Data Interface — real C-ABI ArrowSchema/ArrowArray structs
(counterpart of arrow_tpu/io/cdata.py).

Re-designs the reference's FFI layer (arrow-data/src/ffi.rs:39
FFI_ArrowArray, arrow-schema/src/ffi.rs FFI_ArrowSchema, arrow-array/
src/ffi.rs:256 to_ffi/from_ffi, arrow-pyarrow/src/lib.rs:88 PyCapsule
protocol) for this engine: the structs are built in ctypes memory with
format strings per the C data interface spec, exported/imported through
PyCapsules named "arrow_schema"/"arrow_array" — NO pyarrow types cross
the boundary (pyarrow is the test oracle only).

Engine specifics: dense bool validity masks pack to Arrow validity
BITMAPS on export and unpack on import.
  - Export copies each exported column, or each batch of a stream, to
    the host once (`hostio.to_host`; a CPU tensor is read in place),
    reads that view only (`hostio.host`) and copies its bytes into
    C-owned memory, which the consumer's `release` frees (the native
    callbacks of native/hostcodec.cpp), so nothing on the Python side
    has to stay alive.
  - Import reads each buffer through the producer's pointers, copies it
    and places it on the `device` the caller names; then the producer's
    `release` is called.

  export_column(col)  -> (schema_capsule, array_capsule)
  import_column(caps, device) <- any producer's capsules
  export_table / import_table: a table is a struct array of its columns
  (the RecordBatch convention).  Column and Table have
  __arrow_c_array__ and Table __arrow_c_stream__, so `pa.array(col)`,
  `pa.record_batch(t)` and `pa.table(t)` take port objects.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import (Column, DictionaryColumn, ListColumn,
                           NullColumn, PrimitiveColumn, StringColumn,
                           StructColumn)
from ..core.nested import (DecimalColumn, FixedSizeBinaryColumn,
                           FixedSizeListColumn, IntervalMDNColumn,
                           MapColumn, RunEndColumn, UnionColumn)
from ..errors import ArrowInvalid, ArrowNotImplementedError
from ..utils import hostcodec
from .hostio import host, tensor, to_host

__all__ = ["export_column", "import_column", "export_table",
           "import_table", "export_stream", "import_stream"]


class ArrowSchema(ctypes.Structure):
    pass


class ArrowArray(ctypes.Structure):
    pass


_SCHEMA_RELEASE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchema))
_ARRAY_RELEASE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArray))

ArrowSchema._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowSchema))),
    ("dictionary", ctypes.POINTER(ArrowSchema)),
    ("release", _SCHEMA_RELEASE),
    ("private_data", ctypes.c_void_p),
]

ArrowArray._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowArray))),
    ("dictionary", ctypes.POINTER(ArrowArray)),
    ("release", _ARRAY_RELEASE),
    ("private_data", ctypes.c_void_p),
]

ARROW_FLAG_DICTIONARY_ORDERED = 1
ARROW_FLAG_NULLABLE = 2

# exported trees stay alive until the consumer calls release()
_LIVE: Dict[int, object] = {}
_NEXT_ID = [1]


def _register(keepalive) -> int:
    token = _NEXT_ID[0]
    _NEXT_ID[0] += 1
    _LIVE[token] = keepalive
    return token


# ---------------------------------------------------------------------------
# format strings (C data interface spec)
# ---------------------------------------------------------------------------

_PRIM_FMT = {
    "bool": "b", "int8": "c", "uint8": "C", "int16": "s", "uint16": "S",
    "int32": "i", "uint32": "I", "int64": "l", "uint64": "L",
    "float16": "e", "float32": "f", "float64": "g",
    "date32": "tdD", "date64": "tdm",
}
_FMT_PRIM = {v: k for k, v in _PRIM_FMT.items()}


def _fmt_for(d: dt.DataType) -> str:
    n = d.name
    if n == "null":
        return "n"
    if n in _PRIM_FMT:
        return _PRIM_FMT[n]
    if n == "utf8":
        return "u"
    if n == "large_utf8":
        return "U"
    if n == "binary":
        return "z"
    if n == "large_binary":
        return "Z"
    if n == "utf8_view":
        return "vu"
    if n == "binary_view":
        return "vz"
    if n == "fixed_size_binary":
        return f"w:{d.list_size}"
    if d.is_decimal:
        # decimal32 and decimal64 name their width, as pyarrow does (the
        # reference has no format for them: ROADMAP C17)
        bits = int(n[len("decimal"):])
        suffix = "" if bits == 128 else f",{bits}"
        return f"d:{d.precision},{d.scale}{suffix}"
    if n == "timestamp":
        u = {"s": "s", "ms": "m", "us": "u", "ns": "n"}[d.unit]
        return f"ts{u}:{d.tz or ''}"
    if n == "time32":
        return "tts" if d.unit == "s" else "ttm"
    if n == "time64":
        return "ttu" if d.unit == "us" else "ttn"
    if n == "duration":
        u = {"s": "s", "ms": "m", "us": "u", "ns": "n"}[d.unit]
        return f"tD{u}"
    if n == "interval":
        u = {"year_month": "tiM", "day_time": "tiD",
             "month_day_nano": "tin"}[d.unit]
        return u
    if n == "union":
        tag = "ud" if d.mode == "dense" else "us"
        ids = d.type_ids or tuple(range(len(d.fields)))
        return f"+{tag}:" + ",".join(str(i) for i in ids)
    if n == "run_end_encoded":
        return "+r"
    if n == "dictionary":
        return _fmt_for(d.index_type)
    if n == "list":
        return "+l"
    if n == "large_list":
        return "+L"
    if n == "list_view":
        return "+vl"
    if n == "large_list_view":
        return "+vL"
    if n == "fixed_size_list":
        return f"+w:{d.list_size}"
    if n == "struct":
        return "+s"
    if n == "map":
        return "+m"
    raise ArrowNotImplementedError(f"C data export of {d!r}")


def _dtype_from_fmt(fmt: str) -> dt.DataType:
    if fmt in _FMT_PRIM:
        n = _FMT_PRIM[fmt]
        return dt.bool_ if n == "bool" else getattr(dt, n)
    if fmt == "n":
        return dt.null
    if fmt == "u":
        return dt.utf8
    if fmt == "U":
        return dt.large_utf8
    if fmt == "z":
        return dt.binary
    if fmt == "Z":
        return dt.large_binary
    if fmt == "vu":
        return dt.utf8_view
    if fmt == "vz":
        return dt.binary_view
    if fmt.startswith("w:"):
        return dt.fixed_size_binary(int(fmt[2:]))
    if fmt.startswith("d:"):
        parts = fmt[2:].split(",")
        prec, scale = int(parts[0]), int(parts[1])
        bits = parts[2] if len(parts) > 2 else "128"
        return getattr(dt, f"decimal{bits}")(prec, scale)
    if fmt.startswith("ts") and ":" in fmt:
        unit = {"s": "s", "m": "ms", "u": "us", "n": "ns"}[fmt[2]]
        tz = fmt.split(":", 1)[1] or None
        return dt.timestamp(unit, tz)
    if fmt in ("tts", "ttm"):
        return dt.time32("s" if fmt == "tts" else "ms")
    if fmt in ("ttu", "ttn"):
        return dt.time64("us" if fmt == "ttu" else "ns")
    if fmt.startswith("tD"):
        unit = {"s": "s", "m": "ms", "u": "us", "n": "ns"}[fmt[2]]
        return dt.duration(unit)
    if fmt in ("tiM", "tiD", "tin"):
        return dt.interval({"tiM": "year_month", "tiD": "day_time",
                            "tin": "month_day_nano"}[fmt])
    raise ArrowNotImplementedError(f"C data import of format {fmt!r}")


# ---------------------------------------------------------------------------
# export — the whole exported tree (structs, format/name strings, buffer
# bytes) lives in C-malloc'd memory with NATIVE release callbacks from
# hostcodec (cdata_release_schema/array), so a consumer may release at any
# time, including after Python interpreter finalization (a Python-trampoline
# release would segfault there).  Top-level structs handed to capsules are
# intentionally never freed (~120 B per export; consumers move immediately).
# ---------------------------------------------------------------------------

def _c_alloc(size: int) -> int:
    return hostcodec.cdata_malloc(size)


def _c_str(b: bytes) -> ctypes.c_char_p:
    p = _c_alloc(len(b) + 1)
    if b:
        ctypes.memmove(p, b, len(b))
    return ctypes.cast(ctypes.c_void_p(p), ctypes.c_char_p)


def _c_buf(a: np.ndarray) -> int:
    a = np.ascontiguousarray(a)
    p = _c_alloc(max(a.nbytes, 1))
    if a.nbytes:
        ctypes.memmove(p, a.ctypes.data, a.nbytes)
    return p


def _c_new(struct_type):
    p = _c_alloc(ctypes.sizeof(struct_type))
    return ctypes.cast(ctypes.c_void_p(p), ctypes.POINTER(struct_type))


def _fill_schema(s, d: dt.DataType, name: str, nullable: bool) -> None:
    s.format = _c_str(_fmt_for(d).encode())
    s.name = _c_str(name.encode())
    s.metadata = None
    s.flags = ARROW_FLAG_NULLABLE if nullable else 0
    children: List[Tuple[str, dt.DataType, bool]] = []
    if d.name in ("list", "large_list", "fixed_size_list", "list_view",
                  "large_list_view"):
        children = [("item", d.value_type, True)]
    elif d.name in ("struct", "union"):
        children = [(f.name, f.dtype, f.nullable) for f in d.fields]
    elif d.name == "map":
        children = [("entries", d.value_type, False)]
    elif d.name == "run_end_encoded":
        children = [("run_ends", d.index_type, False),
                    ("values", d.value_type, True)]
    if children:
        arrp = _c_alloc(ctypes.sizeof(ctypes.c_void_p) * len(children))
        arr = ctypes.cast(ctypes.c_void_p(arrp),
                          ctypes.POINTER(ctypes.POINTER(ArrowSchema)))
        for i, (cn, cd, cnul) in enumerate(children):
            cp = _c_new(ArrowSchema)
            _fill_schema(cp.contents, cd, cn, cnul)
            arr[i] = cp
        s.children = arr
        s.n_children = len(children)
    else:
        s.children = None
        s.n_children = 0
    if d.name == "dictionary":
        vp = _c_new(ArrowSchema)
        _fill_schema(vp.contents, d.value_type, "", True)
        s.dictionary = vp
        if d.ordered:
            s.flags |= ARROW_FLAG_DICTIONARY_ORDERED
    else:
        s.dictionary = None
    s.release = _SCHEMA_RELEASE(hostcodec.cdata_release("schema"))
    s.private_data = None


def _fill_array(a, col: Column) -> None:
    """The ArrowArray of a host column (`to_host`)."""
    n = len(col)
    a.length = n
    a.offset = 0
    a.dictionary = None
    a.private_data = None
    v = None if col.validity is None else host(col.validity)
    a.null_count = 0 if v is None else int(n - v.sum())
    bufs: List[int] = []
    bufs.append(0 if v is None else _c_buf(hostcodec.pack_bits(v)))
    children: List[Column] = []

    if isinstance(col, NullColumn):
        bufs = [0]
        a.null_count = n
    elif isinstance(col, UnionColumn):
        # unions carry no validity buffer: [type_ids] (+offsets if dense)
        a.null_count = 0
        bufs = [_c_buf(host(col.type_ids).astype(np.int8))]
        if col.offsets is not None:
            bufs.append(_c_buf(host(col.offsets)
                               .astype(np.int32)))
        children = list(col.children)
    elif isinstance(col, RunEndColumn):
        # REE: no buffers; children = [run_ends, values]
        a.null_count = 0
        bufs = []
        children = [PrimitiveColumn(col.run_ends,
                                    col.dtype.index_type),
                    col.values]
    elif isinstance(col, DictionaryColumn):
        bufs.append(_c_buf(host(col.codes)))
        dp = _c_new(ArrowArray)
        _fill_array(dp.contents, col.values)
        a.dictionary = dp
    elif isinstance(col, IntervalMDNColumn):
        packed = np.zeros(n, np.dtype([("m", "<i4"), ("d", "<i4"),
                                       ("n", "<i8")]))
        packed["m"] = host(col.months)
        packed["d"] = host(col.days)
        packed["n"] = host(col.nanos)
        bufs.append(_c_buf(packed))
    elif isinstance(col, PrimitiveColumn):
        vals = host(col.values).view(col.dtype.to_numpy())
        if col.dtype.name == "bool":
            vals = np.packbits(vals.astype(bool), bitorder="little")
        elif col.dtype.name == "interval" and col.dtype.unit == "day_time":
            # engine packs i64 days<<32|millis; C ABI is [i32 d][i32 ms]
            pairs = np.zeros(n, np.dtype([("d", "<i4"), ("ms", "<i4")]))
            pairs["d"] = (vals >> 32).astype(np.int32)
            pairs["ms"] = (vals & 0xFFFFFFFF).astype(np.uint32) \
                .view(np.int32)
            vals = pairs
        bufs.append(_c_buf(vals))
    elif isinstance(col, DecimalColumn):
        bufs.append(_c_buf(host(col.limbs)))
    elif isinstance(col, FixedSizeBinaryColumn):
        bufs.append(_c_buf(host(col.data)))
    elif isinstance(col, StringColumn):
        if col.dtype.name in ("utf8_view", "binary_view"):
            # view layout (byte_view_array.rs / C spec): buffers =
            # [validity, 16B views, data..., i64 variadic sizes]
            offs = host(col.offsets).astype(np.int64)
            data = host(col.data)
            if len(data) > (1 << 31) - 64:
                raise ArrowNotImplementedError(
                    "C data export of >2GB view data")
            lens = (offs[1:] - offs[:-1]).astype(np.int32)
            views = np.zeros((n, 16), np.uint8)
            views[:, 0:4] = lens.view(np.uint8).reshape(n, 4)
            padded = np.concatenate([data, np.zeros(16, np.uint8)])
            take = offs[:-1, None] + np.arange(12)
            gathered = padded[np.minimum(take, len(padded) - 1)]
            within = np.arange(12) < lens[:, None]
            gathered = np.where(within, gathered, 0)
            short = lens <= 12
            views[short, 4:16] = gathered[short]
            li = np.nonzero(~short)[0]
            if len(li):
                views[li, 4:8] = gathered[li, :4]
                views[li, 8:12] = 0          # buffer index 0
                views[li, 12:16] = offs[:-1][li].astype(np.int32) \
                    .view(np.uint8).reshape(-1, 4)
            bufs.append(_c_buf(views))
            bufs.append(_c_buf(data if len(data)
                               else np.zeros(1, np.uint8)))
            bufs.append(_c_buf(np.array([len(data)], np.int64)))
        else:
            offs = host(col.offsets)
            width = np.int64 if col.dtype.name.startswith("large") \
                else np.int32
            bufs.append(_c_buf(offs.astype(width, copy=False)))
            data = host(col.data)
            bufs.append(_c_buf(data if len(data)
                               else np.zeros(1, np.uint8)))
    elif isinstance(col, (ListColumn, MapColumn)):
        offs = host(col.offsets)
        width = np.int64 if col.dtype.name == "large_list" else np.int32
        bufs.append(_c_buf(offs.astype(width, copy=False)))
        children = [col.entries if isinstance(col, MapColumn)
                    else col.child]
    elif type(col).__name__ == "ListViewColumn":
        width = np.int64 if col.dtype.name == "large_list_view" \
            else np.int32
        bufs.append(_c_buf(host(col.offsets).astype(width,
                                                          copy=False)))
        bufs.append(_c_buf(host(col.sizes).astype(width,
                                                        copy=False)))
        children = [col.child]
    elif isinstance(col, FixedSizeListColumn):
        children = [col.child]
    elif isinstance(col, StructColumn):
        children = list(col.children)
    else:
        raise ArrowNotImplementedError(
            f"C data export of {type(col).__name__}")

    bufp = _c_alloc(ctypes.sizeof(ctypes.c_void_p) * max(len(bufs), 1))
    barr = ctypes.cast(ctypes.c_void_p(bufp),
                       ctypes.POINTER(ctypes.c_void_p))
    for i, b in enumerate(bufs):
        barr[i] = b or None
    a.buffers = barr
    a.n_buffers = len(bufs)
    if children:
        arrp = _c_alloc(ctypes.sizeof(ctypes.c_void_p) * len(children))
        arr = ctypes.cast(ctypes.c_void_p(arrp),
                          ctypes.POINTER(ctypes.POINTER(ArrowArray)))
        for i, ch in enumerate(children):
            cp = _c_new(ArrowArray)
            _fill_array(cp.contents, ch)
            arr[i] = cp
        a.children = arr
        a.n_children = len(children)
    else:
        a.children = None
        a.n_children = 0
    a.release = _ARRAY_RELEASE(hostcodec.cdata_release("array"))


_PyCapsule_New = ctypes.pythonapi.PyCapsule_New
_PyCapsule_New.restype = ctypes.py_object
_PyCapsule_New.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_void_p]
_PyCapsule_GetPointer = ctypes.pythonapi.PyCapsule_GetPointer
_PyCapsule_GetPointer.restype = ctypes.c_void_p
_PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]


def _capsule(struct, name: bytes):
    return _PyCapsule_New(ctypes.byref(struct), name, None)


def export_column(col: Column, name: str = "",
                  nullable: bool = True):
    """-> (schema_capsule, array_capsule) for any consumer.

    The exported tree is wholly C-owned (hostcodec cdata_release_*
    frees it), so the consumer may release from any thread at any
    time — no Python object must stay alive."""
    sp = _c_new(ArrowSchema)
    ap = _c_new(ArrowArray)
    _fill_schema(sp.contents, col.dtype, name, nullable)
    _fill_array(ap.contents, to_host(col))
    return (_PyCapsule_New(ctypes.cast(sp, ctypes.c_void_p),
                           b"arrow_schema", None),
            _PyCapsule_New(ctypes.cast(ap, ctypes.c_void_p),
                           b"arrow_array", None))


def export_table(table):
    """Table -> capsules of a struct array of its columns (the
    RecordBatch convention understood by pa.RecordBatch)."""
    sc = StructColumn(tuple(table.columns),
                      tuple(table.schema.fields))
    return export_column(sc, "", False)


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

def _read_buffer(ptr: int, dtype, count: int) -> np.ndarray:
    if count == 0:
        return np.zeros(0, dtype)
    buf = (ctypes.c_char * (np.dtype(dtype).itemsize * count)) \
        .from_address(ptr)
    # a view of the producer's memory: every caller copies it (onto the
    # device, or into a new host array) before the producer's release
    return np.frombuffer(buf, dtype=dtype)


def _unpack_bitmap(ptr: int, n: int) -> Optional[np.ndarray]:
    if not ptr or n == 0:
        return None
    raw = _read_buffer(ptr, np.uint8, (n + 7) // 8)
    return np.unpackbits(raw, bitorder="little")[:n].astype(bool)


def _import_schema(s: ArrowSchema):
    fmt = s.format.decode()
    name = (s.name or b"").decode()
    nullable = bool(s.flags & ARROW_FLAG_NULLABLE)
    kids = [_import_schema(s.children[i].contents)
            for i in range(s.n_children)]
    if fmt == "+s":
        d = dt.struct([dt.Field(kn, kd, knul)
                       for kn, kd, knul in kids])
    elif fmt in ("+l", "+L"):
        d = (dt.list_ if fmt == "+l" else dt.large_list)(kids[0][1])
    elif fmt in ("+vl", "+vL"):
        d = (dt.list_view if fmt == "+vl"
             else dt.large_list_view)(kids[0][1])
    elif fmt.startswith("+w:"):
        d = dt.fixed_size_list(kids[0][1], int(fmt[3:]))
    elif fmt == "+m":
        kv = kids[0][1]
        d = dt.map_(kv.fields[0].dtype, kv.fields[1].dtype)
    elif fmt.startswith("+ud:") or fmt.startswith("+us:"):
        ids = [int(x) for x in fmt[4:].split(",") if x]
        mode = "dense" if fmt[1:3] == "ud" else "sparse"
        d = dt.union([dt.Field(kn, kd, knul) for kn, kd, knul in kids],
                     mode, ids)
    elif fmt == "+r":
        d = dt.run_end_encoded(kids[0][1], kids[1][1])
    elif fmt.startswith("+"):
        raise ArrowNotImplementedError(f"C data import of {fmt!r}")
    else:
        d = _dtype_from_fmt(fmt)
    if s.dictionary:
        _, vd_, _ = _import_schema(s.dictionary.contents)
        d = dt.dictionary(d, vd_, ordered=bool(
            s.flags & ARROW_FLAG_DICTIONARY_ORDERED))
    return name, d, nullable


def _import_array(a: ArrowArray, d: dt.DataType, dev) -> Column:
    """The column of an ArrowArray, every buffer copied onto `dev`."""
    n = int(a.length)
    off = int(a.offset)
    total = off + n          # window [off, off+n) of the buffers

    def buf(i):
        return int(a.buffers[i]) if a.buffers and i < a.n_buffers \
            and a.buffers[i] else 0

    def T(x):
        return tensor(x, dev)

    nm = d.name
    if nm == "union":                # buffer 0 is type_ids, no bitmap
        tids = _read_buffer(buf(0), np.int8, total)[off:]
        kids = [_import_array(a.children[i].contents, f.dtype, dev)
                for i, f in enumerate(d.fields)]
        if d.mode == "dense":
            offarr = _read_buffer(buf(1), np.int32, total)[off:]
            return UnionColumn(T(tids), T(offarr),
                               kids, d.fields, d.type_ids)
        if off:
            kids = [k.slice(off, n) for k in kids]
        return UnionColumn(T(tids), None, kids, d.fields,
                           d.type_ids)
    if nm == "run_end_encoded":      # no buffers, children carry data
        if off:
            raise ArrowNotImplementedError("sliced REE C arrays")
        ends = _import_array(a.children[0].contents, d.index_type, dev)
        vals = _import_array(a.children[1].contents, d.value_type, dev)
        return RunEndColumn(ends.values, vals, length=n)
    validity = None
    if int(a.null_count) != 0:       # -1 = unknown: consult the bitmap
        full = _unpack_bitmap(buf(0), total)
        validity = None if full is None else T(full[off:])
    if nm == "null":
        return NullColumn(n, dev)
    if nm == "bool":
        raw = _read_buffer(buf(1), np.uint8, (total + 7) // 8)
        vals = np.unpackbits(raw, bitorder="little")[off:total] \
            .astype(bool)
        return PrimitiveColumn(T(vals), d, validity)
    if nm == "dictionary":
        codes = _read_buffer(buf(1), d.index_type.to_numpy(),
                             total)[off:]
        values = _import_array(a.dictionary.contents, d.value_type, dev)
        return DictionaryColumn(T(codes), values, validity,
                                ordered=bool(d.ordered))
    if nm in ("decimal128", "decimal256"):
        k = 2 if nm == "decimal128" else 4
        limbs = _read_buffer(buf(1), np.int64,
                             total * k).reshape(total, k)[off:]
        return DecimalColumn(T(limbs), d, validity)
    if nm == "fixed_size_binary":
        data = _read_buffer(buf(1), np.uint8, total * d.list_size) \
            .reshape(total, d.list_size)[off:]
        return FixedSizeBinaryColumn(T(data), validity)
    if nm in ("utf8_view", "binary_view"):
        import struct as _st
        views = _read_buffer(buf(1), np.uint8,
                             total * 16).reshape(total, 16)[off:]
        nvar = max(int(a.n_buffers) - 3, 0)
        sizes = _read_buffer(buf(int(a.n_buffers) - 1), np.int64, nvar) \
            if nvar else np.zeros(0, np.int64)
        datas = [_read_buffer(buf(2 + i), np.uint8, int(sizes[i]))
                 for i in range(nvar)]
        lens = views[:, 0:4].copy().view(np.int32).ravel()
        offs_out = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs_out[1:])
        out = np.zeros(int(offs_out[-1]), np.uint8)
        short = lens <= 12
        if short.any():
            si = np.nonzero(short)[0]
            pos = offs_out[si, None] + np.arange(12)
            src_rows = views[si, 4:16]
            within = np.arange(12) < lens[si, None]
            out[pos[within]] = src_rows[within]
        for i in np.nonzero(~short)[0]:
            ln = int(lens[i])
            bi, bo = _st.unpack_from("<ii", views[i].tobytes(), 8)
            out[offs_out[i]:offs_out[i] + ln] = datas[bi][bo:bo + ln]
        return StringColumn.from_numpy(offs_out, out, None, d,
                                       device=dev).with_validity(validity)
    if nm in ("utf8", "large_utf8", "binary", "large_binary"):
        width = np.int64 if nm.startswith("large") else np.int32
        offs = _read_buffer(buf(1), width, total + 1)[off:]
        nbytes = int(offs[-1]) if n else 0
        data = _read_buffer(buf(2), np.uint8, nbytes)
        if off:
            b0 = int(offs[0])
            data = data[b0:]
            offs = offs - b0
        return StringColumn(T(offs), T(data), d, validity)
    if nm in ("list", "large_list"):
        width = np.int64 if nm == "large_list" else np.int32
        offs = _read_buffer(buf(1), width, total + 1)[off:]
        child = _import_array(a.children[0].contents, d.value_type, dev)
        if off:
            b0 = int(offs[0])
            child = child.slice(b0, int(offs[-1]) - b0)
            offs = offs - b0
        return ListColumn(T(offs), child, validity, large=nm == "large_list")
    if nm in ("list_view", "large_list_view"):
        from ..core.nested import ListViewColumn
        width = np.int64 if nm == "large_list_view" else np.int32
        offs = _read_buffer(buf(1), width, total)[off:]
        sizes = _read_buffer(buf(2), width, total)[off:]
        child = _import_array(a.children[0].contents, d.value_type, dev)
        return ListViewColumn(T(offs), T(sizes), child, validity, d)
    if nm == "fixed_size_list":
        child = _import_array(a.children[0].contents, d.value_type, dev)
        if off:
            child = child.slice(off * d.list_size, n * d.list_size)
        return FixedSizeListColumn(child, d.list_size, validity)
    if nm == "map":
        offs = _read_buffer(buf(1), np.int32, total + 1)[off:]
        entries = _import_array(a.children[0].contents, d.value_type, dev)
        if off:
            b0 = int(offs[0])
            entries = entries.slice(b0, int(offs[-1]) - b0)
            offs = offs - b0
        return MapColumn(T(offs), entries, validity)
    if nm == "struct":
        kids = tuple(
            _import_array(a.children[i].contents, f.dtype, dev)
            .slice(off, n) if off else
            _import_array(a.children[i].contents, f.dtype, dev)
            for i, f in enumerate(d.fields))
        return StructColumn(kids, tuple(d.fields), validity)
    if nm == "interval" and d.unit == "month_day_nano":
        raw = _read_buffer(buf(1), np.dtype([("m", "<i4"), ("d", "<i4"),
                                             ("n", "<i8")]), total)[off:]
        return IntervalMDNColumn(T(raw["m"]), T(raw["d"]), T(raw["n"]),
                                 validity)
    if nm == "interval" and d.unit == "day_time":
        raw = _read_buffer(buf(1), np.dtype([("d", "<i4"),
                                             ("ms", "<i4")]), total)[off:]
        packed = ((raw["d"].astype(np.int64) << 32)
                  | (raw["ms"].astype(np.int64) & 0xFFFFFFFF))
        return PrimitiveColumn(T(packed), d, validity)
    # fixed-width primitive (incl. interval year_month as i32)
    vals = _read_buffer(buf(1), d.storage_numpy(), total)[off:]
    return PrimitiveColumn(T(vals), d, validity)


def _caps_from(obj):
    if isinstance(obj, tuple):
        return obj
    if hasattr(obj, "__arrow_c_array__"):
        return obj.__arrow_c_array__()
    raise ArrowInvalid(f"no C data interface on {type(obj)}")


def import_column(obj, device: DeviceLike) -> Column:
    """(schema_capsule, array_capsule) or any object with
    __arrow_c_array__ -> a port Column on `device` (data copied; the
    producer's release is then called)."""
    dev = resolve_device(device)
    sc, ac = _caps_from(obj)
    sp = ctypes.cast(_PyCapsule_GetPointer(sc, b"arrow_schema"),
                     ctypes.POINTER(ArrowSchema))
    ap = ctypes.cast(_PyCapsule_GetPointer(ac, b"arrow_array"),
                     ctypes.POINTER(ArrowArray))
    _, d, _ = _import_schema(sp.contents)
    col = _import_array(ap.contents, d, dev)
    if ap.contents.release:
        ap.contents.release(ap)
    if sp.contents.release:
        sp.contents.release(sp)
    return col


def import_table(obj, device: DeviceLike):
    """Struct-array capsules (RecordBatch convention) -> Table on
    `device`."""
    from ..core.table import Table
    col = import_column(obj, device)
    if not isinstance(col, StructColumn):
        raise ArrowInvalid("import_table expects a struct array")
    return Table(tuple(col.children), dt.Schema(tuple(col.fields)))


# ---------------------------------------------------------------------------
# ArrowArrayStream (arrow-array/src/ffi_stream.rs:87 role)
# ---------------------------------------------------------------------------

class ArrowArrayStream(ctypes.Structure):
    pass


_GET_SCHEMA = ctypes.CFUNCTYPE(ctypes.c_int,
                               ctypes.POINTER(ArrowArrayStream),
                               ctypes.POINTER(ArrowSchema))
_GET_NEXT = ctypes.CFUNCTYPE(ctypes.c_int,
                             ctypes.POINTER(ArrowArrayStream),
                             ctypes.POINTER(ArrowArray))
_GET_LAST_ERROR = ctypes.CFUNCTYPE(ctypes.c_char_p,
                                   ctypes.POINTER(ArrowArrayStream))
_STREAM_RELEASE = ctypes.CFUNCTYPE(None,
                                   ctypes.POINTER(ArrowArrayStream))

ArrowArrayStream._fields_ = [
    ("get_schema", _GET_SCHEMA),
    ("get_next", _GET_NEXT),
    ("get_last_error", _GET_LAST_ERROR),
    ("release", _STREAM_RELEASE),
    ("private_data", ctypes.c_void_p),
]

# stream state: token -> {"batches": [...], "pos": int, "schema": dtype
# struct-source}
_STREAMS: Dict[int, dict] = {}


@_GET_SCHEMA
def _stream_get_schema(sp, out):
    st = _STREAMS.get(int(sp.contents.private_data or 0))
    if st is None:
        return 5                       # EIO
    _fill_schema(out.contents, st["dtype"], "", False)
    return 0


@_GET_NEXT
def _stream_get_next(sp, out):
    st = _STREAMS.get(int(sp.contents.private_data or 0))
    if st is None:
        return 5
    if st["pos"] >= len(st["batches"]):
        # end of stream: released out marks exhaustion
        ctypes.memset(out, 0, ctypes.sizeof(ArrowArray))
        return 0
    col = st["batches"][st["pos"]]
    st["pos"] += 1
    _fill_array(out.contents, to_host(col))
    return 0


@_GET_LAST_ERROR
def _stream_get_last_error(sp):
    return None


@_STREAM_RELEASE
def _stream_release(sp):
    s = sp.contents
    _STREAMS.pop(int(s.private_data or 0), None)
    _LIVE.pop(int(s.private_data or 0), None)
    s.release = ctypes.cast(None, _STREAM_RELEASE)


def export_stream(tables) -> object:
    """Tables/batches -> "arrow_array_stream" capsule (each batch a
    struct array; pa.table() and pa.RecordBatchReader consume it).

    A batch goes to the host in `get_next`, on whichever thread the
    consumer calls it from.  That copy is synchronous and runs on the
    thread's current stream, the card's default stream unless the
    consumer set another, so it follows the work queued there; batches
    made on a side stream need that stream synchronized first."""
    batches = []
    d = None
    for t in tables:
        sc = StructColumn(tuple(t.columns), tuple(t.schema.fields))
        batches.append(sc)
        d = sc.dtype
    if d is None:
        raise ArrowInvalid("export_stream needs at least one batch")
    stream = ArrowArrayStream()
    stream.get_schema = _stream_get_schema
    stream.get_next = _stream_get_next
    stream.get_last_error = _stream_get_last_error
    stream.release = _stream_release
    token = _register([stream])
    stream.private_data = token
    _STREAMS[token] = {"batches": batches, "pos": 0, "dtype": d}
    return _capsule(stream, b"arrow_array_stream")


def import_stream(obj, device: DeviceLike):
    """"arrow_array_stream" capsule (or object with
    __arrow_c_stream__) -> list of Tables on `device`, one per batch."""
    dev = resolve_device(device)
    cap = obj.__arrow_c_stream__() \
        if hasattr(obj, "__arrow_c_stream__") else obj
    sp = ctypes.cast(
        _PyCapsule_GetPointer(cap, b"arrow_array_stream"),
        ctypes.POINTER(ArrowArrayStream))
    st = sp.contents
    from ..core.table import Table
    s_out = ArrowSchema()
    if st.get_schema(sp, ctypes.byref(s_out)) != 0:
        raise ArrowInvalid("stream get_schema failed")
    _, d, _ = _import_schema(s_out)
    if s_out.release:
        s_out.release(ctypes.byref(s_out))
    if d.name != "struct":
        raise ArrowInvalid("import_stream expects struct batches")
    out = []
    while True:
        a_out = ArrowArray()
        if st.get_next(sp, ctypes.byref(a_out)) != 0:
            raise ArrowInvalid("stream get_next failed")
        if not a_out.release:
            break
        col = _import_array(a_out, d, dev)
        a_out.release(ctypes.byref(a_out))
        out.append(Table(tuple(col.children),
                         dt.Schema(tuple(col.fields))))
    if st.release:
        st.release(sp)
    return out
