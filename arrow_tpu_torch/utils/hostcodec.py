"""ctypes bindings to the repository's native host library
(native/hostcodec.cpp): the string interning, gather and sort the port's
dictionary encoding runs on the host, the variable-length row cells of
`RowConverter`, and the string kernels of ops/strings.py (the LIKE /
prefix / suffix / substring matcher, the byte compare against a scalar,
ASCII case mapping, the UTF-8 substring and character counts, and the
lazy-DFA regex engine with the reference's bounded handle cache)
(counterpart of arrow_tpu/utils/native.py: _load, _bind_strings,
intern_varlen, gather_varlen, argsort_varlen, encode_varlen_rows,
decode_varlen_rows and the string bindings, native.py:28-86,197-290,
430-650); and the codecs of the file layer (io/): validity bitmaps,
LZ4 frames and blocks, Parquet's RLE / bit-packed hybrid, PLAIN and
DELTA byte arrays, DELTA_BINARY_PACKED, snappy, XXH64 and the
split-block bloom filter, and the C-owned memory of the C Data
Interface (native.py:96-130,268-430,797-819); and the text formats'
engines: CSV indexing, parsing and formatting, the JSON tape and
unescaper, Avro's block decoder and zigzag varints, and the byte-range
gather of Variant (native.py:124-142,651-663,694-870).

The library is built from the repository's `native/hostcodec.cpp`, with
`native/Makefile`'s flags, into the port's own build directory
(`build/arrow_tpu_torch/libhostcodec.so`) at first use, and again when
the source is newer than it.  The port never writes into `native/`: the
JAX package builds `native/libhostcodec.so` in place there.  Processes
that load the library at the same time take a file lock beside it; the
one that builds compiles to a temporary name and renames it into place,
so no process ever opens a half-written file.  There is no per-row
Python fallback: without the library these functions raise.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["intern_varlen", "gather_varlen", "argsort_varlen",
           "encode_varlen_rows", "decode_varlen_rows", "MATCH_LIKE",
           "MATCH_STARTS", "MATCH_ENDS", "MATCH_CONTAINS", "MATCH_EQ",
           "bytes_match", "bytes_cmp_scalar", "ascii_case", "utf8_substring",
           "utf8_char_lengths", "regex_compile", "regex_match",
           "pack_bits", "unpack_bits", "count_set_bits",
           "lz4_frame_compress", "lz4_frame_decompress",
           "lz4_block_decompress", "rle_bp_decode", "rle_bp_encode",
           "plain_byte_array_decode", "plain_byte_array_encode",
           "delta_binary_packed_decode", "delta_byte_array_build",
           "snappy_decompress", "snappy_compress", "xxhash64",
           "sbbf_insert", "sbbf_check", "cdata_malloc", "cdata_release",
           "csv_lib", "json_tape", "json_unescape", "decode_zigzag_longs",
           "avro_decode_block", "gather_ranges", "variant_get_path"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "hostcodec.cpp"
BUILD_DIR = _ROOT / "build" / "arrow_tpu_torch"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall")                 # native/Makefile's CXXFLAGS

_lib: Optional[ctypes.CDLL] = None


def load_library(source: Path = SOURCE, build_dir: Path = BUILD_DIR
                 ) -> ctypes.CDLL:
    """Build `build_dir/libhostcodec.so` from `source` when it is missing
    or older than the source, then load it.  Builds are serialized by a
    file lock in `build_dir` and renamed into place once complete."""
    build_dir.mkdir(parents=True, exist_ok=True)
    so = build_dir / "libhostcodec.so"
    with open(build_dir / "hostcodec.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists() or source.stat().st_mtime > so.stat().st_mtime:
            tmp = build_dir / f".libhostcodec.{os.getpid()}.so"
            try:
                subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS,
                                "-o", str(tmp), str(source)],
                               check=True, capture_output=True, timeout=300)
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
        return ctypes.CDLL(str(so))


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library()
        i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.intern_varlen.argtypes = [i64p, u8p, i64,
                                      ctypes.POINTER(ctypes.c_int32), i64p]
        lib.intern_varlen.restype = i64
        lib.gather_varlen.argtypes = [i64p, u8p, i64p, i64, i64p, u8p]
        lib.gather_varlen.restype = i64
        lib.argsort_varlen.argtypes = [i64p, u8p, i64,
                                       ctypes.POINTER(ctypes.c_uint32)]
        lib.argsort_varlen.restype = None
        i32p, u8 = ctypes.POINTER(ctypes.c_int32), ctypes.c_uint8
        lib.encode_varlen_rows.argtypes = [i32p, u8p, u8p, i64,
                                           ctypes.c_int32, u8, u8, u8p]
        lib.encode_varlen_rows.restype = None
        lib.decode_varlen_rows.argtypes = [u8p, i64, i64, i64,
                                           ctypes.c_int32, u8, u8, i32p,
                                           u8p, u8p]
        lib.decode_varlen_rows.restype = i64
        lib.bytes_match.argtypes = [i64p, u8p, i64, u8p, i64,
                                    ctypes.c_int32, u8, u8p]
        lib.bytes_match.restype = None
        lib.bytes_cmp_scalar.argtypes = [i64p, u8p, i64, u8p, i64,
                                         ctypes.POINTER(ctypes.c_int8)]
        lib.bytes_cmp_scalar.restype = None
        lib.ascii_case.argtypes = [u8p, i64, ctypes.c_int32, u8p]
        lib.ascii_case.restype = i64
        lib.utf8_substring.argtypes = [i64p, u8p, i64, i64, i64, i64p, u8p]
        lib.utf8_substring.restype = i64
        lib.utf8_char_lengths.argtypes = [i64p, u8p, i64, i64p]
        lib.utf8_char_lengths.restype = None
        lib.regex_compile.argtypes = [u8p, i64, ctypes.c_int32]
        lib.regex_compile.restype = ctypes.c_void_p
        lib.regex_free.argtypes = [ctypes.c_void_p]
        lib.regex_free.restype = None
        lib.regex_match_batch.argtypes = [ctypes.c_void_p, i64p, u8p, i64,
                                          u8p]
        lib.regex_match_batch.restype = None
        _bind_io(lib)
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _buffers(offsets: np.ndarray, data: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, int]:
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    if n < 0 or (n and (offsets[0] < 0 or offsets[-1] > len(data)
                        or (np.diff(offsets) < 0).any())):
        raise ValueError("string offsets must rise within the data")
    return offsets, data, n


def intern_varlen(offsets: np.ndarray, data: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Hash-intern byte strings: (int32 code per row in first-occurrence
    order, the int64 row that introduced each code)."""
    offsets, data, n = _buffers(offsets, data)
    codes = np.zeros(max(n, 1), np.int32)
    uniq = np.zeros(max(n, 1), np.int64)
    k = _library().intern_varlen(_ptr(offsets, ctypes.c_int64),
                                 _ptr(data, ctypes.c_uint8), n,
                                 _ptr(codes, ctypes.c_int32),
                                 _ptr(uniq, ctypes.c_int64))
    return codes[:n], uniq[:k]


def gather_varlen(offsets: np.ndarray, data: np.ndarray, idx: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The strings at rows `idx`, packed: (int64 offsets, uint8 data)."""
    offsets, data, n = _buffers(offsets, data)
    idx = np.ascontiguousarray(idx, np.int64)
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise IndexError("gather_varlen index out of range")
    lens = offsets[1:] - offsets[:-1]
    cap = int(lens[idx].sum()) if len(idx) else 0
    out_offs = np.zeros(len(idx) + 1, np.int64)
    out_data = np.zeros(max(cap, 1), np.uint8)
    _library().gather_varlen(_ptr(offsets, ctypes.c_int64),
                             _ptr(data, ctypes.c_uint8),
                             _ptr(idx, ctypes.c_int64), len(idx),
                             _ptr(out_offs, ctypes.c_int64),
                             _ptr(out_data, ctypes.c_uint8))
    return out_offs, out_data[:cap]


def argsort_varlen(offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Order of the strings by their bytes (a shorter prefix first), as
    uint32; ties in no particular order."""
    offsets, data, n = _buffers(offsets, data)
    out = np.zeros(max(n, 1), np.uint32)
    _library().argsort_varlen(_ptr(offsets, ctypes.c_int64),
                              _ptr(data, ctypes.c_uint8), n,
                              _ptr(out, ctypes.c_uint32))
    return out[:n]


def encode_varlen_rows(offsets: np.ndarray, data: np.ndarray,
                       valid: Optional[np.ndarray], nblocks: int,
                       descending: bool, nulls_first: bool) -> np.ndarray:
    """arrow-row's variable-length cells (variable.rs:28-100) as an
    (n, 1 + 33 * nblocks) uint8 matrix: 0x02 and 32-byte blocks, each
    closed by a continuation token (0xFF) or its length + 1; 0x01 for an
    empty value; a null is 0x00 (nulls first) or 0xFF; descending
    inverts every byte but a null's."""
    offsets = np.ascontiguousarray(offsets, np.int32)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    out = np.zeros((n, 1 + 33 * nblocks), np.uint8)
    v = None if valid is None else np.ascontiguousarray(valid, np.uint8)
    _library().encode_varlen_rows(
        _ptr(offsets, ctypes.c_int32), _ptr(data, ctypes.c_uint8),
        None if v is None else _ptr(v, ctypes.c_uint8), n, nblocks,
        int(descending), int(nulls_first), _ptr(out, ctypes.c_uint8))
    return out


def decode_varlen_rows(rows: np.ndarray, cell_offset: int, nblocks: int,
                       descending: bool, nulls_first: bool
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The inverse of `encode_varlen_rows` for the cells at byte
    `cell_offset` of each row: (int32 offsets, uint8 data, uint8
    validity)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    n, stride = rows.shape
    offs = np.zeros(n + 1, np.int32)
    data = np.zeros(max(n * 32 * nblocks, 1), np.uint8)
    valid = np.zeros(n, np.uint8)
    total = _library().decode_varlen_rows(
        _ptr(rows, ctypes.c_uint8), n, stride, cell_offset, nblocks,
        int(descending), int(nulls_first), _ptr(offs, ctypes.c_int32),
        _ptr(data, ctypes.c_uint8), _ptr(valid, ctypes.c_uint8))
    return offs, data[:total], valid


# ---- string kernels (native.py:430-650) -----------------------------------

MATCH_LIKE, MATCH_STARTS, MATCH_ENDS, MATCH_CONTAINS, MATCH_EQ = range(5)


# rows a thread of `bytes_match` takes at least: below it, one thread
PARALLEL_ROWS = 1 << 20


def _row_parts(n: int, run) -> None:
    """run(a, b) over row ranges covering [0, n): one range per core
    (at most 8) for long inputs, each in a thread (ctypes releases the
    interpreter lock during the native call); the ranges write disjoint
    parts of the output."""
    k = max(1, min(8, os.cpu_count() or 1, n // PARALLEL_ROWS))
    if k == 1:
        run(0, n)
        return
    bounds = np.linspace(0, n, k + 1).astype(np.int64).tolist()
    with ThreadPoolExecutor(k) as pool:
        for f in [pool.submit(run, a, b) for a, b in zip(bounds, bounds[1:])]:
            f.result()


def bytes_match(offsets: np.ndarray, data: np.ndarray, pattern: bytes,
                op: int, case_insensitive: bool = False) -> np.ndarray:
    """One pass of the matcher over every value (predicate.rs:28, like.rs):
    `op` is a MATCH_* constant; case_insensitive folds ASCII only.  ->
    bool per value.  Long inputs split into row ranges across threads."""
    offsets, data, n = _buffers(offsets, data)
    pat = np.frombuffer(pattern, np.uint8)
    out = np.zeros(max(n, 1), np.uint8)
    lib = _library()

    def run(a: int, b: int) -> None:
        lib.bytes_match(_ptr(offsets[a:], ctypes.c_int64),
                        _ptr(data, ctypes.c_uint8), b - a,
                        _ptr(pat, ctypes.c_uint8), len(pat), op,
                        int(case_insensitive), _ptr(out[a:], ctypes.c_uint8))
    _row_parts(n, run)
    return out[:n].view(bool)


def bytes_cmp_scalar(offsets: np.ndarray, data: np.ndarray,
                     scalar: bytes) -> np.ndarray:
    """sign(value - scalar) in byte order (a shorter prefix first), as
    int8 -1 / 0 / 1 per value."""
    offsets, data, n = _buffers(offsets, data)
    pat = np.frombuffer(scalar, np.uint8)
    out = np.zeros(max(n, 1), np.int8)
    _library().bytes_cmp_scalar(_ptr(offsets, ctypes.c_int64),
                                _ptr(data, ctypes.c_uint8), n,
                                _ptr(pat, ctypes.c_uint8), len(pat),
                                _ptr(out, ctypes.c_int8))
    return out[:n]


def ascii_case(data: np.ndarray, to_upper: bool) -> Tuple[np.ndarray, bool]:
    """(every byte ASCII-upper- or lower-cased, whether every byte was
    ASCII): a caller that finds a non-ASCII byte maps case per value."""
    data = np.ascontiguousarray(data, np.uint8)
    out = np.zeros(max(len(data), 1), np.uint8)
    ok = _library().ascii_case(_ptr(data, ctypes.c_uint8), len(data),
                               int(to_upper), _ptr(out, ctypes.c_uint8))
    return out[:len(data)], bool(ok)


def utf8_substring(offsets: np.ndarray, data: np.ndarray, start: int,
                   length: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Each value's characters [start, start + length) (substring.rs: a
    negative start counts from the end; no length runs to the end),
    packed: (int64 offsets, uint8 data)."""
    offsets, data, n = _buffers(offsets, data)
    out_offs = np.zeros(n + 1, np.int64)
    out_data = np.zeros(max(len(data), 1), np.uint8)
    total = _library().utf8_substring(
        _ptr(offsets, ctypes.c_int64), _ptr(data, ctypes.c_uint8), n, start,
        -1 if length is None else length, _ptr(out_offs, ctypes.c_int64),
        _ptr(out_data, ctypes.c_uint8))
    return out_offs, out_data[:total]


def utf8_char_lengths(offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Characters per value (bytes that are not UTF-8 continuations), as
    int64."""
    offsets, data, n = _buffers(offsets, data)
    out = np.zeros(max(n, 1), np.int64)
    _library().utf8_char_lengths(_ptr(offsets, ctypes.c_int64),
                                 _ptr(data, ctypes.c_uint8), n,
                                 _ptr(out, ctypes.c_int64))
    return out[:n]


_REGEX_CACHE: dict = {}      # (pattern, ci) -> handle, 0 when unsupported
_REGEX_LOCK = threading.Lock()


def regex_compile(pattern: str, case_insensitive: bool = False):
    """A handle of the native NFA / lazy-DFA engine for an ASCII pattern,
    or None when the engine declines it (a construct it lacks, non-ASCII
    bytes): the caller then uses Python's `re`.  Handles are cached per
    (pattern, flag); past 256 the oldest 128 are freed, as in the
    reference's cache."""
    key = (pattern, bool(case_insensitive))
    lib = _library()
    with _REGEX_LOCK:
        h = _REGEX_CACHE.get(key)
        if h is not None:
            return h or None
        raw = pattern.encode()
        pat = np.frombuffer(raw or b"\0", np.uint8)
        h = lib.regex_compile(_ptr(pat, ctypes.c_uint8), len(raw),
                              int(case_insensitive))
        if len(_REGEX_CACHE) >= 256:
            for k in list(_REGEX_CACHE)[:128]:
                old = _REGEX_CACHE.pop(k)
                if old:
                    lib.regex_free(old)
        _REGEX_CACHE[key] = h or 0
        return h or None


def regex_match(handle, offsets: np.ndarray, data: np.ndarray) -> np.ndarray:
    """One DFA pass over every value: bool per value, True where the
    pattern matches anywhere in it (`re.search`)."""
    offsets, data, n = _buffers(offsets, data)
    out = np.zeros(max(n, 1), np.uint8)
    _library().regex_match_batch(handle, _ptr(offsets, ctypes.c_int64),
                                 _ptr(data, ctypes.c_uint8), n,
                                 _ptr(out, ctypes.c_uint8))
    return out[:n].view(bool)


# ---- the file layer's codecs (native.py:96-130,268-430,797-819) ----------

def _bind_io(lib: ctypes.CDLL) -> None:
    i64, u8p = ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64, u64p = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
    u8, f64p = ctypes.c_uint8, ctypes.POINTER(ctypes.c_double)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    sigs = {
        "pack_bits": ([u8p, i64, u8p], None),
        "unpack_bits": ([u8p, i64, u8p], None),
        "count_set_bits": ([u8p, i64], i64),
        "lz4_frame_compress": ([u8p, i64, u8p, i64], i64),
        "lz4_frame_decompress": ([u8p, i64, u8p, i64], i64),
        "lz4_block_decompress": ([u8p, i64, u8p, i64], i64),
        "rle_bp_decode": ([u8p, i64, ctypes.c_int32, i64, u32p], i64),
        "rle_bp_encode": ([u32p, i64, ctypes.c_int32, u8p, i64], i64),
        "plain_byte_array_decode": ([u8p, i64, i64, i32p, u8p, i64], i64),
        "plain_byte_array_encode": ([i64p, u8p, i64, u8p, i64], i64),
        "delta_binary_packed_decode": ([u8p, i64, i64, i64p], i64),
        "delta_byte_array_build": ([i64p, i64p, u8p, i64, i64, i32p, u8p,
                                    i64], i64),
        "snappy_decompress": ([u8p, i64, u8p, i64], i64),
        "snappy_compress": ([u8p, i64, u8p, i64], i64),
        "xxhash64": ([u8p, i64, u64], u64),
        "sbbf_insert": ([u8p, i64, u64p, i64], None),
        "sbbf_check": ([u8p, i64, u64p, i64, u8p], None),
        "cdata_malloc": ([i64], ctypes.c_void_p),
        # the text formats (native.py:124-142,651-663,694-870)
        "csv_count_seps": ([u8p, i64, u8], i64),
        "csv_index": ([u8p, i64, u8, u8, i64p, i64p, u8p, i64, i64p, i64p],
                      i64),
        "csv_extract": ([u8p, i64p, i64p, u8p, i64, u8, i64p, u8p], i64),
        "csv_parse_i64": ([u8p, i64p, i64p, i64, i64p, u8p], i64),
        "csv_parse_f64": ([u8p, i64p, i64p, i64, f64p, u8p], i64),
        "csv_parse_bool": ([u8p, i64p, i64p, i64, u8p, u8p], i64),
        "csv_parse_timestamp": ([u8p, i64p, i64p, i64, i64, ctypes.c_int32,
                                 i64p, u8p], i64),
        "csv_format_i64": ([i64p, i64, i64, u8p], None),
        "csv_format_timestamp": ([i64p, i64, i64, i64, i64, u8p], None),
        "csv_join_rows": ([i64, vpp, i64p, i64, u8, u8p], i64),
        "json_join_rows": ([i64, vpp, i64p, i64, u8p], i64),
        "json_tape": ([u8p, i64, u8p, i64p, i64p, u8p, i64], i64),
        "json_unescape": ([u8p, i64p, i64p, u8p, i64, i64p, u8p], i64),
        "decode_zigzag_longs": ([u8p, i64, i64, i64, i64p], i64),
        "avro_decode_block": ([u8p, i64, i64, u8p, i32p, i32p, i32p, i32p,
                               ctypes.c_int32, ctypes.c_int32,
                               ctypes.c_int32, i64p, i64p, vpp, vpp], i64),
        "gather_ranges": ([u8p, i64p, i64p, i64p, i64, u8p], None),
        "variant_get_path": ([u8p, i64p, u8p, i64p, i64, i64, u8p, i64p,
                              i64p, u8p, i64p, i64p], i64),
    }
    for name, (args, res) in sigs.items():
        f = getattr(lib, name)
        f.argtypes, f.restype = args, res


def _src(data) -> np.ndarray:
    """Bytes (or a uint8 array) as a contiguous uint8 array, no copy."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, np.uint8).reshape(-1)
    return np.frombuffer(data, np.uint8)


def _u8(a: np.ndarray):
    return _ptr(a, ctypes.c_uint8) if len(a) \
        else _ptr(np.zeros(1, np.uint8), ctypes.c_uint8)


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """A bool mask as an LSB-first bitmap (Arrow's validity layout)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    out = np.zeros((len(mask) + 7) // 8, np.uint8)
    _library().pack_bits(_u8(mask), len(mask), _u8(out))
    return out


def unpack_bits(bits, n: int) -> np.ndarray:
    """The first `n` bits of an LSB-first bitmap as a bool array."""
    bits = _src(bits)
    out = np.zeros(n, np.uint8)
    _library().unpack_bits(_u8(bits), n, _u8(out))
    return out.view(bool)


def count_set_bits(bits, n: int) -> int:
    """The set bits among the first `n` of an LSB-first bitmap."""
    return int(_library().count_set_bits(_u8(_src(bits)), n))


def lz4_frame_compress(data) -> bytes:
    """One LZ4 frame (Arrow IPC's LZ4_FRAME buffer codec)."""
    src = _src(data)
    cap = len(src) + len(src) // 200 + 64
    out = np.zeros(cap, np.uint8)
    n = _library().lz4_frame_compress(_u8(src), len(src), _u8(out), cap)
    if n < 0:
        raise ValueError("lz4 frame compression overflow")
    return out[:n].tobytes()


def lz4_frame_decompress(data, uncompressed_len: int) -> bytes:
    src = _src(data)
    out = np.zeros(max(uncompressed_len, 1), np.uint8)
    n = _library().lz4_frame_decompress(_u8(src), len(src), _u8(out),
                                        uncompressed_len)
    if n != uncompressed_len:
        raise ValueError(
            f"lz4 frame decompressed to {n}, expected {uncompressed_len}")
    return out[:uncompressed_len].tobytes()


def lz4_block_decompress(data, uncompressed_len: int):
    """One raw LZ4 block (Parquet's LZ4_RAW) -> (bytes written, the
    output array); the caller checks the count."""
    src = _src(data)
    out = np.zeros(max(uncompressed_len, 1), np.uint8)
    n = _library().lz4_block_decompress(_u8(src), len(src), _u8(out),
                                        uncompressed_len)
    return int(n), out[:uncompressed_len]


def rle_bp_decode(data, bit_width: int, count: int) -> np.ndarray:
    """RLE / bit-packed hybrid -> uint32[count] (parquet encodings/rle.rs)."""
    src = _src(data)
    out = np.zeros(count, np.uint32)
    consumed = _library().rle_bp_decode(_u8(src), len(src), bit_width,
                                        count, _ptr(out, ctypes.c_uint32))
    if consumed < 0:
        raise ValueError("malformed RLE/bit-packed data")
    return out


def rle_bp_encode(vals: np.ndarray, bit_width: int) -> bytes:
    vals = np.ascontiguousarray(vals, np.uint32)
    cap = len(vals) * ((bit_width + 7) // 8 + 1) + 64
    out = np.zeros(cap, np.uint8)
    n = _library().rle_bp_encode(_ptr(vals, ctypes.c_uint32), len(vals),
                                 bit_width, _u8(out), cap)
    if n < 0:
        raise ValueError("rle encode overflow")
    return out[:n].tobytes()


def plain_byte_array_decode(data, count: int):
    """u32-length-prefixed byte arrays -> (int32 offsets[count+1], u8 data)."""
    src = _src(data)
    offsets = np.zeros(count + 1, np.int32)
    out = np.zeros(max(len(src), 1), np.uint8)
    total = _library().plain_byte_array_decode(
        _u8(src), len(src), count, _ptr(offsets, ctypes.c_int32), _u8(out),
        len(out))
    if total < 0:
        raise ValueError("malformed PLAIN byte-array page")
    return offsets, out[:total]


def plain_byte_array_encode(offsets: np.ndarray, data: np.ndarray) -> bytes:
    """(offsets, data) -> the u32-length-prefixed PLAIN byte-array stream."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    data = np.ascontiguousarray(data, np.uint8)
    n = len(offsets) - 1
    cap = int(offsets[-1]) + 4 * n + 8
    out = np.zeros(max(cap, 1), np.uint8)
    sz = _library().plain_byte_array_encode(
        _ptr(offsets, ctypes.c_int64), _u8(data), n, _u8(out), cap)
    if sz < 0:
        raise ValueError("byte-array encode overflow")
    return out[:sz].tobytes()


def delta_binary_packed_decode(data, count: int):
    """-> (int64 values[count], bytes consumed)."""
    src = _src(data)
    out = np.zeros(max(count, 1), np.int64)
    consumed = _library().delta_binary_packed_decode(
        _u8(src), len(src), count, _ptr(out, ctypes.c_int64))
    if consumed < 0:
        raise ValueError("malformed DELTA_BINARY_PACKED page")
    return out[:count], int(consumed)


def delta_byte_array_build(prefix_lens: np.ndarray, suffix_lens: np.ndarray,
                           suffixes):
    """-> (int32 offsets, u8 data) from incrementally encoded strings."""
    count = len(prefix_lens)
    pl = np.ascontiguousarray(prefix_lens, np.int64)
    sl = np.ascontiguousarray(suffix_lens, np.int64)
    suf = _src(suffixes)
    cap = int(pl.sum() + sl.sum()) + 1
    offsets = np.zeros(count + 1, np.int32)
    data = np.zeros(cap, np.uint8)
    total = _library().delta_byte_array_build(
        _ptr(pl, ctypes.c_int64), _ptr(sl, ctypes.c_int64), _u8(suf),
        len(suf), count, _ptr(offsets, ctypes.c_int32), _u8(data), cap)
    if total < 0:
        raise ValueError("malformed DELTA_BYTE_ARRAY page")
    return offsets, data[:total]


def snappy_decompress(data, uncompressed_len: int) -> np.ndarray:
    """-> a uint8 array (16 bytes of slack let the C side copy in 8- and
    16-byte chunks)."""
    src = _src(data)
    out = np.empty(max(uncompressed_len, 1) + 16, np.uint8)
    n = _library().snappy_decompress(_u8(src), len(src), _u8(out),
                                     uncompressed_len + 16)
    if n != uncompressed_len:
        raise ValueError(
            f"snappy decompressed to {n}, expected {uncompressed_len}")
    return out[:uncompressed_len]


def snappy_compress(data) -> bytes:
    src = _src(data)
    cap = len(src) + len(src) // 4 + 64
    out = np.empty(cap, np.uint8)
    n = _library().snappy_compress(_u8(src), len(src), _u8(out), cap)
    return out[:n].tobytes()


def xxhash64(data, seed: int = 0) -> int:
    """XXH64 of a byte string (the Parquet bloom filter's hash)."""
    src = _src(data)
    return int(_library().xxhash64(_u8(src), len(src), seed))


def sbbf_insert(bitset: np.ndarray, hashes: np.ndarray) -> None:
    """Insert 64-bit hashes into a split-block bloom filter in place
    (parquet bloom_filter/mod.rs): 32 bytes a block."""
    hashes = np.ascontiguousarray(hashes, np.uint64)
    _library().sbbf_insert(_u8(bitset), len(bitset) // 32,
                           _ptr(hashes, ctypes.c_uint64), len(hashes))


def sbbf_check(bitset, hashes: np.ndarray) -> np.ndarray:
    """Whether each hash may be in the filter (False: surely absent)."""
    bits = np.ascontiguousarray(_src(bitset))
    hashes = np.ascontiguousarray(hashes, np.uint64)
    out = np.zeros(max(len(hashes), 1), np.uint8)
    _library().sbbf_check(_u8(bits), len(bits) // 32,
                          _ptr(hashes, ctypes.c_uint64), len(hashes),
                          _u8(out))
    return out[:len(hashes)].astype(bool)


def cdata_malloc(size: int) -> int:
    """Zeroed C memory that the C Data Interface's native release
    callbacks free (hostcodec.cpp cdata_release_*)."""
    return int(_library().cdata_malloc(max(int(size), 1)))


def cdata_release(kind: str) -> int:
    """The address of the native release callback of an exported
    ArrowSchema (`kind` "schema") or ArrowArray ("array")."""
    f = getattr(_library(), f"cdata_release_{kind}")
    return ctypes.cast(f, ctypes.c_void_p).value


# ---- the text formats: CSV, JSON, Avro, Variant (native.py:124-142,
# 651-663,694-870) ------------------------------------------------------

def _i64p(a: np.ndarray):
    return _ptr(a, ctypes.c_int64) if len(a) \
        else _ptr(np.zeros(1, np.int64), ctypes.c_int64)


def _i32p(a: np.ndarray):
    return _ptr(a, ctypes.c_int32) if len(a) \
        else _ptr(np.zeros(1, np.int32), ctypes.c_int32)


def _f64p(a: np.ndarray):
    return _ptr(a, ctypes.c_double) if len(a) \
        else _ptr(np.zeros(1, np.float64), ctypes.c_double)


def csv_lib() -> ctypes.CDLL:
    """The library with the CSV engine bound: the separator count, the
    RFC 4180 indexer, the typed field parsers, the field extractor, the
    integer and civil-calendar formatters and the row joiners.  A reader
    calls it on its own thread before it starts any other."""
    return _library()


def json_tape(data: bytes):
    """-> (types u8, starts i64, ends i64, escs u8): the token tape of a
    JSON buffer."""
    lib = _library()
    src = _src(data)
    cap = max(len(data) // 2 + 16, 64)
    while True:
        types = np.zeros(cap, np.uint8)
        starts = np.zeros(cap, np.int64)
        ends = np.zeros(cap, np.int64)
        escs = np.zeros(cap, np.uint8)
        nt = lib.json_tape(_u8(src), len(src), _u8(types), _i64p(starts),
                           _i64p(ends), _u8(escs), cap)
        if nt == -1:
            cap *= 2
            continue
        if nt == -2:
            raise ValueError("malformed JSON")
        return types[:nt], starts[:nt], ends[:nt], escs[:nt]


def json_unescape(data: np.ndarray, starts, ends, escs):
    """-> (offsets i64, bytes u8): the tape's string tokens unescaped."""
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    escs = np.ascontiguousarray(escs, np.uint8)
    n = len(starts)
    cap = int((ends - starts).sum()) + 4 * max(n, 1)
    offs = np.zeros(n + 1, np.int64)
    out = np.zeros(max(cap, 1), np.uint8)
    total = _library().json_unescape(_u8(_src(data)), _i64p(starts),
                                     _i64p(ends), _u8(escs), n,
                                     _i64p(offs), _u8(out))
    if total < 0:
        raise ValueError("malformed JSON string escape")
    return offs, out[:total]


def decode_zigzag_longs(data: bytes, pos: int, count: int):
    """-> (values int64[count], new_pos): Avro's zigzag varints."""
    arr = _src(data)
    out = np.zeros(count, np.int64)
    new_pos = _library().decode_zigzag_longs(_u8(arr), len(arr), pos, count,
                                             _i64p(out))
    if new_pos < 0:
        raise ValueError("truncated avro varint data")
    return out, int(new_pos)


def avro_decode_block(payload: bytes, row_count: int, prog, fill: bool,
                      vals=None, lens=None):
    """One pass of the native Avro block decoder over `prog` = (kind u8[],
    extra i32[], cstart i32[], ccount i32[], cidx i32[], root):
    fill=False counts each node's occurrences and bytes, fill=True
    writes into the caller's numpy buffers `vals` / `lens`.  ->
    (consumed bytes, occurrences i64[nodes], bytes i64[nodes]); consumed
    < 0 means malformed."""
    lib = _library()
    kind, extra, cstart, ccount, cidx, root = prog
    n_nodes = len(kind)
    data = _src(payload)
    occ = np.zeros(n_nodes, np.int64)
    nb = np.zeros(n_nodes, np.int64)
    valp = (ctypes.c_void_p * n_nodes)()
    lenp = (ctypes.c_void_p * n_nodes)()
    if fill:
        for i in range(n_nodes):
            if vals[i] is not None:
                valp[i] = vals[i].ctypes.data
            if lens[i] is not None:
                lenp[i] = lens[i].ctypes.data
    pos = lib.avro_decode_block(
        _u8(data), len(data), row_count, _u8(kind), _i32p(extra),
        _i32p(cstart), _i32p(ccount), _i32p(cidx), n_nodes, root,
        1 if fill else 0, _i64p(occ), _i64p(nb), valp, lenp)
    return int(pos), occ, nb


def gather_ranges(src: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  out_offs: np.ndarray, out: np.ndarray) -> None:
    """Copy each (start, len) byte range of src to out[out_offs[i]:]."""
    _library().gather_ranges(
        _u8(src), _i64p(np.ascontiguousarray(starts, np.int64)),
        _i64p(np.ascontiguousarray(lens, np.int64)),
        _i64p(np.ascontiguousarray(out_offs, np.int64)), len(starts),
        _u8(out))


def variant_get_path(vals: np.ndarray, voffs: np.ndarray, metas: np.ndarray,
                     moffs: np.ndarray, kinds: np.ndarray, idxs: np.ndarray,
                     kstarts: np.ndarray, keys: np.ndarray, n_steps: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Walk one key / index path through each of the n Variant values
    (packed `vals` at `voffs`, their metadata `metas` at `moffs`) ->
    (start, length) of each row's leaf in `vals`; length -1 where the
    path is missing or null."""
    n = len(voffs) - 1
    out_start = np.zeros(n, np.int64)
    out_len = np.zeros(n, np.int64)
    rc = _library().variant_get_path(
        _u8(vals), _i64p(voffs), _u8(metas), _i64p(moffs), n, n_steps,
        _u8(kinds), _i64p(idxs), _i64p(kstarts), _u8(keys),
        _i64p(out_start), _i64p(out_len))
    if rc != 0:
        raise ValueError(f"malformed variant at row {-rc - 1}")
    return out_start, out_len
