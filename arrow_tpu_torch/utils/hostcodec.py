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
430-650).

The library is `native/libhostcodec.so` at the repository's root, built
by `make -C native` at first use (and again when hostcodec.cpp is newer
than it).  Processes that load it at the same time take a file lock in
the port's build directory; another program that builds the same file
may leave it half written for a moment, so a load that fails is retried
briefly.  There is no per-row Python fallback: without the library these
functions raise.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["intern_varlen", "gather_varlen", "argsort_varlen",
           "encode_varlen_rows", "decode_varlen_rows", "MATCH_LIKE",
           "MATCH_STARTS", "MATCH_ENDS", "MATCH_CONTAINS", "MATCH_EQ",
           "bytes_match", "bytes_cmp_scalar", "ascii_case", "utf8_substring",
           "utf8_char_lengths", "regex_compile", "regex_match"]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_SO = _NATIVE_DIR / "libhostcodec.so"
_LOCK = Path(__file__).resolve().parents[2] / "build" / "arrow_tpu_torch" \
    / "hostcodec.lock"

_lib: Optional[ctypes.CDLL] = None


def _stale() -> bool:
    src = _NATIVE_DIR / "hostcodec.cpp"
    return not _SO.exists() or src.stat().st_mtime > _SO.stat().st_mtime


def _open() -> ctypes.CDLL:
    """Build the library when it is missing or stale, then load it."""
    _LOCK.parent.mkdir(parents=True, exist_ok=True)
    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        err = None
        for _ in range(20):
            if _stale():
                subprocess.run(["make", "-C", str(_NATIVE_DIR), "-s"],
                               check=True, capture_output=True, timeout=300)
            try:
                return ctypes.CDLL(str(_SO))
            except OSError as e:          # half written by another build
                err = e
                time.sleep(0.5)
        raise RuntimeError(f"cannot load {_SO}: {err}")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _open()
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
