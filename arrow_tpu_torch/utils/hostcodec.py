"""ctypes bindings to the repository's native host library
(native/hostcodec.cpp): the string interning, gather and sort the port's
dictionary encoding runs on the host, and the variable-length row cells
of `RowConverter` (counterpart of arrow_tpu/utils/native.py: _load,
_bind_strings, intern_varlen, gather_varlen, argsort_varlen,
encode_varlen_rows and decode_varlen_rows, native.py:28-86,197-290,
430-598).

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
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["intern_varlen", "gather_varlen", "argsort_varlen",
           "encode_varlen_rows", "decode_varlen_rows"]

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
