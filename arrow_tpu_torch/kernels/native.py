"""Build and load the port's CUDA kernels.

Every kernel of the port is CUDA C++ for sm_90a in arrow_tpu_torch/csrc/
with a plain C interface.  At first use, `nvcc` compiles all of them into
one shared library under build/arrow_tpu_torch/ at the root of the
checkout (git-ignored), named by a hash of the sources and flags so an
edited source builds anew; ctypes loads it.  Nothing is built when the
package is imported, so a machine without nvcc imports it fine; only a
kernel launch on a CUDA tensor needs the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["library", "check", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "arrow_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_int, _i64, _ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# (argtypes, restype) of every C entry of csrc/*.cu
_SIGNATURES = {
    "atp_error_string": ([_int], ctypes.c_char_p),
    "atp_compact_tile_rows": ([], _int),
    "atp_compact_max_cols": ([], _int),
    # device, keep, n, cols, ncols, cap, tile_counts, tile_offsets, count,
    # stream
    "atp_compact": ([_int, _ptr, _i64, _ptr, _int, _i64, _ptr, _ptr, _ptr,
                     _ptr], _int),
    "atp_groupagg_max_slots": ([], _int),
    # device, codes, n, G, slots, n_sum, n_mm, g_sum, g_cnt, g_min, g_max,
    # stream
    "atp_groupagg": ([_int, _ptr, _i64, _int, _ptr, _int, _int, _ptr, _ptr,
                      _ptr, _ptr, _ptr], _int),
}


@dataclass(frozen=True)
class Library:
    """The loaded kernels: `lib` is the ctypes handle; `build_seconds` is
    0.0 when a built library was reused; `log` holds nvcc's output
    (ptxas registers, shared memory and spills per kernel)."""
    lib: ctypes.CDLL
    path: Path
    build_seconds: float
    log: str


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "arrow_tpu_torch are built from csrc/ at first use")
    return found


@functools.cache
def library() -> Library:
    """Build (once per source hash) and load the kernel library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        digest.update(src.name.encode() + src.read_bytes())
    path = BUILD_DIR / f"libarrow_tpu_torch_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)        # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return Library(lib, path, seconds, log)


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if status != 0:
        msg = library().lib.atp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
