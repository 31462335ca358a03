"""Build and load the port's CUDA kernels.

Every kernel of the port is CUDA C++ for sm_90a in arrow_tpu_torch/csrc/
with a plain C interface.  At first use, one `nvcc` per source compiles
them all at once (in parallel), and a last `nvcc` links the objects into
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
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_int, _i64, _ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# (argtypes, restype) of every C entry of csrc/*.cu
_SIGNATURES = {
    "atp_error_string": ([_int], ctypes.c_char_p),
    "atp_compact_tile_rows": ([], _int),
    "atp_compact_max_cols": ([], _int),
    # device, keep, n, cols (host), ncols, cap, positions, pos_width,
    # scratch, stream
    "atp_compact": ([_int, _ptr, _i64, _ptr, _int, _i64, _ptr, _int, _ptr,
                     _ptr], _int),
    "atp_groupagg_max_slots": ([], _int),
    "atp_groupagg_smem_limit": ([], _int),
    # device, key, key_valid, base, key_width, key_signed, n, G,
    # slots (host), nslots, cnt_all_out, out, stream
    "atp_groupagg": ([_int, _ptr, _ptr, _i64, _int, _int, _i64, _int, _ptr,
                      _int, _i64, _ptr, _ptr], _int),
    # device, n, bytes (host)
    "atp_strrank_scratch": ([_int, _i64, _ptr], _int),
    # device, offsets, off_width, data, n, passes, at, scratch,
    # scratch_bytes, left (pinned host), out (host), stream
    "atp_strrank": ([_int, _ptr, _int, _ptr, _i64, _i64, _ptr, _ptr, _i64,
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
        seconds, log = _build(sources, path)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return Library(lib, path, seconds, log)


def _run(cmds):
    """Run commands side by side; (log, the failed command or None)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, failed = "", None
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        log += out
        if p.returncode != 0 and failed is None:
            failed = (c, p.returncode)
    return log, failed


def _build(sources, path: Path):
    """One nvcc per source, all started together, then one link; the
    library lands at `path` atomically (concurrent builds agree)."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in sources]
        log, failed = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)]
                            for src, o in zip(sources, objs)])
        if failed is None:
            lib = str(Path(tmp) / "lib.so")
            link_log, failed = _run([[nvcc, "-gencode",
                                      "arch=compute_90a,code=sm_90a",
                                      "-shared", "-o", lib, *objs]])
            log += link_log
        if failed is not None:
            raise RuntimeError(f"nvcc failed ({failed[1]}): "
                               f"{' '.join(failed[0])}\n{log}")
        os.replace(lib, path)
    return time.perf_counter() - t0, log


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if status != 0:
        msg = library().lib.atp_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
