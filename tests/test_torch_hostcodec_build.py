"""The port's build of the host library (utils/hostcodec.py::load_library):
processes that load it at once all get a whole library, and the build
writes only into the port's build directory, never beside the source
(`native/`, where the JAX package builds its own copy in place)."""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from arrow_tpu_torch.utils import hostcodec

REPO = Path(__file__).resolve().parent.parent
LOADER = ("import sys; from pathlib import Path; "
          "from arrow_tpu_torch.utils import hostcodec as h; "
          "lib = h.load_library(Path(sys.argv[1]), Path(sys.argv[2])); "
          "print('loaded', lib.intern_varlen is not None)")


def _load_at_once(src: Path, build: Path, n: int) -> None:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(src),
                               str(build)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(n)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "loaded True", (out, err)


def test_processes_loading_at_once_build_one_whole_library(tmp_path):
    src = tmp_path / "native" / "hostcodec.cpp"
    src.parent.mkdir()
    shutil.copy(REPO / "native" / "hostcodec.cpp", src)
    build = tmp_path / "build"
    _load_at_once(src, build, 4)
    assert sorted(p.name for p in src.parent.iterdir()) == ["hostcodec.cpp"]
    assert sorted(p.name for p in build.iterdir()) == \
        ["hostcodec.lock", "libhostcodec.so"]


def test_a_newer_source_is_rebuilt_and_renamed_into_place(tmp_path):
    src = tmp_path / "hostcodec.cpp"
    shutil.copy(REPO / "native" / "hostcodec.cpp", src)
    build = tmp_path / "build"
    hostcodec.load_library(src, build)
    so = build / "libhostcodec.so"
    first = so.stat().st_ino
    later = time.time() + 10
    os.utime(src, (later, later))
    _load_at_once(src, build, 3)
    assert so.stat().st_ino != first          # a new file, renamed in
    assert sorted(p.name for p in build.iterdir()) == \
        ["hostcodec.lock", "libhostcodec.so"]


def test_the_port_builds_outside_native():
    assert hostcodec.SOURCE == REPO / "native" / "hostcodec.cpp"
    assert hostcodec.BUILD_DIR == REPO / "build" / "arrow_tpu_torch"
    assert hostcodec.CXXFLAGS[:5] == ("-O3", "-march=native", "-fPIC",
                                      "-shared", "-std=c++17")
