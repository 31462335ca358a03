"""The import guard: no module the harness or the reference loads is JAX
or the JAX package, comparing top-level names whole (arrow_tpu_torch
passes, arrow_tpu does not); the reference loads no part of the program
either.  Each check runs in a fresh process."""

import json
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "arrow_tpu"}

HARNESS = ["benchmark.run", "benchmark.control",
           "benchmark.drivers.embedded", "benchmark.trace",
           "benchmark.program", "arrow_tpu_torch.sql"]


def _loaded(modules) -> set:
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r})\n"
            f"import importlib\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def _modules(kind):
    return [f"benchmark.{kind}.{p.stem}" for p in
            (ROOT / "benchmark" / kind).glob("*.py")]


def test_harness_loads_no_jax():
    top = _loaded(HARNESS + _modules("metrics") + _modules("end_to_end"))
    assert "arrow_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_loads_no_program():
    top = _loaded(["benchmark.compare", "benchmark.tpch_gen",
                   "benchmark.traffic"] + _modules("reference"))
    assert not top & (FORBIDDEN | {"arrow_tpu_torch"})


def test_guard_compares_whole_names():
    from benchmark import run
    saved = dict(sys.modules)
    try:
        sys.modules["arrow_tpu_torch_extra"] = sys
        assert "arrow_tpu" not in run.forbidden_modules()
        sys.modules["arrow_tpu.sql"] = sys
        assert run.forbidden_modules() == ["arrow_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
