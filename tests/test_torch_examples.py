"""The port's examples (examples_torch/) against the reference's
(examples/): each runs in process with `--device cpu` and prints what
the JAX example prints."""

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import pytest

import arrow_tpu as at

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = ["builders", "collect", "distributed_group_by", "dynamic_types",
            "etl_pipeline", "flightsql_dml", "integration_json",
            "parquet_records", "read_csv", "sql_query", "tensor_builder",
            "version", "zero_copy_ipc"]
TAKES_TMPDIR = {"integration_json", "parquet_records"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_every_example_but_one_is_ported():
    """Every script of examples/ has a port (the name dates from when
    distributed_group_by waited for parallel/)."""
    ref = {p.stem for p in (REPO / "examples").glob("*.py")}
    port = {p.stem for p in (REPO / "examples_torch").glob("*.py")}
    assert port == set(EXAMPLES)
    assert ref == port


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_the_reference_prints(name, tmp_path):
    ref = _load(REPO / "examples" / f"{name}.py", f"ref_example_{name}")
    port = _load(REPO / "examples_torch" / f"{name}.py",
                 f"port_example_{name}")
    argv = ["--device", "cpu"]
    if name in TAKES_TMPDIR:
        (tmp_path / "ref").mkdir()
        (tmp_path / "port").mkdir()
        want = _stdout(lambda: ref.main(str(tmp_path / "ref")))
        argv += ["--tmpdir", str(tmp_path / "port")]
    else:
        want = _stdout(ref.main)
    got = _stdout(lambda: port.main(argv))
    assert got.strip()
    if name == "version":
        # the package names itself and counts the devices of its own
        # backend (the reference's CPU backend here has eight)
        m = re.fullmatch(r"arrow_tpu (\S+) on cpu \(\d+ device\(s\)\)\n",
                         want)
        assert m and m.group(1) == at.__version__
        assert got == f"arrow_tpu_torch {at.__version__} on cpu " \
                      "(1 device(s))\n"
    else:
        assert got == want


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = _load(REPO / "examples_torch" / f"{name}.py",
                 f"port_example_{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main([])
