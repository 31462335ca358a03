"""Parity of the port's CLI (arrow_tpu_torch/cli.py) with the
reference's (arrow_tpu/cli.py): the CLI tests of
tests/test_derive_validate_cli.py, each run through both CLIs over the
same file (written by the reference) or the same query, their output
equal; the port's runs with `--device cpu`.  Also every other
subcommand, and the device rule: `cuda` is the default and raises with
no card, the commands that read only metadata ignore it."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.cli import main as ref_main
from arrow_tpu_torch.cli import main as port_main
from torch_port_util import port_table

DEVICE_COMMANDS = {"parquet-read", "parquet-rewrite", "parquet-concat",
                   "parquet-fromcsv", "pretty", "flight-sql"}


def _run(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(list(argv))
    return buf.getvalue()


def both(*argv, port_argv=None) -> str:
    """Both CLIs' output for the same arguments (the port's on the
    CPU), equal; returns it."""
    want = _run(ref_main, argv)
    argv = list(port_argv or argv)
    if argv[0] in DEVICE_COMMANDS:
        argv += ["--device", "cpu"]
    got = _run(port_main, argv)
    assert got == want
    return got


@pytest.fixture
def pq_file(tmp_path):
    from arrow_tpu.io.parquet_io import WriterProperties, write_parquet
    path = str(tmp_path / "data.parquet")
    write_parquet(path, at.Table.from_pydict({
        "id": at.column(np.arange(5, dtype=np.int64)),
        "name": at.column(["a", "b", "c", "d", "e"]),
    }), WriterProperties(bloom_filter_columns=["id", "name"]))
    return path


def test_cli_parquet_read(pq_file):
    out = both("parquet-read", pq_file, "--limit", "2")
    import json
    lines = out.strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[0]) == {"id": 0, "name": "a"}
    both("parquet-read", pq_file)


def test_cli_parquet_schema(pq_file):
    out = both("parquet-schema", pq_file)
    assert "num_rows: 5" in out and "name" in out


@pytest.mark.parametrize("limit", ["3", "100"])
def test_cli_pretty(pq_file, tmp_path, limit):
    out = both("pretty", pq_file, "--limit", limit)
    assert out.startswith("+") and "| id" in out
    csv = tmp_path / "in.csv"
    csv.write_text("x,y\n1,a\n2,b\n3,\n")
    both("pretty", str(csv), "--limit", limit)


def test_cli_rewrite_concat(tmp_path, pq_file):
    from arrow_tpu.io.parquet_io import read_parquet
    from torch_port_util import assert_tables_equal
    rz, rcat, pz, pcat = (str(tmp_path / f"{f}.parquet")
                          for f in ("r_z", "r_cat", "p_z", "p_cat"))
    # the printed lines name the output path: compare with it swapped
    want = _run(ref_main, ["parquet-rewrite", pq_file, rz,
                           "--compression", "zstd"])
    got = _run(port_main, ["parquet-rewrite", pq_file, pz,
                           "--compression", "zstd", "--device", "cpu"])
    assert got == want.replace(rz, pz)
    want = _run(ref_main, ["parquet-concat", rcat, pq_file, rz])
    got = _run(port_main, ["parquet-concat", pcat, pq_file, pz,
                           "--device", "cpu"])
    assert got == want.replace(rz, pz).replace(rcat, pcat)
    assert read_parquet(pcat).num_rows == 10
    assert_tables_equal(port_table(read_parquet(pcat)), read_parquet(rcat))


def test_cli_fromcsv(tmp_path):
    from arrow_tpu.io.parquet_io import read_parquet
    from torch_port_util import assert_tables_equal
    csv = tmp_path / "in.csv"
    csv.write_text("x,y\n1,a\n2,b\n")
    ro, po = str(tmp_path / "r.parquet"), str(tmp_path / "p.parquet")
    want = _run(ref_main, ["parquet-fromcsv", str(csv), ro])
    got = _run(port_main, ["parquet-fromcsv", str(csv), po,
                           "--device", "cpu"])
    assert got == want.replace(ro, po)
    assert read_parquet(po).to_pydict() == {"x": [1, 2], "y": ["a", "b"]}
    assert_tables_equal(port_table(read_parquet(po)), read_parquet(ro))


@pytest.mark.parametrize("query", ["SELECT * FROM t WHERE v = 2",
                                   "SELECT v, v * 2 AS w FROM t ORDER BY v DESC",
                                   "INSERT INTO t VALUES (3)"])
def test_cli_flight_sql(query):
    from arrow_tpu.io.flightsql import FlightSQLServer as RefServer
    from arrow_tpu_torch.io.flightsql import FlightSQLServer
    ref = at.Table.from_pydict({"v": at.column(np.array([1, 2], np.int64))})
    rs = RefServer("grpc://127.0.0.1:0")
    ps = FlightSQLServer("grpc://127.0.0.1:0", device="cpu")
    rs.register("t", ref)
    ps.register("t", port_table(ref))
    try:
        out = both("flight-sql", "--uri", rs.uri, query,
                   port_argv=["flight-sql", "--uri", ps.uri, query])
        assert ("| 2" in out) or ("1 rows affected" in out)
        # the port's CLI against the reference's server says the same
        assert _run(port_main, ["flight-sql", "--uri", rs.uri, query,
                                "--device", "cpu"]) == \
            _run(ref_main, ["flight-sql", "--uri", rs.uri, query])
    finally:
        rs.shutdown()
        ps.shutdown()


# ---- the other subcommands and the device rule ------------------------------

def test_cli_metadata_commands(pq_file):
    for argv in (("parquet-layout", pq_file), ("parquet-index", pq_file, "id"),
                 ("parquet-index", pq_file, "name"),
                 ("parquet-show-bloom-filter", pq_file, "id", "3", "77"),
                 ("parquet-show-bloom-filter", pq_file, "name", "c", "zz")):
        out = both(*argv)
        assert out
        # they read only the file's metadata: a device is not needed
        assert _run(port_main, list(argv) + ["--device", "cuda"]) == out


def test_cli_json_integration(tmp_path):
    from arrow_tpu.io import integration_json as ij
    t = at.Table.from_pydict({"x": [1, None, 3], "s": ["a", None, "c"]})
    jp = str(tmp_path / "t.json")
    ij.write_json_file(jp, t)
    ra, pa_ = str(tmp_path / "r.arrow"), str(tmp_path / "p.arrow")
    _run(ref_main, ["json-integration", "--mode", "JSON_TO_ARROW",
                    "--json", jp, "--arrow", ra])
    _run(port_main, ["json-integration", "--mode", "JSON_TO_ARROW",
                     "--json", jp, "--arrow", pa_])
    for arrow in (ra, pa_):
        assert both("json-integration", "--mode", "VALIDATE", "--json", jp,
                    "--arrow", arrow) == "OK\n"
    rj, pj = str(tmp_path / "r.json"), str(tmp_path / "p.json")
    _run(ref_main, ["json-integration", "--mode", "ARROW_TO_JSON",
                    "--json", rj, "--arrow", ra])
    _run(port_main, ["json-integration", "--mode", "ARROW_TO_JSON",
                     "--json", pj, "--arrow", ra])
    assert open(pj).read() == open(rj).read()


@pytest.mark.parametrize("command", sorted(DEVICE_COMMANDS - {"flight-sql"}))
def test_cli_defaults_to_the_card(command, pq_file, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"parquet-read": [pq_file], "pretty": [pq_file],
            "parquet-rewrite": [pq_file, str(tmp_path / "o.parquet")],
            "parquet-concat": [str(tmp_path / "o.parquet"), pq_file],
            "parquet-fromcsv": [str(tmp_path / "x.csv"),
                                str(tmp_path / "o.parquet")]}[command]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main([command] + args)
