"""BENCHMARK.json against the rules a benchmark file keeps (names, units,
keys, sizes), every cell's files found by name, the harness's refusal
without a card or without the program, and a new cell made of files
alone found and run."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap


from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        names.append(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) \
            and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"} | (
            {"bound"} if m["name"] in e2e else {"layer", "moves"})
        assert set(m) <= allowed and set(m) >= allowed - {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(names) == len(set(names))


def test_every_name_has_its_files():
    b = ROOT / "benchmark"
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (b / "drivers" / f"{cfg['driver']}.py").is_file()
        assert set(c["reduced"]) <= set(cfg)
    for w in BENCH["workloads"]:
        mix = json.loads((b / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        for q in mix["queries"]:
            spec = json.loads((b / "queries" / f"{q}.json").read_text())
            assert (b / "reference" / f"{q.lower()}.py").is_file()
            if spec["answer"]["floats"]:
                assert spec["limits"]["rel_err"] > 0
    for m in BENCH["end_to_end"]:
        assert (b / "end_to_end" / f"{m['name'].rsplit('.', 1)[-1]}.py"
                ).is_file()
    for m in BENCH["per_layer"]:
        assert (b / "metrics" / f"{m['name'].rsplit('.', 1)[-1]}.py"
                ).is_file()
        for cell in m.get("workloads", ()):
            assert cell in {w["name"] for w in BENCH["workloads"]}


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, "benchmark/run.py", "--workload",
             BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
             "--trace", "0", env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def _copy(tmp, with_program: bool):
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp / p, ignore=shutil.ignore_patterns(
            "__pycache__"))
    if with_program:
        os.symlink(ROOT / "arrow_tpu_torch", tmp / "arrow_tpu_torch")


DRIVE = textwrap.dedent("""
    import sys, torch
    sys.path.insert(0, sys.argv[1])
    from benchmark import run, tpch_gen
    real = tpch_gen.make_tables
    def small(cfg, seed, device):
        cfg = dict(cfg, rows={"lineitem": 3000, "customer": 900,
                              "supplier": 100}, text_pool_bytes=1 << 15)
        return real(cfg, seed, device)
    tpch_gen.make_tables = small
    sys.exit(run.main(["--workload", sys.argv[2], "--seed", "11",
                       "--seconds", "0.5", "--trace", "0"],
                      device=torch.device("cpu")))
""")


def test_without_the_program_no_result(tmp_path):
    _copy(tmp_path, with_program=False)
    (tmp_path / "drive.py").write_text(DRIVE)
    r = _run(tmp_path, "drive.py", str(tmp_path),
             BENCH["workloads"][0]["name"])
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_new_cell_of_files_alone_is_found(tmp_path):
    """A mix, a cell and its end-to-end metric added as a file and
    entries, no file edited: the metric `q6_only.queries_per_s` is read
    by end_to_end/queries_per_s.py."""
    _copy(tmp_path, with_program=True)
    (tmp_path / "benchmark" / "traffic" / "q6_only.json").write_text(
        json.dumps({"name": "q6_only", "queries": ["Q6"], "sample": 2,
                    "streams": 1}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "tpch-sf10-embedded.q6_only", "config": "tpch-sf10-embedded",
        "traffic": "q6_only", "chips": 1, "why": "Q6 alone"})
    bench["end_to_end"].append({
        "name": "q6_only.queries_per_s", "unit": "queries/s",
        "better": "higher", "bound": 0.1, "source": "host_clock",
        "workloads": ["tpch-sf10-embedded.q6_only"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "drive.py").write_text(DRIVE)
    r = _run(tmp_path, "drive.py", str(tmp_path),
             "tpch-sf10-embedded.q6_only")
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert set(out["checks"]) >= {"Q6.compared", "Q6.rel_err"}
    assert set(out["metrics"]) == {"q6_only.queries_per_s", "setup_s"}
