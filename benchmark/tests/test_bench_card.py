"""On the card: one short traced run of the first cell, whole, from a
process of its own (the command as BENCHMARK.json gives it)."""

import json
import subprocess
import sys

import pytest

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
def test_first_cell_traced_on_card(card):
    cell = BENCH["workloads"][0]["name"]
    r = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload", cell,
         "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    want = {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
