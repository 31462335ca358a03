"""chip_smoke.py's phase 34 rehearsed on the CPU at small sizes: the dry
run, configs 4, 3 and 5 and the table API over TPC-H tables of 6,000
lineitem rows on an 8-shard LocalMesh of the CPU, each held to its
single-device answer, and the process-group route at world size 1 (over
gloo here; the phase takes NCCL on the card).  CPU tensors take K1's
plain version, so the meter's launch counts are zero."""

import time

import pytest
import torch

from test_torch_tpch_sql import CPU, PlainMeter
from test_torch_tpch_strings import _chip_smoke


class Meter(PlainMeter):
    what = "phase 34 rehearsal"

    def peak_gib(self) -> float:
        return 0.0


@pytest.fixture
def chip(monkeypatch):
    chip = _chip_smoke()
    for name, value in (("P34_CONFIG4_ROWS", 80_000),
                        ("P34_CONFIG4_GROUPS", (1_000, 10_000)),
                        ("P34_CONFIG3_ROWS", 40_000), ("P34_PROBE", 40_000),
                        ("P34_BUILD", 4_000), ("P34_SF1_ROWS", 6_000),
                        ("P31_CUSTOMERS", 600), ("P34_NCCL_ROWS", 20_000)):
        monkeypatch.setattr(chip, name, value)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip, "time_ms", lambda fn, reps=5: (fn(), 0.0)[1])
    monkeypatch.setattr(chip, "kernel_ms", lambda *a, **k: None)
    monkeypatch.setattr(chip, "peak_gib", lambda: 0.0)
    monkeypatch.setattr(chip, "CardMeter", lambda profile, what: Meter(chip))
    real = chip.p34_nccl
    monkeypatch.setattr(chip, "p34_nccl",
                        lambda dev, meter: real(dev, meter, "gloo"))
    return chip


def test_phase34_rehearsal(chip):
    t0 = time.perf_counter()
    entries = chip.run_phase34(CPU, False)
    assert [e["call_site"].split(",")[0] for e in entries] == [
        "phase 34 config 4 local_group_aggregate run starts (one of 8 shards)",
        "phase 34 config 5 dist_join_skew _compact_front of the heavy build "
        "rows (one of 8 shards)",
        "phase 34 dist_table_group_by trim", "phase 34 dist_table_sort trim",
        "phase 34 dist_table_join trim"]
    for e in entries:
        assert e["name"] == "compact" and e["max_abs_err"] == 0.0
        assert e["bound_by"] == "bytes" and e["bytes"] > 0
    assert time.perf_counter() - t0 < 120


def test_phase34_refuses_a_wrong_distributed_answer(chip, monkeypatch):
    """Each mesh answer is held to the single-device one: a shard that
    loses one group's sum fails the phase."""
    from arrow_tpu_torch import parallel as par
    from arrow_tpu_torch.parallel import dist
    real = dist.local_group_aggregate

    def lossy(*args, **kwargs):
        gk, gv, outs, over = real(*args, **kwargs)
        outs[0] = outs[0].clone()
        outs[0][0] += 1
        return gk, gv, outs, over
    monkeypatch.setattr(dist, "local_group_aggregate", lossy)
    mesh = par.make_mesh(8, CPU)
    with pytest.raises(AssertionError, match="differs from the single-device"):
        chip.p34_config4(mesh, CPU, Meter(chip), 1_000, site=False)
