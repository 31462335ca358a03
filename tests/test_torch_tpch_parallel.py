"""chip_smoke.py's phases 34 and 35 rehearsed on the CPU at small sizes.
Phase 34: the dry run, configs 4, 3 and 5 and the table API over TPC-H
tables of 6,000 lineitem rows on an 8-shard LocalMesh of the CPU, each
held to its single-device answer, and the process-group route at world
size 1 (over gloo here; the phase takes NCCL on the card).  CPU tensors
take K1's plain version, so the meter's launch counts are zero.  Phase
35: the scaling harness at 256 rows a shard over a key domain of 2^10
(at 256 rows over the reference's 2^20 nearly every key is distinct and
the reference's group caps overflow), K1's plain calls counted as
launches."""

import json
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


@pytest.fixture
def phase35(chip, monkeypatch):
    """Phase 35 at 256 rows a shard over keys in [0, 2^10); each plain K1
    call counts as a launch, as the kernel's would on the card."""
    from arrow_tpu_torch.kernels import compact as kc
    from tools_torch import bench_scaling as bs
    monkeypatch.setattr(chip, "P35_ROWS", 256)
    monkeypatch.setattr(bs, "KEY_DOMAIN", 1 << 10)
    monkeypatch.setattr(chip, "card", lambda: "cpu rehearsal")
    real = kc.compact_plain

    def counted(*args, **kwargs):
        kc.compact.launches += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(kc, "compact_plain", counted)
    return chip


def test_phase35_rehearsal(phase35, capsys):
    t0 = time.perf_counter()
    (entry,) = phase35.run_phase35(CPU, False)
    assert entry["call_site"].startswith(
        "phase 35 8-shard group_by local_group_aggregate run starts (one of "
        "8 shards), 2,048 rows")
    assert entry["name"] == "compact" and entry["max_abs_err"] == 0.0
    assert entry["launches"] == 16          # warm and timed runs, 8 shards
    lines = capsys.readouterr().out.splitlines()
    report = json.loads(next(l for l in lines if l.startswith('{"metric"')))
    assert report["per_device_rows"] == 256 and report["card"] == \
        "cpu rehearsal"
    for rec in report["operators"].values():
        assert set(rec["overflow"]) == {"1", "2", "4", "8"}
        assert not any(rec["overflow"].values())
    assert time.perf_counter() - t0 < 60


def test_phase35_refuses_a_wrong_answer(phase35, monkeypatch):
    """The N-shard answers are held to the 1-shard answers: a sort whose
    last valid key at 8 shards is one too large fails."""
    from tools_torch import bench_scaling as bs
    real = bs.op_sort

    def swapped(comm, *args):
        (sk, svalid), over = real(comm, *args)
        if comm.size == 8 and comm.rank == 7:
            sk = sk.clone()
            sk[int(svalid.sum()) - 1] += 1
        return (sk, svalid), over
    monkeypatch.setitem(bs.OPS, "sort", swapped)
    with pytest.raises(AssertionError, match="sort at 8 shards differs"):
        phase35.run_phase35(CPU, False)
