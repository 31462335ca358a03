"""The readers of the program's spans (metrics/sql_self_share.py,
operator_self_share.py, readback_copy_share.py, readback_mb_per_query.py)
on a hand-built window with known answers, and None on an empty one;
and on the card, that every device-to-host copy a query makes is one of
the program's `readback` spans."""

import bisect
import importlib
from types import SimpleNamespace

import pytest
import torch

from .conftest import small_config

READERS = ("sql_self_share", "operator_self_share", "readback_copy_share",
           "readback_mb_per_query")
MS = 1_000_000


def _window():
    """Two statements in a 2 s window of 4 queries (times in ms):

    sql.execute 0-100 (self 30)
      op.join 10-60 (self 30)
        readback 15-25 (drain 4, 2,000,000 bytes)
        kernel.k1 30-40
      op.filter 60-80 (self 15)
        readback 70-75 (drain 1, 8 bytes)
    sql.execute 200-300 (self 80)
      op.group_by 210-230 (self 10)
        op.group_by 212-222 (a nested operator, self 10)
    """
    from arrow_tpu_torch.utils.trace import Span
    rows = [  # id, name, start, end, parent, attrs
        (1, "sql.execute", 0, 100, None, {}),
        (2, "op.join", 10, 60, 1, {"plan": "index"}),
        (3, "readback", 15, 25, 2, {"site": "a", "bytes": 2_000_000,
                                    "drain_ns": 4 * MS}),
        (4, "kernel.k1", 30, 40, 2, {"rows": 10}),
        (5, "op.filter", 60, 80, 1, {"rows": 10}),
        (6, "readback", 70, 75, 5, {"site": "b", "bytes": 8,
                                    "drain_ns": 1 * MS}),
        (7, "sql.execute", 200, 300, None, {}),
        (8, "op.group_by", 210, 230, 7, {"plan": "sort"}),
        (9, "op.group_by", 212, 222, 8, {"plan": "dictionary"}),
    ]
    root = {1: 1, 2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 7: 7, 8: 7, 9: 7}
    return [Span(name, a * MS, b * MS, i, p, root[i], 1, attrs)
            for i, name, a, b, p, attrs in rows]


WANT = {"sql_self_share": (30 + 80) / 2000,
        "operator_self_share": (30 + 15 + 10 + 10) / 2000,
        "readback_copy_share": (6 + 4) / 2000,
        "readback_mb_per_query": 2.000008 / 4}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_known_window(monkeypatch, name):
    from arrow_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", _window)
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    got = reader.read(SimpleNamespace(window_s=2.0, queries=4))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_reads_nothing(monkeypatch, name):
    from arrow_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", lambda: [])
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(SimpleNamespace(window_s=2.0, queries=4)) is None


# ---- on the card ------------------------------------------------------------

def readback_coverage(events):
    """For the profile's `events` (kineto's): the device-to-host copies
    made inside a `query <name>` span, as (host calls, host seconds) of
    their cudaMemcpyAsync calls, in all and inside a program `readback`
    span; and the names of the host ops that made those outside one."""
    cpu, d2h = [], set()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name(), e.start_thread_id(), e.correlation_id(),
                        e.linked_correlation_id()))
        elif "DtoH" in e.name():
            d2h.add(e.correlation_id())

    def intervals(pred):
        """Per thread, the sorted (start, end) of the host events named
        by `pred`: spans that do not overlap on one thread."""
        out = {}
        for o in cpu:
            if pred(o[2]):
                out.setdefault(o[3], []).append(o[:2])
        for v in out.values():
            v.sort()
        return out

    def inside(spans, o) -> bool:
        ivs = spans.get(o[3], [])
        i = bisect.bisect_right(ivs, (o[0], float("inf"))) - 1
        return i >= 0 and ivs[i][0] <= o[0] and o[1] <= ivs[i][1]

    queries = intervals(lambda n: n.startswith("query "))
    readbacks = intervals(lambda n: n == "readback")
    calls = [o for o in cpu if o[2] == "cudaMemcpyAsync" and o[4] in d2h
             and inside(queries, o)]
    covered = [inside(readbacks, o) for o in calls]
    ops = [o for o in cpu if o[5] == 0 and not o[2].startswith("query ")]
    outside = [" > ".join(p[2] for p in sorted(
        p for p in ops if p[3] == o[3] and p[0] <= o[0] and o[1] <= p[1]))
        for o, ok in zip(calls, covered) if not ok]
    return {"calls": len(calls), "covered": sum(covered),
            "seconds": sum(o[1] - o[0] for o in calls) / 1e9,
            "covered_seconds": sum(o[1] - o[0] for o, ok in zip(
                calls, covered) if ok) / 1e9,
            "outside": outside}


@pytest.mark.card
def test_every_readback_of_a_query_is_a_program_readback(card):
    """Q10 and Q1 at a tenth of SF1 under torch.profiler: each
    device-to-host copy made inside a query falls inside a `readback`
    span of the program."""
    from arrow_tpu_torch.sql import execute_sql
    from benchmark import program, tpch_gen, traffic
    from benchmark.trace import Profile
    cfg = small_config(rows={"lineitem": 600_000, "customer": 15_000,
                             "supplier": 1_000})
    tables = program.port_tables(
        tpch_gen.make_tables(cfg, 2 ** 31 + 91, card), card)
    picked = {}
    for mix in ("join", "scan"):
        queries = traffic.stream(traffic.load("traffic", mix), 2 ** 31 + 91,
                                 0)
        for q, _ in zip(queries, range(3)):       # a round of each mix
            picked.setdefault(q.name, q)
    runs = [picked["Q10"], picked["Q1"]]
    for q in runs:                                # warm
        program.run_query(execute_sql, tables, q)
    torch.cuda.synchronize(card)
    with Profile() as prof:
        for q in runs:
            with torch.profiler.record_function(f"query {q.name}"):
                program.run_query(execute_sql, tables, q)
                torch.cuda.synchronize(card)
    got = readback_coverage(prof.prof.profiler.kineto_results.events())
    assert got["calls"] > 0
    assert got["covered"] == got["calls"], got["outside"]
