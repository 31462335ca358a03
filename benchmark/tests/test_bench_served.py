"""The served configuration's driver and readers.  The readers of the
service layer's spans (metrics/service_ms_per_query.py,
admit_wait_ms_per_query.py, reruns_per_query.py) on a hand-built window
with known answers, and None on an empty one.  On the CPU at a tiny
size: the `flightsql` driver with its three client processes, which
return three records of sound answers and are all gone after `close()`;
an answer altered in the server's encode makes `correct` false; a client
loads neither JAX, the JAX package nor the program, and refuses to serve
where it could see a card.  On the card: every device-to-host copy the
server's path makes is one of the program's `readback` spans."""

import importlib
import json
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run, traffic

from .conftest import ROOT, small_config
from .test_bench_faults import _assert_caught
from .test_bench_imports import FORBIDDEN, _loaded

CELL = "tpch-sf10-flightsql.throughput"
CONFIG = "tpch-sf10-flightsql"
READERS = ("service_ms_per_query", "admit_wait_ms_per_query",
           "reruns_per_query")
MS = 1_000_000


def _window():
    """Two served statements and an encode in a window of 4 queries
    (times in ms):

    flightsql.statement 0-100 (runs 1, self 100 - 10 - 60 = 30)
      server.admit 0-10 (shared)
      sql.execute 10-70
        readback 20-30
    flight.encode 100-120 (self 20 - 5 = 15)
      readback 110-115
    flightsql.statement 200-400 (runs 2, self 200 - 20 - 50 - 30 = 100)
      server.admit 200-220 (shared)
      sql.execute 220-270
      server.admit 270-300 (exclusive)
    """
    from arrow_tpu_torch.utils.trace import Span
    rows = [  # id, name, start, end, parent, attrs
        (1, "flightsql.statement", 0, 100, None, {"kind": "query",
                                                  "runs": 1}),
        (2, "server.admit", 0, 10, 1, {"mode": "shared"}),
        (3, "sql.execute", 10, 70, 1, {}),
        (4, "readback", 20, 30, 3, {"site": "a", "bytes": 8}),
        (5, "flight.encode", 100, 120, None, {"rows": 1}),
        (6, "readback", 110, 115, 5, {"site": "flight.encode",
                                      "bytes": 8}),
        (7, "flightsql.statement", 200, 400, None, {"kind": "update",
                                                    "runs": 2}),
        (8, "server.admit", 200, 220, 7, {"mode": "shared"}),
        (9, "sql.execute", 220, 270, 7, {}),
        (10, "server.admit", 270, 300, 7, {"mode": "exclusive"}),
    ]
    root = {1: 1, 2: 1, 3: 1, 4: 1, 5: 5, 6: 5, 7: 7, 8: 7, 9: 7, 10: 7}
    return [Span(name, a * MS, b * MS, i, p, root[i], 1, attrs)
            for i, name, a, b, p, attrs in rows]


WANT = {"service_ms_per_query": (30 + 15 + 100) / 4,
        "admit_wait_ms_per_query": (10 + 20 + 30) / 4,
        "reruns_per_query": 1 / 4}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_known_window(monkeypatch, name):
    from arrow_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", _window)
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    got = reader.read(SimpleNamespace(window_s=1.0, queries=4))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_reads_nothing(monkeypatch, name):
    from arrow_tpu_torch.utils import trace
    embedded = [s for s in _window() if s.name in ("sql.execute",
                                                   "readback")]
    for recorded in ([], embedded):
        monkeypatch.setattr(trace, "spans", lambda: recorded)
        reader = importlib.import_module(f"benchmark.metrics.{name}")
        assert reader.read(SimpleNamespace(window_s=1.0, queries=4)) is None


# ---- the driver on the CPU ----------------------------------------------------

def _result(capsys, seconds=2.0):
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 7),
                   "--seconds", str(seconds), "--trace", "0"],
                  device=torch.device("cpu"))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_driver_three_clients_sound_and_gone():
    from benchmark import tpch_gen
    from benchmark.drivers.flightsql import Driver
    cpu, seed = torch.device("cpu"), 2 ** 31 + 3
    cfg = small_config(CONFIG)
    mix = traffic.load("traffic", "throughput")
    driver = Driver(cfg, mix, seed, cpu, False)
    driver.start()
    try:
        tables = tpch_gen.make_tables(cfg, seed, cpu)
        driver.setup(tables)
        records = driver.window(2.0)
    finally:
        driver.close()
        procs = driver.clients
    assert procs == [] and driver.server is None
    assert len(records) == 3
    for rec in records:
        assert rec.latencies and not rec.errors
        assert not any(failed for *_, failed in rec.latencies)
        assert rec.latencies[-1][2] >= driver.t_open + 2.0
    checks = run.judge([s for r in records for s in r.samples], tables, mix)
    assert all(run.passed(c) for c in checks.values()), checks


def test_no_client_is_left(monkeypatch):
    """close() leaves no client process, also after a failed set-up."""
    from benchmark.drivers import flightsql
    started = []
    real = subprocess.Popen

    def popen(*args, **kwargs):
        started.append(real(*args, **kwargs))
        return started[-1]
    monkeypatch.setattr(flightsql.subprocess, "Popen", popen)
    driver = flightsql.Driver(small_config(CONFIG), traffic.load(
        "traffic", "throughput"), 1, torch.device("cpu"), False)
    driver.start()
    with pytest.raises(RuntimeError, match="a client failed"):
        driver._ask(driver.clients[0], "warm")      # before "connect"
        driver._answer(driver.clients[0])
    driver.close()
    assert len(started) == 3
    assert all(p.poll() is not None for p in started)


def test_sound_run_is_correct(small_tables, capsys):
    r = _result(capsys)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "join.queries_per_s"}


def test_answer_altered_in_the_encode_is_not_correct(small_tables, capsys,
                                                     monkeypatch):
    from arrow_tpu_torch.core.column import PrimitiveColumn
    from arrow_tpu_torch.core.table import Table
    from arrow_tpu_torch.io import flight
    real = flight.encode_flight_stream

    def altered(table):
        cols = list(table.columns)
        for i, c in enumerate(cols):
            if isinstance(c, PrimitiveColumn) and len(c) and \
                    c.values.dtype in (torch.float64, torch.int64):
                v = c.values.clone()
                v[0] += 1
                cols[i] = c.with_values(v)
                break
        return Table(cols, table.schema)

    def encode(tables, *args, **kwargs):
        if isinstance(tables, Table):
            tables = [tables]
        return real([altered(t) for t in tables], *args, **kwargs)
    monkeypatch.setattr(flight, "encode_flight_stream", encode)
    _assert_caught(_result(capsys))


def test_client_loads_no_jax_nor_the_program():
    top = _loaded(["benchmark.drivers.flightsql_client"])
    assert not top & (FORBIDDEN | {"arrow_tpu_torch"})


def _client(env):
    p = subprocess.Popen([sys.executable, "-m",
                          "benchmark.drivers.flightsql_client"], cwd=ROOT,
                         env=env, stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE)
    pickle.dump(("quit",), p.stdin)
    p.stdin.close()
    out = p.stdout.read()
    p.stdout.close()
    return p.wait(60), out


def test_client_that_could_see_a_card_refuses():
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    rc, out = _client(env)
    assert rc == 3
    kind, why = pickle.loads(out)
    assert kind == "error" and "CUDA_VISIBLE_DEVICES" in why
    assert _client(dict(env, CUDA_VISIBLE_DEVICES=""))[0] == 0


@pytest.mark.parametrize("name", ["jax", "arrow_tpu.sql", "arrow_tpu_torch"])
def test_client_refuses_with_a_forbidden_module(monkeypatch, name):
    from benchmark.drivers import flightsql_client as fc
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setitem(sys.modules, name, sys)
    assert repr(name.split(".")[0]) in fc.broken()


# ---- on the card ------------------------------------------------------------

@pytest.mark.card
def test_every_readback_of_the_served_path_is_a_program_readback(card):
    """Q10, Q1 and Q4 at a tenth of SF1, three at once through the
    server under torch.profiler (all threads): each device-to-host copy
    made inside a statement or an encode falls inside a `readback`
    span."""
    import threading
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    from arrow_tpu_torch.io.flightsql import FlightSQLServer
    from benchmark import program, tpch_gen
    from benchmark.drivers.flightsql_client import Session
    from .test_bench_spans import readback_coverage
    seed = 2 ** 31 + 93
    cfg = small_config(CONFIG, rows={"lineitem": 600_000,
                                     "customer": 15_000, "supplier": 1_000})
    server = FlightSQLServer("grpc://localhost:0", device=card)
    for name, t in program.port_tables(tpch_gen.make_tables(cfg, seed, card),
                                       card).items():
        server.register(name, t)
    mix = traffic.load("traffic", "throughput")
    picked = {}
    for q, _ in zip(traffic.stream(mix, seed, 0), range(5)):
        picked[q.name] = q
    runs = [picked["Q10"], picked["Q1"], picked["Q4"]]
    sessions = [Session(server.uri, k) for k in range(3)]
    try:
        for s, q in zip(sessions, runs):          # warm
            s.call(q)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            ts = [threading.Thread(target=s.call, args=(q,))
                  for s, q in zip(sessions, runs)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(300)
    finally:
        for s in sessions:
            s.close()
        server.shutdown()
    events = prof.profiler.kineto_results.events()
    got = readback_coverage(_as_queries(events))
    assert got["calls"] > 0
    assert got["covered"] == got["calls"], got["outside"]


class _Renamed:
    """A profiler event whose `flightsql.statement` or `flight.encode`
    name reads as a `query <name>` span, as readback_coverage takes it."""

    def __init__(self, e):
        self._e = e

    def name(self):
        n = self._e.name()
        return f"query {n}" if n in ("flightsql.statement",
                                     "flight.encode") else n

    def __getattr__(self, attr):
        return getattr(self._e, attr)


def _as_queries(events):
    return [_Renamed(e) for e in events]
