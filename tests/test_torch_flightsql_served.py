"""The port's Flight SQL server holding the statements of concurrent
clients on one device (arrow_tpu_torch/io/flightsql.py): three client
threads over the benchmark's TPC-H tables at 20,000 lineitem rows give
the plain reference's answers; each GetFlightInfo has a ticket and a
result of its own; the statement gate runs a statement that raised
torch.cuda.OutOfMemoryError again alone (a query, a CTAS, an INSERT
applied once), holds new statements back while one waits to run alone,
lets no more run together than ran beside a failure, and is taken
outside the update lock, so a CTAS waiting at it never deadlocks a DML
statement.  All on the CPU."""

import importlib
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch.io.flightsql import (FlightSQLClient, FlightSQLServer,
                                          StatementGate)
from arrow_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, program, tpch_gen, traffic  # noqa: E402
from benchmark.drivers.flightsql_client import (Session,  # noqa: E402
                                                read_answer)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 20
WAIT_S = 30                     # no step here takes near this long


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory (test)")


def _statements(spans):
    return [s for s in spans if s.name == "flightsql.statement"]


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.reset_spans()
    yield
    trace.reset_spans()


@pytest.fixture(scope="module")
def tpch():
    """The benchmark's eight tables at 20,000 lineitem rows behind a CPU
    server: (generator's tables, server)."""
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "tpch-sf10-flightsql.json").read_text())
    gen = tpch_gen.make_tables(dict(cfg, rows={
        "lineitem": 20_000, "customer": 3_000, "supplier": 100},
        text_pool_bytes=1 << 16), SEED, CPU)
    server = FlightSQLServer("grpc://localhost:0", device=CPU)
    for name, t in program.port_tables(gen, CPU).items():
        server.register(name, t)
    yield gen, server
    server.shutdown()


def _trades():
    return att.Table.from_pydict({
        "id": np.arange(10, dtype=np.int64),
        "px": np.arange(10, dtype=np.float64) / 4}, device="cpu")


@pytest.fixture
def served():
    """A CPU server over a small `trades` table and a client of it."""
    server = FlightSQLServer("grpc://localhost:0", device=CPU)
    server.register("trades", _trades())
    client = FlightSQLClient(server.uri, device=CPU)
    yield server, client
    client.close()
    server.shutdown()


def _threads(fns):
    """Run each fn on a thread of its own; their results (or raise the
    first error); fail where one is not done within WAIT_S."""
    out, errs = [None] * len(fns), []

    def one(i, fn):
        try:
            out[i] = fn()
        except Exception as e:             # noqa: BLE001
            errs.append(e)
    ts = [threading.Thread(target=one, args=(i, fn), daemon=True)
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(WAIT_S)
        assert not t.is_alive(), "a statement did not finish"
    if errs:
        raise errs[0]
    return out


def test_three_streams_give_the_reference_answers(tpch):
    gen, server = tpch
    mix = traffic.load("traffic", "throughput")
    specs = traffic.queries_of(mix)

    def stream(k):
        s = Session(server.uri, k)
        try:
            qs = traffic.stream(mix, SEED, k)
            return [(q, read_answer(s.call(q)))
                    for q, _ in zip(qs, mix["queries"])]
        finally:
            s.close()

    got = [a for answers in _threads([lambda k=k: stream(k)
                                      for k in range(3)]) for a in answers]
    assert sorted(q.name for q, _ in got) == sorted(mix["queries"] * 3)
    for q, rows in got:
        spec = specs[q.name]
        ref = importlib.import_module(f"benchmark.reference."
                                      f"{q.name.lower()}")
        want, k = ref.answer(gen, q.params)
        why, gap = compare.compare(rows, want, k, spec["answer"])
        assert why is None, (q.name, q.params, why)
        if spec["answer"]["floats"]:
            assert gap <= spec["limits"]["rel_err"]
    # every stream's Q4 table was dropped, and no result is left unread
    assert not [n for n in server._tables if n.startswith("q4_")]
    assert server._results == {}


def test_same_text_at_once_one_run_and_one_result_each(served):
    server, client = served
    real, calls = server._executor, []
    both_in = threading.Barrier(2, timeout=WAIT_S)

    def executor(tables, query):
        calls.append(query)
        if len(calls) <= 2:
            both_in.wait()              # the two statements run at once
        return real(tables, query)
    server._executor = executor
    q = "SELECT id FROM trades WHERE id < 4 ORDER BY id"
    clients = [FlightSQLClient(server.uri, device=CPU) for _ in range(2)]
    try:
        infos = _threads([lambda c=c: c.get_query_info(q) for c in clients])
        tickets = [i.endpoints[0][0] for i in infos]
        assert tickets[0] != tickets[1]
        got = _threads([lambda c=c, t=t: c._client.do_get_ticket(t)
                        for c, t in zip(clients, tickets)])
    finally:
        for c in clients:
            c.close()
    assert len(calls) == 2
    for tables in got:
        assert tables[0].to_pydict() == {"id": [0, 1, 2, 3]}
    assert server._results == {}


def _fail_once(real, after=False):
    """An executor that raises an out-of-memory error on its first call:
    before running, or after (its result made and dropped, as an error
    late in a statement)."""
    state = {"raised": 0, "calls": 0}

    def executor(tables, query):
        state["calls"] += 1
        if not state["raised"]:
            state["raised"] = 1
            if after:
                real(tables, query)
            raise _oom()
        return real(tables, query)
    return executor, state


def _the_rerun(spans, kind):
    runs = [s for s in _statements(spans) if s.attrs["runs"] == 2]
    assert [s.attrs["kind"] for s in runs] == [kind]
    admits = [s for s in spans if s.name == "server.admit"
              and s.parent == runs[0].id]
    assert [s.attrs["mode"] for s in admits] == ["shared", "exclusive"]


def test_query_runs_again_alone_after_out_of_memory(served):
    server, client = served
    server._executor, state = _fail_once(server._executor)
    before = trace.counters_snapshot().get("flightsql.reruns", 0)
    with trace.recording():
        got = client.execute("SELECT SUM(px) AS s FROM trades")
    assert got.to_pydict() == {"s": [11.25]}
    assert state["calls"] == 2
    assert trace.counters_snapshot()["flightsql.reruns"] == before + 1
    _the_rerun(trace.spans(), "query")


@pytest.mark.parametrize("sql,after", [
    ("CREATE TABLE cheap AS SELECT id FROM trades WHERE px > 1", False),
    ("CREATE TABLE cheap AS SELECT id FROM trades WHERE px > 1", True),
    ("INSERT INTO trades VALUES (100, 9.5)", True)])
def test_update_runs_again_alone_and_applies_once(served, sql, after):
    server, client = served
    server._update_executor, state = _fail_once(server._update_executor,
                                                after=after)
    with trace.recording():
        client.execute_update(sql)
    assert state["calls"] == 2
    _the_rerun(trace.spans(), "update")
    if sql.startswith("CREATE"):
        got = client.execute("SELECT id FROM cheap ORDER BY id")
        assert got.to_pydict() == {"id": [5, 6, 7, 8, 9]}
    else:
        got = client.execute("SELECT COUNT(*) AS n FROM trades")
        assert got.to_pydict() == {"n": [11]}


def test_out_of_memory_alone_fails(served):
    server, client = served

    def executor(tables, query):
        raise _oom()
    server._executor = executor
    with pytest.raises(Exception, match="OutOfMemoryError"):
        client.execute("SELECT id FROM trades")
    assert server.gate._shared == 0 and not server.gate._alone


def test_exclusive_waits_for_shared_and_holds_new_ones_back():
    gate = StatementGate(CPU)
    a_go, a_done = threading.Event(), threading.Event()
    c_started = threading.Event()
    seen = {}

    def a():
        a_go.wait(WAIT_S)
        a_done.set()
        return "a"

    def b():
        if "first" not in seen:
            seen["first"] = True
            raise _oom()
        seen["alone"] = (a_done.is_set(), c_started.is_set(),
                         gate._shared)
        return "b"

    def c():
        c_started.set()
        return "c"

    ta = threading.Thread(target=gate.run, args=("query", a), daemon=True)
    ta.start()
    _until(lambda: gate._shared == 1)
    tb = threading.Thread(target=gate.run, args=("query", b), daemon=True)
    tb.start()
    _until(lambda: gate._waiting == 1)
    tc = threading.Thread(target=gate.run, args=("query", c), daemon=True)
    tc.start()
    time.sleep(0.2)
    assert not c_started.is_set()       # held back behind the wait
    assert not gate._alone              # a shared statement still runs
    a_go.set()
    for t in (ta, tb, tc):
        t.join(WAIT_S)
        assert not t.is_alive()
    assert seen["alone"] == (True, False, 0)
    assert c_started.is_set()
    assert gate._shared == 0 and gate._waiting == 0 and not gate._alone


def test_out_of_memory_beside_others_lowers_the_limit():
    """Three statements run together and the third runs out of memory:
    it runs again alone, and from then on at most two run together."""
    gate = StatementGate(CPU)
    hold = threading.Event()

    def held():
        hold.wait(WAIT_S)
        return "held"

    def oom_once():
        if not oom_once.raised:
            oom_once.raised = True
            raise _oom()
        return "alone"
    oom_once.raised = False
    first = [threading.Thread(target=gate.run, args=("query", held),
                              daemon=True) for _ in range(2)]
    for t in first:
        t.start()
    _until(lambda: gate._shared == 2)
    third = threading.Thread(target=gate.run, args=("query", oom_once),
                             daemon=True)
    third.start()
    _until(lambda: gate._waiting == 1)
    assert gate._limit == 2
    hold.set()
    for t in first + [third]:
        t.join(WAIT_S)
        assert not t.is_alive()
    hold.clear()
    later = [threading.Thread(target=gate.run, args=("query", held),
                              daemon=True) for _ in range(3)]
    for t in later:
        t.start()
    _until(lambda: gate._shared == 2)
    time.sleep(0.2)
    assert gate._shared == 2            # the third waits for a place
    hold.set()
    for t in later:
        t.join(WAIT_S)
        assert not t.is_alive()
    assert gate._shared == 0 and gate._limit == 2


def _until(cond):
    end = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < end, "the gate did not get there"
        time.sleep(0.005)


def test_ctas_waiting_alone_does_not_deadlock_a_dml(served):
    """The CTAS holds its table's write lock when it runs out of memory;
    an INSERT into that table waits for the lock outside the gate, so the
    CTAS runs again alone, publishes and leaves the lock, then the INSERT
    runs."""
    server, _ = served
    real = server._update_executor

    def executor(tables, query):
        if query.startswith("CREATE") and not executor.raised:
            executor.raised = True
            ctas_in_lock.set()
            time.sleep(0.2)                  # the INSERT waits for the lock
            assert server.gate._shared == 1  # outside the gate
            raise _oom()
        return real(tables, query)
    executor.raised = False
    ctas_in_lock = threading.Event()
    server._update_executor = executor
    clients = [FlightSQLClient(server.uri, device=CPU) for _ in range(2)]

    def insert():
        ctas_in_lock.wait(WAIT_S)
        return clients[1].execute_update("INSERT INTO big VALUES (50, 1.0)")
    try:
        got = _threads([lambda: clients[0].execute_update(
            "CREATE TABLE big AS SELECT id, px FROM trades WHERE id >= 5"),
            insert])
        assert got == [5, 1]            # the INSERT ran after the CTAS
        n = clients[0].execute("SELECT COUNT(*) AS n FROM big")
    finally:
        for c in clients:
            c.close()
    assert n.to_pydict() == {"n": [6]}


def test_gate_under_stress_never_runs_beside_a_lone_statement():
    """24 statements on threads (more than the cores) through one gate,
    the interpreter switching every microsecond, every third running out
    of memory once: none ever runs beside one that runs alone, and all
    end with the right count of re-runs."""
    gate, lock = StatementGate(CPU), threading.Lock()
    state = {"inside": 0, "bad": 0}

    def statement(i):
        tried = []

        def fn():
            with lock:
                state["inside"] += 1
                if gate._alone and state["inside"] != 1:
                    state["bad"] += 1
            time.sleep(0.001)
            with lock:
                state["inside"] -= 1
            if i % 3 == 0 and not tried:
                tried.append(1)
                raise _oom()
            return i
        return lambda: gate.run("query", fn)

    before = trace.counters_snapshot().get("flightsql.reruns", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _threads([statement(i) for i in range(24)])
    finally:
        sys.setswitchinterval(interval)
    assert got == list(range(24)) and state["bad"] == 0
    assert trace.counters_snapshot()["flightsql.reruns"] == before + 8
    assert gate._shared == 0 and gate._waiting == 0 and not gate._alone
