"""The port's spans and its one readback helper (arrow_tpu_torch/utils/
trace.py): spans nest under the SQL statement that caused them, self time
on a hand-built tree, nothing recorded (and no profiler annotation made)
while recording is off, the spans on torch.profiler's timeline by name,
`to_host`'s record and its guard inside a fused region, the plan each
operator span names, and `span_report`'s totals.  All on the CPU but the
count of the device encode's native passes, on the card."""

import numpy as np
import pytest
import torch

import arrow_tpu_torch as att
from arrow_tpu_torch import dtypes as pdt
from arrow_tpu_torch.config import fused_region
from arrow_tpu_torch.core.column import PrimitiveColumn, from_numpy
from arrow_tpu_torch.ops.cast import CastOptions, cast
from arrow_tpu_torch.ops.filter import filter as pfilter
from arrow_tpu_torch.ops.groupby import AggSpec, group_by
from arrow_tpu_torch.ops.join import join
from arrow_tpu_torch.ops.sort import partition
from arrow_tpu_torch.ops.take import take
from arrow_tpu_torch.sql import execute_sql
from arrow_tpu_torch.utils import trace

MS = 1_000_000
QUERY = ("SELECT o.cust, SUM(o.amount) AS total, COUNT(*) AS n FROM orders o "
         "JOIN custs c ON o.cust = c.cid WHERE o.amount > 2 "
         "GROUP BY o.cust ORDER BY total DESC LIMIT 2")


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.reset_spans()
    yield
    trace.reset_spans()


def _tables():
    orders = att.Table.from_pydict({
        "cust": np.array([1, 2, 1, 3, 2, 1, 3, 3, 2, 1], np.int64),
        "amount": np.array([10.0, 20.5, 5.0, 7.25, 100.0, 1.0, 8.0, 9.5,
                            30.0, 2.5]),
        "tag": ["aa", "ab", "ba", "bb", "aa", "ab", "ba", "bb", "aa", "cc"],
    }, device="cpu")
    custs = att.Table.from_pydict({
        "cid": np.array([1, 2, 3, 4], np.int64),
        "name": ["ann", "bob", "cat", "dan"]}, device="cpu")
    return {"orders": orders, "custs": custs}


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided at run
    time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device encode's native route")
    return torch.device("cuda")


def _recorded(fn):
    with trace.recording():
        out = fn()
    return out, trace.spans()


def test_spans_nest_under_the_statement():
    out, spans = _recorded(lambda: execute_sql(_tables(), QUERY))
    assert out.num_rows == 2
    by_id = {s.id: s for s in spans}
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["sql.execute"]
    assert {s.root for s in spans} == {top[0].id}
    names = {s.name for s in spans}
    assert {"op.join", "op.filter", "op.group_by", "op.sort", "op.take",
            "kernel.k1", "readback"} <= names
    for s in spans:
        if s.name.startswith("op."):
            assert by_id[s.parent].name == "sql.execute"
        if s.name == "kernel.k1":
            assert by_id[s.parent].name.startswith("op.")
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
        assert s.thread == top[0].thread
    # spans close before their parent does
    assert spans[-1] is top[0]


def test_two_statements_two_roots():
    tables = _tables()
    _, spans = _recorded(lambda: [execute_sql(tables, QUERY),
                                  execute_sql(tables, QUERY)])
    roots = [s for s in spans if s.name == "sql.execute"]
    assert len(roots) == 2
    for r in roots:
        assert r.root == r.id
        assert any(s.root == r.id and s.name == "op.join" for s in spans)


def test_self_ns_on_a_hand_built_tree():
    """a 0-100 holds b 10-40 (which holds c 20-30) and d 30-60: d starts
    inside b, so a's children cover 10-60 once; c and d have no
    children."""
    Span = trace.Span
    tree = [Span("a", 0, 100 * MS, 1, None, 1, 0, {}),
            Span("b", 10 * MS, 40 * MS, 2, 1, 1, 0, {}),
            Span("c", 20 * MS, 30 * MS, 3, 2, 1, 0, {}),
            Span("d", 30 * MS, 60 * MS, 4, 1, 1, 0, {})]
    assert trace.self_ns(tree) == {1: 50 * MS, 2: 20 * MS, 3: 10 * MS,
                                   4: 30 * MS}


def test_off_records_nothing_and_annotates_nothing(monkeypatch):
    made = []
    real = trace._profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(trace._profiler, "record_function", counting)
    execute_sql(_tables(), QUERY)
    trace.to_host("x", torch.ones(3))
    assert trace.span("op.join") is trace._OFF
    assert trace.spans() == [] and made == []
    with trace.recording():
        execute_sql(_tables(), QUERY)
    assert "sql.execute" in made and len(trace.spans()) == len(made)


def test_spans_appear_in_the_profile_by_name():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        execute_sql(_tables(), QUERY)
    recorded = {s.name for s in trace.spans()}
    assert {"sql.execute", "op.join", "readback"} <= recorded
    profiled = {e.name for e in prof.events()}
    assert recorded <= profiled
    n = sum(e.name == "readback" for e in prof.events())
    assert n == sum(s.name == "readback" for s in trace.spans())


def test_to_host_records_site_and_bytes():
    t = torch.arange(12, dtype=torch.int32)
    with trace.recording():
        with trace.span("op.take"):
            got = trace.to_host("take.range_gather", t)
    assert torch.equal(got, t) and got.device.type == "cpu"
    rb, op = trace.spans()
    assert rb.name == "readback" and op.name == "op.take"
    assert rb.parent == op.id and rb.root == op.id
    assert rb.attrs["site"] == "take.range_gather"
    assert rb.attrs["bytes"] == 48
    assert 0 <= rb.attrs["drain_ns"] <= rb.end_ns - rb.start_ns


def test_to_host_guard_inside_a_fused_region():
    t = torch.ones(2)
    with fused_region():
        assert torch.equal(trace.to_host("unguarded", t), t)
        with pytest.raises(RuntimeError, match="arrow_tpu_torch.fuse: "
                                               "guarded reads"):
            trace.to_host("guarded", t, guard=True)
    assert torch.equal(trace.to_host("guarded", t, guard=True), t)


@pytest.mark.parametrize("op", ["filter", "take_checked", "partition",
                                "cast_unsafe"])
def test_guarded_reads_raise_inside_a_fused_region(op):
    """The reads `fuse` cannot capture still raise there, as the
    guard before them did."""
    x = PrimitiveColumn(torch.arange(10), pdt.int64)
    calls = {
        "filter": lambda: pfilter(x, PrimitiveColumn(x.values > 4,
                                                     pdt.bool_)),
        "take_checked": lambda: take(x, x, check_bounds=True),
        "partition": lambda: partition([x]),
        "cast_unsafe": lambda: cast(x, pdt.int8, CastOptions(safe=False)),
    }
    calls[op]()                                   # eager: fine
    with fused_region():
        with pytest.raises(RuntimeError, match="arrow_tpu_torch.fuse"):
            calls[op]()


def _dict_key(n):
    return from_numpy(np.arange(n, dtype=np.int32) % 3, device="cpu",
                      dictionary=["x", "y", "z"])


GROUP_KEYS = {
    "dictionary": lambda n: _dict_key(n),
    "small_domain": lambda n: att.column(np.arange(n) % 5, device="cpu"),
    "sort": lambda n: att.column(np.arange(n) * 1_000_003, device="cpu"),
    "string_keys": lambda n: att.column([f"k{i % 4}" for i in range(n)],
                                        device="cpu"),
}


@pytest.mark.parametrize("plan", sorted(GROUP_KEYS))
def test_group_by_names_its_plan(plan):
    n = 40
    t = att.Table([GROUP_KEYS[plan](n), att.column(np.arange(n),
                                                   device="cpu")],
                  pdt.Schema((pdt.Field("k", GROUP_KEYS[plan](1).dtype),
                              pdt.Field("v", pdt.int64))))
    _, spans = _recorded(lambda: group_by(t, ["k"], [AggSpec("v", "sum")]))
    ops = [s for s in spans if s.name == "op.group_by"]
    assert len(ops) == 1 and ops[0].attrs["plan"] == plan
    k2 = [s for s in spans if s.name == "kernel.k2"]
    if plan != "sort":           # the K2 plans: one pass over n rows
        assert [(s.parent, s.attrs) for s in k2] == [(ops[0].id,
                                                      {"rows": n})]


def test_string_key_encode_is_a_span_under_the_group_by():
    """A string key's dictionary encode is a `strings.encode` span inside
    the operator that asked for it; a CPU column takes the host route,
    with no refinement passes or drops and none counted as native, and a
    dictionary passes through unrecorded."""
    from arrow_tpu_torch.ops.strings import dictionary_encode
    t = att.Table([att.column(["b", "a", None, "b"], device="cpu"),
                   att.column(np.arange(4), device="cpu")],
                  pdt.Schema((pdt.Field("k", pdt.utf8),
                              pdt.Field("v", pdt.int64))))
    native = trace.counters_snapshot().get("strings.native_passes", 0)
    _, spans = _recorded(lambda: group_by(t, ["k"], [AggSpec("v", "sum")]))
    (op,) = [s for s in spans if s.name == "op.group_by"]
    (enc,) = [s for s in spans if s.name == "strings.encode"]
    assert enc.parent == op.id
    assert enc.attrs == {"rows": 4, "distinct": 3, "passes": 0, "drops": 0}
    assert trace.counters_snapshot().get("strings.native_passes", 0) == \
        native
    dcol = dictionary_encode(t.column("k"))
    trace.reset_spans()
    _, spans = _recorded(lambda: dictionary_encode(dcol))
    assert spans == []


def test_cuda_encode_counts_its_native_passes(cuda_device):
    """On the card the encode's span carries the passes and drops of K3's
    routine, and `strings.native_passes` adds the same passes."""
    from arrow_tpu_torch.ops.strings import dictionary_encode
    words = [f"customer#{i % 700:09d} {'x' * (i % 23)}" for i in range(3000)]
    col = att.column(words, device=cuda_device)
    native = trace.counters_snapshot().get("strings.native_passes", 0)
    _, spans = _recorded(lambda: dictionary_encode(col))
    (enc,) = [s for s in spans if s.name == "strings.encode"]
    assert enc.attrs["passes"] == -(-max(map(len, words)) // 7)
    assert enc.attrs["drops"] >= 1 and enc.attrs["distinct"] == len(set(words))
    assert trace.counters_snapshot()["strings.native_passes"] - native == \
        enc.attrs["passes"]


JOIN_RIGHT = {
    "index": np.array([1, 2, 3, 4], np.int64),            # unique keys
    "packed merge": np.array([1, 2, 2, 4], np.int64),     # a repeated key
    "general merge": np.array([1, 2, 2, -(1 << 62)], np.int64),
}


@pytest.mark.parametrize("plan", sorted(JOIN_RIGHT))
def test_join_names_its_plan(plan):
    left = att.Table.from_pydict({"k": np.array([1, 2, 2, 3, 5], np.int64),
                                  "a": np.arange(5)}, device="cpu")
    right = att.Table.from_pydict({"k": JOIN_RIGHT[plan],
                                   "b": np.arange(4)}, device="cpu")
    _, spans = _recorded(lambda: join(left, right, ["k"]))
    ops = [s for s in spans if s.name == "op.join"]
    assert len(ops) == 1 and ops[0].attrs["plan"] == plan


def test_span_report_totals():
    Span = trace.Span
    spans = [Span("readback", 1 * MS, 2 * MS, 2, 1, 1, 0,
                  {"bytes": 3_000_000, "drain_ns": 0}),
             Span("readback", 3 * MS, 5 * MS, 3, 1, 1, 0,
                  {"bytes": 1_000_000, "drain_ns": 0}),
             Span("op.join", 0, 10 * MS, 1, None, 1, 0, {})]
    lines = trace.span_report(spans).splitlines()
    assert lines[0].split() == ["span", "calls", "total", "ms", "self", "ms",
                                "MB"]
    assert lines[1].split() == ["op.join", "1", "10.00", "7.00", "0.000"]
    assert lines[2].split() == ["readback", "2", "3.00", "3.00", "4.000"]
    assert len(lines) == 3


def test_a_served_statement_is_a_root():
    """Over Flight SQL: the statement is the root on the handler's
    thread, its wait at the gate and `sql.execute` beneath it; the
    result's encode is a span of its own, each buffer's copy a
    `readback` of site `flight.encode` beneath it."""
    from arrow_tpu_torch.io.flightsql import FlightSQLClient, FlightSQLServer
    server = FlightSQLServer("grpc://localhost:0", device="cpu")
    for name, t in _tables().items():
        server.register(name, t)
    client = FlightSQLClient(server.uri, device="cpu")
    try:
        out, spans = _recorded(lambda: client.execute(QUERY))
    finally:
        client.close()
        server.shutdown()
    assert out.num_rows == 2
    by_id = {s.id: s for s in spans}
    st, = [s for s in spans if s.name == "flightsql.statement"]
    assert st.parent is None and st.attrs == {"kind": "query", "runs": 1}
    admit, = [s for s in spans if s.name == "server.admit"]
    assert admit.parent == st.id
    assert admit.attrs == {"mode": "shared", "limit": 0}
    sql, = [s for s in spans if s.name == "sql.execute"]
    assert sql.parent == st.id
    assert all(s.root == st.id for s in spans if s.name.startswith("op."))
    enc, = [s for s in spans if s.name == "flight.encode"]
    assert enc.parent is None and enc.attrs["rows"] == 2
    assert enc.attrs["messages"] == 2 and enc.attrs["bytes"] > 0
    copies = [s for s in spans if s.name == "readback"
              and s.attrs["site"] == "flight.encode"]
    assert copies and all(by_id[s.parent] is enc for s in copies)
    # every buffer of the 2 x 3 result: the key, the sum and the count
    assert sum(s.attrs["bytes"] for s in copies) == 2 * 3 * 8


TPCH_STAR = ("SELECT * FROM customer JOIN orders ON c_custkey = o_custkey "
             "JOIN lineitem ON o_orderkey = l_orderkey")


@pytest.mark.parametrize("query, read, pushed", [("Q3", 2 + 4 + 4, 3),
                                                 (TPCH_STAR, 8 + 9 + 16, 0)])
def test_statement_names_the_columns_it_reads(query, read, pushed):
    """`sql.execute` carries the columns of the tables the statement
    reads (customer 8, orders 9, lineitem 16), the columns left after
    the cut (Q3 names 2, 4 and 4 of them, SELECT * every one) and the
    WHERE conjuncts that filtered their table before the joins (each of
    Q3's three names one table; SELECT * has no WHERE).  The counters
    `sql.columns_pruned` and `sql.conjuncts_pushed` add the differences
    and the pushed conjuncts: 0 and 0 for SELECT *."""
    from test_torch_tpch_strings import _chip_smoke
    chip = _chip_smoke()
    tabs, _ = chip.tpch_tables(2_000, 200, torch.device("cpu"), text=False,
                               pool_bytes=1 << 16, seed=18)
    query = chip.P32_QUERIES.get(query, query)
    names = ("sql.columns_pruned", "sql.conjuncts_pushed")
    before = [trace.counters_snapshot().get(n, 0) for n in names]
    _, spans = _recorded(lambda: execute_sql(tabs, query))
    (st,) = [s for s in spans if s.name == "sql.execute"]
    assert st.attrs == {"columns_in": 33, "columns_read": read,
                        "conjuncts_pushed": pushed, "rows_masked": 0}
    after = [trace.counters_snapshot()[n] for n in names]
    assert [a - b for a, b in zip(after, before)] == [33 - read, pushed]


def _written(device) -> tuple:
    """A version over a utf8, a large_utf8 and a dictionary column, and
    rows to append whose dictionary holds a word the table's lacks."""
    from arrow_tpu_torch.storage import TableVersion

    def table(n, words):
        return att.Table.from_pydict({
            "k": np.arange(n, dtype=np.int64),
            "s": [f"s{i % 7}" for i in range(n)],
            "d": _dict_column([words[i % len(words)] for i in range(n)],
                              device)}, device=device)
    return TableVersion.of(table(40, ["a", "b"])), table(6, ["b", "c"])


def _dict_column(values, device):
    from arrow_tpu_torch.ops.strings import dictionary_encode
    return dictionary_encode(att.column(values, device=device))


def test_a_write_is_a_table_write_span():
    """An append that grows the table's buffers and maps a new word into
    its dictionary, then a delete: each a `table.write` span with its
    table, rows added and deleted and bytes; the counters add the
    versions, bytes and growths."""
    from arrow_tpu_torch.storage import Delta
    v, add = _written("cpu")
    before = trace.counters_snapshot()

    def write():
        v1 = v.apply(Delta(append=add), "t")
        gone = torch.zeros(46, dtype=torch.bool)
        gone[:5] = True
        return v1.apply(Delta(delete=gone, deleted=5), "t")
    v2, spans = _recorded(write)
    assert v2.num_rows == 41
    assert v2.visible().column("d").to_pylist()[-6:] == \
        ["b", "c", "b", "c", "b", "c"]
    by_id = {s.id: s for s in spans}
    ap, de = [s for s in spans if s.name == "table.write"]
    assert {k: ap.attrs[k] for k in ("table", "rows_added",
                                     "rows_deleted")} == \
        {"table": "t", "rows_added": 6, "rows_deleted": 0}
    assert {k: de.attrs[k] for k in ("table", "rows_added",
                                     "rows_deleted")} == \
        {"table": "t", "rows_added": 0, "rows_deleted": 5}
    assert ap.attrs["bytes"] > 40 * 8 and de.attrs["bytes"] >= 80
    # host tensors are read in place: no readback (on the card, the
    # write's reads are `readback` spans: the card test below)
    assert not [s for s in spans if s.name == "readback"]
    assert all(by_id[s.parent] in (ap, de) for s in spans
               if s.name != "table.write")
    after = trace.counters_snapshot()
    grown = {n: after.get(n, 0) - before.get(n, 0)
             for n in ("tables.versions", "tables.bytes_written",
                       "tables.regrows")}
    assert grown["tables.versions"] == 2
    assert grown["tables.bytes_written"] == ap.attrs["bytes"] + \
        de.attrs["bytes"]
    assert grown["tables.regrows"] >= 4


def test_publish_and_transaction_spans():
    """A transaction's two writes publish as one `table.publish` span
    naming both tables, with the time waited for their write locks; the
    transaction is a `flightsql.transaction` span from its begin to its
    end, with its statements and outcome."""
    from arrow_tpu_torch.io.flightsql import FlightSQLClient, FlightSQLServer
    server = FlightSQLServer("grpc://localhost:0", device="cpu")
    for name, t in _tables().items():
        server.register(name, t)
    client = FlightSQLClient(server.uri, device="cpu")

    def run():
        tid = client.begin_transaction()
        client.execute_update("INSERT INTO custs VALUES (5, 'eve')",
                              transaction_id=tid)
        client.execute_update("DELETE FROM orders WHERE cust = 3",
                              transaction_id=tid)
        client.commit(tid)
        tid = client.begin_transaction()
        client.execute_update("DELETE FROM orders WHERE cust = 1",
                              transaction_id=tid)
        client.rollback(tid)
    try:
        _, spans = _recorded(run)
    finally:
        client.close()
        server.shutdown()
    pub, = [s for s in spans if s.name == "table.publish"]
    assert pub.attrs["tables"] == "custs,orders"
    assert isinstance(pub.attrs["wait_ns"], int) and pub.attrs["wait_ns"] >= 0
    txns = [s for s in spans if s.name == "flightsql.transaction"]
    assert [s.attrs for s in txns] == [
        {"statements": 2, "outcome": "commit"},
        {"statements": 1, "outcome": "rollback"}]
    assert all(s.parent is None and s.end_ns > s.start_ns for s in txns)
    writes = [s.attrs["table"] for s in spans if s.name == "table.write"]
    assert writes == ["custs", "orders", "orders"]


def test_a_writes_device_reads_are_readback_spans(cuda_device):
    """On the card, under torch.profiler: every device-to-host copy an
    append (a growth and a new dictionary word) and a delete by an IN
    list make falls inside a program `readback` span."""
    from arrow_tpu_torch.sql import execute_sql_update
    from benchmark.tests.test_bench_spans import readback_coverage
    from benchmark.trace import Profile
    from arrow_tpu_torch.storage import Delta
    v, add = _written(cuda_device)
    v.apply(Delta(append=add), "t")            # warm
    torch.cuda.synchronize()
    with Profile() as prof:
        with torch.profiler.record_function("query write"):
            v1 = v.apply(Delta(append=add), "t")
            deltas, _ = execute_sql_update(
                {"t": v1}, "DELETE FROM t WHERE k IN (1, 2, 3, 40)")
            v1.apply(deltas["t"], "t")
            torch.cuda.synchronize()
    got = readback_coverage(prof.prof.profiler.kineto_results.events())
    assert got["calls"] > 0
    assert got["covered"] == got["calls"], got["outside"]
