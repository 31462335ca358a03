"""Table versions and the write path that makes them
(arrow_tpu_torch/storage.py, sql.execute_sql_update's deltas, the Flight
SQL server's versions, transactions and write locks), on the CPU.

- INSERT ... VALUES, INSERT ... SELECT, DELETE ... WHERE and DELETE ...
  IN (...), applied as deltas to versions one after another, read as the
  reference's execute_sql_update leaves its tables, over utf8,
  large_utf8, dictionary text and nulls; ingest APPEND through both
  packages' servers the same.
- An append into spare room copies no row; a reader of a version keeps
  reading it after later appends, deletes and a growth.
- A transaction over two tables publishes both as one commit; ROLLBACK
  publishes nothing; each result carries its snapshot's commit.
- Q1, Q3, Q4, Q6, Q10 and Q4's first statement over tables with deleted
  rows equal the reference over the same rows.
- A long IN list is one membership test and equals the reference's
  per-item Kleene rule, NULL in the list and NULL keys included.
- A CREATE TABLE ... AS does not wait for a write lock held on another
  table; a write to the held table does.  Two transactions that take
  two tables' locks in opposite orders do not deadlock (wait-die), and
  a transaction its client left is rolled back once idle.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import sql as rsql
from arrow_tpu.io import flightsql as rq
from arrow_tpu.io.interop import table_from_pyarrow
from arrow_tpu_torch import sql as psql
from arrow_tpu_torch.io import flightsql as pq
from arrow_tpu_torch.io.interop import table_to_pyarrow
from arrow_tpu_torch.ops import boolean as b_ops
from arrow_tpu_torch.storage import Delta, TableVersion
from arrow_tpu_torch.utils import trace
from test_torch_tpch_sql import _close, _rows
from test_torch_tpch_strings import _chip_smoke
from torch_port_util import (assert_tables_equal, cuda_device,  # noqa: F401
                             port_table)

CPU = torch.device("cpu")
WAIT_S = 20                     # no step here takes near this long
WORDS = ["alpha", "beta", "", "gamma ray", None]


def _ref(n: int, seed: int) -> at.Table:
    """k int64 with nulls, s utf8, l large_utf8, d dictionary<int32,
    utf8>, each with nulls."""
    rng = np.random.default_rng(seed)
    k = [None if rng.random() < 0.1 else int(x)
         for x in rng.integers(0, 60, n)]
    pick = [WORDS[i] for i in rng.integers(0, len(WORDS), 3 * n)]
    s, l, d = pick[:n], pick[n:2 * n], pick[2 * n:]
    return at.Table.from_pyarrow(pa.table({
        "k": pa.array(k, pa.int64()), "s": pa.array(s, pa.utf8()),
        "l": pa.array(l, pa.large_utf8()),
        "d": pa.array(d, pa.utf8()).dictionary_encode()}))


CHAIN = [
    "INSERT INTO t VALUES (100, 'x', 'long x', 'beta'), (NULL, NULL, NULL, "
    "NULL)",
    "DELETE FROM t WHERE k < 10",
    "INSERT INTO t SELECT k + 1000, s, l, d FROM t WHERE k >= 40",
    "DELETE FROM t WHERE k IN (41, 42, 1040, 1041, 7)",
    "INSERT INTO t (k, d) VALUES (7, 'delta')",
    "DELETE FROM t WHERE s = 'alpha' OR l IS NULL",
    "DELETE FROM t WHERE k IN (11, 12, NULL, 1043)",
    "INSERT INTO t (k, s) SELECT k, d FROM t WHERE k > 1045",
]


@pytest.mark.parametrize("steps", range(1, len(CHAIN) + 1))
def test_delta_chain_reads_as_the_reference(steps):
    """The chain's first `steps` statements as deltas on versions read as
    the reference's execute_sql_update leaves its table after each."""
    ref = {"t": _ref(300, steps)}
    port = {"t": TableVersion.of(port_table(ref["t"]))}
    for stmt in CHAIN[:steps]:
        deltas, n = psql.execute_sql_update(port, stmt)
        want, wn = rsql.execute_sql_update(ref, stmt)
        assert n == wn, stmt
        assert list(deltas) == ["t"] and isinstance(deltas["t"], Delta)
        assert (deltas["t"].append is None) == stmt.startswith("DELETE")
        port["t"] = port["t"].apply(deltas["t"], "t")
        ref.update(want)
        assert_tables_equal(port["t"].visible(), port_table(ref["t"]))
        assert_tables_equal(psql.execute_sql(port, "SELECT * FROM t"),
                            port_table(ref["t"]))


def test_append_into_spare_room_copies_no_row():
    """After the first append (a growth, every buffer at least doubled) a
    small append writes into the tails: the same buffers, no growth."""
    base = port_table(_ref(200, 1))
    v1 = TableVersion.of(base).apply(Delta(append=base.slice(0, 10)), "t")
    before = trace.counters_snapshot().get("tables.regrows", 0)
    v2 = v1.apply(Delta(append=base.slice(10, 20)), "t")
    assert trace.counters_snapshot().get("tables.regrows", 0) == before
    for a, b in zip(v1._states, v2._states):
        assert a.capacity >= 2 * 200
        pa_, pb = (a.codes, b.codes) if hasattr(a, "codes") else (a, b)
        buf = "values" if hasattr(pa_, "values") else "data"
        assert getattr(pa_, buf).data_ptr() == getattr(pb, buf).data_ptr()
    assert v2.num_rows == 230


def test_a_reader_keeps_its_version():
    """Versions v0..v4 (append with a growth, append into spare room,
    delete, append): each reads, after every later write, as it read
    when it was made."""
    base = port_table(_ref(120, 2))
    add = port_table(_ref(40, 3))
    v = [TableVersion.of(base)]
    seen = [v[0].visible().to_pydict()]
    keep = torch.ones(120, dtype=torch.bool)
    keep[::3] = False
    for d in (Delta(append=add), Delta(append=add.slice(0, 7)),
              Delta(delete=~torch.cat([keep, torch.ones(47, dtype=bool)]),
                    deleted=40),
              Delta(append=add.slice(5, 9))):
        v.append(v[-1].apply(d, "t"))
        seen.append(v[-1].visible().to_pydict())
    for ver, want in zip(v, seen):
        assert ver.visible().to_pydict() == want
    assert [x.num_rows for x in v] == [120, 160, 167, 127, 136]
    assert v[3].deleted == 40 and v[0].live is None


# ---- the servers ------------------------------------------------------------

class _Pair:
    """Both packages' Flight SQL servers over the same tables, a client
    of each."""

    def __init__(self, tables: dict):
        self.ref_server = rq.FlightSQLServer("grpc://127.0.0.1:0")
        self.port_server = pq.FlightSQLServer("grpc://127.0.0.1:0",
                                              device="cpu")
        for name, t in tables.items():
            self.ref_server.register(name, t)
            self.port_server.register(name, port_table(t))
        self.ref = rq.FlightSQLClient(self.ref_server.uri)
        self.port = pq.FlightSQLClient(self.port_server.uri, device="cpu")

    def same(self, query: str):
        got = self.port.execute(query)
        assert_tables_equal(got, port_table(self.ref.execute(query)))
        return got

    def close(self):
        for c in (self.ref, self.port):
            c.close()
        for s in (self.ref_server, self.port_server):
            s.shutdown()


def test_ingest_append_reads_as_the_reference():
    pair = _Pair({"t": _ref(150, 4)})
    try:
        for i, stmt in enumerate((None, "DELETE FROM t WHERE k < 30", None,
                                  "DELETE FROM t WHERE k IN (31, 33, 35)")):
            if stmt is None:
                data = _ref(50, 10 + i)
                assert pair.ref.execute_ingest(
                    "t", data, if_exists=rq.TABLE_EXISTS_APPEND) == \
                    pair.port.execute_ingest(
                        "t", port_table(data),
                        if_exists=pq.TABLE_EXISTS_APPEND) == 50
            else:
                assert pair.ref.execute_update(stmt) == \
                    pair.port.execute_update(stmt)
            pair.same("SELECT * FROM t")
        assert pair.port_server.get_table("t").num_rows == \
            pair.ref_server.get_table("t").num_rows
    finally:
        pair.close()


def _snapshot(table) -> int:
    return int(dict(table.schema.metadata)[pq.SNAPSHOT_KEY])


def test_a_transaction_publishes_both_tables_at_once():
    """Writes to `a` and `b` under one transaction: invisible to another
    client until COMMIT, then both in one commit; ROLLBACK publishes
    nothing.  Results carry the commit number of their snapshot."""
    ref = {"a": _ref(40, 5), "b": _ref(30, 6)}
    server = pq.FlightSQLServer("grpc://127.0.0.1:0", device="cpu")
    for name, t in ref.items():
        server.register(name, port_table(t))
    c1, c2 = (pq.FlightSQLClient(server.uri, device="cpu") for _ in "12")
    count = "SELECT COUNT(*) AS n FROM {}"

    def counts():
        return [c2.execute(count.format(n)).to_pydict()["n"][0]
                for n in "ab"]
    try:
        before = counts()
        commit0 = _snapshot(c2.execute(count.format("a")))
        tid = c1.begin_transaction()
        assert c1.execute_ingest("a", port_table(_ref(5, 7)),
                                 if_exists=pq.TABLE_EXISTS_APPEND,
                                 transaction_id=tid) == 5
        n = c1.execute_update("DELETE FROM b WHERE k >= 0",
                              transaction_id=tid)
        assert counts() == before
        assert len(server.history) == 0
        c1.commit(tid)
        assert counts() == [before[0] + 5, before[1] - n]
        assert list(server.history) == [(commit0 + 1, ("a", "b"))]
        assert _snapshot(c2.execute(count.format("b"))) == commit0 + 1
        tid = c1.begin_transaction()
        c1.execute_update("INSERT INTO a (k) VALUES (1)", transaction_id=tid)
        c1.rollback(tid)
        assert counts() == [before[0] + 5, before[1] - n]
        assert len(server.history) == 1
    finally:
        for c in (c1, c2):
            c.close()
        server.shutdown()


def test_ctas_does_not_wait_for_another_tables_write_lock():
    """A transaction holds `t`'s write lock: a CREATE TABLE ... AS over
    `t` finishes at once (reading `t` as committed), an INSERT INTO t
    waits until the transaction ends."""
    server = pq.FlightSQLServer("grpc://127.0.0.1:0", device="cpu")
    server.register("t", port_table(_ref(50, 8)))
    clients = [pq.FlightSQLClient(server.uri, device="cpu")
               for _ in range(3)]
    out = {}

    def run(key, fn):
        t = threading.Thread(target=lambda: out.__setitem__(key, fn()),
                             daemon=True)
        t.start()
        return t
    try:
        tid = clients[0].begin_transaction()
        clients[0].execute_update("INSERT INTO t (k) VALUES (1)",
                                  transaction_id=tid)
        ctas = run("ctas", lambda: clients[1].execute_update(
            "CREATE TABLE c AS SELECT k FROM t"))
        ctas.join(WAIT_S)
        assert not ctas.is_alive(), "the CTAS waited for t's write lock"
        assert out["ctas"] == 50
        insert = run("insert", lambda: clients[2].execute_update(
            "INSERT INTO t (k) VALUES (2)"))
        time.sleep(0.3)
        assert insert.is_alive()
        clients[0].commit(tid)
        insert.join(WAIT_S)
        assert not insert.is_alive() and out["insert"] == 1
        assert server.get_table("t").num_rows == 52
    finally:
        for c in clients:
            c.close()
        server.shutdown()


def test_concurrent_rf1_and_rf2_do_not_deadlock():
    """RF1 writes orders then lineitem, RF2 lineitem then orders, in two
    transactions at once: the younger fails at once where it would wait
    for the older (wait-die), its rollback frees the older, which
    commits both tables in one commit."""
    server = pq.FlightSQLServer("grpc://127.0.0.1:0", device="cpu")
    for name in ("orders", "lineitem"):
        server.register(name, port_table(_ref(40, 9)))
    rf1, rf2 = (pq.FlightSQLClient(server.uri, device="cpu") for _ in "12")
    out = {}
    try:
        t1 = rf1.begin_transaction()
        t2 = rf2.begin_transaction()
        rf1.execute_ingest("orders", port_table(_ref(5, 10)),
                           if_exists=pq.TABLE_EXISTS_APPEND,
                           transaction_id=t1)
        n2 = rf2.execute_update("DELETE FROM lineitem WHERE k < 30",
                                transaction_id=t2)
        older = threading.Thread(target=lambda: out.__setitem__(
            "rf1", rf1.execute_ingest("lineitem", port_table(_ref(7, 11)),
                                      if_exists=pq.TABLE_EXISTS_APPEND,
                                      transaction_id=t1)), daemon=True)
        older.start()
        time.sleep(0.3)
        assert older.is_alive(), "RF1 did not wait for RF2's lineitem"
        t0 = time.monotonic()
        with pytest.raises(Exception, match="older transaction"):
            rf2.execute_update("DELETE FROM orders WHERE k < 30",
                               transaction_id=t2)
        assert time.monotonic() - t0 < WAIT_S
        rf2.rollback(t2)
        older.join(WAIT_S)
        assert not older.is_alive() and out["rf1"] == 7
        rf1.commit(t1)
        assert list(server.history) == [(1, ("lineitem", "orders"))]
        assert server.get_table("orders").num_rows == 45
        assert server.get_table("lineitem").num_rows == 47 and n2 > 0
    finally:
        for c in (rf1, rf2):
            c.close()
        server.shutdown()


def test_an_idle_transaction_is_rolled_back(monkeypatch):
    """A client that begins a transaction, writes and leaves without
    ending it frees its write lock once the transaction has been idle
    for TXN_IDLE_S: a later writer of the table waits that long, not
    for good, and the left transaction publishes nothing."""
    monkeypatch.setattr(pq, "TXN_IDLE_S", 0.3)
    server = pq.FlightSQLServer("grpc://127.0.0.1:0", device="cpu")
    server.register("t", port_table(_ref(50, 12)))
    left, later = (pq.FlightSQLClient(server.uri, device="cpu")
                   for _ in "12")
    try:
        tid = left.begin_transaction()
        left.execute_update("INSERT INTO t (k) VALUES (1)",
                            transaction_id=tid)
        left.close()
        t0 = time.monotonic()
        assert later.execute_update("INSERT INTO t (k) VALUES (2)") == 1
        assert 0.3 <= time.monotonic() - t0 < WAIT_S
        assert server.get_table("t").num_rows == 51
        assert list(server.history) == [(1, ("t",))]
        with pytest.raises(Exception, match="unknown transaction"):
            later.commit(tid)
    finally:
        later.close()
        server.shutdown()


# ---- queries over versions with deleted rows -----------------------------------

@pytest.fixture(scope="module")
def chip():
    return _chip_smoke()


@pytest.fixture(scope="module")
def deleted(chip):
    """TPC-H tables at 6,000 lineitem rows as versions with a fifth of the
    orders and their lines deleted, and the same rows as the reference's
    tables."""
    tabs, _ = chip.tpch_tables(6_000, 600, CPU, text=False,
                               pool_bytes=1 << 16, seed=25)
    vers = {n: TableVersion.of(t) for n, t in tabs.items()}
    keys = tabs["orders"].column("o_orderkey").to_pylist()[::5]
    in_list = ", ".join(map(str, keys))
    for name, col in (("lineitem", "l_orderkey"), ("orders", "o_orderkey")):
        vers[name] = vers[name].apply(psql.execute_sql_update(
            vers, f"DELETE FROM {name} WHERE {col} IN ({in_list})")[0][name],
            name)
    assert vers["orders"].deleted == len(keys)
    ref = {n: table_from_pyarrow(table_to_pyarrow(v.visible()))
           for n, v in vers.items()}
    return vers, ref


def _q4_step():
    lo, hi = 8_582, 8_674          # 1993-07-01, 1993-10-01
    return ("SELECT DISTINCT o_orderkey, o_orderpriority FROM orders JOIN "
            f"lineitem ON o_orderkey = l_orderkey WHERE o_orderdate >= {lo} "
            f"AND o_orderdate < {hi} AND l_commitdate < l_receiptdate")


@pytest.mark.parametrize("name", ["Q1", "Q3", "Q4", "Q6", "Q10", "Q4 step"])
def test_query_over_deleted_rows_matches_reference(chip, deleted, name):
    vers, ref = deleted
    query = _q4_step() if name == "Q4 step" else chip.P32_QUERIES[name]
    with trace.recording():
        got = psql.execute_sql(vers, query)
    (st,) = [s for s in trace.spans() if s.name == "sql.execute"]
    trace.reset_spans()
    assert st.attrs["rows_masked"] > 0
    _close(_rows(got), _rows(rsql.execute_sql(ref, query)), name)


# ---- IN lists ----------------------------------------------------------------

@pytest.mark.parametrize("items, nulls", [(3, False), (3000, False),
                                         (3000, True), (2, True)])
def test_long_in_list_is_one_membership_test(monkeypatch, items, nulls):
    """k IN (...) and k NOT IN (...) over an int64 and an int32 column with
    NULL keys: the port's membership test (no per-item OR) equals the
    reference's per-item Kleene rule; a list that holds NULL is compared
    item by item, with the same answer."""
    rng = np.random.default_rng(items)
    n = 5_000
    k = [None if rng.random() < 0.1 else int(x)
         for x in rng.integers(-4_000, 4_000, n)]
    ref = at.Table.from_pyarrow(pa.table({
        "k": pa.array(k, pa.int64()), "j": pa.array(k, pa.int32())}))
    vals = [str(int(x)) for x in rng.integers(-5_000, 5_000, items)]
    if nulls:
        vals.insert(len(vals) // 2, "NULL")
    lst = ", ".join(vals)
    query = (f"SELECT k IN ({lst}) AS a, k NOT IN ({lst}) AS b, "
             f"j IN ({lst}) AS c FROM t")
    ors = []
    real = b_ops.or_kleene
    monkeypatch.setattr(b_ops, "or_kleene",
                        lambda *a: ors.append(1) or real(*a))
    got = psql.execute_sql({"t": port_table(ref)}, query)
    assert bool(ors) == nulls
    assert_tables_equal(got, port_table(rsql.execute_sql({"t": ref}, query)))


def test_in_list_over_unsigned_keys_past_the_signed_range():
    """uint32 keys stored past int32's range: the membership test sorts
    the items as the column stores them, and equals the reference."""
    big = [1, 3_000_000_000, None, 5, 4_294_967_295, 2_147_483_648]
    ref = at.Table.from_pyarrow(pa.table({"u": pa.array(big, pa.uint32())}))
    query = ("SELECT u IN (3000000000, 1, 7, 4294967295) AS a, u IN (5) AS "
             "b FROM t")
    assert_tables_equal(psql.execute_sql({"t": port_table(ref)}, query),
                        port_table(rsql.execute_sql({"t": ref}, query)))


def test_in_list_outside_the_column_range_compares_item_by_item():
    """An item past an int32 column's range leaves the list to the
    per-item comparisons, which refuse it as the reference does."""
    ref = at.Table.from_pyarrow(pa.table({"j": pa.array([1, None, 3],
                                                        pa.int32())}))
    query = "SELECT j IN (1, 5000000000) AS a FROM t"
    with pytest.raises(OverflowError):
        rsql.execute_sql({"t": ref}, query)
    with pytest.raises(OverflowError):
        psql.execute_sql({"t": port_table(ref)}, query)


def test_host_rows_append_to_a_card_table(cuda_device):
    """Rows on the host (as a Flight SQL ingest decodes them) appended to
    a version on the card, twice (a growth, then spare room), then a
    delete: the same rows as the same writes on the host, every buffer
    on the card."""
    from arrow_tpu_torch.io.hostio import to_device
    base, add = port_table(_ref(200, 1)), port_table(_ref(50, 2))
    gone = torch.zeros(200 + 50 + 20, dtype=torch.bool)   # the rows written
    gone[::7] = True
    writes = (Delta(append=add), Delta(append=add.slice(3, 20)),
              Delta(delete=gone, deleted=int(gone.sum())))
    host, card = TableVersion.of(base), TableVersion.of(
        to_device(base, cuda_device))
    for d in writes:
        host = host.apply(d, "t")
        if d.delete is not None:
            d = Delta(delete=d.delete.to(cuda_device), deleted=d.deleted)
        card = card.apply(d, "t")
    got = card.visible()
    assert all(c.device.type == "cuda" for c in got.columns)
    assert got.to_pydict() == host.visible().to_pydict()
