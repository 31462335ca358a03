"""Parity of the port's FlightSQL layer (arrow_tpu_torch/io/flightsql.py)
with the reference's (arrow_tpu/io/flightsql.py): each test of
tests/test_flightsql.py runs the same calls through both packages, each
client against its own package's in-process server on localhost, over
the same seeded tables, and the answers compare (tables by buffers,
schema and nullability; errors by name).  Also: C7.2 (a cancelled
command refused for the life of the reference's server), the server's
device, and each package's client against the other's server."""

import threading

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.io import flightsql as rq
from arrow_tpu_torch.io import flightsql as pq
from torch_port_util import assert_tables_equal, port_table

CPU = torch.device("cpu")


class Side:
    """One package's FlightSQL server and client over the same tables."""

    def __init__(self, mod, port: bool, tables: dict, **kw):
        self.mod, self.port = mod, port
        self.kw = {"device": "cpu"} if port else {}
        self.server = mod.FlightSQLServer("grpc://127.0.0.1:0", **kw,
                                          **self.kw)
        for name, t in tables.items():
            self.server.register(name, self.table(t))
        self.client = self.connect()

    def table(self, ref):
        """A reference table as this side's."""
        return port_table(ref) if self.port else ref

    def connect(self):
        return self.mod.FlightSQLClient(self.server.uri, **self.kw)

    def close(self):
        self.client.close()
        self.server.shutdown()


class Pair:
    def __init__(self, tables: dict, **kw):
        self.ref = Side(rq, False, tables, **kw)
        self.port = Side(pq, True, tables, **kw)

    def both(self, fn):
        """fn(side) on the reference, then on the port: both raise
        errors of the same name, or return equal answers (tables by
        buffers, anything else by ==).  Returns the port's answer."""
        try:
            want = fn(self.ref)
        except Exception as e:               # the reference decides
            with pytest.raises(Exception) as got:
                fn(self.port)
            assert type(got.value).__name__ == type(e).__name__, \
                (got.value, e)
            return None
        got = fn(self.port)
        if isinstance(want, at.Table):
            assert_tables_equal(got, want)
            assert all(c.device == CPU for c in got.columns)
        else:
            assert got == want
        return got

    def close(self):
        self.ref.close()
        self.port.close()


def trades():
    return at.Table.from_pydict({
        "id": at.column(np.arange(10, dtype=np.int64)),
        "px": at.column(np.arange(10, dtype=np.float64) * 1.5),
    })


@pytest.fixture
def pair():
    p = Pair({"trades": trades()})
    yield p
    p.close()


def _small():
    return Pair({"t": at.Table.from_pydict({"id": np.arange(5),
                                             "v": np.arange(5) * 2.0})})


# ---- tests/test_flightsql.py, both packages --------------------------------

def test_execute_query(pair):
    t = pair.both(lambda s: s.client.execute(
        "SELECT id, px FROM trades WHERE id >= 7"))
    assert t.to_pydict() == {"id": [7, 8, 9], "px": [10.5, 12.0, 13.5]}


def test_execute_star_limit(pair):
    t = pair.both(lambda s: s.client.execute("select * from trades limit 3"))
    assert t.num_rows == 3 and t.column_names == ["id", "px"]


def test_prepared_statement_lifecycle(pair):
    handles = {}

    def prepare(s):
        handles[s.port] = s.client.prepare("SELECT id FROM trades WHERE id = 4")
        return len(handles[s.port])
    pair.both(prepare)
    t = pair.both(lambda s: s.client.execute_prepared(handles[s.port]))
    assert t.to_pydict() == {"id": [4]}
    pair.both(lambda s: s.client.close_prepared(handles[s.port]))
    assert pair.both(
        lambda s: s.client.execute_prepared(handles[s.port])) is None


def test_catalog_metadata(pair):
    c = pair.both(lambda s: s.client.get_catalogs())
    assert c.to_pydict()["catalog_name"] == ["default"]
    t = pair.both(lambda s: s.client.get_tables()).to_pydict()
    assert t["table_name"] == ["trades"] and t["table_type"] == ["TABLE"]


@pytest.mark.parametrize("query", ["DROP TABLE x", "SELECT * FROM missing"])
def test_simple_executor_errors(query):
    with pytest.raises(Exception) as want:
        rq.simple_sql_executor({}, query)
    with pytest.raises(Exception) as got:
        pq.simple_sql_executor({}, query)
    assert type(got.value).__name__ == type(want.value).__name__


@pytest.mark.parametrize("query", [
    "SELECT COUNT(*) FROM t", "SELECT SUM(v), MAX(v) FROM t",
    "SELECT k, SUM(v) FROM t GROUP BY k",
    "SELECT v FROM t ORDER BY v DESC LIMIT 2",
    "SELECT AVG(v) FROM t WHERE k = 1",
    "SELECT * FROM t JOIN u ON t.x = u.x", "DELETE FROM t"])
def test_sql_executor_aggregates_and_order(query):
    ref = at.Table.from_pydict({
        "k": [1, 2, 1, 2, 1],
        "v": np.array([10, 20, 30, 40, 50], np.int64),
    })
    try:
        want = rq.simple_sql_executor({"t": ref}, query)
    except Exception as e:
        with pytest.raises(Exception) as got:
            pq.simple_sql_executor({"t": port_table(ref)}, query)
        assert type(got.value).__name__ == type(e).__name__ == "ArrowInvalid"
        return
    got = pq.simple_sql_executor({"t": port_table(ref)}, query)
    assert_tables_equal(got, want)


def test_get_sql_info_all_and_filtered():
    pair = _small()
    try:
        others = [i for i in pq.default_sql_info()._entries
                  if i != pq.SQL_INFO_SERVER_NAME]
        info = pair.both(lambda s: s.client.get_sql_info(others))
        assert info.schema.fields[0].name == "info_name"
        assert info.schema.fields[1].dtype.name == "union"
        by_id = dict(zip(info.columns[0].to_pylist(),
                         info.columns[1].to_pylist()))
        assert by_id[pq.SQL_INFO_SERVER_READ_ONLY] is True
        assert by_id[pq.SQL_INFO_SERVER_TRANSACTION] == 1
        assert "SELECT" in by_id[pq.SQL_INFO_KEYWORDS]
        assert dict(by_id[pq.SQL_INFO_SUPPORTS_CONVERT])[7] == [7, 10]
        # every id, and one alone: the server names its package
        full = {s.port: s.client.get_sql_info() for s in (pair.ref,
                                                         pair.port)}
        names = {k: dict(zip(t.columns[0].to_pylist(),
                             t.columns[1].to_pylist()))[
                                 pq.SQL_INFO_SERVER_NAME]
                 for k, t in full.items()}
        assert names == {False: "arrow_tpu", True: "arrow_tpu_torch"}
        assert full[True].columns[0].to_pylist() == \
            full[False].columns[0].to_pylist()
        one = pair.both(lambda s: s.client.get_sql_info(
            [pq.SQL_INFO_SERVER_VERSION]))
        assert one.columns[0].to_pylist() == [pq.SQL_INFO_SERVER_VERSION]
    finally:
        pair.close()


def test_primary_and_foreign_keys():
    pair = _small()
    try:
        for s in (pair.ref, pair.port):
            s.server.register_primary_key("t", ["id"], key_name="pk_t")
            s.server.register_foreign_key("t", "orders", [("id", "t_id")])
        pk = pair.both(lambda s: s.client.get_primary_keys("t"))
        row = {f.name: c.to_pylist()[0]
               for f, c in zip(pk.schema.fields, pk.columns)}
        assert row["table_name"] == "t" and row["key_sequence"] == 1
        exp = pair.both(lambda s: s.client.get_exported_keys("t"))
        assert exp.num_rows == 1
        assert pair.both(
            lambda s: s.client.get_imported_keys("orders")).num_rows == 1
        assert pair.both(lambda s: s.client.get_cross_reference(
            "t", "orders")).num_rows == 1
        empty = pair.both(lambda s: s.client.get_exported_keys("nope"))
        assert empty.num_rows == 0 and len(empty.schema.fields) == 13
    finally:
        pair.close()


@pytest.mark.parametrize("code", [None, -5, 12, 93, 0])
def test_xdbc_type_info_and_table_types(code):
    pair = _small()
    try:
        ti = pair.both(lambda s: s.client.get_xdbc_type_info(code))
        assert len(ti.schema.fields) == 19
        assert ti.num_rows == (7 if code is None else 0 if code == 0
                               else 1)
        tt = pair.both(lambda s: s.client.get_table_types())
        assert tt.columns[0].to_pylist() == ["TABLE"]
    finally:
        pair.close()


def test_transactions_begin_commit_rollback():
    pair = _small()
    tids = {}
    try:
        def begin(s):
            tids[s.port] = s.client.begin_transaction()
            return len(tids[s.port])
        assert pair.both(begin) == 16
        pair.both(lambda s: s.client.commit(tids[s.port]))
        assert pair.both(lambda s: s.client.commit(tids[s.port])) is None
        pair.both(begin)
        pair.both(lambda s: s.client.rollback(tids[s.port]))
        assert pair.both(lambda s: s.client.rollback(tids[s.port])) is None
    finally:
        pair.close()


def test_execute_update_insert_update_delete(pair):
    for q, n in (("INSERT INTO trades VALUES (10, 99.5), (11, 1.25)", 2),
                 ("UPDATE trades SET px = px * 2 WHERE id = 10", 1),
                 ("DELETE FROM trades WHERE id >= 10", 2)):
        assert pair.both(lambda s: s.client.execute_update(q)) == n
        pair.both(lambda s: s.client.execute("SELECT * FROM trades"))
    t = pair.both(lambda s: s.client.execute(
        "SELECT COUNT(*) AS n FROM trades"))
    assert t.to_pydict()["n"] == [10]


def test_execute_update_ddl_and_transaction(pair):
    assert pair.both(lambda s: s.client.execute_update(
        "CREATE TABLE scratch (k INT, v VARCHAR)")) == 0
    assert all(c.device == CPU
               for c in pair.port.server.get_table("scratch").columns)
    pair.both(lambda s: s.client.get_tables())
    tids = {}

    def insert(s):
        tids[s.port] = s.client.begin_transaction()
        return s.client.execute_update("INSERT INTO scratch VALUES (1, 'a')",
                                       transaction_id=tids[s.port])
    assert pair.both(insert) == 1
    pair.both(lambda s: s.client.commit(tids[s.port]))
    assert pair.both(lambda s: s.client.execute_update(
        "DELETE FROM scratch", transaction_id=b"bogus-txn-id....")) is None
    pair.both(lambda s: s.client.execute("SELECT * FROM scratch"))
    assert pair.both(lambda s: s.client.execute_update(
        "DROP TABLE scratch")) == 0
    t = pair.both(lambda s: s.client.get_tables())
    assert "scratch" not in t.to_pydict()["table_name"]


def test_prepared_statement_update_with_params(pair):
    params = at.Table.from_pydict({"p0": [20, 21, 22], "p1": [1.0, 2.0, 3.0]})

    def insert(s):
        h = s.client.prepare("INSERT INTO trades VALUES (?, ?)")
        return s.client.execute_prepared_update(h, s.table(params))
    assert pair.both(insert) == 3
    got = pair.both(lambda s: s.client.execute(
        "SELECT id, px FROM trades WHERE id >= 20"))
    assert got.to_pydict() == {"id": [20, 21, 22], "px": [1.0, 2.0, 3.0]}
    assert pair.both(lambda s: s.client.execute_prepared_update(
        s.client.prepare("DELETE FROM trades WHERE id >= 20"))) == 3


def test_bind_prepared_query_params(pair):
    def run(s):
        h = s.client.prepare("SELECT px FROM trades WHERE id = ?")
        h = s.client.bind_prepared(h, s.table(at.Table.from_pydict(
            {"p0": [4]})))
        return s.client.execute_prepared(h)
    assert pair.both(run).to_pydict() == {"px": [6.0]}


def test_statement_ingest(pair):
    data = at.Table.from_pydict({
        "k": at.column(np.arange(1000, dtype=np.int64)),
        "s": at.column(["v%d" % (i % 7) for i in range(1000)])})
    count = "SELECT COUNT(*) AS n FROM bulk"
    assert pair.both(lambda s: s.client.execute_ingest(
        "bulk", s.table(data))) == 1000
    assert pair.both(lambda s: s.client.execute(count)) \
        .to_pydict()["n"] == [1000]
    assert pair.both(lambda s: s.client.execute_ingest(
        "bulk", s.table(data), if_exists=pq.TABLE_EXISTS_FAIL)) is None
    assert pair.both(lambda s: s.client.execute_ingest(
        "bulk", [s.table(data.slice(0, 500)), s.table(data.slice(500, 500))],
        if_exists=pq.TABLE_EXISTS_APPEND)) == 1000
    pair.both(lambda s: s.client.execute("SELECT * FROM bulk"))
    assert pair.both(lambda s: s.client.execute_ingest(
        "bulk", s.table(data.slice(0, 10)),
        if_exists=pq.TABLE_EXISTS_REPLACE)) == 10
    assert pair.both(lambda s: s.client.execute(count)) \
        .to_pydict()["n"] == [10]
    bad = at.Table.from_pydict({"k": [1.5], "s": ["x"]})
    assert pair.both(lambda s: s.client.execute_ingest(
        "bulk", s.table(bad), if_exists=pq.TABLE_EXISTS_APPEND)) is None
    assert pair.both(lambda s: s.client.execute_ingest(
        "nope", s.table(data), if_not_exist=pq.TABLE_NOT_EXIST_FAIL)) is None
    assert all(c.device == CPU
               for c in pair.port.server.get_table("bulk").columns)


def test_cancel_query(pair):
    infos = {}

    def cancel(s):
        infos[s.port] = s.client.get_query_info("SELECT id FROM trades")
        return s.client.cancel_query(infos[s.port])
    assert pair.both(cancel) == 1           # CANCEL_RESULT_CANCELLED
    assert pair.both(lambda s: s.client._client.do_get_ticket(
        infos[s.port].endpoints[0][0])) is None


def test_substrait_plan_command(pair):
    assert pair.both(lambda s: s.client.execute_substrait(
        b"\x01\x02plan")) is None

    def toy(sql):
        def run(tables, plan, version):
            assert version == "0.52.0"
            return sql.execute_sql(tables, plan.decode())
        return run

    import arrow_tpu.sql as rsql
    import arrow_tpu_torch.sql as psql
    ref = Side(rq, False, {"t": at.Table.from_pydict({"a": [1, 2, 3]})},
               substrait_executor=toy(rsql))
    port = Side(pq, True, {"t": at.Table.from_pydict({"a": [1, 2, 3]})},
                substrait_executor=toy(psql))
    try:
        plan = b"SELECT a FROM t WHERE a > 1"
        want = ref.client.execute_substrait(plan, version="0.52.0")
        got = port.client.execute_substrait(plan, version="0.52.0")
        assert_tables_equal(got, want)
        assert got.to_pydict() == {"a": [2, 3]}
    finally:
        ref.close()
        port.close()


def test_get_tables_filters_and_schema(pair):
    orders = at.Table.from_pydict({"o": [1]})
    pair.ref.server.register("orders", orders)
    pair.port.server.register("orders", port_table(orders))
    for kw in ({"table_name_filter_pattern": "tra%"},
               {"table_name_filter_pattern": "_rders"},
               {"table_types": ["VIEW"]}):
        pair.both(lambda s: s.client.get_tables(**kw))
    got = pair.both(lambda s: s.client.get_tables(include_schema=True))
    d = got.to_pydict()
    from arrow_tpu_torch.io.flight import schema_ipc_bytes
    i = d["table_name"].index("trades")
    assert d["table_schema"][i] == schema_ipc_bytes(
        pair.port.server._tables["trades"].schema)
    for pat, n in (("pub%", 1), ("nope%", 0)):
        t = pair.both(lambda s: s.client.get_db_schemas(
            db_schema_filter_pattern=pat))
        assert t.num_rows == n


def test_concurrent_updates_serialize(pair):
    """DML read-modify-write cycles serialize: concurrent INSERTs
    through separate clients all land (no lost updates), on both; the
    interpreter switches threads every microsecond meanwhile."""
    import sys
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for side in (pair.ref, pair.port):
            errs = []

            def one(i, side=side):
                try:
                    c = side.connect()
                    assert c.execute_update(
                        f"INSERT INTO trades VALUES ({100 + i}, 1.0)") == 1
                    c.close()
                except Exception as e:         # noqa: BLE001
                    errs.append(e)

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            assert not errs
    finally:
        sys.setswitchinterval(interval)
    got = pair.both(lambda s: s.client.execute(
        "SELECT COUNT(*) AS n FROM trades WHERE id >= 100"))
    assert got.to_pydict()["n"] == [8]
    pair.both(lambda s: s.client.execute(
        "SELECT id FROM trades WHERE id >= 100 ORDER BY id"))


# ---- C7.2, the server's device, and the two packages across ----------------

def test_reference_refuses_a_cancelled_command_for_good(pair):
    """C7.2: the reference keeps a cancelled ticket for the life of the
    server, so the same query text never runs again; the port refuses
    the cancelled ticket, and a new GetFlightInfo issues the command as
    a new query, as arrow-rs does."""
    q = "SELECT id FROM trades WHERE id < 3"
    for s in (pair.ref, pair.port):
        assert s.client.cancel_query(s.client.get_query_info(q)) == 1
    with pytest.raises(Exception, match="cancelled"):
        pair.ref.client.execute(q)
    got = pair.port.client.execute(q)
    assert got.to_pydict() == {"id": [0, 1, 2]}
    assert pair.port.server._cancelled == set()
    # the cancelled ticket itself stays refused until it is issued anew
    info = pair.port.client.get_query_info(q)
    pair.port.client.cancel_query(info)
    with pytest.raises(Exception, match="cancelled"):
        pair.port.client._client.do_get_ticket(info.endpoints[0][0])


def test_server_and_client_name_their_device():
    with pytest.raises(TypeError):
        pq.FlightSQLServer("grpc://127.0.0.1:0")
    with pytest.raises(TypeError):
        pq.FlightSQLClient("grpc://127.0.0.1:1")
    with pytest.raises(TypeError):
        pq.SqlInfoData().table()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pq.FlightSQLServer("grpc://127.0.0.1:0", device="cuda")


def test_reference_and_port_clients_across(pair):
    q = "SELECT id, px FROM trades WHERE id > 3 ORDER BY px DESC"
    want = pair.ref.client.execute(q)
    ref_on_port = rq.FlightSQLClient(pair.port.server.uri)
    port_on_ref = pq.FlightSQLClient(pair.ref.server.uri, device="cpu")
    try:
        assert_tables_equal(port_table(ref_on_port.execute(q)), want)
        assert_tables_equal(port_on_ref.execute(q), want)
        assert ref_on_port.execute_update(
            "INSERT INTO trades VALUES (50, 0.5)") == 1
        assert port_on_ref.execute_update(
            "INSERT INTO trades VALUES (50, 0.5)") == 1
        pair.both(lambda s: s.client.execute("SELECT * FROM trades"))
    finally:
        ref_on_port.close()
        port_on_ref.close()
