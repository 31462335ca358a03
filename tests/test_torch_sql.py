"""Parity of the port's SQL frontend (arrow_tpu_torch/sql.py) with the JAX
package's (arrow_tpu/sql.py), mirroring tests/test_sql.py: every query
and statement runs through both packages over the same tables, and the
results are equal (names, types, nullability and values, bit for bit).
Also: the literal columns' types on empty and non-empty tables, the
decimal literal of ROADMAP C24, the chunked group-by of C3 and the
parameter rendering of C7.4, each with the reference's answer beside the
port's."""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu import sql as rsql
from arrow_tpu_torch import sql as psql
from torch_port_util import (applied, assert_tables_equal,  # noqa: F401
                             cuda_device,  # noqa: F401
                             port_table, route)  # noqa: F401

CPU = "cpu"


def _db():
    orders = at.Table.from_pydict({
        "id": np.arange(10, dtype=np.int64),
        "cust": np.array([1, 2, 1, 3, 2, 1, 3, 3, 2, 1], np.int64),
        "amount": np.array([10.0, 20.5, 5.0, 7.25, 100.0, 1.0, 8.0, 9.5,
                            30.0, 2.5]),
        "tag": ["aa", "ab", "ba", "bb", "aa", "ab", "ba", "bb", "aa", "cc"],
    })
    custs = at.Table.from_pydict({
        "cid": np.array([1, 2, 3, 4], np.int64),
        "name": ["ann", "bob", "cat", "dan"],
    })
    t1 = at.Table.from_pydict({"k": np.array([1, 2], np.int64),
                               "v": np.array([10, 20], np.int64)})
    t2 = at.Table.from_pydict({"k": np.array([1, 2], np.int64),
                               "v": np.array([100, 200], np.int64)})
    q1 = at.Table.from_pydict({"a": [1, 2, 3], "b": [10, 20, 30]})
    q2 = at.Table.from_pydict({"a": [10, 20, 99], "b": [7, 8, 9]})
    t3 = at.Table.from_pydict({"k": [1, 1, 2], "x": [100, 100, 100]})
    t4 = at.Table.from_pydict({"k": [1, 2], "x": [5, 7]})
    kv = at.Table.from_pydict({"k": ["a", "a", "b"], "v": [1, 2, 3]})
    nul = at.Table.from_pydict({"x": [None, None], "y": [1, 2]})
    empty = at.Table.from_pydict({
        "a": at.column(np.array([], np.int64)),
        "v": at.column(np.array([], np.float64))})
    return {"orders": orders, "custs": custs, "t1": t1, "t2": t2,
            "q1": q1, "q2": q2, "t3": t3, "t4": t4, "kv": kv, "nul": nul,
            "e": empty}


@pytest.fixture(scope="module")
def dbs():
    ref = _db()
    return ref, {k: port_table(v) for k, v in ref.items()}


QUERIES = [
    "SELECT * FROM orders WHERE cust = 1 AND amount > 2 OR id = 3",
    "SELECT id, amount * 2 + 1 AS x, -id AS neg FROM orders WHERE id < 3",
    "SELECT id FROM orders WHERE cust IN (2, 3)",
    "SELECT id FROM orders WHERE amount BETWEEN 5 AND 10",
    "SELECT id FROM orders WHERE amount NOT BETWEEN 5 AND 10",
    "SELECT id FROM orders WHERE tag LIKE 'a%'",
    "SELECT id FROM orders WHERE tag NOT LIKE '%b'",
    "SELECT id FROM orders WHERE tag IS NOT NULL LIMIT 2",
    "SELECT id FROM orders WHERE tag IS NULL",
    "SELECT cust, SUM(amount) AS total, COUNT(*) AS n, MIN(amount) AS lo, "
    "AVG(amount) AS mean, MAX(tag) AS hi FROM orders GROUP BY cust "
    "ORDER BY cust",
    "SELECT COUNT(*) AS n, SUM(amount) AS s, MAX(id) AS m FROM orders "
    "WHERE cust <> 1",
    "SELECT AVG(amount) AS a, MIN(tag) AS t FROM orders",
    "SELECT cust, SUM(amount * 2) AS d FROM orders GROUP BY cust "
    "ORDER BY cust",
    "SELECT cust, SUM(amount) AS total FROM orders GROUP BY cust "
    "HAVING total > 20 ORDER BY total DESC",
    "SELECT name, amount FROM orders JOIN custs ON cust = cid "
    "WHERE amount > 20 ORDER BY amount",
    "SELECT cid, COUNT(id) AS n FROM custs LEFT JOIN orders ON cid = cust "
    "GROUP BY cid ORDER BY cid",
    "SELECT id FROM orders ORDER BY amount DESC, id LIMIT 3 OFFSET 1",
    "SELECT DISTINCT cust FROM orders ORDER BY cust",
    "SELECT UPPER(tag) AS u, LOWER(tag) AS lo, LENGTH(tag) AS l, "
    "ABS(id - 5) AS a, CAST(amount AS int) AS i, COALESCE(NULL, id) AS co "
    "FROM orders WHERE id < 4",
    "SELECT t1.v AS a, t2.v AS b FROM t1 JOIN t2 ON t1.k = t2.k ORDER BY a",
    "SELECT q1.a, q2.b FROM q1 JOIN q2 ON q2.a = q1.b",
    "SELECT t3.k, SUM(t4.x) AS s FROM t3 JOIN t4 ON t3.k = t4.k "
    "GROUP BY t3.k ORDER BY k",
    "SELECT k, SUM(v) AS s FROM kv GROUP BY k HAVING COUNT(*) > 1",
    "SELECT k, COUNT(*) AS c FROM kv GROUP BY k HAVING COUNT(*) > 1",
    "SELECT v total FROM kv",
    "SELECT sum(x) AS s, avg(x) AS a, min(x) AS m, count(x) AS c FROM nul",
    "SELECT max(y) AS m FROM nul WHERE y > 99",
    "SELECT a FROM e WHERE a >= -8",
    "SELECT a + 1, v * -2.5 FROM e",
    "SELECT id, 1 AS i, 2.5 AS f, TRUE AS b, 'lit' AS s, NULL AS n "
    "FROM orders WHERE id < 3",
    "SELECT 1 AS i, 2.5 AS f, FALSE AS b, 'x' AS s, NULL AS n FROM e",
    "SELECT id FROM orders WHERE id > 100",
    "SELECT id FROM orders WHERE tag = 'bb'",
    "SELECT id FROM orders WHERE tag >= 'b' AND NOT cust = 3",
    "SELECT id, amount / 2 AS h, id % 3 AS r FROM orders WHERE id > 6",
    "SELECT id FROM orders WHERE amount > 5 ORDER BY tag DESC, id",
    "SELECT cust, COUNT(tag) AS n FROM orders GROUP BY cust",
    "SELECT id FROM orders WHERE CAST('7' AS int) < id",
]


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_query_matches_reference(dbs, i):
    ref, port = dbs
    want = rsql.execute_sql(ref, QUERIES[i])
    got = psql.execute_sql(port, QUERIES[i])
    assert_tables_equal(got, port_table(want))


@pytest.mark.parametrize("i", [9, 15])
def test_query_matches_reference_on_both_routes(dbs, route, i):
    ref, port = dbs
    assert_tables_equal(psql.execute_sql(port, QUERIES[i]),
                        port_table(rsql.execute_sql(ref, QUERIES[i])))


ERRORS = ["SELECT FROM orders", "SELECT nosuch FROM orders",
          "SELECT id FROM nosuch", "SELECT cust, id FROM orders GROUP BY cust",
          "SELECT id FROM orders ORDER BY id + 1",
          "SELECT id FROM orders JOIN custs ON cust > cid",
          "SELECT id FROM orders WHERE @"]


@pytest.mark.parametrize("query", ERRORS)
def test_errors_match_reference(dbs, query):
    ref, port = dbs
    with pytest.raises(at.errors.ArrowInvalid):
        rsql.execute_sql(ref, query)
    with pytest.raises(att.errors.ArrowInvalid):
        psql.execute_sql(port, query)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_where_agg_matches_reference(seed):
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(10, 500))
    mask = rng.random(n) < 0.2
    ref = at.Table.from_pydict({
        "a": at.column(rng.integers(-50, 50, n), validity=~mask),
        "b": at.column(rng.normal(0, 10, n))})
    port = port_table(ref)
    thr = int(rng.integers(-40, 40))
    op = [">", "<", ">=", "="][seed]
    for query in (f"SELECT count(a) AS c, sum(a) AS s, min(b) AS m FROM t "
                  f"WHERE a {op} {thr}",
                  "SELECT a, count(*) AS c FROM t GROUP BY a ORDER BY a "
                  "LIMIT 5"):
        assert_tables_equal(psql.execute_sql({"t": port}, query),
                            port_table(rsql.execute_sql({"t": ref}, query)))


def _same_mutation(port, got, want):
    """The reference's mutated tables against the port's tables after its
    deltas."""
    (gm, gn), (wm, wn) = got, want
    gm = applied(port, gm)
    assert gn == wn
    assert sorted(gm) == sorted(wm)
    for k in wm:
        if wm[k] is None:
            assert gm[k] is None
        else:
            assert_tables_equal(gm[k], port_table(wm[k]))


STATEMENTS = [
    "INSERT INTO x VALUES (4, 'w')",
    "INSERT INTO x VALUES (-4, 'w'), (CAST(2.5 AS int), NULL)",
    "UPDATE x SET a = a + 100, s = 'z' WHERE a >= 3",
    "UPDATE x SET a = 0",
    "UPDATE x SET a = NULL WHERE s = 'q'",
    "DELETE FROM x WHERE s = 'q'",
    "DELETE FROM x WHERE a > NULL",
    "DELETE FROM x",
    "INSERT INTO x (s) VALUES ('only')",
    "INSERT INTO x (a) SELECT a * 10 FROM x WHERE a > 1",
    "CREATE TABLE y (k BIGINT, v VARCHAR, f DOUBLE, d DATE)",
    "CREATE TABLE IF NOT EXISTS x (k INT)",
    "CREATE TABLE z AS SELECT a FROM x WHERE a > 1",
    "DROP TABLE x",
    "DROP TABLE IF EXISTS nope",
    "UPDATE e SET v = v + 3 WHERE a >= -1",
    "DELETE FROM e WHERE a < -5",
]


@pytest.mark.parametrize("stmt", STATEMENTS)
def test_statement_matches_reference(stmt):
    ref = {"x": at.Table.from_pydict({"a": [1, 2, 3], "s": ["p", "q", "r"]}),
           "e": _db()["e"]}
    port = {k: port_table(v) for k, v in ref.items()}
    _same_mutation(port, psql.execute_sql_update(port, stmt),
                   rsql.execute_sql_update(ref, stmt))


@pytest.mark.parametrize("stmt", ["CREATE TABLE x (k INT)",
                                  "DROP TABLE nope", "UPDATE x SET q = 1",
                                  "INSERT INTO x VALUES (1)", "MERGE x"])
def test_statement_errors_match_reference(stmt):
    ref = {"x": at.Table.from_pydict({"a": [1, 2, 3], "s": ["p", "q", "r"]})}
    port = {k: port_table(v) for k, v in ref.items()}
    with pytest.raises(at.errors.ArrowInvalid):
        rsql.execute_sql_update(ref, stmt)
    with pytest.raises(att.errors.ArrowInvalid):
        psql.execute_sql_update(port, stmt)


def test_create_table_takes_a_device():
    got, _ = psql.execute_sql_update({}, "CREATE TABLE y (k INT)",
                                     device=CPU)
    assert got["y"].table.column("k").device == torch.device("cpu")
    with pytest.raises(att.errors.ArrowInvalid):
        psql.execute_sql_update({}, "CREATE TABLE y (k INT)")


LITERALS = ["1", "-7", "2.5", "TRUE", "FALSE", "'txt'", "''", "NULL"]


@pytest.mark.parametrize("rows", [0, 1, 5])
@pytest.mark.parametrize("lit", LITERALS)
def test_literal_columns_match_reference_types(lit, rows):
    """A literal column has the table's rows, on its device, with the
    type the reference gives it: int64, float64, bool, utf8 or null,
    empty tables included (the typed-empty-literal regression)."""
    ref = at.Table.from_pydict({"a": at.column(np.arange(rows,
                                                         dtype=np.int64))})
    port = port_table(ref)
    query = f"SELECT a, {lit} AS c FROM t"
    want = rsql.execute_sql({"t": ref}, query)
    got = psql.execute_sql({"t": port}, query)
    assert_tables_equal(got, port_table(want))
    assert got.column("c").device == port.column("a").device


def test_empty_in_list_is_false_like_the_reference(dbs):
    """An IN list of no items cannot be parsed; the evaluator's empty
    accumulator is a bool column of the table's rows on its device."""
    ref, port = dbs
    ev = psql._Evaluator(port["orders"], {})
    got = ev.eval(psql.InList(psql.Col(None, "id"), [], False))
    want = rsql._Evaluator(ref["orders"], {}).eval(
        rsql.InList(rsql.Col(None, "id"), [], False))
    assert got.to_pylist() == want.to_pylist() == [False] * 10
    assert repr(got.dtype) == repr(want.dtype)


# ---- ROADMAP C24: a decimal column against a literal ------------------------

DEC_VALUES = [decimal.Decimal("0.05"), None, decimal.Decimal("0.07"),
              decimal.Decimal("0.10")]


def _dec_tables():
    batch = pa.record_batch({"d": pa.array(DEC_VALUES, pa.decimal128(10, 2)),
                             "k": pa.array([1, 2, 3, 4])})
    from arrow_tpu.io.interop import table_from_pyarrow
    ref = table_from_pyarrow(batch)
    return ref, port_table(ref), batch


def test_decimal_scalar_compare_follows_pyarrow():
    """The port rescales the Scalar on the host: [False, None, True,
    True] for d > 0.06, as pyarrow; the reference raises TypeError."""
    from arrow_tpu.core.datum import Scalar as RScalar
    from arrow_tpu.ops import cmp as rcmp
    from arrow_tpu_torch.core.datum import Scalar as PScalar
    from arrow_tpu_torch.ops import cmp as pcmp
    ref, port, batch = _dec_tables()
    with pytest.raises(TypeError):
        rcmp.gt(ref.column("d"), RScalar(0.06, at.dtypes.decimal128(10, 2)))
    got = pcmp.gt(port.column("d"),
                  PScalar(0.06, att.dtypes.decimal128(10, 2))).to_pylist()
    want = pc.greater(batch.column(0), pa.scalar(
        decimal.Decimal("0.06"), pa.decimal128(10, 2))).to_pylist()
    assert got == want == [False, None, True, True]


@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "=", "<>"])
@pytest.mark.parametrize("lit", ["0.06", "0.07", "0", "1", "0.065"])
def test_decimal_literal_in_sql_follows_pyarrow(op, lit):
    """WHERE d <op> literal goes through `_coerce_pair` (a Scalar of the
    column's type); the port answers as pyarrow, the reference raises."""
    ref, port, batch = _dec_tables()
    query = f"SELECT k FROM t WHERE d {op} {lit}"
    with pytest.raises(TypeError):
        rsql.execute_sql({"t": ref}, query)
    got = psql.execute_sql({"t": port}, query).column("k").to_pylist()
    fn = {"<": pc.less, "<=": pc.less_equal, ">": pc.greater,
          ">=": pc.greater_equal, "=": pc.equal, "<>": pc.not_equal}[op]
    keep = fn(batch.column(0), pa.scalar(decimal.Decimal(lit),
                                         pa.decimal128(20, 3)))
    assert got == batch.column(1).filter(keep).to_pylist()


# ---- ROADMAP C3: a chunked group-by whose partial rows exceed a chunk --------

def test_chunked_group_by_with_many_partial_rows(monkeypatch):
    """dictionary<utf8> keys, 600 rows, 100 keys, chunks of 150: the
    reference merges its partial rows through the public group_by, which
    chunks again without end (RecursionError); the port returns the 100
    groups of an unchunked group_by."""
    import arrow_tpu.ops.groupby as rg
    import arrow_tpu_torch.ops.groupby as pg
    rng = np.random.default_rng(3)
    words = np.array([f"k{i:03d}" for i in range(100)])
    keys = words[np.concatenate([np.arange(100),
                                 rng.integers(0, 100, 500)])]
    batch = pa.record_batch({"k": pa.array(keys).dictionary_encode(),
                             "v": pa.array(rng.integers(0, 1000, 600))})
    from arrow_tpu.io.interop import table_from_pyarrow
    ref = table_from_pyarrow(batch)
    port = port_table(ref)
    aggs_r = [rg.AggSpec("v", "sum"), rg.AggSpec("v", "count")]
    aggs_p = [pg.AggSpec("v", "sum"), pg.AggSpec("v", "count")]
    whole = pg.group_by(port, ["k"], aggs_p)
    monkeypatch.setattr(rg, "_SORT_AGG_CHUNK", 150)
    monkeypatch.setattr(pg, "_SORT_AGG_CHUNK", 150)
    with pytest.raises(RecursionError):
        rg.group_by(ref, ["k"], aggs_r)
    got = pg.group_by(port, ["k"], aggs_p)
    assert got.num_rows == 100

    def rows(t):
        d = t.to_pydict()
        return sorted(zip(*[d[n] for n in t.column_names]))
    assert rows(got) == rows(whole)


# ---- ROADMAP C7.4: parameters rendered as SQL literals ----------------------

def test_bind_params_matches_reference_where_it_is_right():
    for q, row in [("SELECT * FROM t WHERE a = ? AND s = ?", [5, "it's"]),
                   ("WHERE s = '?' AND a = ?", [None]), ("a = ?", [True]),
                   ("a = ? OR b = ?", [-3, 2.5])]:
        assert psql.bind_sql_params(q, row) == rsql.bind_sql_params(q, row)


@pytest.mark.parametrize("value,text", [
    (1e20, "100000000000000000000.0"), (1.5e-7, "0.00000015"),
    (float("inf"), "CAST('inf' AS double)"),
    (float("-inf"), "CAST('-inf' AS double)"),
    (decimal.Decimal("12.50"), "12.50")])
def test_bind_params_render_literals_the_grammar_reads(value, text):
    """The reference renders with repr(): 1e+20, inf, Decimal('12.50')
    are text its own tokenizer cannot read back as the value.  The port
    writes digits (and a CAST for non-finite floats), and the bound
    query selects by the value, as a typed parameter would (arrow-rs)."""
    r = rsql.bind_sql_params("SELECT a FROM t WHERE b < ?", [value])
    assert r == f"SELECT a FROM t WHERE b < {value!r}"
    p = psql.bind_sql_params("SELECT a FROM t WHERE b < ?", [value])
    assert p == f"SELECT a FROM t WHERE b < {text}"
    b = [-1.0, 0.0, 3.0, float("inf")]
    t = {"t": att.Table.from_pydict({"a": [0, 1, 2, 3], "b": b},
                                    device=CPU)}
    got = psql.execute_sql(t, p).column("a").to_pylist()
    assert got == [i for i, x in enumerate(b) if x < float(value)]
    ref_t = {"t": at.Table.from_pydict({"a": [0, 1, 2, 3], "b": b})}
    try:
        ref_got = rsql.execute_sql(ref_t, r).column("a").to_pylist()
    except (at.errors.ArrowInvalid, TypeError):
        return
    assert ref_got != got


def test_bind_params_nan_and_unsupported_types():
    p = psql.bind_sql_params("SELECT ?", [float("nan")])
    assert p == "SELECT CAST('nan' AS double)"
    assert rsql.bind_sql_params("SELECT ?", [b"\x00"]) == "SELECT b'\\x00'"
    with pytest.raises(att.errors.ArrowInvalid):
        psql.bind_sql_params("SELECT ?", [b"\x00"])
    import datetime
    assert psql.bind_sql_params("a = ?", [datetime.date(2020, 1, 2)]) == \
        "a = CAST('2020-01-02' AS date32)"


# ---- the device of a statement ---------------------------------------------

def test_sql_runs_on_the_tables_card(dbs, cuda_device):  # noqa: F811
    ref, _ = dbs
    port = {k: port_table(v, cuda_device) for k, v in ref.items()}
    for query in QUERIES[:20]:
        got = psql.execute_sql(port, query)
        assert all(c.device.type == "cuda" for c in got.columns), query
        assert_tables_equal(got, port_table(rsql.execute_sql(ref, query)))
    mixed = {"orders": port["orders"],
             "custs": port_table(ref["custs"], CPU)}
    with pytest.raises(att.errors.ArrowInvalid):
        psql.execute_sql(mixed, QUERIES[14])
