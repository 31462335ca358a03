"""Each table is filtered by the WHERE's conjuncts that name it alone
before the statement's joins (arrow_tpu_torch/sql.py, `_pushdown`).
Every statement runs through the port, through the JAX package's
`execute_sql` over the same tables (the TPC-H helper of
test_torch_sql_pruning.py, text as utf8 and as dictionaries) and through
the port again with the pushdown turned off.  Against the port over the
whole WHERE the answer is the same table bit for bit: names, types,
validity, row order and every float's bits.  Against the reference it is
the same table, float sums within rtol 1e-9 (the packages add in another
order, as test_torch_sql_pruning.py says).  Each statement also reports
how many conjuncts it pushed (`conjuncts_pushed` of `sql.execute`):
those of one table read once, not the right side of a LEFT JOIN, with
no arithmetic, function or cast anywhere in the WHERE."""

import math

import pytest

from arrow_tpu.io.interop import table_from_pyarrow
from arrow_tpu.sql import execute_sql as ref_sql
from arrow_tpu_torch import sql as psql
from arrow_tpu_torch.io.interop import table_to_pyarrow
from arrow_tpu_torch.utils import trace
from benchmark import traffic
from test_torch_sql_pruning import _days, _rows, _tables
from test_torch_tpch_strings import _chip_smoke
from torch_port_util import assert_tables_equal, storage_list

D = _days(1995, 3, 15)
D0, D1 = _days(1993, 7, 1), _days(1993, 10, 1)
OL = "FROM orders JOIN lineitem ON o_orderkey = l_orderkey"
CN = "FROM customer c JOIN cust_note n ON c.c_custkey = n.c_custkey"
LEFT = "FROM customer LEFT JOIN orders ON c_custkey = o_custkey"

# name -> (statement, conjuncts pushed)
CASES = {
    "from_table": (f"SELECT o_orderkey, o_totalprice, l_linenumber {OL} "
                   f"WHERE o_orderdate < {D}", 1),
    "joined_table": (f"SELECT o_orderkey, l_linenumber, l_quantity {OL} "
                     "WHERE l_quantity < 20", 1),
    "both_tables": (f"SELECT o_orderkey, l_linenumber, l_shipmode {OL} "
                    f"WHERE o_orderdate < {D} AND l_quantity < 20 "
                    "AND l_shipmode IN ('AIR', 'MAIL', 'TRUCK')", 3),
    "aliased": ("SELECT o.o_orderkey, l.l_quantity, l.l_discount "
                "FROM orders o JOIN lineitem l "
                "ON o.o_orderkey = l.l_orderkey "
                f"WHERE o.o_orderdate BETWEEN {D0} AND {D} "
                "AND l.l_returnflag <> 'N' AND NOT l.l_discount > 0.05", 3),
    "qualified_by_table": (
        "SELECT orders.o_orderkey, lineitem.l_linenumber FROM orders "
        "JOIN lineitem ON orders.o_orderkey = lineitem.l_orderkey "
        "WHERE lineitem.l_linenumber = 1 AND orders.o_orderstatus = 'F'",
        2),
    "unqualified_in_two_tables": (
        f"SELECT c.c_custkey, c.c_name, n.c_phone AS note {CN} "
        "WHERE c_phone > '2'", 0),
    "qualified_in_two_tables": (
        f"SELECT c.c_custkey, c.c_name, n.c_phone AS note {CN} "
        "WHERE n.c_phone LIKE '%1%' AND c.c_phone < '20'", 2),
    "suffixed_name": (
        f"SELECT c.c_custkey, c.c_comment {CN} WHERE c_phone_right > 'C'",
        0),
    "or_across_tables": (f"SELECT o_orderkey, l_linenumber {OL} "
                         f"WHERE o_orderdate < {D0} OR l_quantity < 10", 0),
    "or_within_tables": (
        f"SELECT o_orderkey, l_linenumber {OL} "
        f"WHERE (o_orderdate < {D0} OR o_orderdate > {D}) "
        "AND (l_quantity < 10 OR l_shipmode = 'RAIL') "
        "AND l_comment NOT LIKE '%a%'", 3),
    "two_tables_one_conjunct": (
        f"SELECT o_orderkey, l_linenumber {OL} "
        f"WHERE o_orderdate < l_shipdate AND l_quantity < 10", 1),
    "arithmetic": (f"SELECT o_orderkey, l_linenumber {OL} "
                   f"WHERE l_quantity * 2 < 30 AND o_orderdate < {D}", 0),
    "function": (f"SELECT o_orderkey, l_linenumber {OL} "
                 f"WHERE length(l_shipmode) = 4 AND o_orderdate < {D}", 0),
    "cast": (f"SELECT o_orderkey, l_linenumber {OL} "
             f"WHERE CAST(l_quantity AS int) < 9 AND o_orderdate < {D}", 0),
    "left_join_right_side": (
        f"SELECT c_custkey, o_orderkey, o_totalprice {LEFT} "
        "WHERE o_orderkey IS NULL OR o_totalprice > 100000", 0),
    "left_join_right_side_alone": (
        f"SELECT c_custkey, o_orderkey {LEFT} WHERE o_totalprice > 100000",
        0),
    "left_join_left_side": (
        f"SELECT c_custkey, o_orderkey, o_totalprice {LEFT} "
        "WHERE c_acctbal > 0 AND c_mktsegment <> 'MACHINERY'", 2),
    "left_join_both_sides": (
        f"SELECT c_custkey, o_orderkey {LEFT} "
        "WHERE c_custkey IN (1, 2, 3, 4, 5, 7, 8) AND o_orderkey IS NULL",
        1),
    "left_join_grouped": (
        f"SELECT c_nationkey, SUM(o_totalprice) AS s, "
        f"COUNT(o_orderkey) AS n {LEFT} WHERE c_mktsegment = 'BUILDING' "
        "GROUP BY c_nationkey ORDER BY c_nationkey", 1),
    "read_twice": (
        "SELECT a.o_orderkey, b.o_orderkey AS other FROM orders a "
        "JOIN orders b ON a.o_custkey = b.o_custkey "
        f"WHERE a.o_orderdate < {D1} AND b.o_orderdate >= {D0}", 0),
    "select_star": ("SELECT * FROM customer JOIN orders "
                    f"ON c_custkey = o_custkey WHERE o_orderdate < {D} "
                    "AND c_acctbal > 0", 2),
    "grouped_on_pushed_column": (
        f"SELECT o_orderdate, COUNT(*) AS n, SUM(l_quantity) AS q {OL} "
        f"WHERE o_orderdate < {D0} GROUP BY o_orderdate "
        "ORDER BY o_orderdate", 1),
    "ordered_by_pushed_column": (
        f"SELECT o_orderkey, l_linenumber {OL} WHERE l_shipdate > {D} "
        "ORDER BY l_shipdate, o_orderkey, l_linenumber", 1),
    "three_joins": (
        "SELECT n_name, c_custkey, o_orderkey, l_linenumber FROM nation "
        "JOIN customer ON n_nationkey = c_nationkey "
        "JOIN orders ON c_custkey = o_custkey "
        "JOIN lineitem ON o_orderkey = l_orderkey "
        f"WHERE n_regionkey = 1 AND o_orderdate >= {D0} "
        f"AND o_orderdate < {D1} AND l_returnflag = 'R'", 4),
    "no_join": ("SELECT l_orderkey, l_linenumber FROM lineitem "
                "WHERE l_quantity < 10", 0),
}


@pytest.fixture(scope="module", params=[True, False],
                ids=["text", "dictionaries"])
def dbs(request):
    port = _tables(request.param)
    ref = {k: table_from_pyarrow(table_to_pyarrow(t))
           for k, t in port.items()}
    return port, ref


def _unpushed(fn):
    """`fn()` with the pushdown turned off: the whole WHERE after the
    joins."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(psql, "_pushdown", lambda where, *args: ({}, where))
        return fn()


def _pushed(fn):
    """`fn()`, and the `conjuncts_pushed` of each statement it ran."""
    trace.reset_spans()
    with trace.recording():
        out = fn()
    spans = trace.spans()
    trace.reset_spans()
    return out, [s.attrs["conjuncts_pushed"] for s in spans
                 if s.name == "sql.execute"]


def _same_bits(got, want):
    """The same table, and every float column the same bits."""
    assert_tables_equal(got, want)
    for name, g, w in zip(got.column_names, got.columns, want.columns):
        if g.dtype.is_floating:
            assert storage_list(g) == storage_list(w), name


def _sorted(rows):
    return sorted(rows, key=lambda r: [(x is None, 0 if x is None else x)
                                       for x in r])


def _like_reference(got, want, sums=(), ordered=True):
    """The same table as the reference's; the columns in `sums` within
    rtol 1e-9.  Without ORDER BY the rows compare as a sorted list: the
    reference leaves the order of a probe row's matches unspecified where
    build keys repeat (ROADMAP C)."""
    if ordered and not sums:
        assert_tables_equal(got, want)
        return
    assert got.column_names == want.column_names
    assert [repr(f.dtype) for f in got.schema.fields] == \
        [repr(f.dtype) for f in want.schema.fields]
    g, w = _rows(got), _rows(want)
    if not ordered:
        g, w = _sorted(g), _sorted(w)
    assert len(g) == len(w)
    at = [got.column_names.index(s) for s in sums]
    for i, (a, b) in enumerate(zip(g, w)):
        for k, (x, y) in enumerate(zip(a, b)):
            if k in at and x is not None and y is not None:
                assert math.isclose(x, y, rel_tol=1e-9), (i, x, y)
            else:
                assert x == y, (i, k, x, y)


def _check(port, ref, query, pushed, sums=()):
    got, n = _pushed(lambda: psql.execute_sql(port, query))
    assert n == [pushed]
    _like_reference(got, ref_sql(ref, query), sums,
                    ordered="ORDER BY" in query)
    _same_bits(got, _unpushed(lambda: psql.execute_sql(port, query)))
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_statement_matches_reference_and_whole_where(dbs, name):
    port, ref = dbs
    query, pushed = CASES[name]
    got = _check(port, ref, query, pushed,
                 sums=("s",) if name == "left_join_grouped" else ())
    assert got.num_rows > 0


def test_left_join_keeps_null_extended_rows(dbs):
    """A right-side predicate stays after the LEFT JOIN: the customers
    without orders (every c_custkey divisible by 3, and some others) come
    back null-extended."""
    port, _ = dbs
    got = psql.execute_sql(port, CASES["left_join_right_side"][0])
    keys = got.column("o_orderkey").to_pylist()
    custs = got.column("c_custkey").to_pylist()
    missing = {c for c, k in zip(custs, keys) if k is None}
    assert {c for c in range(3, 301, 3)} <= missing


@pytest.mark.parametrize("query", [
    # the first conjunct keeps no row; the second divides by zero on
    # every first line (l_linenumber 1)
    f"SELECT o_orderkey {OL} WHERE o_orderdate < 0 "
    "AND o_shippriority / (l_linenumber - 1) > 1",
    # the right key of a join leaves the joined table
    f"SELECT o_orderkey {OL} WHERE o_orderdate < {D} AND l_orderkey < 9",
], ids=["divide_by_zero", "right_key"])
def test_error_of_the_whole_where_stays(dbs, query):
    """A WHERE with a part that raises raises as over the joined rows,
    with nothing pushed: the rows a pushed filter drops would no longer
    reach the division, and the join's right key is no column of the
    joined table."""
    port, ref = dbs
    outcomes = []
    for fn in (lambda: psql.execute_sql(port, query),
               lambda: ref_sql(ref, query)):
        with pytest.raises(Exception) as err:
            fn()
        outcomes.append(type(err.value).__name__)
    assert outcomes[0] == outcomes[1]


def _bench_queries(seed: int, n: int):
    """The first `n` queries of the join cell's stream 0 under `seed`,
    by the benchmark's own traffic generator."""
    it = traffic.stream(traffic.load("traffic", "join"), seed, 0)
    return [next(it) for _ in range(n)]


def _run(execute, tables, q):
    """The answer of a benchmark query: its steps' answers registered
    under their names, then its last statement."""
    tables = dict(tables)
    for into, sql in q.steps:
        tables[into] = execute(tables, sql)
    return execute(tables, q.sql)


@pytest.mark.parametrize("seed", [7, 2_718_281_828])
def test_benchmark_join_texts(dbs, seed):
    """The join cell's Q3, Q4 (its step, then the count over the step's
    table) and Q10 with drawn parameters: each of their conjuncts names
    one table; Q4's count has no JOIN."""
    port, ref = dbs
    want_pushed = {"Q3": [3], "Q4": [3, 0], "Q10": [3]}
    rows = 0
    for q in _bench_queries(seed, 6):
        got, n = _pushed(lambda: _run(psql.execute_sql, port, q))
        assert n == want_pushed[q.name], q.name
        sums = ("revenue",) if q.name in ("Q3", "Q10") else ()
        _like_reference(got, _run(ref_sql, ref, q), sums)
        _same_bits(got, _unpushed(lambda: _run(psql.execute_sql, port, q)))
        rows += got.num_rows
    assert rows > 0


@pytest.mark.parametrize("name, pushed", [("Q1", 0), ("Q3", 3), ("Q4", 0),
                                          ("Q6", 0), ("Q10", 3)])
def test_p32_queries(dbs, name, pushed):
    """chip_smoke.py's phase 32 statements: Q3's and Q10's conjuncts
    each name one table; Q1, Q4 and Q6 read one table."""
    port, ref = dbs
    sums = {"Q1": ("sum_qty", "sum_base_price", "sum_disc_price",
                   "sum_charge", "avg_qty", "avg_price", "avg_disc"),
            "Q3": ("revenue",), "Q6": ("revenue",), "Q10": ("revenue",)}
    got = _check(port, ref, _chip_smoke().P32_QUERIES[name], pushed,
                 sums.get(name, ()))
    assert got.num_rows > 0
