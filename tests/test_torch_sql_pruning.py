"""A statement reads only the columns it names (arrow_tpu_torch/sql.py,
`_select`): each table is cut to the names its references may resolve to
before its joins and its WHERE.  Every statement runs through the port
and through the JAX package's `execute_sql` over the same tables
(chip_smoke.py's TPC-H generator at a few thousand lineitem rows, with
its text as utf8 and as dictionaries and large_utf8), and through the
port again with the cut turned off: column names, types, row order and
values agree (floats within rtol 1e-9 against the reference, which adds
in another order; exactly against the port over whole tables).  Then the
gathers: Q1's WHERE and Q3's joins take no comment column."""

import contextlib
import math

import pytest
import torch

from arrow_tpu.io.interop import table_from_pyarrow
from arrow_tpu.sql import execute_sql as ref_sql
from arrow_tpu.sql import execute_sql_update as ref_sql_update
from arrow_tpu_torch import sql as psql
from arrow_tpu_torch.core.column import StringColumn
from arrow_tpu_torch.io.interop import table_to_pyarrow
from arrow_tpu_torch.ops import filter as filter_mod
from arrow_tpu_torch.ops import join as join_mod
from arrow_tpu_torch.ops import take as take_mod
from test_torch_tpch_strings import _chip_smoke
from torch_port_util import assert_tables_equal

ROWS = 3_000
CUSTOMERS = 300
CPU = torch.device("cpu")
COMMENTS = (("lineitem", "l_comment"), ("orders", "o_comment"),
            ("customer", "c_comment"))


def _tables(text: bool) -> dict:
    chip = _chip_smoke()
    tabs, _ = chip.tpch_tables(ROWS, CUSTOMERS, CPU, text=text,
                               pool_bytes=1 << 16, seed=21)
    # two names that collide with customer's: c_comment holds other text
    # (c_address), c_phone other digits (c_name)
    tabs["cust_note"] = tabs["customer"].select(
        ["c_custkey", "c_address", "c_name"]).rename_columns(
        ["c_custkey", "c_comment", "c_phone"])
    return tabs


@pytest.fixture(scope="module", params=[True, False],
                ids=["text", "dictionaries"])
def dbs(request):
    port = _tables(request.param)
    ref = {k: table_from_pyarrow(table_to_pyarrow(t))
           for k, t in port.items()}
    return port, ref


def _days(y, m, d):
    return _chip_smoke()._days(y, m, d)


def _q4_step():
    return ("SELECT DISTINCT o_orderkey, o_orderpriority FROM orders "
            "JOIN lineitem ON o_orderkey = l_orderkey "
            f"WHERE o_orderdate >= {_days(1993, 7, 1)} "
            f"AND o_orderdate < {_days(1993, 10, 1)} "
            "AND l_commitdate < l_receiptdate")


STATEMENTS = {
    "select_star_join": (
        "SELECT * FROM customer JOIN orders ON c_custkey = o_custkey "
        f"WHERE o_orderdate < {_days(1993, 1, 1)} ORDER BY o_orderkey"),
    "collision_bare": (
        "SELECT c_custkey, c_comment, c_comment_right FROM customer "
        "JOIN cust_note ON c_custkey = c_custkey"),
    "collision_suffix_only": (
        "SELECT c_custkey, c_comment_right FROM customer "
        "JOIN cust_note ON c_custkey = c_custkey WHERE c_phone_right > 'C'"),
    "collision_qualified": (
        "SELECT c.c_custkey, n.c_comment AS note, c.c_comment "
        "FROM customer c JOIN cust_note n ON c.c_custkey = n.c_custkey "
        "WHERE n.c_phone LIKE '%1%' ORDER BY c_phone_right"),
    "collision_after_join": (
        "SELECT o_orderkey, c_phone, c_phone_right FROM orders "
        "JOIN customer ON o_custkey = c_custkey "
        "JOIN cust_note n ON o_custkey = n.c_custkey "
        f"WHERE o_orderdate < {_days(1992, 6, 1)} ORDER BY o_orderkey"),
    "count_star": "SELECT COUNT(*) FROM lineitem",
    "count_star_grouped": (
        "SELECT l_returnflag, COUNT(*) AS n FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag"),
    "literal_only": "SELECT 1 AS one FROM orders LIMIT 5",
    "left_join": (
        "SELECT c_custkey, c_name, o_orderkey, o_comment FROM customer "
        "LEFT JOIN orders ON c_custkey = o_custkey WHERE c_custkey < 40 "
        "ORDER BY c_custkey, o_orderkey"),
    "order_by_dropped": (
        "SELECT o_orderkey, o_totalprice FROM orders "
        f"WHERE o_orderdate < {_days(1993, 1, 1)} "
        "ORDER BY o_orderdate, o_orderkey LIMIT 50"),
    "having_unselected": (
        "SELECT l_returnflag, COUNT(*) AS n FROM lineitem "
        "GROUP BY l_returnflag HAVING MAX(l_linenumber) > 3 "
        "ORDER BY l_returnflag"),
    "distinct": "SELECT DISTINCT l_returnflag, l_linestatus FROM lineitem",
    "q4_step": _q4_step(),
}
FLOATS = ("Q1", "Q3", "Q10")


def _unpruned(fn):
    """`fn()` with the cut turned off: every table read whole."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(psql, "_prune", lambda t, names: t)
        return fn()


def _rows(t) -> list:
    d = t.to_pydict()
    return list(zip(*d.values()))


def _close(got, want, what):
    assert got.column_names == want.column_names, what
    assert [repr(f.dtype) for f in got.schema.fields] == \
        [repr(f.dtype) for f in want.schema.fields], what
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w) > 0, what
    for i, (a, b) in enumerate(zip(g, w)):
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert math.isclose(x, y, rel_tol=1e-9), (what, i, x, y)
            else:
                assert x == y, (what, i, x, y)


def _statement(name):
    return STATEMENTS.get(name) or _chip_smoke().P32_QUERIES[name]


@pytest.mark.parametrize("name", ["Q1", "Q3", "Q4", "Q10"]
                         + list(STATEMENTS))
def test_statement_matches_reference_and_whole_tables(dbs, name):
    port, ref = dbs
    query = _statement(name)
    got = psql.execute_sql(port, query)
    want = ref_sql(ref, query)
    if name in FLOATS:
        _close(got, want, name)
    else:
        assert_tables_equal(got, want)
    assert got.num_rows > 0
    assert_tables_equal(got, _unpruned(lambda: psql.execute_sql(port,
                                                                query)))


def test_create_table_as_select(dbs):
    """Q4's step as CTAS through execute_sql_update, then Q4's count over
    the table it made."""
    port, ref = dbs
    query = "CREATE TABLE late AS " + _q4_step()
    got, n = psql.execute_sql_update(port, query)
    want, want_n = ref_sql_update(ref, query)
    assert list(got) == ["late"] and n == want_n > 0
    assert_tables_equal(got["late"].table, want["late"])
    whole, _ = _unpruned(lambda: psql.execute_sql_update(port, query))
    assert_tables_equal(got["late"].table, whole["late"].table)
    count = ("SELECT o_orderpriority, COUNT(*) AS order_count FROM late "
             "GROUP BY o_orderpriority ORDER BY o_orderpriority")
    assert_tables_equal(psql.execute_sql({**port, "late": got["late"].table},
                                         count),
                        ref_sql({**ref, **want}, count))


@contextlib.contextmanager
def _take_spy():
    """Every column `take` receives, through each module that calls it."""
    seen = []
    real = take_mod.take

    def spy(c, idx, *args, **kwargs):
        seen.append(c)
        return real(c, idx, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        for mod in (take_mod, filter_mod, join_mod):
            mp.setattr(mod, "take", spy)
        yield seen


@pytest.mark.parametrize("text", [True, False],
                         ids=["text", "dictionaries"])
@pytest.mark.parametrize("name", ["Q1", "Q3"])
def test_no_comment_is_gathered(name, text):
    """Q1's WHERE keeps nearly every row of lineitem and Q3 joins three
    tables, yet no take receives a comment (every gathered copy of one
    would start at a take of the table's own column); with the text as
    dictionaries no take receives a string column at all.  Over whole
    tables the same spy sees the comments."""
    tabs = _tables(text)
    query = _chip_smoke().P32_QUERIES[name]
    comments = [tabs[t].column(c) for t, c in COMMENTS if t in tabs]
    with _take_spy() as seen:
        psql.execute_sql(tabs, query)
    assert not any(c is k for c in seen for k in comments)
    if not text:
        assert not any(isinstance(c, StringColumn) for c in seen)
    with _take_spy() as seen:
        _unpruned(lambda: psql.execute_sql(tabs, query))
    assert any(c is k for c in seen for k in comments)
