"""The refreshed served configuration (drivers/flightsql_rf.py) and its
reference (reference/refresh.py), on the CPU at a tiny size.

- The reference's refresh functions equal a naive application, row by
  row in Python.
- The three storage readers (metrics/write_ms_per_rf.py,
  version_mib_per_rf.py, write_wait_ms_per_query.py) on a hand-built
  window with known answers, and None on an empty one.
- The cell run end to end, its refresh stream at a fast pace: correct;
  and `correct` false when an acknowledged refresh is not read back, an
  answer carries the wrong snapshot, a refresh is published torn
  (orders in one commit, lineitem in another), or the final state
  differs by one row."""

import importlib
import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import run, tpch_gen, traffic
from benchmark.reference import refresh

from .conftest import small_config

CELL = "tpch-sf10-flightsql-rf.throughput-rf"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 25
MS = 1_000_000


# ---- the reference ------------------------------------------------------------

def _plan(base, pairs=2):
    n_orders = base["orders"]["o_orderkey"].values.shape[0]
    spec = {"seed": SEED, "n_orders": n_orders, "pairs": pairs,
            "per_rf": refresh.per_rf(10, n_orders, 2 * pairs),
            "customers": 900, "suppliers": 100,
            "clerks": len(base["orders"]["o_clerk"].words)}
    return refresh.plan(spec)


def _rows(cols: dict) -> list:
    names = list(cols)
    return [tuple(r) for r in zip(*(cols[n].values.tolist()
                                    for n in names))]


@pytest.mark.parametrize("n", range(5))
def test_reference_state_equals_a_naive_application(n):
    """After n of two pairs' transactions: lineitem the initial rows less
    the deleted orders' lines, then each RF1's lines in turn; orders the
    same, sorted by key."""
    cfg = small_config("tpch-sf10-flightsql-rf",
                       {"lineitem": 3_000, "customer": 900,
                        "supplier": 100})
    base = tpch_gen.make_tables(cfg, SEED, CPU)
    plan = _plan(base)
    got = refresh.state(base, plan, n)
    for name, key in (("lineitem", "l_orderkey"), ("orders", "o_orderkey")):
        cols = {c: v for c, v in base[name].items()
                if v.kind not in refresh.TEXT}
        rows, at = _rows(cols), list(cols).index(key)
        for r in plan[:n]:
            if r.kind == "RF2":
                gone = set(r.keys.tolist())
                rows = [x for x in rows if x[at] not in gone]
            else:
                add = r.lineitem if name == "lineitem" else r.orders
                rows += _rows({c: add[c] for c in cols})
        if name == "orders":
            rows.sort(key=lambda x: x[at])
        assert list(got[name]) == list(cols)
        assert _rows(got[name]) == rows
    assert got["customer"] is base["customer"]


def test_plan_keys_are_fresh_and_distinct():
    cfg = small_config("tpch-sf10-flightsql-rf")
    base = tpch_gen.make_tables(cfg, SEED, CPU)
    plan = _plan(base, pairs=3)
    initial = set(base["orders"]["o_orderkey"].values.tolist())
    new = [k for r in plan if r.kind == "RF1" for k in r.keys.tolist()]
    gone = [k for r in plan if r.kind == "RF2" for k in r.keys.tolist()]
    assert len(set(new)) == len(new) and not set(new) & initial
    assert len(set(gone)) == len(gone) and set(gone) <= initial
    for r in plan:
        if r.kind == "RF1":
            assert set(r.lineitem["l_orderkey"].values.tolist()) == \
                set(r.keys.tolist())


# ---- the readers ------------------------------------------------------------

def _window():
    """Two transactions (one committed, 40 ms; one rolled back) and the
    writes and publishes of a window of 4 queries."""
    from arrow_tpu_torch.utils.trace import Span
    rows = [  # id, name, start, end, attrs
        (1, "flightsql.transaction", 0, 40, {"statements": 2,
                                             "outcome": "commit"}),
        (2, "flightsql.transaction", 50, 60, {"statements": 1,
                                              "outcome": "rollback"}),
        (3, "table.write", 5, 10, {"table": "orders", "bytes": 2 ** 20}),
        (4, "table.write", 15, 20, {"table": "lineitem",
                                    "bytes": 3 * 2 ** 20}),
        (5, "table.publish", 38, 40, {"tables": "lineitem,orders",
                                      "wait_ns": 2 * MS}),
        (6, "table.write", 52, 55, {"table": "orders", "bytes": 2 ** 20}),
        (7, "table.publish", 70, 71, {"tables": "q4", "wait_ns": 6 * MS}),
    ]
    return [Span(name, a * MS, b * MS, i, None, i, 1, attrs)
            for i, name, a, b, attrs in rows]


WANT = {"write_ms_per_rf": 40.0, "version_mib_per_rf": 5.0,
        "write_wait_ms_per_query": (2 + 6) / 4}
READERS = tuple(WANT)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_known_window(monkeypatch, name):
    from arrow_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", _window)
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    got = reader.read(SimpleNamespace(window_s=1.0, queries=4))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_writes_reads_nothing(monkeypatch, name):
    from arrow_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "spans", lambda: [])
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(SimpleNamespace(window_s=1.0, queries=4)) is None


# ---- the cell on the CPU --------------------------------------------------------

@pytest.fixture
def fast(small_tables, monkeypatch):
    """The cell at tiny tables, its refresh stream four pairs, one every
    0.5 s from 0.2 s."""
    real = traffic.load

    def load(kind, name, root=traffic.HERE):
        mix = real(kind, name, root)
        if "refresh" in mix:
            mix["refresh"] = dict(mix["refresh"], first_s=0.2, every_s=0.5,
                                  pairs=4)
        return mix
    monkeypatch.setattr(traffic, "load", load)


def _result(capsys):
    rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds",
                   "3", "--trace", "0"], device=CPU)
    assert rc == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def test_cell_is_correct_on_the_cpu(fast, capsys):
    got, err = _result(capsys)
    assert got["correct"] is True and got["failed"] == 0, err[-3000:]
    assert "refresh in the window: 8 transactions" in err
    assert set(got["metrics"]) == {"join.queries_per_s", "setup_s"}


def _publish_patch(monkeypatch, change):
    from arrow_tpu_torch.io.flightsql import FlightSQLServer
    real = FlightSQLServer._publish
    seen = []

    def publish(self, versions, wait_ns):
        if set(versions) == {"lineitem", "orders"}:
            seen.append(1)
            if len(seen) == 4:          # the window's first RF2
                return change(self, real, versions, wait_ns)
        return real(self, versions, wait_ns)
    monkeypatch.setattr(FlightSQLServer, "_publish", publish)


def test_a_refresh_not_read_back_fails(fast, capsys, monkeypatch):
    _publish_patch(monkeypatch, lambda self, real, v, w: None)
    got, err = _result(capsys)
    assert got["correct"] is False and got["failed"] > 0
    assert "read [" in err


def test_a_torn_refresh_fails(fast, capsys, monkeypatch):
    def torn(self, real, versions, wait_ns):
        for name in sorted(versions):
            real(self, {name: versions[name]}, wait_ns)
    _publish_patch(monkeypatch, torn)
    got, err = _result(capsys)
    assert got["correct"] is False and got["failed"] > 0
    assert "not lineitem and orders together" in err


def test_an_answer_at_the_wrong_snapshot_fails(fast, capsys, monkeypatch):
    from arrow_tpu_torch.io import flightsql
    real = flightsql._stamped
    monkeypatch.setattr(flightsql, "_stamped",
                        lambda table, commit: real(table, 0))
    got, err = _result(capsys)
    assert got["correct"] is False and got["failed"] > 0
    assert "refresh transactions): " in err


def test_a_final_state_one_row_off_fails(fast, capsys, monkeypatch):
    from arrow_tpu_torch.storage import TableVersion
    real = TableVersion._append
    done = []

    def append(self, add, w):
        if add.column_names[0] == "l_orderkey" and len(done) == 1:
            add = add.slice(0, add.num_rows - 1)
        if add.column_names[0] == "l_orderkey":
            done.append(1)
        return real(self, add, w)
    monkeypatch.setattr(TableVersion, "_append", append)
    got, err = _result(capsys)
    assert got["correct"] is False and got["failed"] > 0
    assert "final lineitem.rows" in err
