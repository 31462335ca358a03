"""The refreshed served driver: the served configuration's server and
three query streams (drivers/flightsql.py), and beside them TPC-H's
refresh stream (clause 5.3.4): one more client process, which sees no
card, running RF1/RF2 pairs as Flight SQL transactions at the mix's fixed
pace (`refresh` in traffic/<name>.json: the first pair `first_s` after
the window opens, one every `every_s`, `pairs` in the window,
`warm_pairs` in set-up; a late pair starts when the one before commits).
RF1 is one transaction of two bulk ingests (APPEND), RF2 one of two
DELETE ... WHERE ... IN statements; after each commit the client reads
back the counts of its keys (not counted as queries).  The rows and keys
are reference/refresh.py's plan, drawn from the seed.

Correctness, without run.py's own comparison knowing of writes:

- in the window, each sampled answer is judged against the plain
  reference at the commit its answer carries (the schema metadata key
  `arrow_tpu.snapshot`): the reference's tables after as many refresh
  transactions as had committed by then, by the server's commit
  history; every refresh commit must name `lineitem` and `orders`
  together, and every acknowledged count and read-back must be the
  plan's.  A miss counts as a failed query;
- after the window, each query stream answers one query of each type,
  the samples run.py judges, and the driver brings the generator's
  `lineitem` and `orders` to the final state by the reference's own
  refresh functions (run.py's tables are the driver's); the program's
  final tables must equal the reference's in rows, key sums and the
  integer-cent sums of l_extendedprice and o_totalprice.

A program without versioned tables cannot run this configuration (its
server publishes no snapshot): the driver refuses it at once."""

from __future__ import annotations

import bisect
import importlib
import os
import subprocess
import sys
from collections import defaultdict
from typing import List

import torch

from .. import compare, harness, program, traffic
from ..reference import refresh
from .flightsql import Driver as Served, ROOT, _say

CLIENT = "benchmark.drivers.flightsql_rf_client"
TABLES = ("lineitem", "orders")


class Driver(Served):
    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool):
        from arrow_tpu_torch.io import flightsql
        if not hasattr(flightsql, "SNAPSHOT_KEY"):
            raise SystemExit(
                "the program's FlightSQLServer has no table versions (its "
                "results carry no snapshot): this configuration needs "
                "them")
        super().__init__(cfg, mix, seed, device, trace)
        self.cfg = cfg
        self._unjudged = None

    def start(self) -> None:
        """The query streams' clients and the refresh stream's, started
        while the tables are made."""
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in [os.environ.get(
                           "PYTHONPATH")] if p]))
        for _ in range(self.mix["streams"] + 1):
            self.clients.append(subprocess.Popen(
                [sys.executable, "-m", CLIENT], cwd=ROOT, env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE))

    @property
    def streams(self):
        return self.clients[:self.mix["streams"]]

    @property
    def refresher(self):
        return self.clients[self.mix["streams"]]

    def setup(self, tables: dict) -> None:
        from arrow_tpu_torch.io.flightsql import FlightSQLServer
        pace = self.mix["refresh"]
        self.tables = tables            # run.py judges the final samples here
        self.base = dict(tables)
        n_orders = _rows(tables["orders"]["o_orderkey"])
        pairs = pace["warm_pairs"] + pace["pairs"]
        self.spec = {"seed": self.seed, "n_orders": n_orders,
                     "per_rf": refresh.per_rf(self.cfg["scale_factor"],
                                              n_orders, 2 * pairs),
                     "pairs": pairs,
                     "customers": _rows(tables["customer"]["c_custkey"]),
                     "suppliers": _rows(tables["supplier"]["s_suppkey"]),
                     "clerks": len(tables["orders"]["o_clerk"].words)}
        self.server = FlightSQLServer("grpc://localhost:0",
                                      device=self.device)
        for name, table in program.port_tables(tables, self.device).items():
            self.server.register(name, table)
        for k, c in enumerate(self.clients):
            spec = self.spec if c is self.refresher else None
            self._ask(c, "connect", self.server.uri, self.mix, self.seed, k,
                      spec)
        self.plan = refresh.plan(self.spec)
        for c in self.clients:
            self._answer(c)
        for c in self.streams:          # one of each, one client at a time
            self._ask(c, "warm")
            self._answer(c)
        self._ask(self.refresher, "warm")
        self.warm = self._answer(self.refresher)
        self._say_refresh("set-up", self.warm)

    def _say_refresh(self, when: str, reports: list) -> None:
        if reports:
            ms = [1e3 * (r["commit"] - r["begin"]) for r in reports]
            _say(f"refresh in {when}: {len(reports)} transactions, "
                 f"{sum(ms) / len(ms):.1f} ms each from begin to commit "
                 f"(longest {max(ms):.1f})")

    def window(self, seconds: float) -> List[harness.Record]:
        from arrow_tpu_torch.utils import trace
        pace = self.mix["refresh"]
        pairs = max(0, min(pace["pairs"], int(
            (seconds - pace["first_s"]) // pace["every_s"])))
        reruns = trace.counters_snapshot().get("flightsql.reruns", 0)
        cpu0 = _cpu(self.clients)
        self.t_open = harness.now()
        for c in self.streams:
            self._ask(c, "window", self.t_open, self.t_open + seconds, 0)
        self._ask(self.refresher, "window", self.t_open,
                  self.t_open + seconds, pairs)
        records = [self._answer(c) for c in self.streams]
        reports = self._answer(self.refresher)
        _say_window(records, reports, cpu0, _cpu(self.clients), self.t_open)
        _say(f"re-runs after an out-of-memory error in the window: "
             f"{trace.counters_snapshot().get('flightsql.reruns', 0) - reruns}")
        self._say_refresh("the window", reports)
        late = [r["begin"] - self.t_open - pace["first_s"]
                - k // 2 * pace["every_s"] for k, r in enumerate(reports)
                if k % 2 == 0]
        if late:
            _say(f"refresh pairs begun late by at most {max(late):.3f} s")
        final = []
        for c in self.streams:
            self._ask(c, "final")
            final.append(self._answer(c))
        self._unjudged = (records, reports, final)
        return records

    def close(self) -> None:
        """Judge the window (the reference's tables are made on the card
        here, after run.py has read the device's peak, so the peak is
        the server's), then stop the clients and the server."""
        try:
            if self._unjudged is not None:
                records = self._unjudged[0]
                judged = self.judged(*self._unjudged)
                self._unjudged = None
                records.extend(judged[len(records):])
        finally:
            super().close()

    def judged(self, records, reports, final) -> List[harness.Record]:
        """The window's records with every miss counted as a failed
        query, their samples those drawn after the last commit; the
        generator's lineitem and orders brought to the final state."""
        done = 2 * self.mix["refresh"]["warm_pairs"] + len(reports)
        errors = check_reports(self.warm + reports, self.plan, self.base)
        commits, why = refresh_commits(list(self.server.history), done)
        errors += why
        if not why:
            errors += judge_window(records, commits, self.base, self.plan,
                                   self.mix)
            last = commits[-1] if commits else -1
            errors += [(k, None, f"a final answer read commit {snap}, "
                        f"before the last refresh's {last}")
                       for k, samples in enumerate(final)
                       for _, _, (snap, _) in samples if snap < last]
        want = refresh.state(self.base, self.plan, done)
        errors += [(None, None, e) for e in check_final(
            self.server._tables, want)]
        for name in TABLES:
            self.tables[name] = want[name]
        for rec, samples in zip(records, final):
            rec.samples = [(n, p, rows) for n, p, (_, rows) in samples]
        return mark_failed(records, errors, self.t_open)


def _ticks(path: str) -> int:
    """User and system clock ticks of a /proc stat file."""
    try:
        with open(path) as f:
            s = f.read()
    except OSError:
        return 0
    f = s[s.rindex(")") + 2:].split()
    return int(f[11]) + int(f[12])


def _cpu(clients) -> dict:
    """CPU ticks of this process's threads and of each client process."""
    task = "/proc/self/task"
    out = {"t" + t: _ticks(f"{task}/{t}/stat") for t in os.listdir(task)}
    out.update({f"c{k}": _ticks(f"/proc/{c.pid}/stat")
                for k, c in enumerate(clients)})
    return out


def _say_window(records, reports, before, after, t_open) -> None:
    """Where the window's time went, on standard error: each stream's
    completions a 5-s bucket, each query type's count and mean ms, each
    refresh transaction's ms, the CPU seconds of this process's busiest
    threads and of each client."""
    hz = os.sysconf("SC_CLK_TCK")
    for k, rec in enumerate(records):
        bins = defaultdict(int)
        for _, _, t1, _ in rec.latencies:
            bins[int((t1 - t_open) // 5)] += 1
        _say(f"stream {k} completions a 5-s bucket: "
             f"{[bins[b] for b in range(max(bins) + 1)] if bins else []}")
    by = defaultdict(list)
    for rec in records:
        for q, t0, t1, _ in rec.latencies:
            by[q].append(t1 - t0)
    _say("query ms: " + ", ".join(
        f"{q} {len(v)} x {1e3 * sum(v) / len(v):.1f}"
        for q, v in sorted(by.items())))
    _say("refresh ms: " + str([round(1e3 * (r["commit"] - r["begin"]))
                               for r in reports]))
    use = {k: (v - before.get(k, 0)) / hz for k, v in after.items()}
    threads = sorted((v for k, v in use.items() if k[0] == "t"),
                     reverse=True)
    _say(f"window CPU s: threads {[round(v, 1) for v in threads[:10]]} "
         f"(of {len(threads)}), clients "
         f"{[round(use[k], 1) for k in sorted(use) if k[0] == 'c']}, "
         f"load {os.getloadavg()[0]:.1f} on {os.cpu_count()} CPUs")


def _rows(col) -> int:
    return int(col.values.shape[0])


def refresh_commits(history, transactions: int):
    """The commit numbers of the refresh transactions, in order, from the
    server's history of (commit, tables); and what is wrong: a commit
    that names one of lineitem and orders without the other (a torn
    transaction), or another count of them than `transactions`."""
    rf = [(c, names) for c, names in history if set(names) & set(TABLES)]
    errors = [(None, None, f"commit {c} published {names}, not lineitem "
               f"and orders together") for c, names in rf
              if tuple(sorted(names)) != TABLES]
    if len(rf) != transactions:
        errors.append((None, None, f"{len(rf)} commits wrote lineitem or "
                       f"orders, not the {transactions} refresh "
                       f"transactions"))
    return [c for c, _ in rf], errors


def check_reports(reports, plan, base) -> list:
    """Each refresh transaction's acknowledged and read-back counts
    against the plan: RF1 inserts its orders and lines, which are read
    back; RF2 deletes its orders and the base lines under them, of which
    none is read back."""
    errors = []
    keys = base["lineitem"]["l_orderkey"].values
    for i, (rep, r) in enumerate(zip(reports, plan)):
        k = r.keys.shape[0]
        if r.kind == "RF1":
            lines = r.lineitem["l_orderkey"].values.shape[0]
            want = {"acknowledged": [k, lines], "read": [k, lines]}
        else:
            lines = int(torch.isin(keys, r.keys.to(keys.device)).sum())
            want = {"acknowledged": [lines, k], "read": [0, 0]}
        for what, counts in want.items():
            if rep["kind"] != r.kind or rep[what] != counts:
                errors.append((None, rep["kind"], f"refresh transaction {i} "
                               f"({r.kind}) {what} {rep[what]}, not "
                               f"{counts}"))
    if len(reports) > len(plan):
        errors.append((None, None, "more refresh transactions than the "
                       "plan's"))
    return errors


def judge_window(records, commits, base, plan, mix) -> list:
    """Each sampled answer of the window against the reference at its
    snapshot: the tables after the refresh transactions whose commit
    number is at most the answer's."""
    specs = traffic.queries_of(mix)
    by_n = defaultdict(list)
    for k, rec in enumerate(records):
        for name, params, (snap, rows) in rec.samples:
            by_n[bisect.bisect_right(commits, snap)].append(
                (k, name, params, snap, rows))
    errors = []
    for n in sorted(by_n):
        tables = refresh.state(base, plan, n)
        for k, name, params, snap, rows in by_n[n]:
            spec = specs[name]
            ref = importlib.import_module(f"benchmark.reference."
                                          f"{name.lower()}")
            want, count = ref.answer(tables, params)
            why, gap = compare.compare(rows, want, count, spec["answer"])
            if why is None and spec["answer"]["floats"] and \
                    gap > spec["limits"]["rel_err"]:
                why = f"rel_err {gap} over {spec['limits']['rel_err']}"
            if why is not None:
                errors.append((k, name, f"{name} {params} at commit {snap} "
                               f"({n} refresh transactions): {why}"))
        del tables
    return errors


def check_final(versions: dict, want: dict) -> list:
    """The program's final lineitem and orders (the server's table
    versions, read through its SQL as a statement sees them, only the
    columns summed) against the reference's: rows, key sums, cent
    sums."""
    from arrow_tpu_torch.sql import execute_sql

    def col(t, name):
        return t.column(name).values
    li, o = (execute_sql(versions, f"SELECT {c} FROM {n}") for n, c in (
        ("lineitem", "l_orderkey, l_extendedprice"),
        ("orders", "o_orderkey, o_totalprice")))
    got = {"lineitem.rows": li.num_rows,
           "lineitem.keys": int(col(li, "l_orderkey").sum()),
           "lineitem.cents": int(torch.round(
               col(li, "l_extendedprice") * 100).long().sum()),
           "orders.rows": o.num_rows,
           "orders.keys": int(col(o, "o_orderkey").sum()),
           "orders.cents": int(torch.round(
               col(o, "o_totalprice") * 100).long().sum())}
    ref = refresh.totals(want)
    return [f"final {k}: {got[k]}, the reference's {ref[k]}"
            for k in ref if got[k] != ref[k]]


def mark_failed(records, errors, t_open) -> List[harness.Record]:
    """Each error as a failed query: of its stream and query where it has
    them (a completed one of that name turns failed), else of the
    refresh stream's record."""
    extra = harness.Record()
    for stream, name, text in errors:
        _say(f"refresh cell: {text}")
        rec = records[stream] if stream is not None else None
        hit = None if rec is None else next(
            (i for i, x in enumerate(rec.latencies)
             if x[0] == name and not x[3]), None)
        if hit is None:
            extra.latencies.append((name or "refresh", t_open, t_open, True))
            if len(extra.errors) < 5:
                extra.errors.append(text)
        else:
            q, t0, t1, _ = rec.latencies[hit]
            rec.latencies[hit] = (q, t0, t1, True)
            if len(rec.errors) < 5:
                rec.errors.append(text)
    return records + ([extra] if extra.latencies else [])
