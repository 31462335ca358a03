"""A client of the refreshed served configuration (drivers/flightsql_rf.py):
a query stream, as drivers/flightsql_client.py runs one, that also reads
the commit number each answer carries, or the refresh stream, which runs
TPC-H's RF1 and RF2 as Flight SQL transactions.  Like that client it
speaks Flight SQL through pyarrow.flight with its own encoding of the
commands, sees no card and loads neither JAX, the JAX package nor the
program.

    python -m benchmark.drivers.flightsql_rf_client

reads pickled requests on standard input and writes pickled replies on
standard output:

  ("connect", uri, mix, seed, stream, spec) -> ("ok", None); `spec` is
      None for a query stream, the refresh plan's (reference/refresh.py
      `plan`) for the refresh stream, which then makes its rows
  ("warm",)   a query stream: one query of each type, other parameters;
              the refresh stream: its warm pairs -> ("ok", reports)
  ("window", t_open, deadline, pairs)  a query stream: the closed loop
              until a query completes at or after `deadline`, each
              sampled answer as (snapshot, rows) -> ("record", Record);
              the refresh stream: `pairs` pairs, the k-th begun at
              t_open + first_s + k * every_s or when the one before
              commits, whichever is later -> ("reports", [...])
  ("final",)  a query stream: one query of each type, every answer
              sampled as (snapshot, rows) -> ("samples", [...])
  ("quit",) or the end of the input: exit.

A report is one refresh transaction's: its kind, when it began and
committed (time.monotonic), the counts its statements acknowledged, and
the counts read back after the commit with their snapshot.
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback

import pyarrow as pa
import pyarrow.flight as flight

from benchmark import harness, traffic
from benchmark.drivers.flightsql_client import (SQL_TYPES, Session,
                                                _bytes_field, _varint,
                                                broken, read_answer,
                                                record_count)

SNAPSHOT_KEY = b"arrow_tpu.snapshot"
TABLE_NOT_EXIST_FAIL, TABLE_EXISTS_APPEND = 2, 2
COMMIT, ROLLBACK = 1, 2


def _any(message: str, payload: bytes) -> bytes:
    return _bytes_field(1, (SQL_TYPES + message).encode()) + \
        _bytes_field(2, payload)


def _varint_field(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def snapshot(table: pa.Table) -> int:
    """The commit number an answer carries (-1 where it carries none)."""
    meta = table.schema.metadata or {}
    return int(meta.get(SNAPSHOT_KEY, b"-1"))


def read_stamped(table: pa.Table) -> tuple:
    return snapshot(table), read_answer(table)


def arrow_table(cols) -> pa.Table:
    """The generator's columns (tpch_gen.Col, on the CPU) as a pyarrow
    table of the types the served tables have."""
    out = {}
    for name, c in cols.items():
        v = c.values.numpy()
        n = len(v) - 1 if c.kind in ("utf8", "large_utf8") else len(v)
        if c.kind in ("int64", "int32", "float64"):
            out[name] = pa.array(v)
        elif c.kind == "date32":
            out[name] = pa.Array.from_buffers(pa.date32(), n,
                                              [None, pa.py_buffer(v)])
        elif c.kind == "dict":
            out[name] = pa.DictionaryArray.from_arrays(
                pa.array(v), pa.array(list(c.words), pa.utf8()))
        else:
            typ = pa.utf8() if c.kind == "utf8" else pa.large_utf8()
            out[name] = pa.Array.from_buffers(typ, n, [
                None, pa.py_buffer(v), pa.py_buffer(c.data.numpy())])
    return pa.table(out)


class RefreshSession(Session):
    """The refresh stream's connection: transactions, bulk ingest and
    DML carrying their id, and the read-backs."""

    def action(self, kind: str, body: bytes) -> list:
        return [r.body.to_pybytes() for r in self.client.do_action(
            flight.Action(kind, body))]

    def begin(self) -> bytes:
        (res,) = self.action("BeginTransaction",
                             _any("ActionBeginTransactionRequest", b""))
        # Any{type_url = 1, value = 2 {transaction_id = 1}}
        return _field(_field(res, 2), 1)

    def end(self, tid: bytes, how: int) -> None:
        self.action("EndTransaction", _any(
            "ActionEndTransactionRequest",
            _bytes_field(1, tid) + _varint_field(2, how)))

    def ingest(self, name: str, table: pa.Table, tid: bytes) -> int:
        options = _varint_field(1, TABLE_NOT_EXIST_FAIL) + \
            _varint_field(2, TABLE_EXISTS_APPEND)
        cmd = _any("CommandStatementIngest", _bytes_field(1, options)
                   + _bytes_field(2, name.encode()) + _bytes_field(6, tid))
        writer, reader = self.client.do_put(
            flight.FlightDescriptor.for_command(cmd), table.schema)
        writer.write_table(table)
        writer.done_writing()
        meta = reader.read()
        writer.close()
        return record_count(meta)

    def execute(self, sql: str, tid: bytes) -> int:
        cmd = _any("CommandStatementUpdate", _bytes_field(1, sql.encode())
                   + _bytes_field(2, tid))
        writer, reader = self.client.do_put(
            flight.FlightDescriptor.for_command(cmd), pa.schema([]))
        writer.done_writing()
        meta = reader.read()
        writer.close()
        return record_count(meta)

    def counts(self, keys: str) -> tuple:
        """(snapshot, orders, lineitem rows) of the order keys `keys`."""
        o = self.query(f"SELECT COUNT(*) AS n FROM orders WHERE o_orderkey "
                       f"IN ({keys})")
        li = self.query(f"SELECT COUNT(*) AS n FROM lineitem WHERE "
                        f"l_orderkey IN ({keys})")
        return (min(snapshot(o), snapshot(li)), o.column(0)[0].as_py(),
                li.column(0)[0].as_py())

    def refresh(self, r) -> dict:
        """One transaction of the plan, then its read-back."""
        keys = ", ".join(map(str, r.keys.tolist()))
        t0 = harness.now()
        tid = self.begin()
        if r.kind == "RF1":
            done = [self.ingest("orders", r.orders_arrow, tid),
                    self.ingest("lineitem", r.lineitem_arrow, tid)]
        else:
            done = [self.execute(f"DELETE FROM lineitem WHERE l_orderkey IN "
                                 f"({keys})", tid),
                    self.execute(f"DELETE FROM orders WHERE o_orderkey IN "
                                 f"({keys})", tid)]
        self.end(tid, COMMIT)
        t1 = harness.now()
        snap, orders, lines = self.counts(keys)
        return {"kind": r.kind, "begin": t0, "commit": t1,
                "acknowledged": done, "read": [orders, lines],
                "snapshot": snap}


def _field(buf: bytes, number: int) -> bytes:
    """The first length-delimited field `number` of a protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        if key & 7 == 2:
            n, i = _read_varint(buf, i)
            if key >> 3 == number:
                return buf[i:i + n]
            i += n
        elif key & 7 == 0:
            _, i = _read_varint(buf, i)
        else:
            raise ValueError(f"wire type {key & 7}")
    return b""


def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def serve(inp, out) -> int:
    def reply(*msg):
        pickle.dump(msg, out)
        out.flush()

    session = mix = seed = txns = None
    while True:
        try:
            msg = pickle.load(inp)
        except EOFError:
            msg = ("quit",)
        why = broken()
        if why:
            reply("error", why)
            return 3
        try:
            if msg[0] == "quit":
                if session is not None:
                    session.close()
                return 0
            if msg[0] == "connect":
                uri, mix, seed, stream, spec = msg[1:]
                if spec is None:
                    session = Session(uri, stream)
                else:
                    from benchmark.reference import refresh
                    session = RefreshSession(uri, stream)
                    txns = refresh.plan(spec)
                    for r in txns:
                        if r.kind == "RF1":
                            r.orders_arrow = arrow_table(r.orders)
                            r.lineitem_arrow = arrow_table(r.lineitem)
                    warm = 2 * mix["refresh"]["warm_pairs"]
                    txns, ahead = txns[warm:], txns[:warm]
                    txns = (ahead, txns)
                reply("ok", None)
            elif msg[0] == "warm":
                if txns is None:
                    warm = traffic.stream(mix, seed,
                                          1_000_000 + session.stream)
                    for _ in mix["queries"]:
                        session.call(next(warm))
                    reply("ok", None)
                else:
                    reply("ok", [session.refresh(r) for r in txns[0]])
            elif msg[0] == "window":
                t_open, deadline, pairs = msg[1:]
                if txns is None:
                    rec = harness.Record()
                    sampler = harness.Sampler(mix["sample"], seed,
                                              session.stream)
                    harness.run_stream(
                        traffic.stream(mix, seed, session.stream), deadline,
                        session.call, read_stamped, sampler, rec)
                    rec.samples = sampler.samples()
                    reply("record", rec)
                else:
                    pace = mix["refresh"]
                    reports = []
                    for k in range(pairs):
                        at = t_open + pace["first_s"] + k * pace["every_s"]
                        wait = at - harness.now()
                        if wait > 0:
                            time.sleep(wait)
                        for r in txns[1][2 * k:2 * k + 2]:
                            reports.append(session.refresh(r))
                    reply("reports", reports)
            elif msg[0] == "final":
                final = traffic.stream(mix, seed, 2_000_000 + session.stream)
                samples = []
                for _ in mix["queries"]:
                    q = next(final)
                    samples.append((q.name, q.params,
                                    read_stamped(session.call(q))))
                reply("samples", samples)
            else:
                reply("error", f"unknown request {msg[0]!r}")
        except Exception:              # noqa: BLE001 -- the driver shows it
            reply("error", traceback.format_exc())


def main() -> int:
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)                    # stray prints stay off the replies
    sys.stdout = sys.stderr
    return serve(sys.stdin.buffer, out)


if __name__ == "__main__":
    sys.exit(main())
