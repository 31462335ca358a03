"""A client of the served configuration: one process a query stream,
speaking Flight SQL to the port's server through pyarrow.flight, with
its own encoding of the commands and pyarrow's decoding of the answers
(nothing of the program's codecs).  It sees no card and loads neither
JAX, the JAX package nor the program; it checks this and exits with 3
where it is not so.

Run by drivers/flightsql.py as

    python -m benchmark.drivers.flightsql_client

it reads pickled requests on standard input and writes pickled replies
on standard output (its own prints go to standard error):

  ("connect", uri, mix, seed, stream)  -> ("ok", None)
  ("warm",)      one query of each type, other parameters -> ("ok", None)
  ("window", deadline)  the closed loop until a query completes at or
                 after `deadline` (time.monotonic, the system's clock)
                 -> ("record", harness.Record)
  ("quit",) or the end of the input: exit.

A failure is replied as ("error", text).
"""

from __future__ import annotations

import os
import pickle
import re
import sys
import traceback

import pyarrow as pa
import pyarrow.flight as flight

from benchmark import harness, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "arrow_tpu", "arrow_tpu_torch")
SQL_TYPES = "type.googleapis.com/arrow.flight.protocol.sql."


# ---- Flight SQL commands, by FlightSql.proto's field numbers ---------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(number: int, value: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(value)) + value


def command(message: str, query: str) -> bytes:
    """google.protobuf.Any{type_url, value} of `message`{query = 1}:
    CommandStatementQuery or CommandStatementUpdate."""
    return _bytes_field(1, (SQL_TYPES + message).encode()) + _bytes_field(
        2, _bytes_field(1, query.encode()))


def record_count(meta) -> int:
    """DoPutUpdateResult{record_count = 1} from a PutResult's metadata."""
    raw = b"" if meta is None else meta.to_pybytes()
    if not raw or raw[0] != 1 << 3:
        return 0
    n, shift = 0, 0
    for b in raw[1:]:
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    return n - (1 << 64) if n >= 1 << 63 else n


# ---- a stream's session -------------------------------------------------------

def read_answer(table: pa.Table) -> list:
    """A decoded answer as the comparison takes it: rows of dicts, dates
    as day numbers, dictionaries decoded."""
    cols = []
    for col in table.columns:
        if pa.types.is_date32(col.type):
            col = col.cast(pa.int32())
        cols.append(col.to_pylist())
    return [dict(zip(table.column_names, r)) for r in zip(*cols)]


class Session:
    """Stream `stream`'s connection.  A query runs as Flight SQL runs it:
    GetFlightInfo of a CommandStatementQuery, then DoGet of its ticket;
    a step (Q4's first statement) as `CREATE TABLE <into>_s<stream> AS
    ...` through a CommandStatementUpdate, the query on that name, and
    `DROP TABLE` after."""

    def __init__(self, uri: str, stream: int):
        self.client = flight.connect(uri)
        self.stream = stream

    def query(self, sql: str) -> pa.Table:
        info = self.client.get_flight_info(flight.FlightDescriptor
                                           .for_command(command(
                                               "CommandStatementQuery", sql)))
        return self.client.do_get(info.endpoints[0].ticket).read_all()

    def update(self, sql: str) -> int:
        writer, reader = self.client.do_put(
            flight.FlightDescriptor.for_command(command(
                "CommandStatementUpdate", sql)), pa.schema([]))
        writer.done_writing()
        meta = reader.read()
        writer.close()
        return record_count(meta)

    def call(self, q: traffic.Query) -> pa.Table:
        names = {into: f"{into}_s{self.stream}" for into, _ in q.steps}

        def own(sql: str) -> str:
            for into, name in names.items():
                sql = re.sub(rf"\b{into}\b", name, sql)
            return sql
        made = []
        try:
            for into, sql in q.steps:
                self.update(f"CREATE TABLE {names[into]} AS {own(sql)}")
                made.append(names[into])
            return self.query(own(q.sql))
        finally:
            for name in made:
                self.update(f"DROP TABLE {name}")

    def close(self) -> None:
        self.client.close()


# ---- the process ------------------------------------------------------------

def broken() -> str:
    """Why this process may not serve as a client, or ""."""
    if os.environ.get("CUDA_VISIBLE_DEVICES") != "":
        return "CUDA_VISIBLE_DEVICES is not empty: the client could see a card"
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    return f"modules that must not load were loaded: {loaded}" if loaded \
        else ""


def serve(inp, out) -> int:
    def reply(*msg):
        pickle.dump(msg, out)
        out.flush()

    session = mix = seed = None
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
                uri, mix, seed, stream = msg[1:]
                session = Session(uri, stream)
                reply("ok", None)
            elif msg[0] == "warm":
                warm = traffic.stream(mix, seed, 1_000_000 + session.stream)
                for _ in mix["queries"]:
                    session.call(next(warm))
                reply("ok", None)
            elif msg[0] == "window":
                rec = harness.Record()
                sampler = harness.Sampler(mix["sample"], seed,
                                          session.stream)
                harness.run_stream(traffic.stream(mix, seed, session.stream),
                                   msg[1], session.call, read_answer,
                                   sampler, rec)
                rec.samples = sampler.samples()
                reply("record", rec)
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
