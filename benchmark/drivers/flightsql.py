"""The served driver: the tables resident on the card behind the port's
Flight SQL server (arrow_tpu_torch.io.flightsql.FlightSQLServer) in this
process, queried over localhost gRPC by as many client processes as the
mix has streams, each a closed loop (TPC-H's throughput test, clause
5.3.4).  The clients (drivers/flightsql_client.py) are fresh
interpreters that see no card and load neither JAX nor the program: an
answer is judged after a client that did not encode it has decoded it
from FlightData.  A query is complete when its client holds its answer.

The server must hold concurrent statements on one card: a program whose
FlightSQLServer has no statement gate cannot run this configuration,
and the driver refuses it at once."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import List

from .. import harness, program

ROOT = Path(__file__).resolve().parents[2]
CLIENT = "benchmark.drivers.flightsql_client"
QUIT_S = 10                 # a client's time to leave after "quit"


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool):
        from arrow_tpu_torch.io import flightsql
        if not hasattr(flightsql, "StatementGate"):
            raise SystemExit(
                "the program's FlightSQLServer has no statement gate: "
                "concurrent statements on one card would fail for its "
                "memory; this configuration needs it")
        self.mix, self.seed, self.device = mix, seed, device
        self.clients: List[subprocess.Popen] = []
        self.server = None

    def start(self) -> None:
        """The client processes, started while the tables are made."""
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in [os.environ.get(
                           "PYTHONPATH")] if p]))
        for _ in range(self.mix["streams"]):
            self.clients.append(subprocess.Popen(
                [sys.executable, "-m", CLIENT], cwd=ROOT, env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE))

    def _ask(self, client: subprocess.Popen, *msg) -> None:
        pickle.dump(msg, client.stdin)
        client.stdin.flush()

    def _answer(self, client: subprocess.Popen):
        try:
            kind, value = pickle.load(client.stdout)
        except EOFError:
            raise RuntimeError(f"a client left with code {client.wait()}") \
                from None
        if kind == "error":
            raise RuntimeError(f"a client failed: {value}")
        return value

    def setup(self, tables: dict) -> None:
        from arrow_tpu_torch.io.flightsql import FlightSQLServer
        self.server = FlightSQLServer("grpc://localhost:0",
                                      device=self.device)
        for name, table in program.port_tables(tables, self.device).items():
            self.server.register(name, table)
        for k, c in enumerate(self.clients):
            self._ask(c, "connect", self.server.uri, self.mix, self.seed, k)
            self._answer(c)
        for c in self.clients:          # one of each, one client at a time
            self._ask(c, "warm")
            self._answer(c)

    def window(self, seconds: float) -> List[harness.Record]:
        from arrow_tpu_torch.utils import trace
        reruns = trace.counters_snapshot().get("flightsql.reruns", 0)
        self.t_open = harness.now()
        for c in self.clients:
            self._ask(c, "window", self.t_open + seconds)
        records = [self._answer(c) for c in self.clients]
        _say(f"re-runs after an out-of-memory error in the window: "
             f"{trace.counters_snapshot().get('flightsql.reruns', 0) - reruns}")
        return records

    def close(self) -> None:
        """Stop the clients (none is left behind), then the server; the
        generator's tensors stay for the reference."""
        for c in self.clients:
            try:
                self._ask(c, "quit")
                c.stdin.close()
            except (OSError, ValueError):
                pass
        end = time.monotonic() + QUIT_S
        for c in self.clients:
            try:
                c.wait(max(end - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                c.kill()
                c.wait()
            c.stdout.close()
        self.clients = []
        if self.server is not None:
            self.server.shutdown()
            self.server = None
