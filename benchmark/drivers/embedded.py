"""The embedded driver: the tables resident on the card, queried in this
process through arrow_tpu_torch.sql.execute_sql by one stream, a closed
loop (the power test's shape).  A query is complete when its answer is:
after torch.cuda.synchronize()."""

from __future__ import annotations

from typing import List

import torch

from .. import harness, program, traffic


class Driver:
    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool):
        self.mix, self.seed, self.device = mix, seed, device

    def start(self) -> None:
        """Work that overlaps the making of the tables: none here."""

    def setup(self, tables: dict) -> None:
        from arrow_tpu_torch.sql import execute_sql
        self.execute = execute_sql
        self.tables = program.port_tables(tables, self.device)
        warm = traffic.stream(self.mix, self.seed, 1_000_000)
        for _ in self.mix["queries"]:       # one of each, other parameters
            self.call(next(warm))

    def call(self, q: traffic.Query):
        out = program.run_query(self.execute, self.tables, q)
        program.sync(self.device)
        return out

    def window(self, seconds: float) -> List[harness.Record]:
        if self.mix["streams"] != 1:
            raise ValueError("the embedded driver runs one stream")
        rec = harness.Record()
        sampler = harness.Sampler(self.mix["sample"], self.seed, 0)
        queries = traffic.stream(self.mix, self.seed, 0)
        span = lambda name: torch.profiler.record_function(f"query {name}")
        self.t_open = harness.now()
        harness.run_stream(queries, self.t_open + seconds, self.call,
                           program.read_answer, sampler, rec, span)
        rec.samples = sampler.samples()
        return [rec]

    def close(self) -> None:
        """Drop the program's tables and whatever it holds; the
        generator's tensors stay for the reference."""
        self.tables = None
