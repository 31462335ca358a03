"""What the drivers share: the record of a stream's window and the sample
of its answers that the reference judges."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

now = time.monotonic          # the clock of every latency and window bound


@dataclass
class Record:
    """One stream's window: (query, start, end, failed) per query in the
    order issued; the sampled answers as (query name, params, answer);
    the first errors' text."""
    latencies: List[Tuple[str, float, float, bool]] = field(
        default_factory=list)
    samples: List[Tuple[str, dict, object]] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)


class Sampler:
    """A uniform sample, drawn from the seed, of at most `k` answers of
    each query type (a reservoir): an answer is read back to the host
    only when it is kept, and a later pick may replace it."""

    def __init__(self, k: int, seed: int, stream: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed), int(stream), 0x5A])
        self.seen: Dict[str, int] = {}
        self.kept: Dict[str, list] = {}

    def offer(self, name: str, params: dict, read) -> None:
        """`read()` gives the answer in the comparison's form."""
        n = self.seen.get(name, 0) + 1
        self.seen[name] = n
        kept = self.kept.setdefault(name, [])
        if len(kept) < self.k:
            kept.append((name, params, read()))
            return
        j = int(self.rng.integers(n))
        if j < self.k:
            kept[j] = (name, params, read())

    def samples(self) -> list:
        return [s for kept in self.kept.values() for s in kept]


def run_stream(queries, deadline: float, call, read, sampler: Sampler,
               rec: Record, span=None) -> None:
    """A closed loop: issue the next query when the last is complete,
    until one completes at or after `deadline`.  `call(query)` returns
    the complete answer; `read(answer)` reads it for the comparison;
    `span(name)` is a context for the query's trace span."""
    import contextlib
    span = span or (lambda name: contextlib.nullcontext())
    while True:
        q = next(queries)
        t0 = now()
        out, failed = None, False
        try:
            with span(q.name):
                out = call(q)
        except Exception as e:        # a failed query counts, and is shown
            failed = True
            if len(rec.errors) < 5:
                rec.errors.append(f"{q.name}: {type(e).__name__}: {e}")
        t1 = now()
        rec.latencies.append((q.name, t0, t1, failed))
        if not failed:
            sampler.offer(q.name, q.params, lambda: read(out))
        del out
        if t1 >= deadline:
            return
