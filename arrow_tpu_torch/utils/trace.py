"""Op timing, profiler traces and decision counters (counterpart of
arrow_tpu/utils/trace.py).

- `op_timer(name, sync=None, sink=None)`: times a block on the host
  clock.  PyTorch returns before the card finishes, so the block's end
  waits for the card first: the caller's `sync()` hook when given, else
  `torch.cuda.synchronize()` of the current card when one is present (a
  caller timing another card passes its own `sync`).
- `OpTimings`: a thread-safe accumulator (count, total and max per op);
  `timings` is the process's, `report()` its table.
- `trace(path)`: a torch.profiler run over the block (CPU and, with a
  card, CUDA activity), written to `path` as a Chrome trace, in place of
  the reference's jax.profiler.trace.
- `count`, `counters_snapshot`, `reset_counters`: named counters that
  make a silent plan choice observable.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

__all__ = ["OpTimings", "op_timer", "timings", "trace", "reset_timings",
           "count", "counters_snapshot", "reset_counters"]


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0


class OpTimings:
    """Per-op wall-time accumulator (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, _Stat] = {}

    def record(self, name: str, seconds: float):
        with self._lock:
            s = self._stats.setdefault(name, _Stat())
            s.count += 1
            s.total_s += seconds
            s.max_s = max(s.max_s, seconds)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {"count": v.count, "total_ms": v.total_s * 1e3,
                        "mean_ms": v.total_s / v.count * 1e3,
                        "max_ms": v.max_s * 1e3}
                    for k, v in self._stats.items()}

    def reset(self):
        with self._lock:
            self._stats.clear()

    def report(self) -> str:
        snap = sorted(self.snapshot().items(),
                      key=lambda kv: -kv[1]["total_ms"])
        lines = [f"{'op':<32}{'count':>8}{'total ms':>12}"
                 f"{'mean ms':>10}{'max ms':>10}"]
        for name, s in snap:
            lines.append(f"{name:<32}{s['count']:>8}"
                         f"{s['total_ms']:>12.2f}{s['mean_ms']:>10.3f}"
                         f"{s['max_ms']:>10.3f}")
        return "\n".join(lines)


timings = OpTimings()


def reset_timings():
    timings.reset()


@contextlib.contextmanager
def op_timer(name: str, sync: Optional[Callable] = None,
             sink: Optional[OpTimings] = None):
    """Time a block into `sink` (the global `timings` by default).  The
    block's end waits for its work: `sync()` when given, else the card's
    `torch.cuda.synchronize()` where there is a card."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        (sink or timings).record(name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(path: str):
    """A torch.profiler trace of the block, written to `path` as a
    Chrome trace (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


_counter_lock = threading.Lock()
_counters: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add n to a named counter (thread-safe)."""
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def counters_snapshot() -> Dict[str, int]:
    with _counter_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counter_lock:
        _counters.clear()
