"""Op timing, spans, profiler traces and decision counters (counterpart
of arrow_tpu/utils/trace.py; the spans and `to_host` are the port's own).

- `op_timer(name, sync=None, sink=None)`: times a block on the host
  clock.  PyTorch returns before the card finishes, so the block's end
  waits for the card first: the caller's `sync()` hook when given, else
  `torch.cuda.synchronize()` of the current card when one is present (a
  caller timing another card passes its own `sync`).  Because it syncs,
  it stays off the query path: tools and chip_smoke.py time with it.
- `OpTimings`: a thread-safe accumulator (count, total and max per op);
  `timings` is the process's, `report()` its table.
- `span(name, **attrs)`: a span of the program's work, recorded only
  inside `recording()` or while torch.profiler collects (off, the cost
  is a flag check).  A recorded span keeps its name, start and end
  (`time.time_ns()`, the clock torch.profiler's events are read
  against), id, parent, root (the outermost span, the SQL statement),
  thread and attributes, in memory until `reset_spans()`, and opens a
  `torch.profiler.record_function` of its name, so it sits on the
  profiler's timeline beside the device's work.  The query path opens
  `sql.execute`, `op.join`, `op.filter`, `op.group_by`, `op.sort`,
  `op.take`, `strings.encode` (a string column's dictionary encode: its
  `rows`, `distinct` values and refinement `passes`, 0 on the host),
  `kernel.k1`, `kernel.k2` and `readback`; `annotate` adds a plan choice
  to the open operator span (and to `sql.execute` the columns its tables
  hold and the columns it reads).  `spans()` reads them,
  `self_ns` gives each its self time (its duration less what its
  children cover), `span_report()` the table by name.
- `to_host(what, tensor)`: every device-to-host read of the query path,
  the tensor on the CPU.  Recorded, it is a `readback` span with the
  read's `site`, `bytes` and `drain_ns` (the time the host waited for
  the card's stream before the copy).  `guard=True` marks a read that a
  pipeline `fuse` captures cannot make: inside one it raises.
- `trace(path)`: a torch.profiler run over the block (CPU and, with a
  card, CUDA activity), written to `path` as a Chrome trace, in place of
  the reference's jax.profiler.trace; the spans recorded inside show on
  it by name.
- `record(name, start_ns, **attrs)`: a span that began on an earlier
  call, closed now (a Flight SQL transaction).
- `count`, `counters_snapshot`, `reset_counters`: named counters that
  make a silent plan choice observable.

An operator turns the spans on around the work it wants to see:

    with trace.recording():
        execute_sql(tables, query)
    print(trace.span_report())
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.autograd import profiler as _profiler

from ..config import in_fused_region

__all__ = ["OpTimings", "op_timer", "timings", "trace", "reset_timings",
           "count", "counters_snapshot", "reset_counters", "Span", "span",
           "annotate", "recording", "spans", "reset_spans", "self_ns",
           "span_report", "to_host", "record"]


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


# ---- spans -----------------------------------------------------------------

@dataclass(slots=True)
class Span:
    """One recorded span; times in ns of `time.time_ns()`, `parent` and
    `root` by id (`root` is the span's own id when it has no parent)."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int
    attrs: dict


_recording = 0                   # depth of recording() blocks
_recording_lock = threading.Lock()
_spans: List[Span] = []          # closed spans, in closing order
_ids = itertools.count(1)
_open = threading.local()        # this thread's stack of open spans


def _on() -> bool:
    return _recording > 0 or _profiler._is_profiler_enabled


def _stack() -> List[Span]:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


_OFF = contextlib.nullcontext()  # what `span` gives when nothing records


class _Recorded:
    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        stack = _stack()
        up = stack[-1] if stack else None
        sid = next(_ids)
        s = Span(self.name, time.time_ns(), 0, sid,
                 None if up is None else up.id,
                 sid if up is None else up.root, threading.get_ident(),
                 self.attrs)
        stack.append(s)
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return s

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        s = _stack().pop()
        s.end_ns = time.time_ns()
        _spans.append(s)
        return False


def span(name: str, **attrs):
    """A context for a span of the program's work (see the module's
    docstring); enters to the recorded Span, or to None when off."""
    if not _on():
        return _OFF
    return _Recorded(name, attrs)


def record(name: str, start_ns: int, **attrs) -> None:
    """Close a span begun at `start_ns` by an earlier call (a Flight SQL
    transaction, from its begin to its end), as a root span of this
    thread, when spans record.  It opens no record_function."""
    if not _on():
        return
    sid = next(_ids)
    _spans.append(Span(name, start_ns, time.time_ns(), sid, None, sid,
                       threading.get_ident(), attrs))


def annotate(name: str, **attrs) -> None:
    """Add attributes to this thread's innermost open span when it is
    named `name`; an attribute already set keeps its value (the first
    plan an operator chooses is the one it reports)."""
    if not _on():
        return
    stack = _stack()
    if stack and stack[-1].name == name:
        for k, v in attrs.items():
            stack[-1].attrs.setdefault(k, v)


@contextlib.contextmanager
def recording():
    """Record spans inside the block (as torch.profiler's collection
    does)."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def spans() -> List[Span]:
    """The spans recorded since the last `reset_spans()`, in the order
    they closed (children before their parent)."""
    return list(_spans)


def reset_spans() -> None:
    _spans.clear()


def self_ns(recorded: Sequence[Span]) -> Dict[int, int]:
    """Each span's self time by id: its duration less the union of its
    children's intervals within it."""
    kids: Dict[int, list] = {}
    for s in recorded:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in recorded:
        covered, at = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, at), min(b, s.end_ns)
            if b > a:
                covered += b - a
                at = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def span_report(recorded: Optional[Sequence[Span]] = None) -> str:
    """The recorded spans by name: calls, total and self ms, and the MB
    their `bytes` attributes add up to, largest total first."""
    recorded = spans() if recorded is None else recorded
    own = self_ns(recorded)
    rows: Dict[str, list] = {}
    for s in recorded:
        r = rows.setdefault(s.name, [0, 0, 0, 0])
        r[0] += 1
        r[1] += s.end_ns - s.start_ns
        r[2] += own[s.id]
        r[3] += s.attrs.get("bytes", 0)
    lines = [f"{'span':<32}{'calls':>8}{'total ms':>12}{'self ms':>12}"
             f"{'MB':>12}"]
    for name, (n, total, mine, nbytes) in sorted(
            rows.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<32}{n:>8}{total / 1e6:>12.2f}"
                     f"{mine / 1e6:>12.2f}{nbytes / 1e6:>12.3f}")
    return "\n".join(lines)


def to_host(what: str, tensor: torch.Tensor, *,
            guard: bool = False) -> torch.Tensor:
    """`tensor` on the CPU: the one way the query path reads device
    values on the host (`what` names the site).  With `guard`, inside a
    pipeline `fuse` captures (config.in_fused_region) it raises instead:
    the read could not run in the capture (the reference's jit refuses
    the same reads).  Recorded, the read is a `readback` span: `site`,
    `bytes` (elements x item size) and `drain_ns`, the wait for the
    card's stream before the copy, so a copy's own time is the span's
    less `drain_ns`."""
    if guard and in_fused_region():
        raise RuntimeError(
            f"arrow_tpu_torch.fuse: {what} reads a device value on the "
            "host, which a captured pipeline cannot do; call it eagerly "
            "between fused stages")
    if not _on():
        return tensor.cpu()
    with _Recorded("readback", {
            "site": what,
            "bytes": tensor.numel() * tensor.element_size()}) as s:
        t0 = time.time_ns()
        if tensor.is_cuda:
            torch.cuda.current_stream(tensor.device).synchronize()
        s.attrs["drain_ns"] = time.time_ns() - t0
        return tensor.cpu()
