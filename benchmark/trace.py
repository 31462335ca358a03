"""The traced run: torch.profiler (CPU ops and CUDA activity) over the
measured window, spies on the program's two kernel wrappers, and the
reduction of both into a `Trace` that the per-layer metric readers
(metrics/<name>.py) read.

Spans are the benchmark's own: `query <name>` around each query it
issues.  Nothing is added inside the program.  The spies replace
`kernels.compact.compact` and `kernels.groupagg.grouped_aggregate`
where the program's modules imported them, record what each call was
given (the sizes a roofline's bytes are counted from) and put the
originals back when the window closes; each wrapper's `launches`
counter says how many kernels those calls launched.
"""

from __future__ import annotations

import bisect
import heapq
import inspect
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

SORT_OPS = frozenset({"aten::sort", "aten::argsort"})
GATHER_OPS = frozenset({"aten::index", "aten::index_select", "aten::gather",
                        "aten::take", "aten::index_put_"})
NAME_CHARS = 120          # a kernel's name is cut to this in the breakdown


# ---- spies ----------------------------------------------------------------

@dataclass
class K1Call:
    rows: int                     # keep's length: the mask read once
    widths: List[int]             # bytes of a row of each array
    positions: int                # bytes of a position (0: none asked)
    count: torch.Tensor           # the kept count the kernel wrote
    launched: bool


@dataclass
class K2Call:
    tensors: List[tuple]          # (data_ptr, numel, element_size) read
    groups: int
    slots: int                    # sum and min/max columns: 2 slots each
    launched: bool


@dataclass
class Spies:
    k1: List[K1Call] = field(default_factory=list)
    k2: List[K2Call] = field(default_factory=list)
    k1_launches: int = 0
    k2_launches: int = 0


def _swap(real, fake) -> list:
    """Replace `real` by `fake` in every module of the program that
    imported it (its own module keeps it: the wrapper counts its
    launches there); the undo list."""
    done = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("arrow_tpu_torch.") or mod is None \
                or name == real.__module__:
            continue
        for attr, value in list(vars(mod).items()):
            if value is real:
                setattr(mod, attr, fake)
                done.append((mod, attr))
    return done


class spy_kernels:
    """Context manager: records every K1 and K2 call made inside it."""

    def __enter__(self) -> Spies:
        from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
        self.kc, self.kg = kc, kg
        self.out = Spies()
        real1, real2 = kc.compact, kg.grouped_aggregate
        sig1, sig2 = inspect.signature(real1), inspect.signature(real2)
        out = self.out

        def compact(*args, **kwargs):
            a = sig1.bind(*args, **kwargs)
            a.apply_defaults()
            keep, arrays = a.arguments["keep"], list(a.arguments["arrays"])
            outs, count = real1(keep, arrays, *[a.arguments[k] for k in (
                "out_cap", "positions")])
            pos = a.arguments["positions"]
            out.k1.append(K1Call(
                keep.numel(), [x.element_size() for x in arrays],
                0 if pos is None else pos.itemsize,
                count, keep.is_cuda))
            return outs, count

        def grouped_aggregate(*args, **kwargs):
            a = sig2.bind(*args, **kwargs)
            a.apply_defaults()
            p = a.arguments
            read = [p["codes"], p["codes_valid"]]
            for c in list(p["sum_cols"]) + list(p["mm_cols"]):
                read += [c.values, c.valid]
            out.k2.append(K2Call(
                [(t.data_ptr(), t.numel(), t.element_size())
                 for t in read if t is not None], int(p["num_groups"]),
                2 * (len(p["sum_cols"]) + len(p["mm_cols"])),
                p["codes"].is_cuda))
            return real2(*args, **kwargs)

        self.l1, self.l2 = kc.compact.launches, kg.grouped_aggregate.launches
        self.undo = _swap(real1, compact) + _swap(real2, grouped_aggregate)
        self.reals = {id(compact): real1, id(grouped_aggregate): real2}
        return out

    def __exit__(self, *exc):
        for mod, attr in self.undo:
            setattr(mod, attr, self.reals[id(getattr(mod, attr))])
        self.out.k1_launches = self.kc.compact.launches - self.l1
        self.out.k2_launches = self.kg.grouped_aggregate.launches - self.l2
        return False


# ---- the profile ----------------------------------------------------------

@dataclass
class Trace:
    """What a traced window holds, for the metric readers.  Times in
    seconds; device events as parallel lists."""
    window_s: float
    queries: int
    dev_name: List[str]
    dev_kind: List[str]           # kernel, gpu_memcpy, gpu_memset, ...
    dev_dur: List[int]            # ns
    dev_category: List[str]       # "sort", "gather" or "" by launching op
    busy_s: float
    idle_by_host_op: Dict[str, float]
    spies: Optional[Spies]

    def device_s(self, kinds=None) -> float:
        return sum(d for d, k in zip(self.dev_dur, self.dev_kind)
                   if kinds is None or k in kinds) / 1e9

    def kernels(self, substring: str):
        """(count, seconds) of the kernels whose name holds `substring`."""
        durs = [d for n, d, k in zip(self.dev_name, self.dev_dur,
                                     self.dev_kind)
                if k == "kernel" and substring in n]
        return len(durs), sum(durs) / 1e9


class Profile:
    """torch.profiler over CPU ops and CUDA activity, started and stopped
    around the window; `trace()` reduces the raw events."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.w0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.w1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def trace(self, queries: int, spies: Optional[Spies]) -> Trace:
        events = self.prof.profiler.kineto_results.events()
        w0, w1 = self.w0, self.w1
        ops = []                  # host: (start, end, name, thread, corr, link)
        dev = []                  # (start, dur, name, kind, linked corr)
        for e in events:
            start, dur = e.start_ns(), e.duration_ns()
            if start + dur < w0 or start > w1:
                continue
            if e.device_type() == torch.autograd.DeviceType.CPU:
                ops.append((start, start + dur, e.name(), e.start_thread_id(),
                            e.correlation_id(), e.linked_correlation_id()))
            else:
                dev.append((start, dur, e.name(), _device_kind(e.name()),
                            e.linked_correlation_id()))
        # a span's mirror on the device's timeline is no device work
        spans = {o[2] for o in ops if o[5] == 0}
        dev = [d for d in dev if d[2] not in spans]
        category = _op_categories(ops)
        dev.sort()
        busy, gaps = _busy_and_gaps(dev, w0, w1)
        return Trace(
            window_s=(w1 - w0) / 1e9, queries=queries,
            dev_name=[d[2] for d in dev], dev_kind=[d[3] for d in dev],
            dev_dur=[d[1] for d in dev],
            dev_category=[category.get(d[4], "") for d in dev],
            busy_s=busy / 1e9, idle_by_host_op=_name_gaps(gaps, ops),
            spies=spies)


def _device_kind(name: str) -> str:
    """kernel, gpu_memcpy or gpu_memset, by the name CUPTI gives."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _op_categories(ops) -> Dict[int, str]:
    """For each host op (by correlation id), "sort" or "gather" where it
    or the nearest op around it on its thread is one of SORT_OPS or
    GATHER_OPS, else ""."""
    out = {}
    by_thread = defaultdict(list)
    for o in ops:
        if o[5] == 0:             # ops and annotations, not runtime calls
            by_thread[o[3]].append(o)
    for evs in by_thread.values():
        evs.sort(key=lambda o: (o[0], -o[1]))
        stack = []                # (end, category)
        for start, end, name, _, corr, _ in evs:
            while stack and stack[-1][0] <= start:
                stack.pop()
            cat = "sort" if name in SORT_OPS else "gather" \
                if name in GATHER_OPS else (stack[-1][1] if stack else "")
            out[corr] = cat
            stack.append((end, cat))
    return out


def _busy_and_gaps(dev, w0: int, w1: int):
    """Nanoseconds in which some device event ran inside [w0, w1], and
    the idle gaps (start, end) between."""
    busy, gaps, at = 0, [], w0
    for start, dur, *_ in dev:
        a, b = max(start, at), min(start + dur, w1)
        if start > at:
            gaps.append((at, min(start, w1)))
        if b > a:
            busy += b - a
        at = max(at, start + dur)
        if at >= w1:
            break
    if at < w1:
        gaps.append((at, w1))
    return busy, gaps


def _name_gaps(gaps, ops) -> Dict[str, float]:
    """Idle seconds by the innermost host event running when each gap
    began (on any thread), or "(no host op)"."""
    ops = sorted(ops)
    starts = [o[0] for o in ops]
    out = defaultdict(float)
    heap = []                     # (-start, end, name): latest start on top
    i = 0
    for a, b in gaps:
        j = bisect.bisect_right(starts, a)
        for o in ops[i:j]:
            heapq.heappush(heap, (-o[0], o[1], o[2]))
        i = max(i, j)
        while heap and heap[0][1] <= a:
            heapq.heappop(heap)
        out[heap[0][2] if heap else "(no host op)"] += (b - a) / 1e9
    return dict(out)


def breakdown(t: Trace) -> dict:
    """The device operations that took most time and the idle gaps by
    what the host was doing, ten of each."""
    by_name = defaultdict(int)
    for n, d in zip(t.dev_name, t.dev_dur):
        by_name[n[:NAME_CHARS]] += d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(t.idle_by_host_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, d / 1e9] for n, d in top],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}
