"""Layer `operators`: self time of the program's `op.*` spans (join,
filter, group_by, sort, take) over the traced window's seconds: the
operators' host work outside their readback, kernel and nested operator
spans, host interning of text included.  The spans are the program's own
(arrow_tpu_torch.utils.trace), recorded while the profiler collects;
None where the window recorded none."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import self_ns, spans
    except ImportError:               # a program without spans
        return None
    recorded = spans()
    if not recorded or t.window_s <= 0:
        return None
    own = self_ns(recorded)
    return sum(own[s.id] for s in recorded
               if s.name.startswith("op.")) / 1e9 / t.window_s
