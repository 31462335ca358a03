"""Layer `sql`: self time of the program's `sql.execute` spans over the
traced window's seconds: parse, bind, expression evaluation and eager
dispatch outside any operator, read, kernel or readback span.  The spans
are the program's own (arrow_tpu_torch.utils.trace), recorded while the
profiler collects; None where the window recorded none."""


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
               if s.name == "sql.execute") / 1e9 / t.window_s
