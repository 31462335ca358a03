"""Layer `operators`: device time of the kernels launched under
aten::sort or aten::argsort (the profiler's op-to-kernel correlation,
the op or one around it on its thread) over all device time in the
traced window."""


def read(t):
    total = t.device_s()
    if total == 0:
        return None
    return sum(d for d, c in zip(t.dev_dur, t.dev_category)
               if c == "sort") / 1e9 / total
