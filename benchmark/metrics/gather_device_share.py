"""Layer `operators`: device time of the kernels launched under
aten::index, index_select, gather, take or index_put_ over all device
time in the traced window."""


def read(t):
    total = t.device_s()
    if total == 0:
        return None
    return sum(d for d, c in zip(t.dev_dur, t.dev_category)
               if c == "gather") / 1e9 / total
