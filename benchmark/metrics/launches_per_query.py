"""Layer `sql`: CUDA kernels launched in the traced window over the
queries completed in it.  A count: it repeats for a seed."""


def read(t):
    if t.queries == 0:
        return None
    return sum(k == "kernel" for k in t.dev_kind) / t.queries
