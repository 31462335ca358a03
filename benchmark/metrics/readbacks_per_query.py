"""Layer `sql`: device-to-host copies in the traced window over the
queries completed in it: the host syncs an eager plan makes to size its
next step."""


def read(t):
    if t.queries == 0:
        return None
    n = sum(k == "gpu_memcpy" and "DtoH" in name
            for name, k in zip(t.dev_name, t.dev_kind))
    return n / t.queries
