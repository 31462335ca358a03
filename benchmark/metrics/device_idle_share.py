"""Layer `device`: 1 less the union of the device's activity intervals
over the traced window."""


def read(t):
    if t.window_s <= 0:
        return None
    return 1 - t.busy_s / t.window_s
