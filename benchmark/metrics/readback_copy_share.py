"""Layer `operators`: the host's time copying device data into host
memory after the card's stream has drained, over the traced window's
seconds: each program `readback` span's duration less its `drain_ns`
(arrow_tpu_torch.utils.trace.to_host), summed.  None where the window
recorded no spans."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import spans
    except ImportError:               # a program without spans
        return None
    recorded = spans()
    if not recorded or t.window_s <= 0:
        return None
    return sum(s.end_ns - s.start_ns - s.attrs.get("drain_ns", 0)
               for s in recorded if s.name == "readback") / 1e9 / t.window_s
