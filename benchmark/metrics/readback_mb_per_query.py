"""Layer `operators`: megabytes (1e6 bytes) the program read back from
the card, the `bytes` of its `readback` spans
(arrow_tpu_torch.utils.trace.to_host) summed, over the traced window's
queries.  None where the window recorded no spans."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import spans
    except ImportError:               # a program without spans
        return None
    recorded = spans()
    if not recorded or t.queries == 0:
        return None
    return sum(s.attrs.get("bytes", 0) for s in recorded
               if s.name == "readback") / 1e6 / t.queries
