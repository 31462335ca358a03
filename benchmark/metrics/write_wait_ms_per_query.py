"""Layer `storage`: milliseconds a query that writers waited for tables'
write locks: the `wait_ns` of the traced window's `table.publish` spans
(arrow_tpu_torch.io.flightsql: each write's or transaction's wait for
the locks of the tables it writes) summed, over the window's queries.
None where the window published nothing."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import spans
    except ImportError:               # a program without spans
        return None
    waits = [s.attrs.get("wait_ns", 0) for s in spans()
             if s.name == "table.publish"]
    if not waits or t.queries == 0:
        return None
    return sum(waits) / 1e6 / t.queries
