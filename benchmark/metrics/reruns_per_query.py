"""Layer `service`: statements run again alone after a
torch.cuda.OutOfMemoryError, per query: the `runs` of the traced
window's `flightsql.statement` spans (arrow_tpu_torch.io.flightsql.
StatementGate) less one each, summed over the queries.  None where the
window recorded no such span."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import spans
    except ImportError:               # a program without spans
        return None
    runs = [s.attrs.get("runs", 1) for s in spans()
            if s.name == "flightsql.statement"]
    if not runs or t.queries == 0:
        return None
    return sum(r - 1 for r in runs) / t.queries
