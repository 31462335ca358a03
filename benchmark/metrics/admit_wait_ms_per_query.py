"""Layer `service`: milliseconds a query of its statements' waits at the
Flight SQL server's statement gate: the `server.admit` spans
(arrow_tpu_torch.io.flightsql.StatementGate), summed over the traced
window and over its queries.  None where the window recorded no
`flightsql.statement` span."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import spans
    except ImportError:               # a program without spans
        return None
    recorded = spans()
    if t.queries == 0 or not any(s.name == "flightsql.statement"
                                 for s in recorded):
        return None
    return sum(s.end_ns - s.start_ns for s in recorded
               if s.name == "server.admit") / 1e6 / t.queries
