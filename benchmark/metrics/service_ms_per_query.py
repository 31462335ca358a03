"""Layer `service`: milliseconds a query of the Flight SQL server's own
host work: the self time of its `flightsql.statement` and `flight.encode`
spans (arrow_tpu_torch.io.flightsql, io/flight.py), outside their
children (`sql.execute`, `server.admit`, `readback`), summed over the
traced window and over its queries.  None where the window recorded no
such span."""

SERVICE = ("flightsql.statement", "flight.encode")


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import self_ns, spans
    except ImportError:               # a program without spans
        return None
    recorded = spans()
    served = [s for s in recorded if s.name in SERVICE]
    if not served or t.queries == 0:
        return None
    own = self_ns(recorded)
    return sum(own[s.id] for s in served) / 1e6 / t.queries
