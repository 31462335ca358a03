"""Layer `storage`: the mean milliseconds of a committed transaction,
from its begin to the publish of its tables: the traced window's
`flightsql.transaction` spans whose `outcome` is commit
(arrow_tpu_torch.io.flightsql; in the refresh cell each is one RF1 or
RF2).  None where the window recorded no such span."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import spans
    except ImportError:               # a program without spans
        return None
    done = [s.end_ns - s.start_ns for s in spans()
            if s.name == "flightsql.transaction"
            and s.attrs.get("outcome") == "commit"]
    if not done:
        return None
    return sum(done) / len(done) / 1e6
