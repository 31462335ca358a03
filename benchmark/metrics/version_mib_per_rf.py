"""Layer `storage`: MiB (2^20 bytes) of device memory the traced
window's writes wrote or allocated for their table versions, over its
committed transactions: the `bytes` of the `table.write` spans
(arrow_tpu_torch.storage: rows written into the buffers' spare room, new
live masks, grown buffers) summed, over the `flightsql.transaction` spans
whose `outcome` is commit.  A table made anew (CREATE TABLE ... AS, as
Q4's step) writes no bytes of its own.  None where the window committed
no transaction."""


def read(t):
    try:
        from arrow_tpu_torch.utils.trace import spans
    except ImportError:               # a program without spans
        return None
    recorded = spans()
    done = sum(s.name == "flightsql.transaction"
               and s.attrs.get("outcome") == "commit" for s in recorded)
    if not done:
        return None
    return sum(s.attrs.get("bytes", 0) for s in recorded
               if s.name == "table.write") / 2 ** 20 / done
