"""Layer `kernels`: K1 (kernels.compact.compact, csrc/compact.cu) at its
roofline: the bytes every K1 launch of the window needs, over the H100's
published HBM bandwidth, over K1's device time, in percent.  State it
beside the card's power limit.

The bytes, by the rule of chip_smoke.py's call sites: the mask read once,
and each kept row's bytes read once and written once, with its position
written where one is asked for."""

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, dense HBM3 peak (data sheet)
KERNEL = "compact_kernel"


def k1_bytes(rows: int, widths, kept: int, positions: int) -> int:
    return rows + kept * (2 * sum(widths) + positions)


def read(t):
    s = t.spies
    if s is None:
        return None
    calls = [c for c in s.k1 if c.launched]
    traced, seconds = t.kernels(KERNEL)
    if not calls or traced == 0 or seconds == 0:
        return None
    need = sum(k1_bytes(c.rows, c.widths, int(c.count), c.positions)
               for c in calls)
    # a trace that dropped some launches: the bytes of as many launches
    need *= traced / s.k1_launches
    return need / HBM_BYTES_PER_S / seconds * 100
