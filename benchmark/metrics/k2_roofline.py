"""Layer `kernels`: K2 (kernels.groupagg.grouped_aggregate,
csrc/groupagg.cu) at its roofline: the bytes every K2 call of the window
needs, over the H100's published HBM bandwidth, over K2's device time, in
percent.  Only Q4 launches it.

The bytes, by the rule of chip_smoke.py's call sites: the key, its
validity and every value and validity column read once (each distinct
tensor once), and 8 bytes for each of a group's two slots per column
written once."""

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, dense HBM3 peak (data sheet)
KERNEL = "groupagg_kernel"


def k2_bytes(tensors, groups: int, slots: int) -> int:
    distinct = {(p, n): n * size for p, n, size in tensors}
    return sum(distinct.values()) + 8 * groups * slots


def read(t):
    s = t.spies
    if s is None:
        return None
    calls = [c for c in s.k2 if c.launched]
    traced, seconds = t.kernels(KERNEL)
    if not calls or traced == 0 or seconds == 0:
        return None
    need = sum(k2_bytes(c.tensors, c.groups, c.slots) for c in calls)
    need *= traced / s.k2_launches
    return need / HBM_BYTES_PER_S / seconds * 100
