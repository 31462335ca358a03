"""The comparison that decides `correct`: a program's answer against the
reference's.

An answer is a list of rows.  It has as many rows as the reference says
it must; each row matches a distinct reference row by the `match`
columns; every column not in `floats` is equal exactly; the rows' sort keys, read off the matched reference rows,
come in the reference's order (rows whose sort keys tie may come in any
order, and a LIMIT may keep any of them).  Float columns are judged by
their relative gap from the reference's exact value, the widest over an
answer.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple


def rel_gap(got, want) -> float:
    """|got - want| / |want| (|got| where want is 0), exactly."""
    if got is None:
        return float("inf")
    g, w = Fraction(got), Fraction(want)
    return float(abs(g - w) / abs(w)) if w != 0 else float(abs(g))


def _sort_key(spec: dict, row: dict):
    return tuple(-row[c[1:]] if c.startswith("-") else row[c]
                 for c in spec["sort"])


def compare(got: List[dict], want: List[dict], k: int,
                 spec: dict) -> Tuple[Optional[str], float]:
    """(what differs, or None; the widest float gap)."""
    floats = set(spec["floats"])
    gap = 0.0
    if len(got) != k:
        return f"{len(got)} rows, not {k}", gap
    by_key = {tuple(r[c] for c in spec["match"]): r for r in want}
    used = set()
    matched = []
    for i, row in enumerate(got):
        key = tuple(row.get(c) for c in spec["match"])
        ref = by_key.get(key)
        if ref is None or key in used:
            return f"row {i} key {key!r} is not the reference's", gap
        used.add(key)
        matched.append(ref)
        if set(row) != set(ref):
            return f"row {i} has columns {sorted(row)}", gap
        for c, v in ref.items():
            if c in floats:
                gap = max(gap, rel_gap(row[c], v))
            elif row[c] != v:
                return f"row {i} {c} {row[c]!r} against {v!r}", gap
    if [_sort_key(spec, r) for r in matched] != \
            [_sort_key(spec, r) for r in want[:k]]:
        return "rows out of the reference's order", gap
    return None, gap
