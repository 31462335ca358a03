"""Helpers of the plain reference."""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import torch


def cents(col) -> torch.Tensor:
    """A Float64 money column's integer cents (exact: every value is a
    whole number of cents over 100)."""
    return torch.round(col.values * 100).to(torch.int64)


def money(col, dtype: torch.dtype) -> torch.Tensor:
    return col.values.to(dtype)


def exact(total: int, scale: int) -> Fraction:
    return Fraction(int(total), scale)


def order_index(lo_key: torch.Tensor, hi_key: torch.Tensor) -> torch.Tensor:
    """Row order by hi_key, ties by lo_key (both ascending)."""
    first = torch.argsort(lo_key, stable=True)
    return first[torch.argsort(hi_key[first], stable=True)]


def top_with_ties(rows: List[dict], keys, k: int) -> List[dict]:
    """The first k of `rows` (already in order) and every later row whose
    sort key equals the k-th's: which of them a LIMIT keeps is
    unspecified."""
    if len(rows) <= k:
        return rows
    last = keys(rows[k - 1])
    out = rows[:k]
    for r in rows[k:]:
        if keys(r) != last:
            break
        out.append(r)
    return out


def lookup(okeys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Row of each key in the ascending unique `okeys` (every key is
    there)."""
    return torch.searchsorted(okeys, keys)


def day_range(col, lo: Optional[int], hi: Optional[int]) -> torch.Tensor:
    """lo <= day < hi (either bound may be None)."""
    v = col.values
    m = torch.ones_like(v, dtype=torch.bool)
    if lo is not None:
        m &= v >= lo
    if hi is not None:
        m &= v < hi
    return m
