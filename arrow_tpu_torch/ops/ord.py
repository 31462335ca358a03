"""Dynamic comparators (counterpart of arrow_tpu/ops/ord.py:23-88;
arrow-ord/src/ord.rs:28 make_comparator).

`make_comparator(a, b, options)` returns cmp(i, j) in {-1, 0, 1}, the
order of a[i] against b[j] under SortOptions.  Each row becomes a pair
of u64 keys (its null class, then its `encode_value_key`, inverted when
descending and 0 at nulls), computed on the device over the
concatenation of both arrays -- dictionary, string and host ranks agree
only when they come from one pass over both -- and pulled to the host
once.  Lists, structs, maps, fixed-size lists and binaries and
interval[month_day_nano] compare by their comparator ranks
(row_format.host_ranks).  Floats compare by their IEEE total order
(-0.0 below +0.0), as encode_value_key orders them.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..core.column import Column, PrimitiveColumn
from .concat import concat
from .row_format import (SortOptions, _host_rankable, encode_value_key,
                         host_ranks)

__all__ = ["make_comparator", "make_lexicographic_comparator"]


def _key_rows(col: Column, opt: SortOptions) -> List[Tuple[int, int]]:
    """(null class, value key) per row as Python ints, the keys' u64
    order being the row order (ord.py:27-38: the null class is always
    present; a run-end or union column, which has no validity, raises
    TypeError as in the reference)."""
    if col.validity is None:
        col = col.with_validity(torch.ones(len(col), dtype=torch.bool,
                                           device=col.device))
    key, validity = encode_value_key(col)
    if opt.descending:
        key = ~key
    cls = validity if opt.nulls_first else ~validity
    key = torch.where(validity, key, 0)
    u = torch.stack([cls.to(torch.int64), key], 1).cpu().numpy() \
        .view(np.uint64)
    return [tuple(r) for r in u.tolist()]


def make_comparator(a: Column, b: Column,
                    options: SortOptions = SortOptions()
                    ) -> Callable[[int, int], int]:
    """cmp(i, j): the order of a[i] against b[j] (ord.rs:28)."""
    if a.dtype != b.dtype:
        raise TypeError(f"comparator type mismatch {a.dtype} vs {b.dtype}")
    both = concat([a, b])
    if _host_rankable(a):
        ranks, _, validity = host_ranks(both, options)
        both = PrimitiveColumn(ranks.to(torch.int32), dt.uint32, validity)
    rows = _key_rows(both, options)
    ka, kb = rows[:len(a)], rows[len(a):]

    def cmp(i: int, j: int) -> int:
        x, y = ka[i], kb[j]
        return (x > y) - (x < y)

    return cmp


def make_lexicographic_comparator(
        left: Sequence[Column], right: Sequence[Column],
        options: Sequence[SortOptions]) -> Callable[[int, int], int]:
    """Multi-column comparator (LexicographicalComparator, sort.rs:865),
    over two batches."""
    cmps = [make_comparator(a, b, o)
            for a, b, o in zip(left, right, options)]

    def cmp(i: int, j: int) -> int:
        for c in cmps:
            r = c(i, j)
            if r:
                return r
        return 0

    return cmp
