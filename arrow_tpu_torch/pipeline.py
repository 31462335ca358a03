"""The engine's flagship query on the port (counterpart of
__graft_entry__._pipeline / entry; BASELINE config 1, bench.py:90-169):

    WHERE x > t: sum(y * 2 + x), count(*)

on the compacting route: predicate -> filter_static_multi (one K1
launch for both columns) -> arithmetic -> reduction.

The sum is the query's: over the first `count` compacted rows.  The
reference sums all n slots of its full-length compaction and so adds the
rows the filter dropped (its comment "padding is zero by construction"
does not hold on either of its routes); see ROADMAP queue C.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import DeviceLike, resolve_device
from .core.column import PrimitiveColumn
from .core.table import Table
from .ops.aggregate import count, sum_
from .ops.arity import unary
from .ops.filter import filter_static_multi, filter_table
from .ops.numeric import add, mul
from . import dtypes as dt

__all__ = ["query", "query_table", "entry"]


def query(x: torch.Tensor, y: torch.Tensor, threshold
          ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Config-1 query over an int64 `x` and a float64 `y` on one device.

    Returns (sum, count, (x_compacted, y_compacted)): sum is a 0-d
    float64 tensor, count a 0-d int64 tensor, both on the device and
    unsynced; the compacted columns hold `count` real rows at the front.
    """
    keep = x > threshold
    (xf, yf), n = filter_static_multi(keep, x, y)
    z = yf * 2.0 + xf.to(torch.float64)
    live = torch.arange(z.shape[0], device=z.device) < n
    return torch.where(live, z, 0.0).sum(), n, (xf, yf)


def query_table(table: Table, threshold: int) -> Tuple[float, int]:
    """The same query through the Table API: filter_table, then
    mul / add on columns, then sum_ / count; returns (sum, count) on
    the host.  Columns "x" (int64) and "y" (float64).  The predicate and
    the int64 -> float64 widening of x are plain tensor expressions."""
    x = table.column("x")
    keep = PrimitiveColumn(x.values > threshold, dt.bool_, x.validity)
    kept = filter_table(table, keep)
    xf = unary(kept.column("x"), lambda v: v.to(torch.float64), dt.float64)
    z = add(mul(kept.column("y"), 2.0), xf)
    return sum_(z).as_py(), count(kept.column("x"))


def entry(device: DeviceLike, n: int = 1 << 20):
    """The inputs of __graft_entry__.entry() on `device`: `n` rows of
    x in [-1000, 1000) and y in [0, 1) from default_rng(0), t = 0.
    Returns (query, (x, y, t))."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int64))
    y = torch.from_numpy(rng.random(n))
    return query, (x.to(dev), y.to(dev), 0)
