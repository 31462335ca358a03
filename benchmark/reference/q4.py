"""TPC-H Q4: the quarter's orders that have a line received after its
commit date (the EXISTS subquery), counted by priority, in priority
order."""

from __future__ import annotations

import torch

from .common import day_range


def answer(tables, params, money_dtype=None):
    o, li = tables["orders"], tables["lineitem"]
    late = li["l_commitdate"].values < li["l_receiptdate"].values
    late_keys = torch.unique(li["l_orderkey"].values[late])
    okeys = o["o_orderkey"].values
    sel = day_range(o["o_orderdate"], params["DATE"], params["DATE_END"])
    sel &= torch.isin(okeys, late_keys)
    pr = o["o_orderpriority"]
    count = torch.bincount(pr.values.long()[sel],
                           minlength=len(pr.words)).tolist()
    rows = [{"o_orderpriority": w, "order_count": c}
            for w, c in zip(pr.words, count) if c > 0]
    rows.sort(key=lambda r: r["o_orderpriority"])
    return rows, len(rows)
