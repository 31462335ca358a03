"""TPC-H Q3: the 10 unshipped orders of a market segment with the highest
revenue, by revenue (descending) and order date."""

from __future__ import annotations

import torch

from .common import cents, exact, lookup, money, order_index, top_with_ties

LIMIT = 10


def answer(tables, params, money_dtype=None):
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    seg = c["c_mktsegment"]
    in_segment = seg.values == seg.words.index(params["SEGMENT"])
    okey, odate = o["o_orderkey"].values, o["o_orderdate"].values
    osel = (odate < params["DATE"]) & in_segment[o["o_custkey"].values - 1]
    row = lookup(okey, li["l_orderkey"].values)
    keep = (li["l_shipdate"].values > params["DATE"]) & osel[row]
    r = row[keep]
    if money_dtype is None:
        p, d = cents(li["l_extendedprice"]), cents(li["l_discount"])
        rev = torch.zeros(okey.shape[0], dtype=torch.int64,
                          device=okey.device).index_add_(
            0, r, (p * (100 - d))[keep])
    else:
        p = money(li["l_extendedprice"], money_dtype)
        d = money(li["l_discount"], money_dtype)
        rev = torch.zeros(okey.shape[0], dtype=money_dtype,
                          device=okey.device).index_add_(
            0, r, (p * (1 - d))[keep])
    groups = torch.unique(r)
    g_rev, g_date = rev[groups], odate[groups]
    order = groups[order_index(g_date, -g_rev)]
    head = order[:4 * LIMIT].tolist()
    rows = [{"l_orderkey": int(okey[i]),
             "revenue": exact(int(rev[i]), 10 ** 4) if money_dtype is None
             else float(rev[i]),
             "o_orderdate": int(odate[i]),
             "o_shippriority": int(o["o_shippriority"].values[i])}
            for i in head]
    key = lambda x: (-x["revenue"], x["o_orderdate"])
    return top_with_ties(rows, key, LIMIT), min(LIMIT, len(groups))
