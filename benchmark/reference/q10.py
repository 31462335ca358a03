"""TPC-H Q10: the 20 customers whose returned items of a quarter's orders
lost the most revenue, with their details."""

from __future__ import annotations

import torch

from .common import cents, day_range, exact, lookup, money, top_with_ties

LIMIT = 20


def answer(tables, params, money_dtype=None):
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    n = tables["nation"]
    okey = o["o_orderkey"].values
    osel = day_range(o["o_orderdate"], params["DATE"], params["DATE_END"])
    rf = li["l_returnflag"]
    row = lookup(okey, li["l_orderkey"].values)
    keep = (rf.values == rf.words.index("R")) & osel[row]
    cust = o["o_custkey"].values[row[keep]] - 1
    nc = c["c_custkey"].values.shape[0]
    if money_dtype is None:
        p, d = cents(li["l_extendedprice"]), cents(li["l_discount"])
        rev = torch.zeros(nc, dtype=torch.int64, device=okey.device) \
            .index_add_(0, cust, (p * (100 - d))[keep])
    else:
        p = money(li["l_extendedprice"], money_dtype)
        d = money(li["l_discount"], money_dtype)
        rev = torch.zeros(nc, dtype=money_dtype, device=okey.device) \
            .index_add_(0, cust, (p * (1 - d))[keep])
    groups = torch.unique(cust)
    order = groups[torch.argsort(-rev[groups], stable=True)]
    head = order[:4 * LIMIT]
    names = [w for w in n["n_name"].strings(torch.arange(
        n["n_name"].values.shape[0] - 1))]
    nation_of = c["c_nationkey"].values[head].tolist()
    text = {k: c[k].strings(head) for k in ("c_name", "c_address",
                                             "c_phone", "c_comment")}
    rows = []
    for j, i in enumerate(head.tolist()):
        rows.append({
            "c_custkey": int(c["c_custkey"].values[i]),
            "c_name": text["c_name"][j],
            "revenue": exact(int(rev[i]), 10 ** 4) if money_dtype is None
            else float(rev[i]),
            "c_acctbal": float(c["c_acctbal"].values[i]),
            "n_name": names[nation_of[j]],
            "c_address": text["c_address"][j],
            "c_phone": text["c_phone"][j],
            "c_comment": text["c_comment"][j]})
    return top_with_ties(rows, lambda x: -x["revenue"], LIMIT), \
        min(LIMIT, len(groups))
