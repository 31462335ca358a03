"""TPC-H Q1: lineitem shipped by the cut date, summed by return flag and
line status, in flag and status order."""

from __future__ import annotations

import torch

from .common import cents, exact, money


def answer(tables, params, money_dtype=None):
    li = tables["lineitem"]
    sel = li["l_shipdate"].values <= params["SHIPDATE_MAX"]
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    group = (rf.values.long() * len(ls.words) + ls.values.long())[sel]
    ng = len(rf.words) * len(ls.words)
    count = torch.bincount(group, minlength=ng).tolist()
    if money_dtype is None:
        q = cents(li["l_quantity"])[sel]
        p = cents(li["l_extendedprice"])[sel]
        d = cents(li["l_discount"])[sel]
        t = cents(li["l_tax"])[sel]
        dp = p * (100 - d)
        terms = {"sum_qty": (q, 100), "sum_base_price": (p, 100),
                 "sum_disc_price": (dp, 10 ** 4),
                 "sum_charge": (dp * (100 + t), 10 ** 6), "disc": (d, 100)}
        sums = {k: (torch.zeros(ng, dtype=torch.int64, device=x.device)
                    .index_add_(0, group, x).tolist(), s)
                for k, (x, s) in terms.items()}
        value = {k: [exact(v, s) for v in vs] for k, (vs, s) in sums.items()}
    else:
        q = money(li["l_quantity"], money_dtype)[sel]
        p = money(li["l_extendedprice"], money_dtype)[sel]
        d = money(li["l_discount"], money_dtype)[sel]
        t = money(li["l_tax"], money_dtype)[sel]
        dp = p * (1 - d)
        terms = {"sum_qty": q, "sum_base_price": p, "sum_disc_price": dp,
                 "sum_charge": dp * (1 + t), "disc": d}
        value = {k: [float(x[group == g].sum()) for g in range(ng)]
                 for k, x in terms.items()}
    rows = []
    for g in range(ng):
        n = count[g]
        if n == 0:
            continue
        rows.append({
            "l_returnflag": rf.words[g // len(ls.words)],
            "l_linestatus": ls.words[g % len(ls.words)],
            "sum_qty": value["sum_qty"][g],
            "sum_base_price": value["sum_base_price"][g],
            "sum_disc_price": value["sum_disc_price"][g],
            "sum_charge": value["sum_charge"][g],
            "avg_qty": value["sum_qty"][g] / n,
            "avg_price": value["sum_base_price"][g] / n,
            "avg_disc": value["disc"][g] / n,
            "count_order": n})
    rows.sort(key=lambda r: (r["l_returnflag"], r["l_linestatus"]))
    return rows, len(rows)
