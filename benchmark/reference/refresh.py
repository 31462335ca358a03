"""TPC-H's refresh functions (clause 2.27, RF1; clause 2.28, RF2) as plain
PyTorch over the generator's tensors (tpch_gen.Col), and the plan of a
run's refresh stream drawn from the seed.

A plan is a list of transactions, two a pair, RF1 then RF2; the set-up's
warm pairs come first, on keys the window's pairs do not use.

- RF1 inserts `per_rf` new orders and their lineitems (1 to 7 each).
  Their keys are the next unused ones of the sparse rule's gaps: the
  generator gives order i the key (i // 8) * 32 + i % 8 + 1, the first 8
  of every 32, so 24 of every 32 are free; a run starts at a block drawn
  from the seed.  The rows are the generator's own (tpch_gen.
  lineitem_orders) from streams of their own, cut from a 1 MiB text pool
  of the same grammar; o_clerk draws over the base table's clerks.
- RF2 deletes `per_rf` orders of the initial population and their
  lineitems, drawn from the seed without replacement, no key twice in a
  run.

`state(base, plan, n)` is the tables after the plan's first n
transactions: RF2 as a boolean mask over the rows, RF1 as `torch.cat`
(orders then sorted by key again, as the queries' references read
them).
The reference's copy leaves out the text columns of `lineitem` and
`orders` (l_comment, o_comment), which none of the five queries reads.
Nothing here imports the program or JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import tpch_gen
from ..tpch_gen import Col

POOL_BYTES = 1 << 20           # the RF1 comments' text pool
TEXT = ("utf8", "large_utf8")


@dataclass
class Refresh:
    """One refresh transaction: RF1 inserts `orders` and `lineitem` (rows
    on the CPU) under the order keys `keys`; RF2 deletes the orders
    `keys` and their lines."""
    kind: str
    keys: torch.Tensor
    orders: Optional[Dict[str, Col]] = None
    lineitem: Optional[Dict[str, Col]] = None


def sparse_key(i) -> object:
    """The generator's key of order index i (tensor or int)."""
    return (i // 8) * 32 + i % 8 + 1


def gap_key(t) -> object:
    """The t-th key the sparse rule leaves unused: 24 of every 32."""
    return (t // 24) * 32 + 9 + t % 24


def per_rf(scale_factor: float, n_orders: int, transactions: int) -> int:
    """SF x 1,500 orders a refresh function (clauses 2.27.2, 2.28.2), at
    most what leaves the initial orders enough keys for every RF2 of the
    run (only a table cut far below the scale factor's is limited)."""
    return max(1, min(int(round(scale_factor * 1500)),
                      n_orders // (transactions + 1)))


def _cut(col: Col, rows: int) -> Col:
    """The first `rows` rows of a column."""
    if col.kind in TEXT:
        offs = col.values[:rows + 1]
        return Col(col.kind, offs, col.data[:int(offs[-1])])
    return Col(col.kind, col.values[:rows], col.data, col.words)


def rf1_rows(spec: dict, j: int, keys: torch.Tensor, pool: torch.Tensor):
    """(orders, lineitem) of the j-th RF1 of the plan, on the CPU, under
    `keys` (one an order), comments cut from `pool`."""
    k = keys.shape[0]
    seed = (int(spec["seed"]) * 131 + 17 + 7919 * j) % (1 << 62)
    s = tpch_gen._Streams(seed, 1 << 20, torch.device("cpu"))
    lineitem, orders = tpch_gen.lineitem_orders(
        8 * k, spec["customers"], spec["suppliers"], s, pool)
    lines = int((lineitem["l_orderkey"].values
                 <= sparse_key(k - 1)).sum())
    orders = {n: _cut(c, k) for n, c in orders.items()}
    lineitem = {n: _cut(c, lines) for n, c in lineitem.items()}
    old = lineitem["l_orderkey"].values - 1
    index = (old // 32) * 8 + old % 32
    lineitem["l_orderkey"] = Col("int64", keys[index])
    orders["o_orderkey"] = Col("int64", keys.clone())
    clerks = spec["clerks"]
    orders["o_clerk"] = Col("dict", tpch_gen.umod(s(k, 17), clerks).to(
        torch.int32), words=clerk_words(clerks))
    return orders, lineitem


def clerk_words(clerks: int):
    """The generator's clerk names, Clerk#000000001 on."""
    names = tpch_gen.fixed_rows([b"Clerk#", tpch_gen.digits(
        torch.arange(1, clerks + 1), 9)])
    text = bytes(names.data.numpy()).decode()
    return tuple(text[i * 15:(i + 1) * 15] for i in range(clerks))


def plan(spec: dict) -> List[Refresh]:
    """The run's refresh transactions, RF1 and RF2 of each pair, the warm
    pairs first.  `spec`: seed, n_orders (initial orders), per_rf,
    pairs (all pairs, warm ones included), and the base tables'
    customers, suppliers and clerks."""
    rng = np.random.default_rng([int(spec["seed"]), 0x5246])
    k, pairs, n_orders = spec["per_rf"], spec["pairs"], spec["n_orders"]
    free = (n_orders // 8) * 24              # gaps inside the populated keys
    start = int(rng.integers(0, max(free - pairs * k, 0) + 1))
    drawn = torch.from_numpy(rng.choice(n_orders, pairs * k, replace=False)
                             .astype(np.int64))
    pool = torch.from_numpy(tpch_gen.text_pool(rng, POOL_BYTES))
    out = []
    for j in range(pairs):
        t = torch.arange(start + j * k, start + (j + 1) * k)
        new = gap_key(t)
        orders, lineitem = rf1_rows(spec, j, new, pool)
        out.append(Refresh("RF1", new, orders, lineitem))
        out.append(Refresh("RF2", torch.sort(sparse_key(
            drawn[j * k:(j + 1) * k])).values))
    return out


def _mask(col: Col, keep: torch.Tensor) -> Col:
    if col.kind in TEXT:
        raise ValueError("text columns are not in the reference's copy")
    return Col(col.kind, col.values[keep], col.data, col.words)


def _cat(a: Col, b: Col) -> Col:
    if a.kind == "dict" and tuple(a.words) != tuple(b.words):
        raise ValueError("an RF1 column's words differ from the table's")
    return Col(a.kind, torch.cat([a.values, b.values.to(a.values.device)]),
               a.data, a.words)


def state(base: Dict[str, Dict[str, Col]], transactions: List[Refresh],
          n: int) -> Dict[str, Dict[str, Col]]:
    """The tables after the first n transactions: every RF2 key of them
    deleted by a mask over the initial rows, every RF1's rows appended
    after them, in order (RF2 keys are initial ones, so no appended row
    is deleted).  `lineitem` and `orders` without their text columns,
    the other tables as they are."""
    done = transactions[:n]
    gone = [r.keys for r in done if r.kind == "RF2"]
    out = dict(base)
    for name, key in (("lineitem", "l_orderkey"), ("orders", "o_orderkey")):
        cols = {c: v for c, v in base[name].items() if v.kind not in TEXT}
        keys = cols[key].values
        if gone:
            keep = ~torch.isin(keys, torch.cat(gone).to(keys.device))
            cols = {c: _mask(v, keep) for c, v in cols.items()}
        for r in done:
            if r.kind == "RF1":
                rows = r.lineitem if name == "lineitem" else r.orders
                cols = {c: _cat(v, rows[c]) for c, v in cols.items()}
        if name == "orders" and any(r.kind == "RF1" for r in done):
            # orders in key order, as the queries' lookups take them
            order = torch.argsort(cols[key].values, stable=True)
            cols = {c: Col(v.kind, v.values[order], v.data, v.words)
                    for c, v in cols.items()}
        out[name] = cols
    return out


def totals(tables: Dict[str, Dict[str, Col]]) -> dict:
    """What the final state is held to: each table's rows and the sum of
    its keys, and the integer-cent sums of l_extendedprice and
    o_totalprice."""
    li, o = tables["lineitem"], tables["orders"]
    return {"lineitem.rows": int(li["l_orderkey"].values.shape[0]),
            "lineitem.keys": int(li["l_orderkey"].values.sum()),
            "lineitem.cents": int(torch.round(
                li["l_extendedprice"].values * 100).long().sum()),
            "orders.rows": int(o["o_orderkey"].values.shape[0]),
            "orders.keys": int(o["o_orderkey"].values.sum()),
            "orders.cents": int(torch.round(
                o["o_totalprice"].values * 100).long().sum())}
