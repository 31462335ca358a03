"""The one traffic generator: reads a mix (traffic/<name>.json) and the
queries it names (queries/<name>.json), and yields each stream's queries
with substitution parameters drawn from the seed.

A stream runs the mix's queries, one of each, in an order drawn from the
seed, again and again (TPC-H's query streams, clause 5.3.5); every query
draws its own parameters by the rule its file gives (the spec's clause
2.4.x.3).  Stream i of seed s is the same sequence in every run.
"""

from __future__ import annotations

import datetime
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np

from .tpch_gen import days as _day

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Query:
    """One query as issued: `steps` are statements run first, each
    answer registered as a table under its name (`into`) for the
    statements after it; `sql` gives the answer."""
    name: str
    sql: str
    params: Dict[str, object]
    steps: Tuple[Tuple[str, str], ...] = ()


def _month(ym: str, plus: int = 0) -> datetime.date:
    y, m = map(int, ym.split("-"))
    m += plus
    return datetime.date(y + (m - 1) // 12, (m - 1) % 12 + 1, 1)


def _months_between(a: str, b: str) -> int:
    (ya, ma), (yb, mb) = (map(int, a.split("-")), map(int, b.split("-")))
    return (yb - ya) * 12 + mb - ma


def draw(name: str, rule: dict, rng) -> Dict[str, object]:
    """The values one parameter rule gives: `name` itself, and for some
    kinds `name`_END, _LO, _HI and their cents."""
    kind = rule["kind"]
    if kind == "int":
        return {name: int(rng.integers(rule["lo"], rule["hi"] + 1))}
    if kind == "choice":
        return {name: rule["values"][int(rng.integers(len(rule["values"])))]}
    if kind == "day":
        lo = datetime.date.fromisoformat(rule["from"])
        hi = datetime.date.fromisoformat(rule["to"])
        return {name: _day(lo) + int(rng.integers((hi - lo).days + 1))}
    if kind == "days_before":
        back = int(rng.integers(rule["lo"], rule["hi"] + 1))
        return {name: _day(datetime.date.fromisoformat(rule["date"])) - back}
    if kind == "month":
        steps = _months_between(rule["from"], rule["to"]) // rule["every"]
        first = int(rng.integers(steps + 1)) * rule["every"]
        return {name: _day(_month(rule["from"], first)),
                f"{name}_END": _day(_month(rule["from"],
                                           first + rule["months"]))}
    if kind == "cents_band":
        c = int(rng.integers(rule["lo"], rule["hi"] + 1))
        lo, hi = c - rule["band"], c + rule["band"]
        return {f"{name}_LO": repr(lo / 100), f"{name}_HI": repr(hi / 100),
                f"{name}_LO_CENTS": lo, f"{name}_HI_CENTS": hi}
    raise ValueError(f"parameter {name}: unknown kind {kind!r}")


def load(kind: str, name: str, root: Path = HERE) -> dict:
    """A file of the benchmark's data, found by name."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: no file of {kind} "
                                f"named {name!r}")
    return json.loads(path.read_text())


def queries_of(mix: dict, root: Path = HERE) -> Dict[str, dict]:
    return {q: load("queries", q, root) for q in mix["queries"]}


def stream(mix: dict, seed: int, index: int,
           root: Path = HERE) -> Iterator[Query]:
    """Stream `index` of the mix under `seed`: endless, the same every
    time."""
    qs = queries_of(mix, root)
    rng = np.random.default_rng([int(seed), int(index), 0x51])
    names = list(mix["queries"])
    while True:
        for i in rng.permutation(len(names)):
            q = qs[names[i]]
            params = {}
            for pname, rule in q["params"].items():
                params.update(draw(pname, rule, rng))
            yield Query(q["name"], q["sql"].format(**params), params,
                        tuple((st["into"], st["sql"].format(**params))
                              for st in q.get("steps", ())))
