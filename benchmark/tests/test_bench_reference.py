"""The plain reference against the program at a tiny scale on the CPU:
every query of queries/ on several parameter draws, the port's
execute_sql answer held to the reference by compare.py under the
query's limit; and the float32 control put in the program's place fails
the same comparison."""

import importlib
import json

import pytest
import torch

from benchmark import compare, program, tpch_gen, traffic

from .conftest import ROOT, small_config

SEED = 2 ** 31 + 99
QUERIES = sorted(p.stem for p in (ROOT / "benchmark" / "queries").glob(
    "*.json"))
DRAWS = 4


@pytest.fixture(scope="module")
def tables():
    gen = tpch_gen.make_tables(small_config(rows={
        "lineitem": 20_000, "customer": 3_000, "supplier": 100}), SEED,
        "cpu")
    return gen, program.port_tables(gen, "cpu")


def _draws(name):
    mix = {"name": name, "queries": [name]}
    s = traffic.stream(mix, SEED, 5)
    return [next(s) for _ in range(DRAWS)]


def _spec(name):
    return json.loads((ROOT / "benchmark" / "queries" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", QUERIES)
def test_program_matches_reference(tables, name):
    from arrow_tpu_torch.sql import execute_sql
    gen, port = tables
    spec = _spec(name)
    ref = importlib.import_module(f"benchmark.reference.{name.lower()}")
    for q in _draws(name):
        got = program.read_answer(program.run_query(execute_sql, port, q))
        want, k = ref.answer(gen, q.params)
        assert k > 0, (name, q.params)
        why, gap = compare.compare(got, want, k, spec["answer"])
        assert why is None, (q.params, why)
        if spec["answer"]["floats"]:
            assert gap <= spec["limits"]["rel_err"], (q.params, gap)


@pytest.mark.parametrize("name", QUERIES)
def test_float32_control_fails(tables, name):
    """The reference in float32 in the program's place: a query with
    money in its answer fails; Q4 (counts only) has no money to lose and
    is another query's to catch in every mix that holds it."""
    gen, _ = tables
    spec = _spec(name)
    ref = importlib.import_module(f"benchmark.reference.{name.lower()}")
    failed = 0
    for q in _draws(name):
        got, _ = ref.answer(gen, q.params, torch.float32)
        got = [{c: float(v) if c in spec["answer"]["floats"] else v
                for c, v in r.items()} for r in got]
        want, k = ref.answer(gen, q.params)
        why, gap = compare.compare(got[:k], want, k, spec["answer"])
        limit = spec.get("limits", {}).get("rel_err", 0)
        failed += why is not None or gap > limit
    if name == "Q4":
        assert failed == 0
    else:
        assert failed == DRAWS


def test_every_mix_holds_a_query_the_control_fails():
    for p in (ROOT / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        assert any(q != "Q4" for q in mix["queries"]), p.name
