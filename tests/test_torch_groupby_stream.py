"""Chunked and streaming group_by of arrow_tpu_torch against the
reference: group_by past _SORT_AGG_CHUNK (shrunk in both packages by a
test-side monkeypatch), and GroupByAccumulator against the reference's
accumulator on the same chunks and against one group_by over the whole
table.  Bitwise under `_py_equal` (the float values are multiples of
1/8, so every partial sum is exact)."""

import importlib

import pytest

import arrow_tpu as at
from arrow_tpu.ops.groupby import AggSpec as RefAggSpec
from arrow_tpu.ops.groupby import GroupByAccumulator as RefAccumulator
from arrow_tpu.ops.groupby import group_by as ref_group_by
from arrow_tpu_torch.errors import ArrowInvalid
from arrow_tpu_torch.ops import groupby as tg
from arrow_tpu_torch.ops.groupby import AggSpec, GroupByAccumulator, group_by

from torch_port_util import (assert_tables_equal, port_table,  # noqa: F401
                             rand_column, route)

ref_gb = importlib.import_module("arrow_tpu.ops.groupby")

N = 1500
AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
        ("v", "count_all"), ("v", "mean"), ("w", "sum"), ("w", "mean"),
        ("w", "min"), ("w", "max"), ("b", "mean")]


def table(rng, key: str):
    """key 'float': f32 keys (the reference's general path, which
    chunks); 'wide': int64 keys over a wide range; 'small': 40 int8
    values.  Values: int16 v, float32 w (NaN, inf, -0.0), bool b, each
    10% null."""
    if key == "float":
        k = rand_column(rng, "float32", N, small=True)
    elif key == "wide":
        k = at.column(rng.integers(-10 ** 15, 10 ** 15, 300)[
            rng.integers(0, 300, N)])
    else:
        k = rand_column(rng, "int8", N, small=True)
    return at.Table.from_pydict({"k": k, "v": rand_column(rng, "int16", N),
                                 "w": rand_column(rng, "float32", N),
                                 "b": rand_column(rng, "bool", N)})


def ref_specs():
    return [RefAggSpec(*a) for a in AGGS]


def specs():
    return [AggSpec(*a) for a in AGGS]


@pytest.mark.parametrize("key", ["float", "small"])
def test_group_by_past_the_chunk_bound(rng, route, monkeypatch, key):
    """Five chunks of 300 rows streamed through the accumulator on both
    sides (the float sums take the reference's small-key plans past
    their K2 and binning routes); the float partial sums are in the
    source type, as in the reference."""
    monkeypatch.setattr(ref_gb, "_SORT_AGG_CHUNK", 300)
    monkeypatch.setattr(tg, "_SORT_AGG_CHUNK", 300)
    t = table(rng, key)
    assert_tables_equal(group_by(port_table(t), ["k"], specs()),
                        ref_group_by(t, ["k"], ref_specs()))


@pytest.mark.parametrize("key", ["float", "wide", "small"])
def test_accumulator_matches_reference_accumulator(rng, route, key):
    """Three chunks, with COMPACT_ROWS low enough that partials merge
    on the way."""
    t = table(rng, key)
    pt = port_table(t)
    ref_acc, acc = RefAccumulator(["k"], ref_specs()), \
        GroupByAccumulator(["k"], specs())
    ref_acc.COMPACT_ROWS = acc.COMPACT_ROWS = 100
    for lo in range(0, N, 500):
        ref_acc.update(t.slice(lo, 500))
        acc.update(pt.slice(lo, 500))
    assert_tables_equal(acc.finalize(), ref_acc.finalize())


def test_accumulator_equals_one_group_by(rng):
    """Integer aggregates streamed in chunks equal one group_by over the
    whole table (sums wrap the same way in any grouping)."""
    t = port_table(table(rng, "wide"))
    aggs = [AggSpec("v", op) for op in ("sum", "count", "min", "max",
                                        "count_all", "mean")]
    acc = GroupByAccumulator(["k"], aggs)
    for lo in range(0, N, 350):
        acc.update(t.slice(lo, min(350, N - lo)))
    assert_tables_equal(acc.finalize(), group_by(t, ["k"], aggs))


def test_update_async_matches_update(rng):
    t = port_table(table(rng, "float"))
    sync, asyn = GroupByAccumulator(["k"], specs()), \
        GroupByAccumulator(["k"], specs())
    for lo in range(0, N, 250):
        chunk = t.slice(lo, min(250, N - lo))
        sync.update(chunk)
        asyn.update_async(chunk)
    asyn.flush()
    assert_tables_equal(asyn.finalize(), sync.finalize())


def test_finalize_without_chunks_raises():
    with pytest.raises(ArrowInvalid, match="no chunks"):
        GroupByAccumulator(["k"], specs()).finalize()
