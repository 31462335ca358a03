"""The port's first slice end to end against the JAX reference: the
flagship config-1 query (arrow_tpu_torch.pipeline), the same query
through the Table API, and group_by over a dictionary key on both
reference routes (ARROW_TPU_USE_PALLAS=0: general sort path; =1: the
dictionary fast path on the interpreted Pallas kernel).  Plus the
package's import hygiene and routing by device."""

import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import arrow_tpu as at
from arrow_tpu.ops.cast import cast as ref_cast
from arrow_tpu.ops.groupby import AggSpec as RefAggSpec, group_by as ref_group_by
from arrow_tpu_torch import pipeline
from arrow_tpu_torch import dtypes as tdt
from arrow_tpu_torch.kernels import compact as kc, groupagg as kg
from arrow_tpu_torch.ops import filter as tf
from arrow_tpu_torch.ops.groupby import AggSpec, _fast_agg_stage, group_by

from torch_port_util import (assert_tables_equal, bits, cuda_device,  # noqa: F401
                             port_column, port_table, route)

ref_filter = importlib.import_module("arrow_tpu.ops.filter")
ref_agg = importlib.import_module("arrow_tpu.ops.aggregate")
ref_num = importlib.import_module("arrow_tpu.ops.numeric")

REPO = Path(__file__).resolve().parents[1]
N = 4096
AGGS = ["sum", "count", "min", "max", "count_all", "mean"]


def _entry_inputs(n=N):
    """__graft_entry__.entry()'s inputs (n = 1 << 20, default_rng(0)),
    cut to the first n rows."""
    rng = np.random.default_rng(0)
    x = rng.integers(-1000, 1000, 1 << 20).astype(np.int64)
    y = rng.random(1 << 20)
    return x[:n], y[:n]


def test_entry_builds_the_reference_entry_inputs():
    fn, (x, y, t) = pipeline.entry("cpu")
    rx, ry = _entry_inputs(1 << 20)
    assert fn is pipeline.query and t == 0
    assert (x.numpy() == rx).all() and (bits(y.numpy()) == bits(ry)).all()


def test_pipeline_matches_reference(route):
    x, y = _entry_inputs()
    total, count, (xf, yf) = pipeline.query(torch.from_numpy(x),
                                            torch.from_numpy(y), 0)
    keep = x > 0
    (rxf, ryf), rn = ref_filter.filter_static_multi(
        jnp.asarray(keep), jnp.asarray(x), jnp.asarray(y))
    n = int(rn)
    assert int(count) == n == keep.sum()
    assert (xf[:n].numpy() == np.asarray(rxf)[:n]).all()
    assert (bits(yf[:n].numpy()) == bits(np.asarray(ryf)[:n])).all()
    # torch and XLA add in a different order
    truth = (y[keep] * 2.0 + x[keep]).sum()
    np.testing.assert_allclose(float(total), truth, rtol=1e-12)


def test_reference_pipeline_sums_the_dropped_rows():
    """__graft_entry__._pipeline sums all n slots of its full-length
    compaction, so its answer includes the rows the filter dropped; the
    port sums the first `count` rows.  Pinned here (ROADMAP queue C) on
    entry()'s generator run at n = 4096."""
    rng = np.random.default_rng(0)
    x = rng.integers(-1000, 1000, N).astype(np.int64)
    y = rng.random(N)
    (rxf, ryf), rn = ref_filter.filter_static_multi(
        jnp.asarray(x > 0), jnp.asarray(x), jnp.asarray(y))
    ref_sum = float(jnp.sum(ryf * 2.0 + rxf.astype(jnp.float64)))
    keep = x > 0
    everything = (y * 2.0 + x).sum()
    truth = (y[keep] * 2.0 + x[keep]).sum()
    assert int(rn) == 2070
    np.testing.assert_allclose(ref_sum, everything, rtol=1e-12)
    np.testing.assert_allclose(ref_sum, 32654.39, atol=0.01)
    np.testing.assert_allclose(truth, 1050213.10, atol=0.01)
    total, _, _ = pipeline.query(torch.from_numpy(x), torch.from_numpy(y), 0)
    np.testing.assert_allclose(float(total), truth, rtol=1e-12)


@pytest.mark.parametrize("nulls", [False, True])
def test_table_query_matches_reference(rng, route, nulls):
    x, y = _entry_inputs()
    xv = rng.random(N) > 0.1 if nulls else None
    yv = rng.random(N) > 0.1 if nulls else None
    ref_t = at.Table.from_pydict({"x": at.column(x, validity=xv),
                                  "y": at.column(y, validity=yv)})
    got_sum, got_count = pipeline.query_table(port_table(ref_t), 0)

    rx = ref_t.column("x")
    ref_pred = at.column(np.asarray(rx.values) > 0,
                         validity=None if xv is None else xv)
    kept = ref_filter.filter_table(ref_t, ref_pred)
    z = ref_num.add(ref_num.mul(kept.column("y"), 2.0),
                    ref_cast(kept.column("x"), at.dtypes.float64))
    assert got_count == ref_agg.count(kept.column("x"))
    np.testing.assert_allclose(got_sum, ref_agg.sum_(z).as_py(), rtol=1e-12)
    assert_tables_equal(tf.filter_table(port_table(ref_t),
                                        port_column(ref_pred)), kept)


def _dict_table(rng, n, value_dtype, words=1000, seed_perm=7):
    """A dictionary key (10% null codes, values shuffled so code order
    differs from value order) and a value column v (10% null)."""
    perm = np.random.default_rng(seed_perm).permutation(words)
    values = [f"key{i:04d}" for i in perm]
    codes = rng.integers(0, words, n).astype(np.int32)
    kv = rng.random(n) > 0.1
    d = np.dtype(value_dtype)
    if d.kind in "iu":
        info = np.iinfo(d)
        v = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    else:
        v = rng.normal(0, 1e3, n).astype(d)
        v[::97] = np.nan
        v[1::89] = np.inf
        v[2::83] = -0.0
    vv = rng.random(n) > 0.1
    key = at.DictionaryColumn(jnp.asarray(codes), at.column(values),
                              jnp.asarray(kv))
    return at.Table.from_pydict({"k": key, "v": at.column(v, validity=vv)})


def _aggs_for(value_dtype):
    ops = AGGS if np.dtype(value_dtype).kind in "iu" \
        else ["count", "min", "max", "count_all"]
    return ops


@pytest.mark.parametrize("value_dtype,words", [
    ("int64", 1000), ("int8", 50), ("uint64", 50), ("uint32", 50),
    ("float32", 50), ("float16", 50)])
def test_group_by_dictionary_matches_reference(rng, route, value_dtype,
                                               words):
    ref_t = _dict_table(rng, 3000, value_dtype, words)
    ops = _aggs_for(value_dtype)
    want = ref_group_by(ref_t, ["k"], [RefAggSpec("v", op) for op in ops])
    got = group_by(port_table(ref_t), ["k"], [AggSpec("v", op) for op in ops])
    assert_tables_equal(got, want)


def test_group_by_two_dictionary_keys_matches_reference(rng, route):
    n = 2500
    t1 = _dict_table(rng, n, "int64", words=5)
    a_codes = rng.integers(0, 6, n).astype(np.int32)
    a = at.DictionaryColumn(jnp.asarray(a_codes),
                            at.column(["q", "b", "zz", "a", "m", "c"]),
                            jnp.asarray(rng.random(n) > 0.3))
    ref_t = at.Table.from_pydict({"a": a, "k": t1.column("k"),
                                  "v": t1.column("v")})
    aggs = [("v", "sum"), ("v", "max"), ("k", "count"), ("v", "count_all")]
    want = ref_group_by(ref_t, ["a", "k"], [RefAggSpec(*s) for s in aggs])
    got = group_by(port_table(ref_t), ["a", "k"], [AggSpec(*s) for s in aggs])
    assert_tables_equal(got, want)


@pytest.mark.parametrize("n", [0, 1])
def test_group_by_tiny_tables_match_reference(route, n):
    key = at.DictionaryColumn(jnp.zeros(n, jnp.int32),
                              at.column(["b", "a"]), None)
    ref_t = at.Table.from_pydict(
        {"k": key, "v": at.column(np.arange(n, dtype=np.int64))})
    want = ref_group_by(ref_t, ["k"], [RefAggSpec("v", op) for op in AGGS])
    got = group_by(port_table(ref_t), ["k"], [AggSpec("v", op) for op in AGGS])
    assert_tables_equal(got, want)


def test_encoded_partials_merge_exactly(rng):
    """decode=False partials of two halves merge into the whole (sums
    and counts add; min/max keys combine unsigned), as A5's chunked
    plan will need (the role of groupby.py:387-407)."""
    ref_t = _dict_table(rng, 3000, "int64", words=30)
    t = port_table(ref_t)
    k, v = t.column("k"), t.column("v")
    sizes = [len(k.values)]

    def stage(lo, hi, decode):
        sl = slice(lo, hi)
        return _fast_agg_stage(
            sizes, sizes[0] + 1, [(k.codes[sl], k.validity[sl], 0, None)],
            [kg.SumCol(v.values[sl], v.validity[sl], tdt.int64)],
            [kg.MinMaxCol(v.values[sl], v.validity[sl], tdt.int64)],
            decode=decode)

    whole = stage(0, 3000, True)
    a, b = stage(0, 1234, False), stage(1234, 3000, False)
    assert torch.equal(a[0][0] + b[0][0], whole[0][0])
    assert torch.equal(a[1][0] + b[1][0], whole[1][0])
    sign = -(1 << 63)
    mn = torch.minimum(a[2][0][0] ^ sign, b[2][0][0] ^ sign) ^ sign
    mx = torch.maximum(a[2][0][1] ^ sign, b[2][0][1] ^ sign) ^ sign
    counts = whole[1][0] > 0
    assert torch.equal(kg.decode_order_key(mn, tdt.int64)[counts],
                       whole[2][0][0][counts])
    assert torch.equal(kg.decode_order_key(mx, tdt.int64)[counts],
                       whole[2][0][1][counts])


@pytest.mark.parametrize("case", ["plain-key", "repeated-values", "f64-min",
                                  "too-many-groups"])
def test_group_by_outside_the_dictionary_plan_raises(monkeypatch, case):
    """Inputs outside the dictionary plan.  They raised while it was the
    port's only plan; now the small-domain plan (plain-key) or the sort
    plan takes each, and the output equals the reference's on both of
    its routes."""
    codes = np.array([0, 1, 1], np.int32)
    if case == "plain-key":
        ref_t = at.Table.from_pydict({"k": at.column([1, 2, 2]),
                                      "v": at.column([1, 2, 3])})
        aggs = [("v", "sum")]
    else:
        words = {"repeated-values": ["a", "a"], "f64-min": ["a", "b"],
                 "too-many-groups": [f"w{i}" for i in range(kg.G_MAX)]}
        key = at.DictionaryColumn(jnp.asarray(codes),
                                  at.column(words[case]), None)
        v = np.arange(3.0) if case == "f64-min" else np.arange(3)
        ref_t = at.Table.from_pydict({"k": key, "v": at.column(v)})
        aggs = [("v", "min" if case == "f64-min" else "sum")]
    got = group_by(port_table(ref_t), ["k"], [AggSpec(*a) for a in aggs])
    for use_pallas in ("0", "1"):
        monkeypatch.setenv("ARROW_TPU_USE_PALLAS", use_pallas)
        assert_tables_equal(got, ref_group_by(
            ref_t, ["k"], [RefAggSpec(*a) for a in aggs]))


def test_cpu_tensors_never_reach_a_kernel(rng):
    k0, g0 = kc.compact.launches, kg.grouped_aggregate.launches
    x, y = _entry_inputs()
    pipeline.query(torch.from_numpy(x), torch.from_numpy(y), 0)
    ref_t = _dict_table(rng, 500, "int64", words=20)
    group_by(port_table(ref_t), ["k"], [AggSpec("v", op) for op in AGGS])
    tf.filter_table(port_table(ref_t),
                    port_column(at.column(rng.random(500) < 0.5)))
    assert kc.compact.launches == k0
    assert kg.grouped_aggregate.launches == g0


def test_import_leaves_jax_out():
    code = ("import sys, arrow_tpu_torch, arrow_tpu_torch.pipeline, "
            "arrow_tpu_torch.ops.groupby, arrow_tpu_torch.kernels.native; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'arrow_tpu', 'pyarrow')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def test_port_sources_import_no_reference():
    """No jax and no arrow_tpu anywhere, in the package, its examples,
    its tools or chip_smoke.py; pyarrow only inside the functions that
    use it (interop), never at a module's top level."""
    pat = re.compile(r"^\s*(import|from) (jax|arrow_tpu\b)", re.M)
    top = re.compile(r"^(import|from) pyarrow", re.M)
    files = sorted((REPO / "arrow_tpu_torch").rglob("*.py"))
    examples = sorted((REPO / "examples_torch").glob("*.py"))
    tools = sorted((REPO / "tools_torch").glob("*.py"))
    assert files and len(examples) == 13 and tools
    for f in files + examples + tools + [REPO / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f
        assert not top.search(f.read_text()), f


def test_slice_on_cuda_matches_cpu(cuda_device, rng):
    x, y = _entry_inputs(300_000)
    k0, g0 = kc.compact.launches, kg.grouped_aggregate.launches
    cpu = pipeline.query(torch.from_numpy(x), torch.from_numpy(y), 0)
    gpu = pipeline.query(torch.from_numpy(x).to(cuda_device),
                         torch.from_numpy(y).to(cuda_device), 0)
    n = int(cpu[1])
    assert int(gpu[1]) == n
    for a, b in zip(gpu[2], cpu[2]):
        assert torch.equal(a[:n].cpu(), b[:n])
    np.testing.assert_allclose(float(gpu[0]), float(cpu[0]), rtol=1e-12)
    ref_t = _dict_table(rng, 200_000, "int64")
    aggs = [AggSpec("v", op) for op in AGGS]
    got = group_by(port_table(ref_t, cuda_device), ["k"], aggs)
    want = group_by(port_table(ref_t), ["k"], aggs)
    assert_tables_equal(got, want)
    assert kc.compact.launches == k0 + 1
    assert kg.grouped_aggregate.launches == g0 + 1
