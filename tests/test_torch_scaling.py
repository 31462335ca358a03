"""tools_torch/bench_scaling.py, the port's scaling harness, against
tools/bench_scaling.py: its five bodies at 1, 2, 4 and 8 shards beside
the reference's five calls (tools/bench_scaling.py:82-107, written out
below) under `jax.shard_map` on conftest.py's virtual CPU devices, on
the harness's own draws; its JSON against SCALING_r05.json's keys; no
fallback to the CPU; the gloo route against the local mesh; no reference
import.

Tolerance: none.  The masks and the overflow flag agree exactly, every
other array bit for bit under its mask (u64 keys as their int64 bits);
slots outside a mask hold garbage by contract (parallel/partition.py),
as in test_torch_parallel.py.  At 256 rows a shard the group caps
overflow at two shards and more, and both packages say so.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from arrow_tpu import parallel as rpar
from arrow_tpu_torch import parallel as ppar
from tools_torch import bench_scaling as bs

from torch_port_util import bits

REPO = Path(__file__).resolve().parent.parent
PER = 256
# for each body's arrays, the index of the mask it is read under (None:
# a mask, or an array every slot of which is defined)
MASKED = {"group_by": (1, None, 1), "sort": (1, None),
          "join_unique": (None, None, 1),
          "join_skew": (None, None, 1, None, 3),
          "fused": (1, None, 1, 4, None)}


def reference_body(op: str, axis: str, per: int, nd: int):
    """The reference harness's body of `op`, returning (arrays, overflow)
    in the port body's layout."""
    n = per * nd

    def group_by(k, v, m, bk, bm, bv):
        gk, gv, (gsum,), over = rpar.dist_group_by(
            axis, k, m, per, per, [("sum", v)])
        return (gk, gv, gsum), over

    def sort(k, v, m, bk, bm, bv):
        sk, svalid, _, over = rpar.dist_sort(axis, k, m, per * 2)
        return (sk, svalid), over

    def join_unique(k, v, m, bk, bm, bv):
        _, jvalid, _, hit, (got,), over = rpar.dist_join_unique(
            axis, k, m, (v,), bk, bm, (bv,), per * 2, per * 2)
        return (jvalid, hit, got), over

    def join_skew(k, v, m, bk, bm, bv):
        light, (hit_h, (got_h,), heavy_over) = rpar.dist_join_skew(
            axis, k, m, (v,), bk, bm, (bv,), n, n,
            heavy_cap=8, build_heavy_cap=8 * nd, heavy_min_frac=1.0 / 8)
        _, lvalid, _, lhit, (lgot,), light_over = light
        return (lvalid, lhit, lgot, hit_h, got_h), light_over | heavy_over

    def fused(k, v, m, bk, bm, bv):
        (gk, gv, gsum), g_over = group_by(k, v, m, bk, bm, bv)
        (sk, svalid), s_over = sort(k, v, m, bk, bm, bv)
        return (gk, gv, gsum, sk, svalid), g_over | s_over

    return {"group_by": group_by, "sort": sort, "join_unique": join_unique,
            "join_skew": join_skew, "fused": fused}[op]


def reference_inputs(x):
    """The harness's draws as the reference takes them: u64 keys."""
    return [jnp.asarray(x[a].view(np.uint64) if a in ("k", "bk") else x[a])
            for a in bs.ARGS]


@pytest.mark.parametrize("op", list(bs.OPS))
@pytest.mark.parametrize("nd", bs.COUNTS)
def test_bodies_equal_the_reference_bit_for_bit(op, nd):
    x = bs.inputs_at(PER, nd)
    jmesh = rpar.make_mesh(nd)
    axis = rpar.shard_axis(jmesh)
    step = jax.jit(functools.partial(
        jax.shard_map, mesh=jmesh, in_specs=(P(axis),) * len(bs.ARGS),
        out_specs=(P(axis), P()))(reference_body(op, axis, PER, nd)))
    want_arrays, want_over = step(*reference_inputs(x))
    got_arrays, got_over = bs.run_local(op, ppar.make_mesh(nd, "cpu"),
                                        bs.on("cpu", x))
    got = [g.numpy() for g in got_arrays]
    want = [np.asarray(w) for w in want_arrays]
    assert len(got) == len(want) == len(MASKED[op])
    for i, mask in enumerate(MASKED[op]):
        g, w = got[i], want[i]
        assert g.shape == w.shape, (op, nd, i)
        if mask is not None:
            assert MASKED[op][mask] is None
            g, w = g[got[mask]], w[got[mask]]
        assert np.array_equal(bits(g), bits(w)), (op, nd, i)
    assert bool(got_over) == bool(want_over)
    assert bool(got_over) == (nd > 1 and op in ("group_by", "fused"))


def test_draws_are_the_reference_numbers():
    """Each count's inputs continue one default_rng(0) in the reference's
    order: keys, then values, for counts 1, 2, 4 and 8."""
    rng = np.random.default_rng(0)
    for nd, x in bs.draws(PER):
        n = PER * nd
        keys = rng.integers(0, 1 << 20, n, dtype=np.uint64)
        vals = rng.integers(-1000, 1000, n).astype(np.int64)
        assert np.array_equal(x["k"].view(np.uint64), keys)
        assert np.array_equal(x["v"], vals)
        assert np.array_equal(x["bk"], np.arange(n)) and x["m"].all()
    assert [nd for nd, _ in bs.draws(PER, 4)] == [1, 2, 4]


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_report_has_the_reference_keys(capsys):
    assert bs.main(["--device", "cpu", "--rows-per-device", str(PER),
                    "--reps", "1"]) == 0
    out = _last_json(capsys.readouterr().out)
    ref = json.loads((REPO / "SCALING_r05.json").read_text())
    assert set(ref) <= set(out)
    assert out["metric"] == ref["metric"] and out["backend"] == "cpu"
    assert out["per_device_rows"] == PER and out["card"] is None
    assert set(out["operators"]) == set(ref["operators"])
    counts = {"1", "2", "4", "8"}
    for op, rec in out["operators"].items():
        assert set(ref["operators"][op]) <= set(rec)
        for key in ("rows_per_s", "efficiency", "throughput_retention",
                    "peak_gib", "overflow"):
            assert set(rec[key]) == counts, (op, key)
        assert rec["efficiency"]["1"] == rec["throughput_retention"]["1"] \
            == 1.0
        assert all(r > 0 for r in rec["rows_per_s"].values())
        assert all(p is None for p in rec["peak_gib"].values())
    assert out["operators"]["sort"]["overflow"] == dict.fromkeys(counts,
                                                                 False)
    assert out["shared_core_efficiency_bound"] == \
        ref["shared_core_efficiency_bound"]


def test_no_card_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bs.main(["--rows-per-device", str(PER), "--reps", "1"]) != 0
    assert "is_available() is False" in capsys.readouterr().err
    assert bs.main(["--device", "cpu", "--comm", "gloo", "--profile"]) != 0


def test_no_card_exits_non_zero_as_a_script():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(REPO / "tools_torch" /
                                            "bench_scaling.py"),
                        "--rows-per-device", str(PER), "--reps", "1"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_route_equals_the_local_mesh(world):
    got = bs.run_gloo(world, PER, 1)
    x = bs.on("cpu", bs.inputs_at(PER, world))
    mesh = ppar.make_mesh(world, "cpu")
    for op in bs.OPS:
        out = bs.run_local(op, mesh, x)
        assert bs.same_answer(got[op]["answer"], bs.answer(op, out)), op
        assert got[op]["overflow"] == bool(out[1]), op
        assert len(got[op]["seconds"]) == 1 and got[op]["seconds"][0] > 0


def test_harness_imports_no_reference():
    code = ("import sys; from tools_torch import bench_scaling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'arrow_tpu')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
