"""Parity of the port's checkpoints (arrow_tpu_torch/io/checkpoint.py)
with the JAX package's (arrow_tpu/io/checkpoint.py), mirroring the
checkpoint tests of tests/test_trace_checkpoint.py: a checkpoint file is
an IPC file with the reference's bytes, and restores onto the device
the caller names."""

import os

import numpy as np
import pytest

import arrow_tpu as at
from arrow_tpu.io import checkpoint as rck
from arrow_tpu_torch.io import checkpoint as pck
from torch_port_util import (assert_tables_equal, cuda_device,  # noqa: F401
                             port_table)

CPU = "cpu"


def _table(rng, n=1000):
    return at.Table.from_pydict({
        "k": at.column(rng.integers(0, 100, n)),
        "v": at.column(rng.random(n)),
        "s": at.column([f"v{i % 7}" for i in range(n)]),
    })


@pytest.mark.parametrize("compression", ["zstd", "lz4", None])
def test_checkpoint_file_matches_reference(tmp_path, compression):
    ref = _table(np.random.default_rng(0))
    rp, pp = str(tmp_path / "r.arrow"), str(tmp_path / "p.arrow")
    rck.checkpoint_table(rp, ref, compression=compression)
    pck.checkpoint_table(pp, port_table(ref), compression=compression)
    assert open(pp, "rb").read() == open(rp, "rb").read()
    assert_tables_equal(pck.restore_table(pp, device=CPU),
                        port_table(rck.restore_table(rp)))


def test_restore_needs_a_device(tmp_path):
    p = str(tmp_path / "t.arrow")
    pck.checkpoint_table(p, port_table(_table(np.random.default_rng(1), 10)))
    with pytest.raises(TypeError):
        pck.restore_table(p)


def test_checkpoint_manager_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    t1, t2 = _table(rng, 100), _table(rng, 200)
    rm = rck.CheckpointManager(str(tmp_path / "r"), max_to_keep=2)
    pm = pck.CheckpointManager(str(tmp_path / "p"), max_to_keep=2)
    for step, tables in [(1, {"a": t1}), (2, {"a": t1, "b": t2}),
                         (3, {"a": t2})]:
        rm.save(step, tables)
        pm.save(step, {k: port_table(v) for k, v in tables.items()})
    assert pm.steps() == rm.steps() == [2, 3]
    for step in (None, 2):
        want = rm.restore(step=step)
        got = pm.restore(step=step, device=CPU)
        assert sorted(got) == sorted(want)
        for name in want:
            assert_tables_equal(got[name], port_table(want[name]))


def test_checkpoint_manager_crash_safety(tmp_path):
    mgr = pck.CheckpointManager(str(tmp_path / "ckpt"))
    t = port_table(_table(np.random.default_rng(3), 50))
    mgr.save(1, {"a": t})
    os.makedirs(str(tmp_path / "ckpt" / "step_000000000002"))
    os.makedirs(str(tmp_path / "ckpt" / ".tmp_step_000000000007"))
    with open(tmp_path / "ckpt" / ".tmp_step_000000000007"
              / "MANIFEST.json", "w") as f:
        f.write("{}")
    os.makedirs(str(tmp_path / "ckpt" / "step_junk"))
    assert mgr.steps() == [1]
    assert mgr.latest_step() == 1
    assert_tables_equal(mgr.restore(device=CPU)["a"], t)


def test_restore_of_an_empty_directory_raises(tmp_path):
    with pytest.raises(at.errors.ArrowInvalid):
        rck.CheckpointManager(str(tmp_path / "r")).restore()
    import arrow_tpu_torch as att
    with pytest.raises(att.errors.ArrowInvalid):
        pck.CheckpointManager(str(tmp_path / "p")).restore(device=CPU)


def test_restore_onto_the_card(tmp_path, cuda_device):  # noqa: F811
    ref = _table(np.random.default_rng(4))
    p = str(tmp_path / "t.arrow")
    pck.checkpoint_table(p, port_table(ref, cuda_device), compression="lz4")
    got = pck.restore_table(p, device=cuda_device)
    assert got.column("k").device.type == "cuda"
    assert_tables_equal(got, port_table(ref))
