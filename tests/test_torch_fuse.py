"""The port's `fuse` (arrow_tpu_torch/fuse.py): a plain call on the CPU,
held against the eager pipeline and the reference's `arrow_tpu.fuse` on
config 2 (bench.py:172-239); both decorator forms.  The CUDA-graph cases
(replay after new inputs, the error of a syncing op, checked arithmetic
wrapping, outputs that do not alias) need the card and skip here.
"""

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.ops import cmp as rcmp
from arrow_tpu.ops.cast import cast as rcast
from arrow_tpu_torch import dtypes as pdt, errors as perr
from arrow_tpu_torch.core.column import DictionaryColumn, PrimitiveColumn
from arrow_tpu_torch.fuse import fuse
from arrow_tpu_torch.ops import boolean as pbool, cmp as pcmp, numeric
from arrow_tpu_torch.ops.cast import CastOptions, cast
from arrow_tpu_torch.ops.filter import filter as pfilter
from arrow_tpu_torch.ops.sort import partition
from arrow_tpu_torch.ops.take import take
from test_torch_cast_cmp import (PORT_OPS, REF_OPS, config2_inputs,
                                 config2_run)
from torch_port_util import assert_columns_equal, cuda_device  # noqa: F401

rdt = at.dtypes


def _pipeline(i32, ts, dcol):
    return config2_run(PORT_OPS, pdt, i32, ts, dcol)


def test_fuse_on_the_cpu_is_the_eager_pipeline():
    ref, port = config2_inputs()
    fused = fuse(_pipeline)
    got, eager = fused(*port), _pipeline(*port)
    want = config2_run(REF_OPS, rdt, *ref)
    assert not fused.graphs                     # no capture on the CPU
    for g, e, w in zip(got, eager, want):
        assert_columns_equal(g, e, masks=True)
        assert_columns_equal(g, w, masks=True)


def test_fuse_matches_the_reference_fuse():
    """The reference's fused config-2 pipeline (bench.py:219-233), which
    closes over the dictionary's values and takes the codes."""
    ref, port = config2_inputs()
    dvals = ref[2].values

    @at.fuse
    def ref_fused(i32, ts, codes):
        dc = at.DictionaryColumn(codes, dvals, _canonical=True)
        return (rcmp.lt(rcast(i32, rdt.float64),
                        rcast(rcast(i32, rdt.int64), rdt.float64)),
                rcmp.eq(dc, "word-0042"),
                rcmp.gt_eq(rcast(ts, rdt.timestamp("ns")),
                           rcast(ts, rdt.timestamp("ns"))))

    @fuse
    def port_fused(i32, ts, dcol):
        return _pipeline(i32, ts, dcol)

    for g, w in zip(port_fused(*port), ref_fused(ref[0], ref[1],
                                                 ref[2].codes)):
        assert_columns_equal(g, w, masks=True)


def test_fuse_parameterised_form_and_static_arguments():
    col = att.column([1, None, 3, -4], dtype=pdt.int32, device="cpu")

    @fuse(static_argnums=1)
    def above(x, k):
        return pcmp.gt(x, att.Scalar(k, pdt.int32))

    assert above(col, 0).to_pylist() == [True, None, True, False]
    assert above(col, 2).to_pylist() == [False, None, True, False]
    bare = fuse()(lambda x: pbool.not_(pcmp.eq(x, att.Scalar(3, pdt.int32))))
    assert bare(col).to_pylist() == [True, None, False, True]


def test_fuse_passes_tables_and_scalars_through():
    t = att.Table.from_pydict({"x": [1, 2, None]}, device="cpu")

    @fuse
    def shifted(table, s):
        return numeric.add_wrapping(table.column("x"), s)

    assert shifted(t, att.Scalar(5, pdt.int64)).to_pylist() == [6, 7, None]


# ---- on the card ------------------------------------------------------------

def _card_inputs(dev, seed):
    rng = np.random.default_rng(seed)
    n = 100_000
    i32 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    ts = torch.from_numpy(rng.integers(0, 2 ** 40, n)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32)).to(dev)
    return i32, valid, ts, codes


def test_fuse_replays_new_inputs(cuda_device):
    words = att.StringColumn.from_pylist(
        [f"word-{i:04d}" for i in range(1000)], device=cuda_device)
    fused = fuse(_pipeline)
    for seed in (0, 1, 2):
        i32, valid, ts, codes = _card_inputs(cuda_device, seed)
        args = (PrimitiveColumn(i32, pdt.int32, valid),
                PrimitiveColumn(ts, pdt.timestamp("us")),
                DictionaryColumn(codes, words))
        for g, e in zip(fused(*args), _pipeline(*args)):
            assert torch.equal(g.values, e.values)
            assert torch.equal(g.validity, e.validity) \
                if e.validity is not None else g.validity is None
    assert len(fused.graphs) == 1


@pytest.mark.parametrize("op", ["filter", "take_checked", "partition",
                                "cast_unsafe"])
def test_fuse_refuses_host_syncs(cuda_device, op):
    x = PrimitiveColumn(torch.arange(1000, device=cuda_device), pdt.int64)
    calls = {
        "filter": lambda c: pfilter(c, pcmp.gt(c, att.Scalar(5, pdt.int64))),
        "take_checked": lambda c: take(c, c, check_bounds=True),
        "partition": lambda c: partition([c]),
        "cast_unsafe": lambda c: cast(c, pdt.int8, CastOptions(safe=False)),
    }
    with pytest.raises(RuntimeError, match="arrow_tpu_torch.fuse"):
        fuse(calls[op])(x)


def test_fuse_checked_arithmetic_wraps(cuda_device):
    big = PrimitiveColumn(torch.full((64,), 2 ** 62, device=cuda_device),
                          pdt.int64)
    with pytest.raises(perr.ArithmeticOverflow):
        numeric.add(big, big)
    out = fuse(lambda a: numeric.add(a, a))(big)
    assert out.values.tolist() == [-2 ** 63] * 64


def test_fuse_outputs_do_not_alias(cuda_device):
    fused = fuse(lambda a: numeric.add_wrapping(a, a))
    a = PrimitiveColumn(torch.arange(16, device=cuda_device), pdt.int64)
    first = fused(a)
    second = fused(PrimitiveColumn(torch.ones(16, dtype=torch.int64,
                                              device=cuda_device), pdt.int64))
    assert first.values.tolist() == [2 * i for i in range(16)]
    assert second.values.tolist() == [2] * 16
    assert first.values.data_ptr() != second.values.data_ptr()
