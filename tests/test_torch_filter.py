"""Filter of the PyTorch port against the JAX reference on both of its
routes: ARROW_TPU_USE_PALLAS=0 (partition sort) and =1 (the Pallas
compaction kernel in interpret mode, which the reference takes for
batches of at least 6 u32 planes without f64/f16).  Same numpy inputs;
outputs compare exactly on [:count].  n stays at or below 4096 because
the interpreted kernel is slow."""

import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import arrow_tpu as at
from arrow_tpu.kernels.compact import compact_mask_arrays as ref_compact
from arrow_tpu_torch.errors import ArrowInvalid, ArrowNotImplementedError
from arrow_tpu_torch.kernels import compact as kc
from arrow_tpu_torch.ops import filter as tf

from torch_port_util import (assert_columns_equal, assert_tables_equal, bits,
                             cuda_device, port_column, port_table)  # noqa: F401

# arrow_tpu.ops re-exports `filter` the function over the module
ref_filter = importlib.import_module("arrow_tpu.ops.filter")

N = 4096
DTYPES = ["int8", "int16", "int32", "int64", "uint64",
          "float16", "float32", "float64", "bool"]
# the reference's Pallas kernel takes these (compact.py:249-257)
PALLAS_DTYPES = ["int8", "int16", "int32", "int64", "uint64", "float32",
                 "bool"]
SELECTIVITY = [0.0, 0.5, 1.0]


@pytest.fixture(params=["0", "1"], ids=["sort", "pallas"])
def route(request, monkeypatch):
    monkeypatch.setenv("ARROW_TPU_USE_PALLAS", request.param)
    return request.param


def _array(rng, name, n=N):
    if name == "bool":
        return rng.random(n) < 0.5
    d = np.dtype(name)
    if d.kind in "iu":
        info = np.iinfo(d)
        return rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    v = rng.normal(0, 1e3, n).astype(d)
    v[::9] = np.nan
    v[1::9] = -0.0
    v[2::9] = np.inf
    v[3::9] = -np.inf
    return v


def _keep(rng, p, n=N):
    return rng.random(n) < p


def _check_compacted(got, want, count):
    for g, w in zip(got, want):
        g = g[:count].cpu().numpy()
        w = np.asarray(w)[:count]
        assert g.dtype == w.dtype
        assert (bits(g) == bits(w)).all()


@pytest.mark.parametrize("p", SELECTIVITY)
@pytest.mark.parametrize("name", DTYPES)
def test_compact_by_mask_matches_reference(rng, route, name, p):
    a = _array(rng, name)
    keep = _keep(rng, p)
    count = int(keep.sum())
    want = ref_filter.compact_by_mask(jnp.asarray(keep), count,
                                      jnp.asarray(a))
    got = tf.compact_by_mask(torch.from_numpy(keep), count,
                             torch.from_numpy(a))
    assert got[0].shape == (count,)
    _check_compacted(got, want, count)


@pytest.mark.parametrize("p", SELECTIVITY)
@pytest.mark.parametrize("names", [PALLAS_DTYPES, DTYPES],
                         ids=["pallas-dtypes", "all-dtypes"])
def test_filter_static_multi_batch_matches_reference(rng, route, names, p):
    """A wide batch: on the pallas route the reference runs its kernel
    for the 9-plane batch of supported dtypes."""
    arrays = [_array(rng, name) for name in names]
    keep = _keep(rng, p)
    want, want_n = ref_filter.filter_static_multi(
        jnp.asarray(keep), *[jnp.asarray(a) for a in arrays])
    got, got_n = tf.filter_static_multi(
        torch.from_numpy(keep), *[torch.from_numpy(a) for a in arrays])
    count = int(want_n)
    assert int(got_n) == count == keep.sum()
    assert all(g.shape == (N,) for g in got)
    _check_compacted(got, want, count)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_reference_kernel_and_port_plain_version_agree(rng, p):
    """K1's plain version against the reference's Pallas kernel called
    directly (interpret mode)."""
    arrays = [_array(rng, name) for name in PALLAS_DTYPES]
    keep = _keep(rng, p)
    want, want_n = ref_compact(jnp.asarray(keep),
                               [jnp.asarray(a) for a in arrays])
    got, got_n = kc.compact(torch.from_numpy(keep),
                            [torch.from_numpy(a) for a in arrays])
    assert int(got_n) == int(want_n)
    _check_compacted(got, want, int(want_n))


@pytest.mark.parametrize("with_validity", [False, True])
@pytest.mark.parametrize("name", DTYPES)
def test_filter_column_matches_reference(rng, route, name, with_validity):
    n = 1000
    a = _array(rng, name, n)
    valid = rng.random(n) > 0.3 if with_validity else None
    pred_vals = rng.random(n) < 0.5
    pred_valid = rng.random(n) > 0.1
    ref_col = at.column(a, validity=valid)
    ref_pred = at.column(pred_vals, validity=pred_valid)
    want = ref_filter.filter(ref_col, ref_pred)
    got = tf.filter(port_column(ref_col), port_column(ref_pred))
    assert_columns_equal(got, want)


def _mixed_table(rng, n):
    words = ["kiwi", "apple", "fig", "date", "banana"]
    codes = rng.integers(0, len(words), n).astype(np.int32)
    return at.Table.from_pydict({
        "a": at.column(rng.integers(-100, 100, n).astype(np.int64),
                       validity=rng.random(n) > 0.1),
        "b": at.column(rng.integers(0, 9, n).astype(np.int32)),
        "c": at.column(rng.integers(0, 2 ** 63, n).astype(np.uint64)),
        "d": at.DictionaryColumn(jnp.asarray(codes), at.column(words),
                                 jnp.asarray(rng.random(n) > 0.2)),
        "e": at.column(_array(rng, "float64", n)),
        "f": at.column(_array(rng, "float16", n),
                       validity=rng.random(n) > 0.5),
    })


@pytest.mark.parametrize("p", SELECTIVITY)
def test_filter_table_matches_reference(rng, route, p):
    n = 2000
    ref_t = _mixed_table(rng, n)
    ref_pred = at.column(rng.random(n) < p)
    want = ref_filter.filter_table(ref_t, ref_pred)
    got = tf.filter_table(port_table(ref_t), port_column(ref_pred))
    assert_tables_equal(got, want)


def test_filter_table_pallas_wide_batch(rng, route):
    """Only 6+ plane batches without f64/f16 reach the reference kernel."""
    n = 3000
    ref_t = _mixed_table(rng, n).select(["a", "b", "c", "d"])
    ref_pred = at.column(rng.random(n) < 0.4, validity=rng.random(n) > 0.2)
    want = ref_filter.filter_table(ref_t, ref_pred)
    got = tf.filter_table(port_table(ref_t), port_column(ref_pred))
    assert_tables_equal(got, want)


def test_filter_static_matches_reference(rng, route):
    a = _array(rng, "int64")
    keep = _keep(rng, 0.3)
    want, want_n = ref_filter.filter_static(jnp.asarray(a), jnp.asarray(keep))
    got, got_n = tf.filter_static(torch.from_numpy(a), torch.from_numpy(keep))
    assert int(got_n) == int(want_n)
    _check_compacted([got], [want], int(want_n))


def test_out_cap_shrinks_output_and_raises_below_count(rng):
    a = torch.from_numpy(_array(rng, "int32", 500))
    keep = torch.from_numpy(_keep(rng, 0.5, 500))
    count = int(keep.sum())
    (out,), n = kc.compact(keep, [a], out_cap=count + 3)
    assert out.shape == (count + 3,) and int(n) == count
    with pytest.raises(ArrowInvalid):
        kc.compact(keep, [a], out_cap=count - 1)


@pytest.mark.parametrize("bad", ["length", "dtype", "strided"])
def test_compact_rejects_outside_contract(bad):
    keep = torch.ones(8, dtype=torch.bool)
    a = torch.arange(8)
    if bad == "length":
        args = (keep, [a[:7]])
    elif bad == "dtype":
        args = (keep.to(torch.int32), [a])
    else:
        args = (keep, [torch.arange(16)[::2]])
    with pytest.raises(ArrowInvalid):
        kc.compact(*args)


def test_filter_of_string_column_needs_take():
    """A string column is gathered by the positions K1 emits (the
    reference takes by the predicate's indices)."""
    col = at.column(["a", None, "", "bc"])
    pred = at.column([True, True, False, True])
    assert_columns_equal(tf.filter(port_column(col), port_column(pred)),
                         ref_filter.filter(col, pred), masks=True)


def test_plain_version_never_counts_a_launch(rng):
    before = kc.compact.launches
    keep = torch.from_numpy(_keep(rng, 0.5))
    kc.compact(keep, [torch.from_numpy(_array(rng, "int64"))])
    assert kc.compact.launches == before


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 300_001])
def test_kernel_matches_plain_on_cuda(cuda_device, n):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n)
    keep = torch.rand(n, generator=g, device=cuda_device) < 0.5
    arrays = [torch.randint(-9, 9, (n,), generator=g, device=cuda_device,
                            dtype=d)
              for d in (torch.int8, torch.int16, torch.int32, torch.int64)]
    arrays += [torch.randn(n, generator=g, device=cuda_device, dtype=d)
               for d in (torch.float16, torch.float32, torch.float64)]
    arrays.append(keep.clone())
    before = kc.compact.launches
    got, got_n = kc.compact(keep, arrays)
    want, want_n = kc.compact_plain(keep, arrays, n)
    torch.cuda.synchronize()
    assert kc.compact.launches == before + 1
    count = int(want_n)
    assert int(got_n) == count
    for g_, w_ in zip(got, want):
        assert torch.equal(g_[:count], w_[:count])


def test_kernel_repeated_launches_agree_on_cuda(cuda_device):
    """K1 orders its tiles through status words and a ticket
    (csrc/compact.cu), where an ordering fault would show now and then,
    not at every launch.  compute-sanitizer refused the H100 these tests
    run on ("Device not supported"; PERF.md), so the same inputs go
    through the kernel 100 times at sizes of one, 16 and 200 tiles, each
    launch equal to the plain version."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(16)
    for n, p in ((65_537, 0.5), (1_000_003, 0.02), (13_107_201, 0.5)):
        keep = torch.rand(n, generator=g, device=cuda_device) < p
        a = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                          device=cuda_device)
        (want_a, want_pos), want_n = kc.compact_plain(keep, [a], n,
                                                      torch.int32)
        count = int(want_n)
        for _ in range(100):
            (got_a, got_pos), got_n = kc.compact(keep, [a],
                                                 positions=torch.int32)
            assert int(got_n) == count
            assert torch.equal(got_a[:count], want_a[:count])
            assert torch.equal(got_pos[:count], want_pos[:count])


@pytest.mark.parametrize("positions", [torch.int32, torch.int64])
@pytest.mark.parametrize("p", [0.0, 0.02, 0.5, 1.0])
def test_positions_match_reference_over_an_iota(rng, positions, p):
    """K1's positions output against the reference's Pallas kernel
    (interpret mode) compacting an iota beside a column."""
    a = _array(rng, "int32")
    keep = _keep(rng, p)
    iota = np.arange(N, dtype=np.int32)
    want, want_n = ref_compact(jnp.asarray(keep),
                               [jnp.asarray(a), jnp.asarray(iota)])
    (got_a, got_pos), got_n = kc.compact(torch.from_numpy(keep),
                                         [torch.from_numpy(a)],
                                         positions=positions)
    count = int(want_n)
    assert int(got_n) == count
    assert got_pos.dtype == positions and got_pos.shape == (N,)
    _check_compacted([got_a], [want[0]], count)
    assert (got_pos[:count].numpy() == np.asarray(want[1])[:count]).all()


def test_positions_alone_under_out_cap(rng):
    """A batch of no column but the positions, shrunk by out_cap, as the
    group-by's run starts ask for them; a cap below the count raises."""
    keep = _keep(rng, 0.1)
    count = int(keep.sum())
    (pos,), n = kc.compact(torch.from_numpy(keep), [], out_cap=count + 5,
                           positions=torch.int64)
    assert pos.shape == (count + 5,) and int(n) == count
    assert (pos[:count].numpy() == np.flatnonzero(keep)).all()
    with pytest.raises(ArrowInvalid):
        kc.compact(torch.from_numpy(keep), [], out_cap=count - 1,
                   positions=torch.int64)
    with pytest.raises(ArrowInvalid):
        kc.compact(torch.from_numpy(keep), [], positions=torch.int16)


@pytest.mark.parametrize("n", [16_385, 65_535, 65_536, 65_537, 50_000_017])
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "unaligned"])
def test_one_pass_kernel_with_positions_on_cuda(cuda_device, n, shift):
    """Part and tile edges (16,384 rows a part, 65,536 a tile), a keep
    mask whose address is not 16-byte aligned, and 50M rows: 763 tiles
    whose look-back spans many waves of blocks; both position types."""
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n + shift)
    keep = (torch.rand(n + shift, generator=g, device=cuda_device)
            < 0.3)[shift:]
    arrays = [torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                            device=cuda_device),
              torch.randn(n, generator=g, device=cuda_device,
                          dtype=torch.float16)]
    for positions in (torch.int32, torch.int64):
        before = kc.compact.launches
        got, got_n = kc.compact(keep, arrays, positions=positions)
        want, want_n = kc.compact_plain(keep, arrays, n, positions)
        torch.cuda.synchronize()
        assert kc.compact.launches == before + 1
        count = int(want_n)
        assert int(got_n) == count
        for g_, w_ in zip(got, want):
            assert g_.dtype == w_.dtype and torch.equal(g_[:count],
                                                        w_[:count])


@pytest.mark.parametrize("p", [0.001, 0.02, 1.0])
def test_out_cap_below_count_raises_on_cuda(cuda_device, p):
    """The kernel drops writes past the cap and the wrapper raises; at
    the exact cap the outputs equal the plain version's."""
    n = 1_000_003
    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    keep = torch.rand(n, generator=g, device=cuda_device) < p
    a = torch.randint(0, 100, (n,), generator=g, device=cuda_device,
                      dtype=torch.int32)
    count = int(keep.sum())
    with pytest.raises(ArrowInvalid):
        kc.compact(keep, [a], out_cap=count - 1, positions=torch.int64)
    got, _ = kc.compact(keep, [a], out_cap=count, positions=torch.int64)
    want, _ = kc.compact_plain(keep, [a], count, torch.int64)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
