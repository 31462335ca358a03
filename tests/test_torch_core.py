"""Core of the PyTorch port against the JAX reference: dtypes and
to_torch, null-slot zeroing, from_pydict / to_pydict round trips,
unsigned storage, the _py_equal rule, scalars, and the arithmetic and
reduction ops of the config-1 slice.  Same numpy inputs to both
packages, exact comparisons."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.core.column import _py_equal as ref_py_equal
from arrow_tpu.ops import aggregate as ref_agg, numeric as ref_num
from arrow_tpu_torch import dtypes as tdt
from arrow_tpu_torch.core.column import _py_equal
from arrow_tpu_torch.errors import ArithmeticOverflow, ArrowTypeError
from arrow_tpu_torch.ops import aggregate as agg, numeric as num

from torch_port_util import (assert_columns_equal, assert_same, bits,
                             port_column)

INT_TYPES = ["int8", "int16", "int32", "int64",
             "uint8", "uint16", "uint32", "uint64"]
FLOAT_TYPES = ["float16", "float32", "float64"]


def _values(rng, name, n):
    d = np.dtype(name)
    if d.kind in "iu":
        info = np.iinfo(d)
        return rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    v = rng.normal(0, 100, n).astype(d)
    v[::7] = np.nan
    v[1::11] = -0.0
    v[2::13] = np.inf
    return v


@pytest.mark.parametrize("name", INT_TYPES + FLOAT_TYPES + ["bool"])
def test_to_torch_storage(name):
    d = tdt.bool_ if name == "bool" else getattr(tdt, name)
    storage = d.to_torch()
    assert torch.empty(0, dtype=storage).element_size() == d.byte_width
    assert d.to_numpy() == np.dtype(name)
    if name in ("uint16", "uint32", "uint64"):
        assert storage == getattr(torch, name.replace("uint", "int"))
    else:
        assert storage == getattr(torch, name)
    assert repr(d) == repr(getattr(at.dtypes, "bool_" if name == "bool"
                                   else name))


@pytest.mark.parametrize("name", INT_TYPES + FLOAT_TYPES + ["bool"])
def test_null_slots_zeroed_like_reference(rng, name):
    n = 300
    vals = _values(rng, name, n) if name != "bool" else rng.random(n) < .5
    valid = rng.random(n) > 0.3
    ref = at.column(vals, validity=valid)
    got = att.column(vals, validity=valid, device="cpu")
    host = got.to_numpy()
    assert (bits(host)[~valid] == 0).all()
    assert (bits(host) == bits(np.asarray(ref.values))).all()
    assert_columns_equal(got, ref)


@pytest.mark.parametrize("name", INT_TYPES + FLOAT_TYPES + ["bool"])
def test_py_equal_rule_against_reference(rng, name):
    """A reference column walked to numpy and rebuilt in the port gives
    the same to_pylist under the _py_equal rule."""
    n = 200
    vals = _values(rng, name, n) if name != "bool" else rng.random(n) < .5
    ref = at.column(vals, validity=rng.random(n) > 0.2)
    got = port_column(ref)
    assert_columns_equal(got, ref)
    assert _py_equal(got.to_pylist(), ref.to_pylist())


@pytest.mark.parametrize("a,b", [
    (float("nan"), float("nan")), (0.0, -0.0), (1.5, 1.5), (1, 1),
    ([1.0, None], [1.0, None]), ({"k": [float("nan")]}, {"k": [0.0]}),
    (None, None), ("x", "x"), ([1, 2], [1, 2, 3]),
])
def test_py_equal_matches_reference_rule(a, b):
    assert _py_equal(a, b) == ref_py_equal(a, b)


@pytest.mark.parametrize("data", [
    {"i": [1, None, -3], "f": [0.5, float("nan"), None],
     "b": [True, None, False], "s": ["a", None, "ccc"]},
    {"i": [2 ** 62, -2 ** 63, 0], "f": [-0.0, float("inf"), 1e300],
     "b": [None, None, True], "s": ["", "é", "z"]},
    {"i": [7], "f": [3.25], "b": [False], "s": ["only"]},
])
def test_from_pydict_round_trip(data):
    got = att.Table.from_pydict(data, device="cpu")
    ref = at.Table.from_pydict(data)
    assert_same(got.to_pydict(), data)
    assert_same(got.to_pydict(), ref.to_pydict())
    assert [repr(f.dtype) for f in got.schema] \
        == [repr(f.dtype) for f in ref.schema]
    assert [f.nullable for f in got.schema] \
        == [f.nullable for f in ref.schema]


@pytest.mark.parametrize("name", ["uint16", "uint32", "uint64"])
def test_unsigned_storage(rng, name):
    info = np.iinfo(np.dtype(name))
    vals = np.array([0, 1, info.max, info.max // 2 + 1, info.max - 1],
                    dtype=name)
    col = att.column(vals, device="cpu")
    assert col.values.dtype == getattr(torch, name.replace("uint", "int"))
    assert (col.values.numpy().view(name) == vals).all()
    assert col.to_pylist() == [int(v) for v in vals]
    assert_columns_equal(col, at.column(vals))
    big = att.scalar(int(info.max), getattr(tdt, name))
    assert big.as_py() == int(info.max)


def test_dictionary_column_round_trip(rng):
    codes = rng.integers(0, 4, 50).astype(np.int32)
    valid = rng.random(50) > 0.2
    words = ["d", "a", "c", "b"]
    ref = at.DictionaryColumn(jnp.asarray(codes), at.column(words),
                              jnp.asarray(valid))
    got = att.from_numpy(codes, valid, device="cpu", dictionary=words)
    assert_columns_equal(got, ref)
    assert (got.codes.numpy()[~valid] == 0).all()
    assert_columns_equal(got.slice(5, 20), ref.slice(5, 20))


def test_explicit_device_required():
    with pytest.raises(ValueError):
        att.column([1, 2, 3])
    with pytest.raises(ArrowTypeError):
        num.add(att.column([1, 2], device="cpu"), [1, 2])


# ---- arithmetic and reductions (ops/numeric.py, ops/aggregate.py) --------

def _pair(rng, name, n=257):
    if name in FLOAT_TYPES:
        return _values(rng, name, n), _values(rng, name, n)
    d = np.dtype(name)
    info = np.iinfo(d)
    # small operands never overflow; a few extremes make sure some do
    lo, hi = (0, 11) if d.kind == "u" else (-11, 11)
    a = rng.integers(lo, hi, n).astype(d)
    b = rng.integers(lo, hi, n).astype(d)
    return a, b, np.array([info.max, info.min, info.max // 2 + 1], d)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("name", INT_TYPES + FLOAT_TYPES)
def test_arith_matches_reference(rng, op, name):
    parts = _pair(rng, name)
    a, b = parts[0], parts[1]
    va, vb = rng.random(len(a)) > 0.1, rng.random(len(b)) > 0.1
    ra, rb = at.column(a, validity=va), at.column(b, validity=vb)
    ta, tb = port_column(ra), port_column(rb)
    assert_columns_equal(getattr(num, op + "_wrapping")(ta, tb),
                         getattr(ref_num, op + "_wrapping")(ra, rb))
    assert_same(_outcome(num, op, ta, tb), _outcome(ref_num, op, ra, rb))
    if name in FLOAT_TYPES:
        return
    # extremes: wrapping agrees bit for bit; checked raises exactly
    # when the reference raises
    ext = parts[2]
    re_a = at.column(np.concatenate([ext, ext]))
    re_b = at.column(np.concatenate([ext, ext[::-1]]))
    assert_columns_equal(getattr(num, op + "_wrapping")(port_column(re_a),
                                                        port_column(re_b)),
                         getattr(ref_num, op + "_wrapping")(re_a, re_b))
    assert _outcome(num, op, port_column(re_a), port_column(re_b)) \
        == _outcome(ref_num, op, re_a, re_b)


def _outcome(module, op, a, b):
    try:
        return getattr(module, op)(a, b).to_pylist()
    except (ArithmeticOverflow, at.errors.ArithmeticOverflow):
        return "overflow"


@pytest.mark.parametrize("name", ["int64", "uint64", "int32", "uint16",
                                  "int8", "uint8"])
def test_checked_mul_overflow_edges_match_reference(rng, name):
    """Row by row: a product raises in the port exactly when it raises
    in the reference, across the overflow boundary."""
    d = np.dtype(name)
    info = np.iinfo(d)
    half = int(np.sqrt(float(info.max)))
    cands = [0, 1, 2, 3, half - 1, half, half + 1, info.max, info.max // 2,
             info.max // 2 + 1]
    if d.kind == "i":
        cands += [-1, -2, -half, -half - 1, info.min, info.min // 2]
    for x in cands:
        for y in cands:
            ra = at.column(np.array([x], d))
            rb = at.column(np.array([y], d))
            assert _outcome(num, "mul", port_column(ra), port_column(rb)) \
                == _outcome(ref_num, "mul", ra, rb), (x, y)


@pytest.mark.parametrize("name", INT_TYPES + ["float32", "float64"])
def test_sum_and_count_match_reference(rng, name):
    n = 513
    vals = _values(rng, name, n)
    if name in ("float32", "float64"):
        vals = np.nan_to_num(vals, nan=1.0, posinf=2.0)
    valid = rng.random(n) > 0.25
    ref = at.column(vals, validity=valid)
    got = port_column(ref)
    assert agg.count(got) == ref_agg.count(ref)
    s, r = agg.sum_(got), ref_agg.sum_(ref)
    assert repr(s.dtype) == repr(r.dtype)
    if name.startswith("float"):
        # torch and XLA add in a different order
        np.testing.assert_allclose(s.as_py(), r.as_py(), rtol=1e-5)
    else:
        assert s.as_py() == r.as_py()       # wrapping, exact


def test_sum_of_all_null_is_null():
    col = att.column([None, None], dtype=tdt.int64, device="cpu")
    assert agg.sum_(col).as_py() is None
    assert agg.count(col) == 0
    assert ref_agg.sum_(at.column([None, None], dtype=at.dtypes.int64)
                        ).as_py() is None
