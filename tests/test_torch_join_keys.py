"""The join's keys in arrow_tpu_torch against the reference, on both
reference routes (the `route` fixture): `encode_value_key` bit for bit
on every key type, the multi-column fold, merged string ranks, and
`join_indices` on each key type for every `how`, on the port's index
plan and on its merge plans (the `plan` fixture of test_torch_join.py).

Every input here has unique build keys (by value: floats by their bits,
strings by their bytes), so row ids compare exactly: int64, values and
order.  Floats are keyed by their IEEE totalOrder bits: -0.0 and +0.0
are two keys, a NaN matches a NaN of the same bits.
"""

import importlib

import numpy as np
import pytest
import torch

import arrow_tpu as at
import jax.numpy as jnp
from arrow_tpu import dtypes as rdt
from arrow_tpu.ops.row_format import encode_value_key as ref_encode
from arrow_tpu_torch.errors import ArrowInvalid, ArrowTypeError
from arrow_tpu_torch.ops import join as pj, strings as ps
from arrow_tpu_torch.ops.row_format import encode_value_key

from test_torch_join import HOWS, check, plan  # noqa: F401
from torch_port_util import bits, port_column, port_table, route  # noqa: F401

rj = importlib.import_module("arrow_tpu.ops.join")

INTS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
        "uint64"]
TEMPORAL = {
    "timestamp[us]": rdt.timestamp("us"),
    "timestamp[ns, UTC]": rdt.timestamp("ns", "UTC"),
    "date32": rdt.date32, "date64": rdt.date64,
    "time32[ms]": rdt.time32("ms"), "time64[ns]": rdt.time64("ns"),
    "duration[s]": rdt.duration("s"),
    "interval[year_month]": rdt.interval("year_month"),
    "interval[day_time]": rdt.interval("day_time"),
}
FLOATS = ["float16", "float32", "float64"]
WORDS = [f"w{i:03d}" for i in range(60)] + ["", "é", "z\x00", "z"]
KEY_TYPES = INTS + ["bool"] + list(TEMPORAL) + FLOATS + ["dictionary",
                                                         "string"]


def _pool(rng, name, size):
    """Distinct key values of one type (floats distinct by bits, with
    NaN, -NaN, -0.0, +0.0 and both infinities)."""
    if name == "bool":
        return np.array([False, True])
    if name in FLOATS:
        d = np.dtype(name)
        special = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf], d)
        v = (rng.integers(-4000, 4000, size) / 8).astype(d)
        v = np.concatenate([special, v])
        _, first = np.unique(bits(v), return_index=True)
        return v[np.sort(first)]
    if name in TEMPORAL:
        d = np.dtype(TEMPORAL[name].to_jax())
        if name == "interval[day_time]":   # (days << 32) | millis, signed
            days = rng.integers(-2 ** 31, 2 ** 31, size)
            ms = rng.integers(-2 ** 31, 2 ** 31, size)
            return np.unique((days << 32) | (ms & 0xFFFFFFFF))
        info = np.iinfo(d)
        return np.unique(rng.integers(info.min, info.max, size, dtype=d,
                                      endpoint=True))
    info = np.iinfo(name)
    if info.max - info.min < 2 * size:
        return np.arange(info.min, info.max + 1, dtype=name)
    return np.unique(rng.integers(info.min, info.max, size, dtype=name,
                                  endpoint=True))


def _column(name, values, valid):
    if name in TEMPORAL:
        return at.column(values, dtype=TEMPORAL[name], validity=valid)
    return at.column(values, validity=valid)


def key_tables(name, n_l=700, n_r=150):
    """(left, right) reference tables whose key `k` is of type `name`:
    unique build keys drawn from a pool, probe keys from the whole pool
    (many miss), nulls on both sides.  Dictionaries differ between the
    sides and hold a null entry; strings stay host columns."""
    rng = np.random.default_rng(sum(map(ord, name)))
    lvalid = rng.random(n_l) > 0.05
    rvalid = rng.random(max(n_r, len(WORDS) + 1)) > 0.05
    if name in ("dictionary", "string"):
        words = WORDS + [None]
        lw = [words[i] for i in rng.permutation(len(words))[:50]]
        rw = [words[i] for i in rng.permutation(len(words))]
        if name == "string":
            lvals = [lw[i] for i in rng.integers(0, len(lw), n_l)]
            rvals = rw[:n_r]
            lcol = at.column([v if ok else None
                              for v, ok in zip(lvals, lvalid)])
            rcol = at.column([v if ok else None
                              for v, ok in zip(rvals, rvalid[:len(rvals)])])
        else:
            lcol = at.DictionaryColumn(
                jnp.asarray(rng.integers(0, len(lw), n_l).astype(np.int32)),
                at.StringColumn.from_pylist(lw), jnp.asarray(lvalid))
            rcol = at.DictionaryColumn(
                jnp.asarray(rng.permutation(len(rw)).astype(np.int16)),
                at.StringColumn.from_pylist(rw),
                jnp.asarray(rvalid[:len(rw)]))
    else:
        pool = _pool(rng, name, 400)
        rvals = rng.permutation(pool)[:min(n_r, len(pool))]
        lvals = pool[rng.integers(0, len(pool), n_l)]
        lcol = _column(name, lvals, lvalid)
        rcol = _column(name, rvals, rvalid[:len(rvals)])
    return (at.Table.from_pydict({"k": lcol}),
            at.Table.from_pydict({"k": rcol, "w": np.arange(len(rcol))}))


@pytest.mark.parametrize("name", KEY_TYPES)
def test_encode_value_key_matches_reference(route, name):
    """The order key and its validity, bit for bit, on both sides'
    columns (a dictionary's null entry folds into the validity)."""
    for t in key_tables(name):
        col = t.column("k")
        key, valid = encode_value_key(port_column(col))
        want_key, want_valid = ref_encode(col)
        assert key.dtype == torch.int64
        np.testing.assert_array_equal(key.numpy().view(np.uint64),
                                      np.asarray(want_key))
        if want_valid is None:
            assert valid is None
        else:
            np.testing.assert_array_equal(valid.numpy(),
                                          np.asarray(want_valid))


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("name", KEY_TYPES)
def test_join_on_each_key_type(route, plan, name, how):
    lt, rt = key_tables(name)
    got = check(lt, rt, ["k"], how)
    if how == "semi":
        assert 0 < len(got[0]) < lt.num_rows


MULTI = {
    "int32+dictionary": ("int32", "dictionary"),
    "int64+float64": ("int64", "float64"),
    "uint64+bool+timestamp": ("uint64", "bool", "timestamp[us]"),
    "string+int8": ("string", "int8"),
}


def multi_tables(names, n_l=600, n_r=60):
    """Key columns k0, k1, ... of the given types.  The build side's
    column k0 is unique, so its key tuples are; a probe row copies one
    build row's tuple, or (30%) takes k1, k2, ... from another row."""
    rng = np.random.default_rng(len(names))
    pick = rng.integers(0, n_r, n_l)
    other = np.where(rng.random(n_l) < 0.3, rng.integers(0, n_r, n_l), pick)
    lcols, rcols = {}, {}
    for i, name in enumerate(names):
        col = key_tables(name, n_r=n_r)[1].column("k")
        rows = np.arange(n_r) % len(col)
        rcols[f"k{i}"] = _take(col, rows)
        lcols[f"k{i}"] = _take(col, rows[other if i else pick])
    return (at.Table.from_pydict(lcols),
            at.Table.from_pydict({**rcols, "w": np.arange(n_r)}))


def _take(col, idx):
    from arrow_tpu.ops.take import take
    return take(col, at.column(np.asarray(idx, np.int64)))


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", list(MULTI))
def test_multi_column_keys(route, case, how):
    """Multi-column keys: the splitmix fold and the per-column check."""
    names = MULTI[case]
    lt, rt = multi_tables(names)
    on = [f"k{i}" for i in range(len(names))]
    check(lt, rt, on, how)


@pytest.mark.parametrize("case", list(MULTI))
def test_fold_matches_reference_bits(route, case):
    """The folded multi-column key is the reference's, bit for bit: the
    mixer's products and logical shifts on int64 storage wrap as u64."""
    lt, rt = multi_tables(MULTI[case])
    on = [f"k{i}" for i in range(len(MULTI[case]))]
    want = rj.combined_keys([lt.column(c) for c in on],
                            [rt.column(c) for c in on])
    plt, prt = port_table(lt), port_table(rt)
    got = pj.combined_keys([plt.column(c) for c in on],
                           [prt.column(c) for c in on])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_array_equal(g.numpy().view(np.uint64),
                                      np.asarray(w))
    for g, w in ((got[1], want[1]), (got[3], want[3])):
        g = np.ones(len(w), bool) if g is None else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w))


def test_merged_string_ranks_are_dense_byte_order(route):
    """One rank domain over both value sets, in UTF-8 byte order; a null
    slot ranks as the empty string (as the reference interns it)."""
    left = ["b", None, "é", "a", "b"]
    right = ["z\x00", "z", "", "a"]
    lr, rr = ps.merged_string_ranks(
        port_column(at.column(left)), port_column(at.column(right)))
    wl, wr = importlib.import_module("arrow_tpu.ops.strings") \
        .merged_string_ranks(at.column(left), at.column(right))
    assert lr.tolist() == np.asarray(wl).tolist() == [2, 0, 5, 1, 2]
    assert rr.tolist() == np.asarray(wr).tolist() == [4, 3, 0, 1]


@pytest.mark.parametrize("how", HOWS)
def test_string_against_dictionary_key(route, how):
    """A host string column on one side, a dictionary on the other."""
    lt, _ = key_tables("string")
    _, rt = key_tables("dictionary")
    check(lt, rt, ["k"], how)


@pytest.mark.parametrize("how", HOWS)
def test_probe_key_of_another_width(route, plan, how):
    """Integer keys of two widths share the order-key domain: an int32
    probe key meets an int64 build key by value."""
    rng = np.random.default_rng(8)
    lt = at.Table.from_pydict({"k": rng.integers(-300, 300, 500)
                               .astype(np.int32)})
    rt = at.Table.from_pydict({"k": rng.permutation(np.arange(-200, 200))
                               .astype(np.int64)})
    check(lt, rt, ["k"], how)


@pytest.mark.parametrize("case", ["int-dictionary", "dictionary-int"])
def test_non_string_dictionary_keys_raise(case):
    """A dictionary of non-string values raises ArrowInvalid
    (join.py:69-70); a dictionary against an integer key raises
    ArrowTypeError, as the reference's dictionary_encode does."""
    ints = at.Table.from_pydict({"k": [1, 2, 3]})
    dict_of_ints = at.Table.from_pydict({"k": at.DictionaryColumn(
        jnp.asarray(np.array([0, 1, 0], np.int32)), at.column([7, 8]))})
    strings = at.Table.from_pydict({"k": at.DictionaryColumn(
        jnp.asarray(np.array([0, 1, 0], np.int32)), at.column(["a", "b"]))})
    lt, rt, err = (dict_of_ints, strings, ArrowInvalid) \
        if case == "int-dictionary" else (strings, ints, ArrowTypeError)
    with pytest.raises(err):
        pj.join_indices(port_table(lt), port_table(rt), ["k"])
    with pytest.raises(Exception):
        rj.join_indices(lt, rt, ["k"])
