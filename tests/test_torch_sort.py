"""Parity of the port's sorts (arrow_tpu_torch/ops/sort.py, the sort
options of ops/row_format.py, take_table and string take in ops/take.py)
with the JAX package on the CPU, bit for bit: the cases of
tests/test_sort.py that this slice covers, random multi-key tables over
every key type with every (descending, nulls_first) pair, and config 3's
two-key lexsort (bench.py:328-366) at 4,096 rows.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.ops.row_format import SortOptions as RSortOptions
from arrow_tpu.ops.take import take_table as rtake_table
from arrow_tpu.utils.bench_util import (create_primitive_array,
                                        create_string_array,
                                        create_string_dict_array)
from arrow_tpu_torch.core.column import DictionaryColumn, StringColumn
from arrow_tpu_torch.kernels import compact as kc
from arrow_tpu_torch.ops import sort as ps
from arrow_tpu_torch.ops.take import take, take_table
from torch_port_util import (assert_columns_equal, assert_tables_equal,
                             port_column, port_options, port_table,
                             storage_list)

rs = importlib.import_module("arrow_tpu.ops.sort")
rdt = at.dtypes
OPTIONS = [(False, True), (False, False), (True, True), (True, False)]
OPT_IDS = ["asc-nf", "asc-nl", "desc-nf", "desc-nl"]


def _ropt(o):
    return RSortOptions(*o)


def _popt(o):
    return port_options(RSortOptions(*o))


def _indices(col):
    return np.asarray(col.values).astype(np.int64).tolist() \
        if not isinstance(col.values, torch.Tensor) \
        else col.values.numpy().view(np.uint32).astype(np.int64).tolist()


def _rank_list(r):
    return np.asarray(r).astype(np.int64).tolist() \
        if not isinstance(r, torch.Tensor) \
        else r.numpy().view(np.uint32).astype(np.int64).tolist()


# ---- goldens (tests/test_sort.py) ------------------------------------------

SORT_ARRAYS = {
    "int64": lambda: create_primitive_array(500, 0.0, np.int64, lo=-50, hi=50),
    "int64 nulls": lambda: create_primitive_array(500, 0.2, np.int64,
                                                  lo=-50, hi=50),
    "float64 nulls": lambda: create_primitive_array(500, 0.3, np.float64),
    "uint32": lambda: create_primitive_array(500, 0.1, np.uint32),
    "string": lambda: create_string_array(500, 0.2, cardinality=30),
    "string dict": lambda: create_string_dict_array(500, 0.2, cardinality=30),
}


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("name", list(SORT_ARRAYS))
def test_sort_golden_arrays(name, opt):
    """sort, sort_to_indices and rank of test_sort.py's arrays."""
    ref = at.column(SORT_ARRAYS[name]())
    port = port_column(ref)
    assert_columns_equal(ps.sort(port, _popt(opt)), rs.sort(ref, _ropt(opt)))
    assert _indices(ps.sort_to_indices(port, _popt(opt))) == \
        _indices(rs.sort_to_indices(ref, _ropt(opt)))
    assert _rank_list(ps.rank(port, _popt(opt))) == \
        _rank_list(rs.rank(ref, _ropt(opt)))


def test_sort_indices_stable():
    arr = at.column(create_primitive_array(300, 0.2, np.int64, lo=-5, hi=5))
    assert _indices(ps.sort_to_indices(port_column(arr))) == \
        _indices(rs.sort_to_indices(arr))


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("limit", [0, 1, 10, 125, 499, 500, 900])
def test_limit_is_the_stable_prefix(limit, desc):
    """limit takes the first rows of the stable order: the reference's
    top_k breaks ties by ascending index (many ties here)."""
    rng = np.random.default_rng(7)
    ref = at.column(rng.integers(0, 50, 500))
    port = port_column(ref)
    opt = (desc, True)
    assert _indices(ps.sort_to_indices(port, _popt(opt), limit)) == \
        _indices(rs.sort_to_indices(ref, _ropt(opt), limit))
    assert_columns_equal(ps.sort(port, _popt(opt), limit),
                         rs.sort(ref, _ropt(opt), limit))
    f = at.column(rng.standard_normal(500))
    assert_columns_equal(ps.sort(port_column(f), _popt(opt), limit),
                         rs.sort(f, _ropt(opt), limit))
    n = at.column([3, None, 1, 2, None] * 20)
    assert_columns_equal(ps.sort(port_column(n), _popt(opt), limit),
                         rs.sort(n, _ropt(opt), limit))


def _nan_with_payload(dtype):
    bits = {np.float64: [0x7FF8000000000ABC, 0xFFF8000000000001,
                         0x7FF0000000000123],
            np.float32: [0x7FC00ABC, 0xFFC00001, 0x7F800123],
            np.float16: [0x7E12, 0xFE01, 0x7C03]}[dtype]
    u = {np.float64: np.uint64, np.float32: np.uint32,
         np.float16: np.uint16}[dtype]
    return np.array(bits, u).view(dtype)


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
def test_float_total_order_and_canonical_nan(dtype, opt):
    """-inf < -0.0 == +0.0 (input order kept) < ... < +inf < NaN; the
    sorted key column holds the canonical NaN for every NaN, as the
    reference's decode writes it, and keeps the sign of each zero."""
    vals = np.concatenate([np.array([1.5, -0.0, 0.0, -np.inf, np.inf, -2.0,
                                     0.0, -0.0], dtype),
                           _nan_with_payload(dtype)])
    valid = np.ones(len(vals), bool)
    valid[5] = False
    ref = at.PrimitiveColumn(jnp.asarray(vals), getattr(rdt, np.dtype(
        dtype).name), jnp.asarray(valid))
    got = ps.sort(port_column(ref), _popt(opt))
    want = rs.sort(ref, _ropt(opt))
    assert_columns_equal(got, want)
    nan_bits = np.array([np.nan], dtype).view(f"u{np.dtype(dtype).itemsize}")
    v = got.values.numpy()
    assert (v[np.isnan(v)].view(nan_bits.dtype) == nan_bits[0]).all()
    # the payload NaNs ride a gather untouched when the column is not a key
    t = at.Table((at.column(np.arange(len(vals))), ref), rdt.Schema((
        rdt.Field("k", rdt.int64), rdt.Field("f", ref.dtype))))
    assert_tables_equal(ps.sort_table(port_table(t), [("k", _popt(opt))]),
                        rs.sort_table(t, [("k", _ropt(opt))]))


def test_lexsort_mixed_directions():
    a = at.column([1, 1, 2, 2, 1, None])
    b = at.column([5.0, None, 1.0, 2.0, 6.0, 0.0])
    cols = [(a, (False, True)), (b, (True, False))]
    got = ps.lexsort_to_indices([ps.SortColumn(port_column(c), _popt(o))
                                 for c, o in cols])
    want = rs.lexsort_to_indices([rs.SortColumn(c, _ropt(o))
                                  for c, o in cols])
    assert _indices(got) == _indices(want) == [5, 4, 0, 1, 3, 2]
    for g, w in zip(ps.lexsort([ps.SortColumn(port_column(c), _popt(o))
                                for c, o in cols]),
                    rs.lexsort([rs.SortColumn(c, _ropt(o))
                                for c, o in cols])):
        assert_columns_equal(g, w)


def test_rank_doctest_and_golden():
    s = at.column(["foo", None, "foo", None, "bar"])
    assert _rank_list(ps.rank(port_column(s))) == [5, 2, 5, 2, 3]
    arr = at.column(create_primitive_array(300, 0.2, np.int64, lo=-10, hi=10))
    assert _rank_list(ps.rank(port_column(arr))) == \
        _rank_list(rs.rank(arr))


PARTITION_CASES = {
    "ints": lambda: [at.column([1, 1, 2, 2, 2, None, None])],
    "int and str": lambda: [at.column([1, 1, 1, 2]),
                            at.column(["a", "a", "b", "b"])],
    "floats": lambda: [at.column([1.0, 1.0, np.nan, np.nan, 2.0, 0.0, -0.0,
                                  None, None, -0.0])],
    "ints and floats": lambda: [
        at.column([1, 1, 2, 2, 2, None, None]),
        at.column([1.0, 1.0, np.nan, np.nan, 2.0, 0.0, 0.0])],
    "dictionary": lambda: [at.DictionaryColumn(
        jnp.asarray(np.array([0, 2, 1, 1, 3, 0], np.int32)),
        at.StringColumn.from_pylist(["a", "b", "b", None]))],
    "uint64": lambda: [at.column(np.array([2 ** 63, 2 ** 63, 1, 1, 2 ** 64 - 1],
                                          np.uint64))],
    "empty": lambda: [at.column(np.zeros(0, np.int64))],
}


@pytest.mark.parametrize("name", list(PARTITION_CASES))
def test_partition_and_mask(name):
    """Nulls compare equal, NaNs compare equal, -0.0 equals +0.0."""
    cols = PARTITION_CASES[name]()
    pcols = [port_column(c) for c in cols]
    assert ps.partition(pcols).ranges() == rs.partition(cols).ranges()
    assert ps.partition_mask(pcols).tolist() == \
        np.asarray(rs.partition_mask(cols)).tolist()


def _decode_table(n=800, seed=3):
    """TestSortTableDecode's batch: int64 with nulls, a dictionary, a
    float, a bool and a uint16 column."""
    rng = np.random.default_rng(seed)
    null = rng.random(n) < 0.15
    words = [f"w{i % 7}" for i in range(n)]
    uniq = sorted(set(words))
    cols = {
        "k": at.PrimitiveColumn(jnp.asarray(rng.integers(-100, 100, n)),
                                rdt.int64, jnp.asarray(~null)),
        "d": at.DictionaryColumn(jnp.asarray(np.array(
            [uniq.index(w) for w in words], np.int32)),
            at.StringColumn.from_pylist(uniq)),
        "f": at.column(rng.normal(size=n)),
        "b": at.column(rng.integers(0, 2, n) > 0),
        "u": at.column(rng.integers(0, 1000, n).astype(np.uint16)),
    }
    return at.Table(tuple(cols.values()), rdt.Schema(tuple(
        rdt.Field(k, c.dtype) for k, c in cols.items())))


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
def test_sort_table_all_keys(opt):
    """Every column a key: each decoded from the sorted keys."""
    t = _decode_table()
    by = [("k", opt)] + [(c, (False, True)) for c in "dfbu"]
    assert_tables_equal(
        ps.sort_table(port_table(t), [(c, _popt(o)) for c, o in by]),
        rs.sort_table(t, [(c, _ropt(o)) for c, o in by]))


@pytest.mark.parametrize("limit", [None, 17])
def test_sort_table_nonkey_columns_ride_gather(limit):
    t = _decode_table()
    for by in ([("k", (False, True))], [("f", (False, True))],
               [("u", (True, False)), ("k", (False, False))]):
        assert_tables_equal(
            ps.sort_table(port_table(t), [(c, _popt(o)) for c, o in by],
                          limit),
            rs.sort_table(t, [(c, _ropt(o)) for c, o in by], limit))


def _ref_sort_table(t, by, limit=None):
    """The reference's sort_table; where a string key sits beside a
    decodable key the reference raises (ROADMAP C), so its lexsort and
    take_table stand in."""
    if any(isinstance(t.column(c), at.StringColumn) for c, _ in by) and \
            len({c for c, _ in by}) > 1:
        idx = rs.lexsort_to_indices([rs.SortColumn(t.column(c), _ropt(o))
                                     for c, o in by], limit)
        return rtake_table(t, idx)
    return rs.sort_table(t, [(c, _ropt(o)) for c, o in by], limit)


def test_reference_sort_table_fails_on_a_string_key_beside_another():
    """A reference fault the port does not share (ROADMAP C)."""
    t = at.Table.from_pydict({"k": [2, 1], "s": ["b", "a"]})
    by = [("s", RSortOptions()), ("k", RSortOptions())]
    with pytest.raises(AttributeError):
        rs.sort_table(t, by)
    assert ps.sort_table(port_table(t), [(c, port_options(o))
                                         for c, o in by]).to_pydict() == \
        {"k": [1, 2], "s": ["a", "b"]}


def test_sort_table_repeated_and_string_keys():
    t = at.Table.from_pydict({"k": [2, 1, 2, None, 1], "s": ["b", "a", None,
                                                            "a", "c"],
                              "v": [1.0, 2.0, 3.0, 4.0, np.nan]})
    for by in ([("k", (False, True)), ("k", (True, False))],
               [("s", (True, True)), ("k", (False, True))],
               [("s", (False, False))]):
        assert_tables_equal(
            ps.sort_table(port_table(t), [(c, _popt(o)) for c, o in by]),
            _ref_sort_table(t, by))


def test_sort_dictionary_duplicate_values():
    """Ranks repeat where dictionary values do: a rank decodes to the
    first slot holding it."""
    d = at.DictionaryColumn(jnp.asarray(np.array([2, 0, 4, 1, 3], np.int32)),
                            at.StringColumn.from_pylist(["a", "a", "b", None,
                                                         "a"]))
    for opt in OPTIONS:
        got, want = ps.sort(port_column(d), _popt(opt)), rs.sort(d, _ropt(opt))
        assert_columns_equal(got, want)
    assert ps.sort(port_column(d)).to_pylist() == [None, "a", "a", "a", "b"]


def test_day_time_interval_sorts_by_signed_millis():
    pos, neg = (0 << 32) | 1, 0xFFFFFFFF & -1
    c = at.column([pos, neg, (3 << 32) | 5, -1 << 32],
                  dtype=rdt.interval("day_time"))
    for opt in OPTIONS:
        assert storage_list(ps.sort(port_column(c), _popt(opt))) == \
            storage_list(rs.sort(c, _ropt(opt)))
    assert ps.sort(port_column(c)).values.tolist()[1:3] == [neg, pos]


EMPTY = {"int64": lambda: at.column(np.zeros(0, np.int64)),
         "float32": lambda: at.column(np.zeros(0, np.float32)),
         "dictionary": lambda: at.DictionaryColumn(
             jnp.zeros((0,), jnp.int32), at.StringColumn.from_pylist(["a"]))}


@pytest.mark.parametrize("name", list(EMPTY))
def test_empty_columns(name):
    ref = EMPTY[name]()
    port = port_column(ref)
    assert_columns_equal(ps.sort(port), rs.sort(ref))
    assert _indices(ps.sort_to_indices(port)) == []
    assert _rank_list(ps.rank(port)) == _rank_list(rs.rank(ref)) == []
    assert ps.partition([port]).ranges() == rs.partition([ref]).ranges()
    t = at.Table((ref,), rdt.Schema((rdt.Field("c", ref.dtype),)))
    assert_tables_equal(ps.sort_table(port_table(t), [("c", _popt(
        (True, False)))]), rs.sort_table(t, [("c", _ropt((True, False)))]))


# ---- random multi-key tables over every key type ---------------------------

def _pool_values(rng, dtype, n):
    """Full-range values of `dtype` with many ties: half the rows drawn
    from five values (one at each extreme)."""
    d = np.dtype(dtype)
    if d == bool:
        return rng.random(n) < 0.5
    if d.kind == "f":
        v = (rng.integers(-4, 4, n) / 2).astype(d)
        v[::7] = -0.0
        v[1::11] = np.inf
        v[2::13] = -np.inf
        v[3::17] = np.nan
        v[4::19] = _nan_with_payload(d.type)[0]
        return v
    info = np.iinfo(d)
    v = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    pool = np.array([info.min, info.max, 0, info.max // 3, info.min // 2],
                    dtype=d)
    tie = rng.random(n) < 0.5
    v[tie] = pool[rng.integers(0, 5, tie.sum())]
    return v


def _key_column(name, rng, n):
    valid = jnp.asarray(rng.random(n) >= 0.2)
    if name == "dictionary":
        values = at.StringColumn.from_pylist(["q", "b", "zz", "b", None, "a"])
        return at.DictionaryColumn(jnp.asarray(rng.integers(0, 6, n).astype(
            np.int32)), values, valid)
    if name == "string":
        words = ["b", "a", "", "ab", "é", "a\x00"]
        return at.column([None if rng.random() < 0.2 else
                          words[rng.integers(0, 6)] for _ in range(n)])
    dtype = {"date32": rdt.date32, "timestamp[us]": rdt.timestamp("us"),
             "duration[ns]": rdt.duration("ns"),
             "interval[day_time]": rdt.interval("day_time")}.get(name)
    if dtype is None:
        return at.PrimitiveColumn(jnp.asarray(_pool_values(rng, name, n)),
                                  rdt.bool_ if name == "bool"
                                  else getattr(rdt, name), valid)
    store = np.dtype(dtype.to_jax())
    return at.PrimitiveColumn(jnp.asarray(_pool_values(rng, store, n)), dtype,
                              valid)


KEY_TYPES = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
             "uint64", "float16", "float32", "float64", "bool", "date32",
             "timestamp[us]", "duration[ns]", "interval[day_time]",
             "dictionary", "string"]


@pytest.mark.parametrize("opt", OPTIONS, ids=OPT_IDS)
@pytest.mark.parametrize("name", KEY_TYPES)
def test_random_multikey_table(name, opt):
    """lexsort_to_indices, lexsort, sort, rank and sort_table over a key
    of each type (ties, nulls, extremes, NaNs) and a second key."""
    rng = np.random.default_rng(KEY_TYPES.index(name))
    n = 300
    key = _key_column(name, rng, n)
    tie = at.PrimitiveColumn(jnp.asarray(rng.integers(-2, 3, n).astype(
        np.int32)), rdt.int32, jnp.asarray(rng.random(n) >= 0.1))
    pay = at.column(_pool_values(rng, np.float64, n))
    t = at.Table((key, tie, pay), rdt.Schema((
        rdt.Field("k", key.dtype), rdt.Field("j", rdt.int32),
        rdt.Field("v", rdt.float64))))
    pt = port_table(t)
    second = (not opt[0], opt[1])
    got = ps.lexsort_to_indices([ps.SortColumn(pt.column("k"), _popt(opt)),
                                 ps.SortColumn(pt.column("j"),
                                               _popt(second))])
    want = rs.lexsort_to_indices([rs.SortColumn(key, _ropt(opt)),
                                  rs.SortColumn(tie, _ropt(second))])
    assert _indices(got) == _indices(want), name
    by = [("k", opt), ("j", second)]
    assert_tables_equal(ps.sort_table(pt, [(c, _popt(o)) for c, o in by]),
                        _ref_sort_table(t, by))
    assert_columns_equal(ps.sort(pt.column("k"), _popt(opt), 50),
                         rs.sort(key, _ropt(opt), 50))
    for g, w in zip(ps.lexsort([ps.SortColumn(pt.column("k"), _popt(opt)),
                                ps.SortColumn(pt.column("v"))], 77),
                    rs.lexsort([rs.SortColumn(key, _ropt(opt)),
                                rs.SortColumn(pay)], 77)):
        assert_columns_equal(g, w)
    assert _rank_list(ps.rank(pt.column("k"), _popt(opt))) == \
        _rank_list(rs.rank(key, _ropt(opt)))
    assert ps.partition([pt.column("k"), pt.column("j")]).ranges() == \
        rs.partition([key, tie]).ranges()


# ---- config 3 ----------------------------------------------------------------

def _mix2(i: np.ndarray) -> np.ndarray:
    h = (i ^ (i >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    return (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)


def test_config3_lexsort_matches_reference():
    """bench.py:342-350's keys at 4,096 rows: an Int64 key with 10% nulls
    and a Dictionary<Utf8> code h % 1000, ascending, nulls first."""
    n = 4096
    with np.errstate(over="ignore"):
        h = _mix2(np.arange(n, dtype=np.uint64))
    keys = h.view(np.int64)
    codes = (h % np.uint64(1000)).astype(np.int32)
    valid = (h % np.uint64(10)) != 0
    words = at.StringColumn.from_pylist([f"w{i:04d}" for i in range(1000)])
    c1 = at.PrimitiveColumn(jnp.asarray(keys), rdt.int64, jnp.asarray(valid))
    c2 = at.DictionaryColumn(jnp.asarray(codes), words)
    opt = (False, True)
    want = rs.lexsort_to_indices([rs.SortColumn(c1, _ropt(opt)),
                                  rs.SortColumn(c2, _ropt(opt))])
    p1, p2 = port_column(c1), port_column(c2)
    got = ps.lexsort_to_indices([ps.SortColumn(p1, _popt(opt)),
                                 ps.SortColumn(p2, _popt(opt))])
    assert _indices(got) == _indices(want)
    t = at.Table((c1, c2), rdt.Schema((rdt.Field("k", rdt.int64),
                                       rdt.Field("d", c2.dtype))))
    sorted_t = ps.sort_table(port_table(t), [("k", _popt(opt)),
                                             ("d", _popt(opt))])
    assert_tables_equal(sorted_t, rs.sort_table(t, [("k", _ropt(opt)),
                                                    ("d", _ropt(opt))]))
    assert_tables_equal(sorted_t, take_table(port_table(t), got))


def test_ordered_dictionary_follows_pyarrow():
    """ROADMAP C1: the reference takes a declared-ordered dictionary's
    codes as ranks; the port ranks the values, as pyarrow sorts."""
    values = ["q", "b", "zz", "a"]
    codes = np.array([0, 1, 2, 3, 1, 0], np.int32)
    ref = at.DictionaryColumn(jnp.asarray(codes),
                              at.StringColumn.from_pylist(values),
                              ordered=True)
    port = DictionaryColumn(torch.from_numpy(codes),
                            StringColumn.from_pylist(values, device="cpu"),
                            ordered=True)
    assert ps.sort(port).to_pylist() == ["a", "b", "b", "q", "q", "zz"]
    assert rs.sort(ref).to_pylist() == ["q", "q", "b", "b", "zz", "a"]


def test_rank_and_partition_take_compact_plain_on_the_cpu(monkeypatch):
    """On CPU tensors K1's call sites take its plain version."""
    calls = []
    real = kc.compact_plain

    def counting(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(kc, "compact_plain", counting)
    before = kc.compact.launches
    col = att.column([3, 1, None, 3, 2, 1], device="cpu")
    assert _rank_list(ps.rank(col)) == [6, 3, 1, 6, 4, 3]
    assert ps.partition([col]).ranges() == [(i, i + 1) for i in range(6)]
    assert calls == [6, 5]
    assert kc.compact.launches == before


# ---- take ---------------------------------------------------------------------

@pytest.mark.parametrize("null_indices", [False, True])
def test_take_table_and_strings(null_indices):
    t = at.Table.from_pydict({
        "i": [1, None, 3, 4], "s": ["x", None, "zz", ""],
        "f": [1.5, np.nan, None, -0.0]})
    idx = at.PrimitiveColumn(jnp.asarray(np.array([3, 0, 2, 2, 9], np.uint32)),
                             rdt.uint32, jnp.asarray(np.array(
                                 [True, not null_indices, True, True, True])))
    pidx = port_column(idx)
    assert_tables_equal(take_table(port_table(t), pidx), rtake_table(t, idx))
    assert take(StringColumn.from_pylist(["a", "bc", None], device="cpu"),
                torch.tensor([2, 1, 1, 0])).to_pylist() == \
        [None, "bc", "bc", "a"]
