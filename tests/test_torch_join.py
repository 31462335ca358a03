"""arrow_tpu_torch's join against the reference (arrow_tpu.ops.join) on
the same numpy inputs, on both reference routes (the `route` fixture):
`join_indices` for every `how` on the port's index plan and on its
merge plans (forced by making the index build decline, the `plan`
fixture), `HashJoiner` and `join`.  Key types are in
test_torch_join_keys.py.

Comparison: where the build keys are unique, the row ids are equal
exactly (int64, values and order).  Where they repeat (m:n), the
reference sorts unstably and its order of build rows within one probe
row is unspecified, so the pairs are compared after a lexsort on (left,
right), and the port's own order is held to its contract: probe order,
and ascending build rows within a probe row (ROADMAP C).
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
import jax
import jax.numpy as jnp
from arrow_tpu_torch.errors import ArrowInvalid
from arrow_tpu_torch.kernels import compact as kc
from arrow_tpu_torch.ops import join as pj

from torch_port_util import (assert_tables_equal, port_table,  # noqa: F401
                             route, cuda_device)

rj = importlib.import_module("arrow_tpu.ops.join")


@pytest.fixture(autouse=True, scope="module")
def _no_reference_join_traces_left():
    """Drop the JAX package's compiled programs when this module ends.
    tests/test_groupby_join.py::test_perfect_index_with_probe_outliers
    spies on `_index_build_stage`, which runs only while the reference's
    join is traced; a program this module compiled for the same shapes
    (test_probe_outliers) hid the call whenever the two files shared a
    test worker in this order."""
    yield
    jax.clear_caches()
HOWS = ["inner", "left", "semi", "anti"]


@pytest.fixture(params=["index", "merge"])
def plan(request, monkeypatch):
    """The port's plan: "index" lets the index build run (and records that
    it ran); "merge" makes it decline, as duplicate keys would."""
    calls = []
    real = pj._index_build

    def index_build(*args):
        calls.append(args[-1])
        if request.param == "merge":
            return None, torch.tensor(True)
        return real(*args)

    monkeypatch.setattr(pj, "_index_build", index_build)
    return SimpleNamespace(name=request.param, calls=calls)


def ref_pairs(lt, rt, on, how, right_on=None):
    li, ri = rj.join_indices(lt, rt, on, how, right_on)
    return np.asarray(li), np.asarray(ri)


def port_pairs(lt, rt, on, how, right_on=None):
    li, ri = pj.join_indices(port_table(lt), port_table(rt), on, how,
                             right_on)
    assert li.dtype == ri.dtype == torch.int64
    return li.numpy(), ri.numpy()


def lexsorted(pairs):
    order = np.lexsort((pairs[1], pairs[0]))
    return pairs[0][order], pairs[1][order]


def assert_pairs(got, want, unique=True):
    """Exact where build keys are unique; else equal after a lexsort, and
    the port's pairs already in (probe, build) order."""
    assert got[0].dtype == np.int64 and want[0].dtype == np.int64
    if not unique:
        for a, b in zip(got, lexsorted(got)):
            np.testing.assert_array_equal(a, b)
        want = lexsorted(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def check(lt, rt, on, how, right_on=None, unique=True):
    got = port_pairs(lt, rt, on, how, right_on)
    assert_pairs(got, ref_pairs(lt, rt, on, how, right_on), unique)
    return got


def int_table(keys, valid=None, **payload):
    cols = {"k": at.column(np.asarray(keys, np.int64), validity=valid)}
    cols.update({n: np.asarray(v) for n, v in payload.items()})
    return at.Table.from_pydict(cols)


def unique_tables(seed, n_l=2000, n_r=300, domain=1200, nulls=0.05):
    """Unique build keys in [0, domain) and probe keys around them, with
    nulls on both sides (test_groupby_join.py:377-402)."""
    rng = np.random.default_rng(seed)
    bk = rng.choice(domain, n_r, replace=False)
    pk = rng.integers(-50, domain + 200, n_l)
    return (int_table(pk, rng.random(n_l) >= nulls, p=np.arange(n_l)),
            int_table(bk, rng.random(n_r) >= nulls, w=np.arange(n_r) * 7))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("how", HOWS)
def test_unique_build_keys(route, plan, how, seed):
    lt, rt = unique_tables(seed)
    check(lt, rt, ["k"], how)
    assert plan.calls, "the index plan was not tried"


@pytest.mark.parametrize("how", HOWS)
def test_many_to_many(route, plan, how):
    """Repeated build keys: the port's index build finds the duplicates
    and declines, as the reference's does."""
    rng = np.random.default_rng(7)
    n_l, n_r = 600, 200
    lt = int_table(rng.integers(-3, 70, n_l), rng.random(n_l) >= 0.1)
    rt = int_table(rng.integers(0, 60, n_r), rng.random(n_r) >= 0.1)
    got = check(lt, rt, ["k"], how, unique=False)
    if how == "inner":
        assert len(got[0]) > n_l       # some probe rows match several
    if plan.name == "index":
        assert plan.calls


@pytest.mark.parametrize("unique", [True, False], ids=["unique", "m-n"])
@pytest.mark.parametrize("how", HOWS)
def test_general_merge_plan_on_wide_keys(route, how, unique):
    """Keys spanning more than 2^61 take the general (unpacked) merge
    plan: int64 keys at both ends of the type."""
    rng = np.random.default_rng(3)
    pool = np.concatenate([[-2 ** 63, 2 ** 63 - 1, 0, -1],
                           rng.integers(-2 ** 62, 2 ** 62, 300)])
    pool = np.unique(pool)
    bk = rng.permutation(pool)[:200] if unique \
        else rng.choice(pool[:80], 200)
    pk = rng.choice(pool, 900)
    lt = int_table(pk, rng.random(900) >= 0.05)
    rt = int_table(bk, rng.random(200) >= 0.05)
    check(lt, rt, ["k"], how, unique=unique)


@pytest.mark.parametrize("empty", ["left", "right", "both"])
@pytest.mark.parametrize("how", HOWS)
def test_empty_inputs(route, how, empty):
    """A filter that matched nothing feeding a join
    (test_groupby_join.py:542-555)."""
    full = int_table([1, 2, 3])
    none = full.slice(0, 0)
    lt = none if empty in ("left", "both") else full
    rt = none if empty in ("right", "both") else full
    check(lt, rt, ["k"], how)


@pytest.mark.parametrize("how", HOWS)
def test_probe_outliers(route, plan, how):
    """Probe keys far outside the build range miss without disabling the
    index plan (test_groupby_join.py:405-425)."""
    lt = int_table([5, 2 ** 60, -2 ** 60, 7, 6, 2 ** 63 - 1, -2 ** 63])
    rt = int_table([5, 6, 8], w=[50, 60, 80])
    got = check(lt, rt, ["k"], how)
    assert plan.calls == [4]            # the build span: keys 5..8
    if how == "inner":
        assert got[0].tolist() == [0, 4] and got[1].tolist() == [0, 1]


@pytest.mark.parametrize("how", HOWS)
def test_many_null_build_keys(route, how, monkeypatch):
    """Null build keys never count as duplicates: the index plan stays
    (test_groupby_join.py:438-458)."""
    dups = []
    real = pj._index_build

    def spy(*args):
        table, dup = real(*args)
        dups.append(bool(dup))
        return table, dup

    monkeypatch.setattr(pj, "_index_build", spy)
    lt = int_table([5, 7, 9, 5])
    rt = int_table([5, 0, 0, 9, 0], [True, False, False, True, False])
    check(lt, rt, ["k"], how)
    assert dups == [False]


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("how", HOWS)
def test_all_null_keys(route, how, side):
    """No valid key on one side: nothing matches."""
    nulls = np.zeros(4, bool)
    lt = int_table([1, 2, 3, 4], nulls if side == "left" else None)
    rt = int_table([1, 2, 3, 4], nulls if side == "right" else None)
    check(lt, rt, ["k"], how)


@pytest.mark.parametrize("how", HOWS)
def test_multi_key_semi_anti_and_tables(route, how):
    """Multi-key joins verify every pair column by column
    (test_groupby_join.py:557-568)."""
    L = at.Table.from_pydict({"a": [1, 1, 2, 2], "b": [1, 2, 1, 9],
                              "v": [10, 20, 30, 40]})
    R = at.Table.from_pydict({"a": [1, 2], "b": [2, 9], "w": [5, 6]})
    want = rj.join(L, R, ["a", "b"], how=how)
    got = pj.join(port_table(L), port_table(R), ["a", "b"], how=how)
    assert_tables_equal(got, want)


@pytest.mark.parametrize("how", HOWS)
def test_forced_mixer_collision(route, how, monkeypatch):
    """Every two-column key folds to one value: all valid pairs become
    candidates and the per-column check (K1 compacting the pairs) must
    leave exactly the reference's matches."""
    monkeypatch.setattr(pj, "_fold", lambda keys: keys[0] if len(keys) == 1
                        else torch.zeros_like(keys[0]))
    compactions = []
    real = pj.compact

    def spy(keep, arrays, *args, **kwargs):
        compactions.append(len(arrays))
        return real(keep, arrays, *args, **kwargs)

    monkeypatch.setattr(pj, "compact", spy)
    rng = np.random.default_rng(5)
    pairs = rng.permutation(np.array([(a, b) for a in range(8)
                                      for b in range(8)]))
    ra, rb = pairs[:40, 0], pairs[:40, 1]           # unique (a, b) tuples
    lt = at.Table.from_pydict({
        "a": at.column(rng.integers(0, 9, 60), validity=rng.random(60) > .1),
        "b": rng.integers(0, 9, 60)})
    rt = at.Table.from_pydict({"a": ra, "b": at.column(
        rb, validity=rng.random(40) > .1)})
    check(lt, rt, ["a", "b"], how)
    assert 2 in compactions             # the pair compaction ran


def test_collision_check_keeps_probe_order_on_left_joins(monkeypatch):
    """A left join whose collisions were removed rebuilds the matched set
    from the surviving pairs."""
    monkeypatch.setattr(pj, "_fold", lambda keys: keys[0] if len(keys) == 1
                        else torch.zeros_like(keys[0]))
    L = at.Table.from_pydict({"a": [3, 1, 2], "b": [3, 1, 0]})
    R = at.Table.from_pydict({"a": [1, 2, 3], "b": [1, 2, 3]})
    assert_pairs(port_pairs(L, R, ["a", "b"], "left"),
                 ref_pairs(L, R, ["a", "b"], "left"))
    li, ri = port_pairs(L, R, ["a", "b"], "left")
    assert li.tolist() == [0, 1, 2] and ri.tolist() == [2, 0, -1]


# ---- HashJoiner ------------------------------------------------------------

def _chunks(n, size):
    return [(s, min(size, n - s)) for s in range(0, n, size)]


@pytest.mark.parametrize("how", HOWS)
def test_hash_joiner_chunks(route, plan, how):
    """Chunked probes of a unique-key build side, each chunk equal to the
    reference's HashJoiner (test_groupby_join.py:637-665); counts and
    checksums too, on the host and on the device."""
    rng = np.random.default_rng(11)
    bk = np.arange(0, 4000, 2, dtype=np.int64)
    pk = rng.integers(-100, 4100, 5000)
    valid = rng.random(5000) >= 0.05
    right, left = int_table(bk), int_table(pk, valid)
    want = rj.HashJoiner(right, ["k"])
    got = pj.HashJoiner(port_table(right), ["k"])
    assert want._plan == "index"
    assert got._plan == plan.name
    pleft = port_table(left)
    for s, n in _chunks(5000, 1500):
        w = want.probe_indices(left.slice(s, n), how)
        g = got.probe_indices(pleft.slice(s, n), how)
        assert_pairs((g[0].numpy(), g[1].numpy()),
                     (np.asarray(w[0]), np.asarray(w[1])))
        assert got.probe_count(pleft.slice(s, n)) == \
            want.probe_count(left.slice(s, n))
        c, k = got.probe_count_device(pleft.slice(s, n))
        assert c.dim() == k.dim() == 0 and c.dtype == k.dtype == torch.int64
        assert (int(c), int(k)) == want.probe_count(left.slice(s, n))


@pytest.mark.parametrize("how", HOWS)
def test_hash_joiner_merge_fallback(route, how):
    """Duplicate build keys decline the index plan; each probe then runs
    the merge plans (test_groupby_join.py:668-683)."""
    right = int_table([1, 1, 2, 5, 9])
    left = int_table([2, 3, 1, 9, 9, 4, 1], [1, 1, 1, 1, 0, 1, 1])
    want, got = rj.HashJoiner(right, ["k"]), pj.HashJoiner(
        port_table(right), ["k"])
    assert want._plan == got._plan == "merge"
    g = got.probe_indices(port_table(left), how)
    w = want.probe_indices(left, how)
    assert_pairs((g[0].numpy(), g[1].numpy()),
                 (np.asarray(w[0]), np.asarray(w[1])), unique=False)
    assert got.probe_count(port_table(left)) == want.probe_count(left)


@pytest.mark.parametrize("keys", ["float64", "dictionary", "two-column",
                                  "empty", "wide"])
def test_hash_joiner_plans(route, keys):
    """The reference's plan for each kind of build side (index only for
    one integer-like key of at most _SPAN_CAP values; floats too, through
    the same encode), and its counts."""
    rng = np.random.default_rng(2)
    if keys == "float64":
        bk = np.array([0.5, -0.0, 0.0, np.nan, 1.0], np.float64)
        right = at.Table.from_pydict({"k": bk})
        left = at.Table.from_pydict({"k": rng.choice(bk, 40)})
    elif keys == "dictionary":
        right = at.Table.from_pydict({"k": at.DictionaryColumn(
            jnp.arange(3, dtype=jnp.int32),
            at.StringColumn.from_pylist(["x", "y", "z"]))})
        left = at.Table.from_pydict({"k": at.DictionaryColumn(
            jnp.asarray(rng.integers(0, 2, 30).astype(np.int32)),
            at.StringColumn.from_pylist(["z", "q"]))})
    elif keys == "two-column":
        right = at.Table.from_pydict({"k": [1, 2, 3], "j": [4, 5, 6]})
        left = at.Table.from_pydict({"k": rng.integers(0, 4, 30),
                                     "j": rng.integers(4, 7, 30)})
    elif keys == "empty":
        right = int_table([]).slice(0, 0)
        left = int_table(rng.integers(0, 4, 30))
    else:
        right = int_table([0, 2 ** 40])
        left = int_table([0, 1, 2 ** 40])
    on = ["k", "j"] if keys == "two-column" else ["k"]
    want = rj.HashJoiner(right, on)
    got = pj.HashJoiner(port_table(right), on)
    assert got._plan == want._plan
    assert got.probe_count(port_table(left)) == want.probe_count(left)
    for how in HOWS:
        g = got.probe_indices(port_table(left), how)
        w = want.probe_indices(left, how)
        assert_pairs((g[0].numpy(), g[1].numpy()),
                     (np.asarray(w[0]), np.asarray(w[1])))


# ---- join ------------------------------------------------------------------

def payload_tables(seed):
    """Unique build keys; payloads of integer, float and dictionary type,
    with nulls, and a right column whose name clashes with the left's."""
    rng = np.random.default_rng(seed)
    n_l, n_r = 400, 120
    lt, rt = unique_tables(seed, n_l, n_r, domain=300)
    words = at.StringColumn.from_pylist(["a", "b", None, "d"])
    lt = at.Table.from_pydict({
        "k": lt.column("k"),
        "v": at.column(rng.integers(-9, 9, n_l).astype(np.int32),
                       validity=rng.random(n_l) > 0.2),
        "x": rng.standard_normal(n_l)})
    rt = at.Table.from_pydict({
        "x": at.column(rng.standard_normal(n_r).astype(np.float32),
                       validity=rng.random(n_r) > 0.2),
        "k": rt.column("k"),
        "d": at.DictionaryColumn(
            jnp.asarray(rng.integers(0, 4, n_r).astype(np.int32)), words,
            jnp.asarray(rng.random(n_r) > 0.1)),
        "u": rng.integers(0, 2 ** 63, n_r).astype(np.uint64)})
    return lt, rt


@pytest.mark.parametrize("how", HOWS)
def test_join_tables(route, plan, how):
    """Output columns, names (suffix on a clash), dtypes, nullability and
    values equal the reference's join."""
    lt, rt = payload_tables(4)
    want = rj.join(lt, rt, ["k"], how=how)
    got = pj.join(port_table(lt), port_table(rt), ["k"], how=how)
    assert_tables_equal(got, want)
    expected = ["k", "v", "x"] if how in ("semi", "anti") \
        else ["k", "v", "x", "x_right", "d", "u"]
    assert got.column_names == expected


def test_join_right_on_and_suffix(route):
    lt, rt = payload_tables(6)
    rt = at.Table(rt.columns, at.Schema(tuple(
        at.Field("key" if f.name == "k" else f.name, f.dtype, f.nullable)
        for f in rt.schema.fields)))
    for how in ("inner", "left"):
        want = rj.join(lt, rt, ["k"], how=how, right_on=["key"],
                       suffix="_r")
        got = pj.join(port_table(lt), port_table(rt), ["k"], how=how,
                      right_on=["key"], suffix="_r")
        assert_tables_equal(got, want)
        assert "x_r" in got.column_names and "key" not in got.column_names


def test_join_string_payload_raises_naming_a7():
    """String columns in join's output, once ROADMAP A7 named, now ride
    the device take (ops/take.py) as the reference's take."""
    left = at.Table.from_pydict({"k": [1, 2, 2], "s": ["a", None, "é"]})
    right = at.Table.from_pydict({"k": [2, 3], "t": ["x", ""]})
    for how in ("inner", "left", "semi", "anti"):
        assert_tables_equal(
            pj.join(port_table(left), port_table(right), ["k"], how=how),
            rj.join(left, right, ["k"], how=how))


@pytest.mark.parametrize("call", ["join_indices", "hash_joiner"])
def test_unknown_join_type_raises(call):
    t = att.Table.from_pydict({"k": [1, 2]}, device="cpu")
    with pytest.raises(ArrowInvalid, match="unknown join type"):
        if call == "join_indices":
            pj.join_indices(t, t, ["k"], how="outer")
        else:
            pj.HashJoiner(t, ["k"]).probe_indices(t, "outer")


@pytest.mark.parametrize("side", ["build", "probe"])
def test_row_ids_beyond_the_limit_raise(side, monkeypatch):
    """The reference's plans hold row ids in int32; a side beyond them
    raises rather than widening silently (here with the limit at 4)."""
    monkeypatch.setattr(pj, "_MAX_ROWS", 4)
    small = att.Table.from_pydict({"k": [1, 2]}, device="cpu")
    big = att.Table.from_pydict({"k": [1, 2, 3, 4, 5]}, device="cpu")
    dup = att.Table.from_pydict({"k": [1, 1]}, device="cpu")
    with pytest.raises(ArrowInvalid, match=side):
        if side == "build":
            pj.join_indices(small, big, ["k"])
        else:
            pj.join_indices(big, dup, ["k"])    # merge plan
    # the index plan takes a probe side of any length
    li, _ = pj.join_indices(big, small, ["k"])
    assert li.tolist() == [0, 1]


# ---- on the card -----------------------------------------------------------

def _to(table, device):
    return att.Table([att.PrimitiveColumn(
        c.values.to(device), c.dtype,
        None if c.validity is None else c.validity.to(device))
        for c in table.columns], table.schema)


@pytest.mark.parametrize("case", ["index", "m-n", "two-column"])
@pytest.mark.parametrize("how", HOWS)
def test_join_on_cuda_equals_the_plain_route(cuda_device, how, case):
    """The same join on the card (K1 at every compaction) and on the CPU
    (K1's plain version): equal row ids; the card launched K1 wherever
    the join compacts."""
    rng = np.random.default_rng(9)
    n_l, n_r = 300_000, 40_000
    if case == "index":
        bk = rng.choice(100_000, n_r, replace=False)
    else:
        bk = rng.integers(0, 30_000, n_r)
    cols_l = {"k": at.column(rng.integers(-10, 100_010, n_l),
                             validity=rng.random(n_l) > 0.05)}
    cols_r = {"k": at.column(bk, validity=rng.random(n_r) > 0.05)}
    on = ["k"]
    if case == "two-column":
        cols_l["j"] = rng.integers(0, 3, n_l)
        cols_r["j"] = rng.integers(0, 3, n_r)
        on = ["k", "j"]
    lt = port_table(at.Table.from_pydict(cols_l))
    rt = port_table(at.Table.from_pydict(cols_r))
    want = pj.join_indices(lt, rt, on, how)
    before = kc.compact.launches
    got = pj.join_indices(_to(lt, cuda_device), _to(rt, cuda_device), on,
                          how)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    # every plan compacts but the index plan's left join
    compacts = how != "left" or case != "index"
    assert (kc.compact.launches > before) == compacts
