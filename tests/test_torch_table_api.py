"""The Table and Column API of the port (core/table.py, core/column.py,
core/equal.py, FilterPredicate.indices, the integer bounds of dtypes.py,
io/flightsql.py's dt_schema) against the JAX package on the CPU.

The same inputs, made from a seed with numpy and pyarrow, go through both
packages (`port_column` carries the reference's buffers across); every
answer is compared exactly.  `Column.equals` and `Table.equals` are held
to the reference's over every layout, with Hypothesis drawing the seed
and the size, on pairs that differ in one thing: a value bit, a NaN
payload, the sign of zero, a null position, the bits under a null slot
(equal), a dictionary built apart (equal), run-end runs split
differently (equal), list-view offsets that differ but agree (equal), a
struct child under a null parent (equal), a slice against its copy
(equal).  Where the reference raises (it lists columns through pyarrow,
which refuses some types), the gap is recorded as ROADMAP's C-table
records the others: C27.
"""

from __future__ import annotations

import importlib
import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import arrow_tpu as at
import arrow_tpu_torch as att
import arrow_tpu_torch.core.equal as peq
from arrow_tpu.core import nested as rn
from arrow_tpu_torch.core.column import PrimitiveColumn
from arrow_tpu_torch.errors import ArrowInvalid
from arrow_tpu_torch.ops.filter import FilterPredicate
from test_torch_nested import WORDS, pa_layout
from torch_port_util import cuda_device  # noqa: F401
from torch_port_util import port_column, port_table

rd, pd = at.dtypes, att.dtypes
rfilter = importlib.import_module("arrow_tpu.ops.filter")
CASES = settings(max_examples=12, deadline=None, derandomize=True,
                 database=None,
                 suppress_health_check=list(HealthCheck))


# ---- dtypes ---------------------------------------------------------------

def every_type(m):
    """One of each DataType constructor of a dtypes module `m` (the
    reference's or the port's), labelled."""
    f = m.Field
    out = [(n, getattr(m, n)) for n in (
        "null", "bool_", "int8", "int16", "int32", "int64", "uint8",
        "uint16", "uint32", "uint64", "float16", "float32", "float64",
        "utf8", "large_utf8", "utf8_view", "binary", "large_binary",
        "binary_view", "date32", "date64")]
    out += [(f"timestamp_{u}", m.timestamp(u)) for u in ("s", "ns")]
    out += [("timestamp_tz", m.timestamp("us", "UTC")),
            ("time32", m.time32("ms")), ("time64", m.time64("ns")),
            ("duration", m.duration("us")),
            ("fixed_size_binary", m.fixed_size_binary(4))]
    out += [(f"interval_{u}", m.interval(u))
            for u in ("year_month", "day_time", "month_day_nano")]
    out += [(n, getattr(m, n)(9, 2)) for n in (
        "decimal32", "decimal64", "decimal128", "decimal256")]
    out += [("dictionary", m.dictionary(m.int32, m.utf8)),
            ("list", m.list_(m.int64)), ("large_list", m.large_list(m.int64)),
            ("list_view", m.list_view(m.int64)),
            ("large_list_view", m.large_list_view(m.int64)),
            ("fixed_size_list", m.fixed_size_list(m.int32, 3)),
            ("struct", m.struct([f("a", m.int64)])),
            ("map", m.map_(m.utf8, m.int64)),
            ("union", m.union([f("a", m.int64)], "sparse", [0])),
            ("run_end_encoded", m.run_end_encoded(m.int32, m.int64)),
            ("uuid", m.uuid()), ("json", m.json_()), ("bool8", m.bool8()),
            ("fixed_shape_tensor",
             m.fixed_shape_tensor(m.float32, (2, 2))),
            ("opaque", m.opaque(m.int64, "t", "v"))]
    return out


def test_integer_limits_tables():
    assert (pd.INT_MIN, pd.INT_MAX, pd.UINT_MAX) == \
        (rd.INT_MIN, rd.INT_MAX, rd.UINT_MAX)


@pytest.mark.parametrize("i", range(len(every_type(rd))))
def test_integer_bounds_of_every_type(i):
    """integer_bounds(dt) gives the reference's bounds, or raises the
    reference's TypeError with its message (the port raised ValueError
    for float64 and bool, and answered for temporal types: ROADMAP C28);
    its parameter is named `dt` (C29)."""
    (label, ref), (plabel, port) = every_type(rd)[i], every_type(pd)[i]
    assert label == plabel
    try:
        want = rd.integer_bounds(dt=ref)
    except (TypeError, AttributeError) as e:
        with pytest.raises(type(e)) as got:
            pd.integer_bounds(dt=port)
        if isinstance(e, TypeError):
            assert str(got.value) == str(e).replace(repr(ref), repr(port))
    else:
        assert pd.integer_bounds(dt=port) == want


# ---- the column helpers -----------------------------------------------------

def test_primitive_with_values_and_to_numpy(rng):
    ref = at.column(rng.integers(-50, 50, 40), validity=rng.random(40) > 0.3)
    port = port_column(ref)
    new = rng.integers(-9, 9, 40)
    rgot = ref.with_values(np.asarray(new))
    pgot = port.with_values(torch.from_numpy(new))
    assert pgot.validity is port.validity and pgot.dtype == port.dtype
    assert pgot.values.tolist() == np.asarray(rgot.values).tolist()
    assert pgot.to_pylist() == rgot.to_pylist()
    canon = port.with_values(torch.from_numpy(new), _canonical=False)
    assert canon.values.tolist() == np.asarray(
        ref.with_values(np.asarray(new), _canonical=False).values).tolist()
    f32 = port.with_values(torch.from_numpy(new.astype(np.float32)),
                           pd.float32)
    assert f32.dtype == pd.float32 and f32.validity is port.validity
    for zero in (True, False):
        assert port.to_numpy(zero_nulls=zero).tolist() == \
            ref.to_numpy(zero_nulls=zero).tolist()


@pytest.mark.parametrize("dtype", ["utf8", "large_utf8", "binary"])
def test_string_to_pylist_host(dtype):
    vals = ["", "a", None, "日本", "zz"] * 3
    vals = vals if dtype != "binary" else \
        [None if v is None else v.encode() for v in vals]
    ref = at.column(pa.array(vals, getattr(pa, dtype)())).slice(2, 11)
    port = port_column(ref)
    assert port.to_pylist_host() == ref.to_pylist_host()


@pytest.mark.parametrize("ordered", [False, True])
def test_dictionary_helpers(rng, ordered):
    arr = pa.DictionaryArray.from_arrays(
        pa.array(rng.integers(0, 4, 30).astype(np.int16)),
        pa.array(["w", "x", "y", "z"]), ordered=ordered)
    ref = at.column(arr)
    port = port_column(ref)
    assert (port.ordered, port.dictionary_size) == \
        (ref.ordered, ref.dictionary_size)
    assert isinstance(type(port).ordered, property)
    codes = rng.integers(0, 4, 30).astype(np.int16)
    rgot = ref.with_codes(np.asarray(codes))
    pgot = port.with_codes(torch.from_numpy(codes))
    assert pgot.values is port.values and pgot.dtype == port.dtype
    assert pgot.to_pylist() == rgot.to_pylist()
    assert pgot.ordered == ordered


def test_base_column_with_validity_is_abstract():
    with pytest.raises(NotImplementedError):
        at.Column.with_validity(None, None)
    with pytest.raises(NotImplementedError):
        att.Column.with_validity(None, None)


# ---- tables: the reference's cases (tests/test_core.py:81-100, 162-190) -----

def both(data):
    return at.Table.from_pydict(data), att.Table.from_pydict(data,
                                                             device="cpu")


def test_table_construction_and_select():
    r, p = both({"a": [1, 2], "b": ["x", "y"]})
    assert (p.num_rows, p.num_columns, p.column_names) == \
        (r.num_rows, r.num_columns, r.column_names)
    assert p.select(["b"]).column_names == r.select(["b"]).column_names
    with pytest.raises(att.ArrowError):
        att.Table.from_pydict({"a": [1, 2], "b": [1]}, device="cpu")


def test_column_table_equals():
    cases = [([1.0, float("nan"), None], [1.0, float("nan"), None], None),
             ([1.0, float("nan"), None], [1.0, 2.0, None], None)]
    for x, y, d in cases:
        got = att.column(x, device="cpu").equals(att.column(y, device="cpu"))
        assert got == at.column(x).equals(at.column(y))
    f32 = at.column([1.0, float("nan"), None], at.float32)
    pf32 = att.column([1.0, float("nan"), None], pd.float32, device="cpu")
    assert at.column([1.0, float("nan"), None]).equals(f32) is False
    assert att.column([1.0, float("nan"), None], device="cpu").equals(pf32) \
        is False
    lt = [[1, None], None]
    assert att.column(lt, pd.list_(pd.int64), device="cpu").equals(
        att.column(lt, pd.list_(pd.int64), device="cpu"))
    r1, p1 = both({"x": [1, 2], "y": ["a", None]})
    r2, p2 = both({"x": [1, 2], "y": ["a", None]})
    r3, p3 = both({"x": [1, 2], "z": ["a", None]})
    for r, p in ((r2, p2), (r2.select(["y", "x"]), p2.select(["y", "x"])),
                 (r3, p3)):
        assert p1.equals(p) == r1.equals(r)
    assert p1.equals(p2) and not p1.equals(p3)
    assert p1.equals("not a table") == r1.equals("not a table") is False


def test_equals_byte_level_and_metadata():
    for x, y in (([0.0, -0.0], [0.0, 0.0]), ([-0.0], [-0.0])):
        got = att.column(x, device="cpu").equals(att.column(y, device="cpu"))
        assert got == at.column(x).equals(at.column(y))
    r1, p1 = both({"x": [1]})
    meta = (("k", "v"),)
    r2 = at.Table(r1.columns, rd.Schema(r1.schema.fields, meta))
    p2 = att.Table(p1.columns, pd.Schema(p1.schema.fields, meta))
    assert (p1.equals(p2), p2.equals(p2)) == (r1.equals(r2), r2.equals(r2))
    rf, pf = r1.schema.fields[0], p1.schema.fields[0]
    fmeta = (("fk", "fv"),)
    r3 = at.Table(r1.columns, rd.Schema((rd.Field(rf.name, rf.dtype,
                                                  rf.nullable, fmeta),)))
    p3 = att.Table(p1.columns, pd.Schema((pd.Field(pf.name, pf.dtype,
                                                   pf.nullable, fmeta),)))
    assert p1.equals(p3) == r1.equals(r3) is False
    r4 = at.Table(r1.columns, rd.Schema((rd.Field(rf.name, rf.dtype,
                                                  not rf.nullable),)))
    p4 = att.Table(p1.columns, pd.Schema((pd.Field(pf.name, pf.dtype,
                                                   not pf.nullable),)))
    assert p1.equals(p4) == r1.equals(r4) is False


def _schema(t):
    return [(f.name, repr(f.dtype), f.nullable, tuple(f.metadata))
            for f in t.schema.fields] + [tuple(t.schema.metadata)]


def _table_pair(rng, n=30):
    batch = pa.record_batch({
        "i": pa.array(rng.integers(-9, 9, n), mask=rng.random(n) < 0.2),
        "f": pa.array(rng.random(n)),
        "s": pa.array([WORDS[i] for i in rng.integers(0, len(WORDS), n)]),
        "d": pa.array([WORDS[i] for i in rng.integers(0, 3, n)])
        .dictionary_encode()})
    batch = batch.replace_schema_metadata({"origin": "test"})
    ref = at.Table.from_pyarrow(batch)
    return ref, port_table(ref)


@pytest.mark.parametrize("key", [["s", "i"], [3, 0, 1], ["f"], [],
                                 ["i", "i"]])
def test_select(rng, key):
    r, p = _table_pair(rng)
    rs, ps = r.select(key), p.select(key)
    assert _schema(ps) == _schema(rs)
    assert all(c is p.columns[p.schema.index_of(n)]
               for c, n in zip(ps.columns, ps.column_names))
    assert ps.to_pydict() == rs.to_pydict()


def test_getitem(rng):
    r, p = _table_pair(rng)
    for k in ("s", 0, -1, "d"):
        assert p[k] is p.column(k)
        assert p[k].to_pylist() == r[k].to_pylist()
    with pytest.raises(KeyError):
        p["nope"]
    with pytest.raises(KeyError):
        r["nope"]


def test_column_edits_are_zero_copy(rng):
    r, p = _table_pair(rng)
    ptrs = [c.values.data_ptr() if hasattr(c, "values") and
            isinstance(c, PrimitiveColumn) else None for c in p.columns]
    rcol, pcol = r["i"], p["i"]
    cases = [
        (lambda t, c: t.append_column("i2", c)),
        (lambda t, c: t.drop_column("f")),
        (lambda t, c: t.rename_columns(["a", "b", "c", "e"])),
        (lambda t, c: t.set_column(1, type(t.schema.fields[0])(
            "g", c.dtype, True), c)),
    ]
    for case in cases:
        rt, pt = case(r, rcol), case(p, pcol)
        assert _schema(pt) == _schema(rt)
        assert pt.to_pydict() == rt.to_pydict()
        assert pt.equals(pt) and pt.equals(port_table(rt)) == rt.equals(rt)
        for c in pt.columns:
            if isinstance(c, PrimitiveColumn):
                assert c.values.data_ptr() in ptrs
    assert p.append_column("n", att.column([1.0] * 30, device="cpu")) \
        .schema.fields[-1].nullable is False


def test_column_on_another_device_raises(rng):
    _, p = _table_pair(rng)
    meta = PrimitiveColumn(torch.empty(30, dtype=torch.int64, device="meta"),
                           pd.int64, _canonical=True)
    with pytest.raises(ArrowInvalid):
        p.append_column("m", meta)
    with pytest.raises(ArrowInvalid):
        p.set_column(0, p.schema.fields[0], meta)
    one = att.Table([p["i"]], pd.Schema((p.schema.fields[0],)))
    assert one.set_column(0, p.schema.fields[0], meta).num_rows == 30
    with pytest.raises(ArrowInvalid):
        p["i"].equals(meta)


def test_dt_schema():
    from arrow_tpu.io.flightsql import dt_schema as rschema
    from arrow_tpu_torch.io.flightsql import dt_schema as pschema
    rcols = [at.column([1, None]), at.column(["a", "b"])]
    pcols = [port_column(c) for c in rcols]
    rs, ps = rschema(["x", "y"], rcols), pschema(["x", "y"], pcols)
    assert [(f.name, repr(f.dtype), f.nullable) for f in ps.fields] == \
        [(f.name, repr(f.dtype), f.nullable) for f in rs.fields]


# ---- FilterPredicate.indices ------------------------------------------------

@pytest.mark.parametrize("share", [0.0, 0.02, 0.5, 1.0])
@pytest.mark.parametrize("nulls", [False, True])
def test_filter_predicate_indices(rng, share, nulls):
    n = 3000
    keep = rng.random(n) < share
    valid = rng.random(n) > 0.1 if nulls else None
    ref = rfilter.FilterPredicate(at.column(keep, validity=valid))
    port = FilterPredicate(port_column(at.column(keep, validity=valid)))
    got = port.indices
    assert got is port.indices                     # made once
    assert got.dtype == pd.int32 and got.values.dtype == torch.int32
    assert got.validity is None
    want = np.asarray(ref.indices.values)
    assert got.values.tolist() == want.tolist()
    assert np.all(np.diff(want) > 0) and len(want) == port.count


def test_filter_predicate_indices_past_int32_raise(monkeypatch):
    """Past 2^31 rows K1's int32 positions raise (checked at a small
    size by stretching the check's bound)."""
    from arrow_tpu_torch.kernels import compact as kc
    keep = PrimitiveColumn(torch.ones(8, dtype=torch.bool), pd.bool_)
    pred = FilterPredicate(keep)
    real = kc._check_args

    def tight(k, arrays, positions):
        if positions == torch.int32 and k.shape[0] > 4:
            raise ArrowInvalid(f"compact: int32 positions of "
                               f"{k.shape[0]} rows")
        return real(k, arrays, positions)
    monkeypatch.setattr(kc, "_check_args", tight)
    with pytest.raises(ArrowInvalid):
        pred.indices


# ---- equals over every layout -----------------------------------------------

STRINGS = {"utf8": pa.utf8(), "large_utf8": pa.large_utf8(),
           "utf8_view": pa.string_view(), "binary": pa.binary(),
           "large_binary": pa.large_binary(),
           "binary_view": pa.binary_view()}
PRIMITIVE = {"int8": pa.int8(), "uint64": pa.uint64(), "int64": pa.int64(),
             "float16": pa.float16(), "float32": pa.float32(),
             "float64": pa.float64(), "bool": pa.bool_(),
             "date32": pa.date32(), "date64": pa.date64(),
             "time32": pa.time32("ms"), "time64_ns": pa.time64("ns"),
             "timestamp_tz": pa.timestamp("ns", "America/New_York"),
             "timestamp_s": pa.timestamp("s"),
             "duration_ns": pa.duration("ns")}
TOP = {"int8": 100, "date32": 2 ** 20, "time32": 86_400_000,
       "time64_ns": 86_400 * 10 ** 9, "timestamp_s": 2 ** 31}
NESTED = ["list", "large_list", "large_list_utf8", "list_list", "list_view",
          "large_list_view", "struct", "map", "fsl", "fsb", "decimal32",
          "decimal128", "decimal256", "interval_mdn", "sparse_union",
          "dense_union", "run_end"]
KINDS = list(PRIMITIVE) + list(STRINGS) + NESTED + [
    "dictionary", "dictionary_f64", "run_end_utf8", "null"]


def pa_array(kind, rng, n):
    """A pyarrow array of `kind`, n rows, nulls among them."""
    mask = rng.random(n) < 0.2
    if kind in PRIMITIVE:
        t = PRIMITIVE[kind]
        if kind.startswith("float"):
            v = (rng.integers(-8, 8, n) / 4).astype(t.to_pandas_dtype())
            v[rng.random(n) < 0.2] = np.nan
            v[rng.random(n) < 0.1] = -0.0
        elif kind == "bool":
            v = rng.random(n) < 0.5
        else:                  # inside the range every unit lists
            v = rng.integers(0, TOP.get(kind, 2 ** 40), n)
            return pa.array(v.astype(f"int{t.bit_width}"),
                            mask=mask).view(t)
        return pa.array(v, t, mask=mask) if kind != "float16" else \
            pa.array(v.astype(np.float16), mask=mask)
    if kind in STRINGS:
        words = [None if m else WORDS[i] for m, i in
                 zip(mask, rng.integers(0, len(WORDS), n))]
        if "binary" in kind:
            words = [None if w is None else w.encode() for w in words]
        return pa.array(words, STRINGS[kind])
    if kind == "dictionary":
        codes = pa.array(rng.integers(0, 4, n).astype(np.int32), mask=mask)
        return pa.DictionaryArray.from_arrays(
            codes, pa.array(["a", "b", None, "日本"]))
    if kind == "dictionary_f64":
        codes = pa.array(rng.integers(0, 4, n).astype(np.int8), mask=mask)
        return pa.DictionaryArray.from_arrays(
            codes, pa.array([1.5, float("nan"), -0.0, 0.0]))
    if kind == "run_end_utf8":
        ends = np.unique(np.append(rng.integers(1, n + 1, n // 2 + 1), n))
        vals = [None if rng.random() < 0.2 else WORDS[i] for i in
                rng.integers(0, len(WORDS), len(ends))]
        return pa.RunEndEncodedArray.from_arrays(
            pa.array(ends.astype(np.int32)), pa.array(vals, pa.utf8()))
    if kind == "null":
        return pa.nulls(n)
    return pa_layout(kind, rng, n)


def ref_col(kind, rng, n):
    if kind == "null":
        return at.NullColumn(n)
    return at.column(pa_array(kind, rng, n))


def agree(ra, rb, expect=None):
    """The port answers as the reference does (and as `expect` says,
    where the case fixes the answer)."""
    want = ra.equals(rb)
    pa_, pb = port_column(ra), port_column(rb)
    assert pa_.equals(pb) == want, (ra.to_pylist(), rb.to_pylist())
    assert pb.equals(pa_) == rb.equals(ra)
    if expect is not None:
        assert want == expect
    ta = att.Table([pa_], pd.Schema((pd.Field("c", pa_.dtype),)))
    tb = att.Table([pb], pd.Schema((pd.Field("c", pb.dtype),)))
    assert ta.equals(tb) == want


def _rows(col):
    return col.to_pylist()


@pytest.mark.parametrize("kind", KINDS)
@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 40))
def test_equals_same_buffers_and_rebuilt(kind, seed, n):
    rng = np.random.default_rng(seed)
    arr = pa_array(kind, rng, n)
    ra = at.NullColumn(n) if kind == "null" else at.column(arr)
    agree(ra, ra if kind == "null" else at.column(arr), True)
    agree(ra, at.NullColumn(n) if kind == "null" else at.column(arr), True)
    rng2 = np.random.default_rng(seed + 1)
    agree(ra, ref_col(kind, rng2, n))          # an unrelated column


REBUILT = [k for k in KINDS if k not in ("sparse_union", "dense_union",
                                         "run_end", "run_end_utf8", "null")]


@pytest.mark.parametrize("kind", REBUILT)
@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(2, 40))
def test_equals_one_row_changed_or_nulled(kind, seed, n):
    """One row set to another row's value, or to null: False where the
    rows differ (pyarrow builds b anew from the rows)."""
    rng = np.random.default_rng(seed)
    arr = pa_array(kind, rng, n)
    rows = arr.to_pylist()
    ra = at.column(arr)
    i, j = rng.integers(0, n, 2)
    for new in (rows[j], None):
        changed = list(rows)
        changed[i] = new
        b = pa.array(changed, arr.type)
        agree(ra, at.column(b))


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "null"])
@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(8, 40))
def test_equals_slice_against_its_copy(kind, seed, n):
    rng = np.random.default_rng(seed)
    arr = pa_array(kind, rng, n)
    ra = at.column(arr).slice(3, n - 5)
    copy = at.column(arr.slice(3, n - 5))
    agree(ra, copy, True)
    if kind not in ("sparse_union", "dense_union") + tuple(
            k for k in KINDS if k.startswith("run_end")):
        agree(ra, at.column(pa.array(arr.slice(3, n - 5).to_pylist(),
                                     arr.type)), True)


# ---- bit-level pairs --------------------------------------------------------

def _ref_primitive(values, dtype, validity=None, canonical=False):
    import jax.numpy as jnp
    return at.PrimitiveColumn(jnp.asarray(values), dtype,
                              None if validity is None
                              else jnp.asarray(validity),
                              _canonical=canonical)


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 40),
       bit=st.integers(0, 63))
def test_equals_one_value_bit(seed, n, bit):
    rng = np.random.default_rng(seed)
    v = rng.integers(-2 ** 62, 2 ** 62, n)
    valid = rng.random(n) > 0.3
    w = v.copy()
    i = int(rng.integers(0, n))
    w.view(np.uint64)[i] ^= np.uint64(1 << bit)
    agree(_ref_primitive(v, rd.int64, valid), _ref_primitive(w, rd.int64,
                                                             valid),
          not valid[i] and None)


NANS64 = [0x7FF8000000000000, 0x7FF8000000000001, 0xFFF8000000000000,
          0x7FF0000000000001, 0x7FF4000000000000]
NANS32 = [0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001, 0x7FA00000]


NANS16 = [0x7E00, 0x7E01, 0xFE00, 0x7C01, 0x7D00]
NAN_BITS = {16: (NANS16, np.uint16, np.float16, rd.float16),
            32: (NANS32, np.uint32, np.float32, rd.float32),
            64: (NANS64, np.uint64, np.float64, rd.float64)}


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("x,y", [(i, j) for i in range(5) for j in range(5)])
def test_equals_nan_payloads(width, x, y):
    """NaNs compare by their bits as the reference lists them: float16
    and float64 exactly (a half widens with its payload and its
    signalling bit); float32 widened, which quiets a signalling NaN (so
    0x7F800001 equals 0x7FC00001 in the reference)."""
    bits, u, fl, f = NAN_BITS[width]
    a = np.array([1.0, 0.0], fl)
    b = a.copy()
    a.view(u)[1], b.view(u)[1] = bits[x], bits[y]
    agree(_ref_primitive(a, f), _ref_primitive(b, f),
          (x == y) if width != 32 else (x == y) or None)


def test_equals_signalling_nan_float32_is_quieted_in_the_reference():
    a = np.array([0x7F800001], np.uint32).view(np.float32)
    b = np.array([0x7FC00001], np.uint32).view(np.float32)
    agree(_ref_primitive(a, rd.float32), _ref_primitive(b, rd.float32), True)


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_equals_sign_of_zero(dtype):
    a = np.array([-0.0, 1.0], dtype)
    b = np.array([0.0, 1.0], dtype)
    f = getattr(rd, dtype)
    agree(_ref_primitive(a, f), _ref_primitive(b, f), False)
    agree(_ref_primitive(a, f), _ref_primitive(a.copy(), f), True)


@pytest.mark.parametrize("dtype,step", [("time64", 999), ("date64", 1000)])
def test_equals_follows_lossy_listing(dtype, step):
    """time64[ns] lists microseconds and date64 whole days: values within
    one listed unit are equal in the reference, and in the port."""
    t = rd.time64("ns") if dtype == "time64" else rd.date64
    a = np.array([5_000, 86_400_000 * 3], np.int64)
    agree(_ref_primitive(a, t), _ref_primitive(a + (step if dtype ==
                                                    "time64" else 7), t),
          True)
    agree(_ref_primitive(a, t), _ref_primitive(a + 86_400_000, t), False)


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 40))
def test_equals_null_position_and_hidden_slots(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.integers(-100, 100, n)
    valid = rng.random(n) > 0.3
    i = int(rng.integers(0, n))
    moved = valid.copy()
    moved[i] = ~moved[i]
    agree(_ref_primitive(v, rd.int64, valid),
          _ref_primitive(v, rd.int64, moved), False)
    junk = np.where(valid, v, rng.integers(1, 9, n))
    agree(_ref_primitive(v, rd.int64, valid, True),
          _ref_primitive(junk, rd.int64, valid, True), True)


def _held_strings(rng, n):
    """A utf8 column; its rows held over buffers with bytes under the
    null rows; those buffers with one byte of row k flipped; whether row
    k is valid."""
    import jax.numpy as jnp
    words = [WORDS[i] + "x" for i in rng.integers(0, len(WORDS), n)]
    valid = rng.random(n) > 0.3
    ref = at.column(pa.array([w if ok else None
                              for w, ok in zip(words, valid)], pa.utf8()))
    offs = np.zeros(n + 1, np.int32)
    np.cumsum([len(w.encode()) for w in words], out=offs[1:])
    data = np.frombuffer("".join(words).encode(), np.uint8).copy()
    held = at.StringColumn(jnp.asarray(offs), jnp.asarray(data), rd.utf8,
                           jnp.asarray(valid))
    k = int(rng.integers(0, n))
    data2 = data.copy()
    data2[offs[k] + int(rng.integers(0, offs[k + 1] - offs[k]))] ^= 1
    flipped = at.StringColumn(jnp.asarray(offs), jnp.asarray(data2), rd.utf8,
                              jnp.asarray(valid))
    return ref, held, flipped, bool(valid[k])


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 30))
def test_equals_string_hidden_bytes_and_one_byte(seed, n):
    """A null string row holding bytes equals an empty one; one byte of a
    valid row changed differs."""
    ref, held, flipped, k_valid = _held_strings(np.random.default_rng(seed),
                                                n)
    agree(ref, held, True)
    agree(held, flipped, not k_valid and None)


@pytest.mark.parametrize("piece", [1, 5, 64])
@pytest.mark.parametrize("kind", list(STRINGS) + [
    "large_list_utf8", "dictionary", "run_end_utf8"])
@pytest.mark.parametrize("seed", range(2))
def test_equals_strings_piece_by_piece(monkeypatch, piece, kind, seed):
    """The byte compare carries its two sums from piece to piece: with
    pieces of a few bytes, rows across a piece's edge, sliced rows and a
    flipped byte compare as in one piece."""
    monkeypatch.setattr(peq, "PIECE", piece)
    rng = np.random.default_rng(seed)
    n = 40
    arr = pa_array(kind, rng, n)
    ra = at.column(arr)
    agree(ra, at.column(arr), True)
    agree(ra, ref_col(kind, np.random.default_rng(seed + 7), n))
    agree(ra.slice(3, n - 5), at.column(arr.slice(3, n - 5)), True)
    if kind == "utf8":
        ref, held, flipped, k_valid = _held_strings(rng, n)
        agree(ref, held, True)
        agree(held, flipped, not k_valid and None)
        agree(ref.slice(2, n - 4), held.slice(2, n - 4), True)


@pytest.mark.parametrize("piece", [5, peq.PIECE])
@pytest.mark.parametrize("kind", list(STRINGS) + [
    "large_list_utf8", "dictionary", "run_end_utf8"])
def test_equals_int64_index_route(monkeypatch, kind, piece):
    """Past 2^31 - 1 bytes the byte compare indexes with int64
    (`_index_dtype`); forced here at 40 rows, the string, list,
    dictionary and run-end compares, in one piece and in pieces of 5
    bytes, answer as the reference does."""
    sizes = []
    monkeypatch.setattr(peq, "_index_dtype",
                        lambda *s: sizes.append(s) or torch.int64)
    monkeypatch.setattr(peq, "PIECE", piece)
    rng = np.random.default_rng(31)
    n = 40
    arr = pa_array(kind, rng, n)
    ra = at.column(arr)
    agree(ra, at.column(arr), True)
    agree(ra, ref_col(kind, np.random.default_rng(32), n))
    agree(ra.slice(3, n - 5), at.column(arr.slice(3, n - 5)), True)
    if kind in STRINGS or kind == "large_list_utf8":
        rows = arr.to_pylist()
        changed = list(rows)
        changed[7] = rows[8]
        agree(ra, at.column(pa.array(changed, arr.type)))
    if kind == "utf8":
        ref, held, flipped, k_valid = _held_strings(rng, n)
        agree(ref, held, True)
        agree(held, flipped, not k_valid and None)
    if kind == "dictionary":
        ra, rb, rc, moved_valid = _dictionary_apart(rng, n)
        agree(ra, rb, True)
        agree(ra, rc, not moved_valid and None)
    if kind == "run_end_utf8":
        ra, rb, rc = _run_end_split(rng, n)
        agree(ra, rb, True)
        agree(ra, rc, False)
    assert sizes


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 40))
def test_equals_decimal_limb(seed, n):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    ra = at.column(pa_layout("decimal128", rng, n))
    limbs = np.asarray(ra.limbs).copy()
    i = int(rng.integers(0, n))
    limbs[i, 1] ^= np.uint64(1 << int(rng.integers(0, 64)))
    rb = rn.DecimalColumn(jnp.asarray(limbs), ra.dtype, ra.validity)
    valid = ra.validity is None or bool(np.asarray(ra.validity)[i])
    agree(ra, rb, False if valid else True)


def _dictionary_apart(rng, n):
    """A string dictionary column; the same rows over a dictionary in
    another order with an unused and a repeated entry; that one with a
    code moved to another word; whether the moved row is valid."""
    import jax.numpy as jnp
    words = ["a", "b", "日本", "zz", "word-0042"]
    codes = rng.integers(0, len(words), n).astype(np.int32)
    valid = rng.random(n) > 0.2
    ra = at.DictionaryColumn(jnp.asarray(codes),
                             at.column(words), jnp.asarray(valid))
    perm = rng.permutation(len(words))
    apart = [words[p] for p in perm] + ["unused", words[perm[0]]]
    where = {w: i for i, w in enumerate(apart[:len(words)])}
    codes2 = np.array([where[words[c]] for c in codes], np.int32)
    codes2[(codes2 == 0) & (rng.random(n) < 0.5)] = len(apart) - 1
    rb = at.DictionaryColumn(jnp.asarray(codes2), at.column(apart),
                             jnp.asarray(valid))
    i = int(rng.integers(0, n))
    codes3 = codes2.copy()
    codes3[i] = where[words[(codes[i] + 1) % len(words)]]
    rc = at.DictionaryColumn(jnp.asarray(codes3), at.column(apart),
                             jnp.asarray(valid))
    return ra, rb, rc, bool(valid[i])


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 40))
def test_equals_dictionary_built_apart(seed, n):
    """A dictionary in another order, with an unused and a repeated
    entry, decodes to the same rows: equal.  One code moved to another
    word: not equal."""
    ra, rb, rc, moved_valid = _dictionary_apart(np.random.default_rng(seed),
                                                n)
    agree(ra, rb, True)
    agree(ra, rc, not moved_valid and None)


def test_equals_dictionary_null_entry_against_null_row():
    """A row pointing at a null dictionary entry lists None, as a null
    row does: equal in the reference."""
    import jax.numpy as jnp
    vals = at.column(["a", None])
    ra = at.DictionaryColumn(jnp.asarray(np.array([0, 1], np.int32)), vals)
    rb = at.DictionaryColumn(jnp.asarray(np.array([0, 0], np.int32)), vals,
                             jnp.asarray(np.array([True, False])))
    agree(ra, rb, True)


def _run_end_split(rng, n):
    """A run-end string column; its rows in runs split at other places;
    those runs with one value changed."""
    import jax.numpy as jnp
    ra = at.column(pa_array("run_end_utf8", rng, n))
    ends = np.asarray(ra.run_ends)
    rows = ra.to_pylist()
    split = np.unique(np.append(ends, rng.integers(1, n + 1, 3)))
    run_of = np.searchsorted(ends, split - 1, side="right")
    vals = [ra.values.to_pylist()[r] for r in run_of]
    rb = rn.RunEndColumn(jnp.asarray(split.astype(np.int32)),
                         at.column(pa.array(vals, pa.utf8())), n)
    assert rb.to_pylist() == rows
    vals2 = list(vals)
    k = int(rng.integers(0, len(vals2)))
    vals2[k] = "other" if vals2[k] != "other" else "x"
    rc = rn.RunEndColumn(jnp.asarray(split.astype(np.int32)),
                         at.column(pa.array(vals2, pa.utf8())), n)
    return ra, rb, rc


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 40))
def test_equals_run_end_split_differently(seed, n):
    """The same logical rows in runs split at other places: equal; one
    run's value changed: not equal."""
    ra, rb, rc = _run_end_split(np.random.default_rng(seed), n)
    agree(ra, rb, True)
    agree(ra, rc, False)


def _constant_hash(offs, data, valid):
    return torch.zeros(offs.shape[0] - 1, dtype=torch.int64,
                       device=offs.device)


def _length_hash(offs, data, valid):
    return (offs[1:] - offs[:-1]).to(torch.int64)


@pytest.mark.parametrize("layout", ["dictionary", "run_end"])
@pytest.mark.parametrize("hash_", ["exact", "constant", "length"])
@pytest.mark.parametrize("seed", range(3))
def test_equals_string_id_collisions(monkeypatch, layout, hash_, seed):
    """String dictionaries and run-end strings compare by ids from a hash
    whose runs are checked byte for byte.  Under a hash that collides
    (one value for every row, or a row's length) the check must flag it
    and the host compare give the reference's answer; under the real
    hash, on entries repeated across both columns, the check must pass
    and no host compare run."""
    host = []
    real = peq._py_equal
    monkeypatch.setattr(peq, "_py_equal",
                        lambda x, y: host.append(1) or real(x, y))
    if hash_ != "exact":
        monkeypatch.setattr(peq, "_string_hash", _constant_hash
                            if hash_ == "constant" else _length_hash)
    rng = np.random.default_rng(seed)
    if layout == "dictionary":
        ra, rb, rc, moved_valid = _dictionary_apart(rng, 30)
        changed = False if moved_valid else None
    else:
        ra, rb, rc = _run_end_split(rng, 30)
        changed = False
    agree(ra, rb, True)
    agree(ra, rc, changed)
    assert bool(host) == (hash_ != "exact")


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 30))
def test_equals_list_view_offsets_that_agree(seed, n):
    """The same rows over a child in another order with gaps: equal."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    ra = at.column(pa_layout("list_view", rng, n))
    rows = ra.to_pylist()
    child, offs, sizes = [], [], []
    for r in reversed(range(n)):
        child.append(int(rng.integers(-9, 9)))            # a gap
        items = rows[r] or []
        offs.append(len(child))
        sizes.append(len(items))
        child.extend(items)
    offs, sizes = offs[::-1], sizes[::-1]
    valid = np.array([r is not None for r in rows])
    rb = rn.ListViewColumn(jnp.asarray(np.array(offs, np.int32)),
                           jnp.asarray(np.array(sizes, np.int32)),
                           at.column(pa.array(child, pa.int64())),
                           jnp.asarray(valid), ra.dtype)
    assert rb.to_pylist() == rows
    agree(ra, rb, True)


@CASES
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 40))
def test_equals_struct_child_under_null_parent(seed, n):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    ra = at.column(pa_layout("struct", rng, n))
    child = ra.children[0]
    parent = np.asarray(ra.validity) if ra.validity is not None \
        else np.ones(n, bool)
    vals = np.asarray(child.values).copy()
    vals[~parent] += 7
    kid = at.PrimitiveColumn(jnp.asarray(vals), child.dtype, child.validity,
                             _canonical=True)
    rb = at.StructColumn((kid,) + ra.children[1:], ra.fields, ra.validity)
    agree(ra, rb, True)
    if parent.any():
        i = int(np.flatnonzero(parent)[0])
        vals2 = np.asarray(child.values).copy()
        vals2[i] += 1
        kid2 = at.PrimitiveColumn(jnp.asarray(vals2), child.dtype,
                                  child.validity, _canonical=True)
        rc = at.StructColumn((kid2,) + ra.children[1:], ra.fields,
                             ra.validity)
        agree(ra, rc)


@pytest.mark.parametrize("unit", ["year_month", "day_time"])
def test_reference_cannot_list_some_intervals(unit):
    """C27: the reference's equals lists both columns through pyarrow,
    which cannot build interval[year_month] or [day_time], so it raises;
    the port compares their storage bits."""
    import jax.numpy as jnp
    np_t = np.int32 if unit == "year_month" else np.int64
    v = np.array([1, 2, 3], np_t)
    t = rd.interval(unit)
    ra = at.PrimitiveColumn(jnp.asarray(v), t)
    with pytest.raises(at.ArrowError):
        ra.equals(at.PrimitiveColumn(jnp.asarray(v), t))
    pa_, pb = port_column(ra), port_column(ra)
    assert pa_.equals(pb)
    assert not pa_.equals(pb.with_validity(torch.tensor([True, False, True])))


def test_equals_type_and_length_first():
    a = att.column([1, 2], device="cpu")
    assert not a.equals(att.column([1, 2, 3], device="cpu"))
    assert not a.equals(att.column([1, 2], pd.int32, device="cpu"))
    assert not a.equals([1, 2]) and a.equals(a)
    assert at.column([1, 2]).equals([1, 2]) is False


# ---- the card: one host sync per call ---------------------------------------

def test_equals_syncs_once_on_the_card(cuda_device):
    """Column.equals and Table.equals read the device once per call, for
    every layout but a union and a list view (torch's sync debug mode
    warns at each read), and answer as on the CPU."""
    kinds = [k for k in KINDS if k not in ("sparse_union", "dense_union",
                                           "list_view", "large_list_view")]

    def columns(seed, device):
        return [port_column(ref_col(k, np.random.default_rng(seed + i), 40),
                            device) for i, k in enumerate(kinds)]
    schema = pd.Schema(tuple(pd.Field(k, c.dtype) for k, c in
                             zip(kinds, columns(0, "cpu"))))

    def syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, sum("called a synchronizing" in str(w.message)
                        for w in seen)
    for seed in (0, 100):
        ta = att.Table(columns(0, cuda_device), schema)
        tb = att.Table(columns(seed, cuda_device), schema)
        on_cpu = zip(columns(0, "cpu"), columns(seed, "cpu"))
        for k, a, b, (ca, cb) in zip(kinds, ta.columns, tb.columns, on_cpu):
            got, n = syncs(lambda: a.equals(b))
            assert n == 1 and got == ca.equals(cb), k
        got, n = syncs(lambda: ta.equals(tb))
        assert n == 1 and got == (seed == 0)
