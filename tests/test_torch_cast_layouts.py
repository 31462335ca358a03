"""Parity of the port's remaining casts (arrow_tpu_torch/ops/cast.py: the
run-end, dictionary packing, text, interval, list, map, struct and
fixed-size binary arms, base64_encode / base64_decode and can_cast's
full matrix) with the JAX package on the CPU.

The same inputs, made from a seed with numpy or written out as in
tests/test_cast.py and tests/test_cast_decimal_list.py, go through the
reference's cast and the port's; each pair gives the same error name or
equal columns: type, values, validity and the presence of a validity
mask, and every buffer of a nested layout bit for bit (`same_outcome`
with masks=True).  No tolerance.  The one departure is ROADMAP C10: a
timestamp[ns] keeps its nanoseconds through text in the port, as
pyarrow keeps them, where the reference drops them.
"""

import base64
import datetime
import importlib

import numpy as np
import pyarrow as pa
import pyarrow.compute as pac
import pytest
import torch

import arrow_tpu as at
from arrow_tpu_torch import dtypes as pdt
from arrow_tpu_torch.core.column import StringColumn
from arrow_tpu_torch.core import nested as pn
from arrow_tpu_torch.errors import ArrowNotImplementedError, CastError
from arrow_tpu_torch.ops.cast import (CastOptions, base64_decode,
                                      base64_encode, can_cast, cast)
from torch_port_util import (assert_columns_equal, port_column, port_dtype,
                             same_outcome)

rc = importlib.import_module("arrow_tpu.ops.cast")
rdt = at.dtypes
N = 64


def _rng(seed=0):
    return np.random.default_rng(seed)


def _nulls(rng, xs, share=0.15):
    return [None if rng.random() < share else x for x in xs]


def check(col, to, safe=True, what=""):
    """The port's cast of the reference column's buffers against the
    reference's cast."""
    same_outcome(lambda: cast(port_column(col), port_dtype(to),
                              CastOptions(safe)),
                 lambda: rc.cast(col, to, rc.CastOptions(safe)),
                 what or f"{col.dtype} -> {to}", masks=True)


# ---- number, bool and temporal <-> utf8 ------------------------------------

NUMBERS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
           "uint64", "float16", "float32", "float64", "bool"]


def _numbers(name, rng):
    d = np.dtype(name)
    if d == bool:
        v = rng.random(N) < 0.5
    elif d.kind in "iu":
        info = np.iinfo(d)
        v = rng.integers(info.min, info.max, N, dtype=d, endpoint=True)
        v[:4] = [info.min, info.max, 0, 1] if d.kind == "i" else \
            [0, info.max, 1, 10]
    else:
        v = (rng.standard_normal(N) * 10.0 ** rng.integers(-8, 8, N)
             ).astype(d)
        v[:6] = [np.nan, np.inf, -np.inf, -0.0, 1.0, 0.1]
    return at.column(v, validity=rng.random(N) >= 0.1)


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("name", NUMBERS)
def test_numbers_to_text_and_back(name, safe):
    """Python's str and repr (floats print '1.0', NaN 'NaN', 'inf'),
    then the parse back (cast.py:671-698,763-779)."""
    col = _numbers(name, _rng(NUMBERS.index(name)))
    check(col, rdt.utf8, safe)
    text = rc.cast(col, rdt.utf8)
    check(text, col.dtype, safe)


TEXT_CASES = {
    "ints": (["42", " 7 ", "nope", None, "-3", "1_000", "+5", ""],
             rdt.int64),
    "int8 overflow": (["127", "128", "-129", "-128"], rdt.int8),
    "uint64 top": (["18446744073709551615", "18446744073709551616", "-1"],
                   rdt.uint64),
    "floats": (["1.5", "-2e3", "inf", "-inf", "nan", "1e400", "x", "0x10"],
               rdt.float64),
    "float16": (["65504", "65520", "1e-8", "0.1"], rdt.float16),
    "bools": (["true", "T", "1", "yes", "false", "F", "0", "no", "maybe",
               None], rdt.bool_),
    "date32": (["2020-01-02", "bad", None, "1969-12-31", "2000-02-29"],
               rdt.date32),
    "timestamp[us]": (["2020-01-02T03:04:05.123456", "2020-01-02",
                       "2020-01-02 03:04", "1970-01-01T00:00:00+05:00",
                       "1970-01-01T00:00:00Z", "bad", None],
                      rdt.timestamp("us")),
    "timestamp[s] offsets": (["1970-01-01T00:00:00+05:00",
                              "1970-01-01T00:00:00Z"], rdt.timestamp("s")),
    "timestamp[ms]": (["1999-12-31T23:59:59.999", "1960-06-01T12:00:00"],
                      rdt.timestamp("ms")),
    "time64[us]": (["02:10:01.123456", "23:59:59", None, "bad"],
                   rdt.time64("us")),
    "time32[ms]": (["02:10:01.123456", "00:00"], rdt.time32("ms")),
    "time32[s]": (["12:34:56", "25:00:00"], rdt.time32("s")),
    "time64[ns]": (["02:10:01.5"], rdt.time64("ns")),
    "date64": (["2020-02-29", "1970-01-02T03:00:00", "nope"], rdt.date64),
    "duration[s]": (["5", "-7", "x"], rdt.duration("s")),
    "large_utf8": (["a", None, "bc"], rdt.large_utf8),
    "binary": (["a", None, "bc"], rdt.binary),
    "fixed_size_binary": (["ab", "c", None, "de"], rdt.fixed_size_binary(2)),
    "decimal": (["1.25", "-3.5", "x"], rdt.decimal128(10, 2)),
    "dictionary": (["b", "a", "b", None, "c"],
                   rdt.dictionary(rdt.int16, rdt.utf8)),
    "dictionary<int8>": (["b", "a"], rdt.dictionary(rdt.int8, rdt.utf8)),
}


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("name", list(TEXT_CASES))
def test_text_to_types(name, safe):
    """utf8 -> number, bool, date, time, timestamp, duration, decimal,
    fixed-size binary, binary and dictionary (cast.py:728-822): values
    that do not parse are null when safe, raise when not."""
    values, to = TEXT_CASES[name]
    check(at.column(values), to, safe)


TEMPORALS = {
    "date32": (pa.date32(), -30_000, 60_000),
    "date64": (pa.date64(), -10 ** 12, 10 ** 13),
    "timestamp[s]": (pa.timestamp("s"), -10 ** 10, 10 ** 10),
    "timestamp[ms]": (pa.timestamp("ms"), -10 ** 13, 10 ** 13),
    "timestamp[us]": (pa.timestamp("us"), -10 ** 16, 10 ** 16),
    "timestamp[ns]": (pa.timestamp("ns"), -10 ** 18, 10 ** 18),
    "timestamp[us, UTC]": (pa.timestamp("us", "UTC"), 0, 10 ** 16),
    "time32[s]": (pa.time32("s"), 0, 86_400),
    "time32[ms]": (pa.time32("ms"), 0, 86_400_000),
    "time64[us]": (pa.time64("us"), 0, 86_400 * 10 ** 6),
    "time64[ns]": (pa.time64("ns"), 0, 86_400 * 10 ** 9),
    "duration[ms]": (pa.duration("ms"), -10 ** 12, 10 ** 12),
}


@pytest.mark.parametrize("name", list(TEMPORALS))
def test_temporal_to_text(name):
    """ISO text through datetime (cast.py:701-726); timestamp[ns] values
    here are whole microseconds (C10 covers the others)."""
    t, lo, hi = TEMPORALS[name]
    rng = _rng(len(name))
    v = rng.integers(lo, hi, N)
    if name == "timestamp[ns]":
        v = v // 1000 * 1000
    check(at.column(pa.array(_nulls(rng, v.tolist()), t)), rdt.utf8)


@pytest.mark.parametrize("name", ["date32", "timestamp[us]", "time64[us]",
                                  "timestamp[s]", "date64"])
def test_temporal_text_round_trip(name):
    t, lo, hi = TEMPORALS[name]
    rng = _rng(7)
    col = at.column(pa.array(rng.integers(lo, hi, N).tolist(), t))
    check(rc.cast(col, rdt.utf8), col.dtype)


def test_reference_drops_timestamp_nanoseconds_in_text():
    """ROADMAP C10: the reference formats and parses timestamps at
    microsecond precision (cast.py:720-724,790-801), so a timestamp[ns]
    loses its last three digits through text.  pyarrow keeps them, and
    so does the port, both ways; whole microseconds print as the
    reference prints them."""
    ns = [1577836800123456789, 1577836800000000001, -1,
          1577836800123456000, -1000]
    col = at.column(pa.array(ns, pa.timestamp("ns")))
    ref = rc.cast(col, rdt.utf8).to_pylist()
    got = cast(port_column(col), pdt.utf8).to_pylist()
    want = pac.cast(pa.array(ns, pa.timestamp("ns")), pa.string()) \
        .to_pylist()
    assert ref[0] == "2020-01-01T00:00:00.123456"              # dropped
    assert got[0] == "2020-01-01T00:00:00.123456789"
    assert [g.replace("T", " ") for g in got[:3]] == want[:3]
    assert got[3:] == ref[3:]
    back = cast(cast(port_column(col), pdt.utf8), pdt.timestamp("ns"))
    assert back.values.tolist() == ns
    ref_back = rc.cast(rc.cast(col, rdt.utf8), rdt.timestamp("ns"))
    assert np.asarray(ref_back.values).tolist()[0] == 1577836800123456000


# ---- intervals --------------------------------------------------------------

def _mdn(rng, n=N, zero_md=False):
    rows = []
    for _ in range(n):
        m = 0 if zero_md else int(rng.integers(-30, 30))
        d = 0 if zero_md else int(rng.integers(-40, 40))
        ns = int(rng.integers(-10 ** 9, 10 ** 9)) * \
            int(rng.choice([1, 1000, 10 ** 6, 10 ** 9]))
        rows.append(pa.MonthDayNano([m, d, ns]))
    return at.column(pa.array(_nulls(rng, rows),
                              pa.month_day_nano_interval()))


INTERVAL_CASES = {
    "mdn -> utf8": (lambda r: _mdn(r), rdt.utf8),
    "mdn -> duration[ms]": (lambda r: _mdn(r, zero_md=True),
                            rdt.duration("ms")),
    "mdn -> duration[ns]": (lambda r: _mdn(r, zero_md=True),
                            rdt.duration("ns")),
    "mdn (months) -> duration[s]": (lambda r: _mdn(r), rdt.duration("s")),
    "duration[s] -> mdn": (lambda r: at.column(pa.array(
        _nulls(r, r.integers(-10 ** 10, 10 ** 10, N).tolist()),
        pa.duration("s"))), rdt.interval("month_day_nano")),
    "duration[s] overflow -> mdn": (lambda r: at.column(pa.array(
        [2 ** 62, -2 ** 62, 5], pa.duration("s"))),
        rdt.interval("month_day_nano")),
    "year_month -> utf8": (lambda r: at.column(
        r.integers(-200, 200, N).astype(np.int32),
        dtype=rdt.interval("year_month")), rdt.utf8),
    "year_month -> mdn": (lambda r: at.column(
        r.integers(-200, 200, N).astype(np.int32),
        dtype=rdt.interval("year_month")), rdt.interval("month_day_nano")),
    "year_month -> int64": (lambda r: at.column(
        r.integers(-200, 200, N).astype(np.int32),
        dtype=rdt.interval("year_month")), rdt.int64),
    "day_time -> utf8": (lambda r: at.column(
        (r.integers(-90, 90, N) << 32) | r.integers(0, 2 ** 32, N),
        dtype=rdt.interval("day_time")), rdt.utf8),
    "day_time -> mdn": (lambda r: at.column(
        (r.integers(-90, 90, N) << 32) | r.integers(0, 2 ** 32, N),
        dtype=rdt.interval("day_time")), rdt.interval("month_day_nano")),
    "int32 -> year_month": (lambda r: at.column(
        r.integers(-500, 500, N).astype(np.int32)),
        rdt.interval("year_month")),
    "int64 -> year_month": (lambda r: at.column([1, 2]),
                            rdt.interval("year_month")),
    "mdn -> int64": (lambda r: _mdn(r, 4), rdt.int64),
}


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("name", list(INTERVAL_CASES))
def test_interval_casts(name, safe):
    """_cast_interval and the interval formatting (cast.py:425-560)."""
    make, to = INTERVAL_CASES[name]
    check(make(_rng(len(name))), to, safe, name)


INTERVAL_TEXT = ["1 year 2 mons", "3 days 04:05:06.5", "bad", None,
                 "1.5 months", "2 weeks 1 day", "-3 hours", "1 day -01:30",
                 "10 minutes 30 seconds", "250 milliseconds",
                 "7 microseconds 9 nanoseconds", "1 mon,", "", "2 days 1",
                 "1.25 days", "01:02", "1:2:3:4", "5 fortnights",
                 "x days", "3000000 days 00:00:01.001"]


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("unit", ["month_day_nano", "year_month",
                                  "day_time"])
def test_interval_text_parse(unit, safe):
    """parse_interval's subset (cast.py:580-669): unit pairs, fractional
    months into days, a trailing clock; values a unit cannot hold fail."""
    check(at.column(INTERVAL_TEXT), rdt.interval(unit), safe)


@pytest.mark.parametrize("unit", ["month_day_nano", "year_month",
                                  "day_time"])
def test_interval_text_round_trip(unit):
    rng = _rng(3)
    if unit == "month_day_nano":
        col = _mdn(rng)
    elif unit == "year_month":
        col = at.column(rng.integers(-300, 300, N).astype(np.int32),
                        dtype=rdt.interval(unit))
    else:
        col = at.column((rng.integers(-90, 90, N) << 32)
                        | rng.integers(0, 2 ** 31, N),
                        dtype=rdt.interval(unit))
    check(rc.cast(col, rdt.utf8), col.dtype, what=f"{unit} text back")


# ---- run-end and dictionary packing ----------------------------------------

def _ree(values, ends, re_type=pa.int32()):
    return at.column(pa.RunEndEncodedArray.from_arrays(
        pa.array(ends, re_type), values))


REE_CASES = {
    "ree -> int64": (lambda: _ree(pa.array([1, 9]), [2, 5]), rdt.int64),
    "ree -> float64": (lambda: _ree(pa.array([1, None, 9]), [2, 3, 5]),
                       rdt.float64),
    "ree -> utf8": (lambda: _ree(pa.array([1, None, -9]), [2, 3, 5]),
                    rdt.utf8),
    "ree -> ree<int64, float32>": (
        lambda: _ree(pa.array([1, 9]), [2, 5]),
        rdt.run_end_encoded(rdt.int64, rdt.float32)),
    "ree -> ree<int16, int8> (narrowing)": (
        lambda: _ree(pa.array([1, 900, None]), [2, 5, 6]),
        rdt.run_end_encoded(rdt.int16, rdt.int8)),
    "ree -> ree<int16> too long": (
        lambda: _ree(pa.array([1]), [40_000]),
        rdt.run_end_encoded(rdt.int16, rdt.int64)),
    "int64 -> ree<int32, int64>": (lambda: at.column([1, 1, 2, None, None]),
                                   rdt.run_end_encoded(rdt.int32,
                                                       rdt.int64)),
    "int64 -> ree<int64, float64>": (
        lambda: at.column([1, 1, 2, None, None, 2]),
        rdt.run_end_encoded(rdt.int64, rdt.float64)),
    "utf8 -> ree<int16, utf8>": (lambda: at.column(["a", "a", "b", None,
                                                    "b", "b"]),
                                 rdt.run_end_encoded(rdt.int16, rdt.utf8)),
    "int64 -> ree<int32, utf8>": (lambda: at.column([3, 3, None, 10]),
                                  rdt.run_end_encoded(rdt.int32, rdt.utf8)),
    "int64 -> dictionary<int32, utf8>": (
        lambda: at.column([3, 3, None, 10]),
        rdt.dictionary(rdt.int32, rdt.utf8)),
    "float64 -> dictionary<int8, utf8>": (
        lambda: at.column([0.5, None, 0.5, -1.0]),
        rdt.dictionary(rdt.int8, rdt.utf8)),
    "int64 -> dictionary<int32, int64>": (lambda: at.column([1, 2]),
                                          rdt.dictionary(rdt.int32,
                                                         rdt.int64)),
    "list -> ree<int32, list>": (lambda: at.column(pa.array(
        [[1]], pa.list_(pa.int64()))),
        rdt.run_end_encoded(rdt.int32, rdt.list_(rdt.int64))),
}


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("name", list(REE_CASES))
def test_run_end_and_packing(name, safe):
    """REE arms (cast.py:137-170) and plain -> dictionary packing
    (:187-192)."""
    make, to = REE_CASES[name]
    check(make(), to, safe, name)


def test_ree_cast_keeps_the_runs():
    """A value cast with the runs kept (the reference's test_ree_cast_arms),
    and encode-after-cast equal to pyarrow's run_end_encode."""
    ree = _ree(pa.array([1, 9]), [2, 5])
    got = cast(port_column(ree), pdt.run_end_encoded(pdt.int64,
                                                     pdt.float32))
    assert got.num_runs == 2 and got.run_ends.dtype == torch.int64
    assert got.to_pylist() == [1.0, 1.0, 9.0, 9.0, 9.0]
    for src, re_t, d in (([1, 1, 2, None, None], pa.int32(), pdt.int64),
                         (["a", "a", "b", None, "b"], pa.int16(), pdt.utf8)):
        out = cast(port_column(at.column(src)),
                   pdt.run_end_encoded(port_dtype(
                       rdt.int32 if re_t == pa.int32() else rdt.int16), d))
        oracle = pac.run_end_encode(pa.array(src), run_end_type=re_t)
        assert out.run_ends.tolist() == oracle.run_ends.to_pylist()
        assert out.to_pylist() == src


# ---- list, map, struct and fixed-size binary --------------------------------

def _ints(rng, k):
    return _nulls(rng, rng.integers(-1000, 1000, k).tolist())


def _lists(rng, t, n=N, max_len=5):
    return at.column(pa.array(
        _nulls(rng, [_ints(rng, int(rng.integers(0, max_len)))
                     for _ in range(n)], 0.1), t))


LIST_SOURCES = {
    "list<int64>": lambda r: _lists(r, pa.list_(pa.int64())),
    "large_list<int64>": lambda r: _lists(r, pa.large_list(pa.int64())),
    "list_view<int64>": lambda r: _lists(r, pa.list_view(pa.int64())),
    "large_list_view<int64>": lambda r: _lists(
        r, pa.large_list_view(pa.int64())),
    "fixed_size_list<int64, 2>": lambda r: at.column(pa.array(
        _nulls(r, [_ints(r, 2) for _ in range(N)], 0.1),
        pa.list_(pa.int64(), 2))),
    "list<int64> of length 2": lambda r: at.column(pa.array(
        _nulls(r, [_ints(r, 2) for _ in range(N)], 0.1),
        pa.list_(pa.int64()))),
}
LIST_TARGETS = {
    "list<int64>": rdt.list_(rdt.int64),
    "list<int32>": rdt.list_(rdt.int32),
    "list<float64>": rdt.list_(rdt.float64),
    "large_list<int64>": rdt.large_list(rdt.int64),
    "large_list<utf8>": rdt.large_list(rdt.utf8),
    "list_view<int16>": rdt.list_view(rdt.int16),
    "large_list_view<int64>": rdt.large_list_view(rdt.int64),
    "fixed_size_list<int64, 2>": rdt.fixed_size_list(rdt.int64, 2),
    "fixed_size_list<float32, 2>": rdt.fixed_size_list(rdt.float32, 2),
    "fixed_size_list<int64, 3>": rdt.fixed_size_list(rdt.int64, 3),
}


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("to", list(LIST_TARGETS))
@pytest.mark.parametrize("src", list(LIST_SOURCES))
def test_list_family_casts(src, to, safe):
    """cast/list.rs (cast.py:974-1067): offsets widen or narrow, a view
    becomes offsets by one gather, fixed-size rows of another length are
    null (safe) or raise (unsafe), the child cast by its own rules."""
    col = LIST_SOURCES[src](_rng(len(src)))
    check(col, LIST_TARGETS[to], safe, f"{src} -> {to}")


def _map_col():
    return at.column(pa.array([[("a", 1)], None, [("b", 2), ("c", None)],
                               []], pa.map_(pa.string(), pa.int64())))


MAP_CASES = {
    "map -> map<utf8, float64>": (_map_col,
                                  rdt.map_(rdt.utf8, rdt.float64)),
    "map -> map<utf8, int8>": (_map_col, rdt.map_(rdt.utf8, rdt.int8)),
    "map -> list<struct>": (_map_col, rdt.list_(rdt.struct([
        rdt.Field("key", rdt.utf8, nullable=False),
        rdt.Field("value", rdt.int64)]))),
    "map -> large_list<struct>": (_map_col, rdt.large_list(rdt.struct([
        rdt.Field("k", rdt.utf8, nullable=False),
        rdt.Field("v", rdt.float64)]))),
    "map -> list<int64>": (_map_col, rdt.list_(rdt.int64)),
    "list<struct> -> map": (lambda: at.column(pa.array(
        [[{"key": "a", "value": 1}], None, []],
        pa.list_(pa.struct([("key", pa.string()), ("value", pa.int64())])))),
        rdt.map_(rdt.utf8, rdt.int32)),
    "list<int64> -> map": (lambda: at.column(pa.array(
        [[1]], pa.list_(pa.int64()))), rdt.map_(rdt.utf8, rdt.int32)),
}


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("name", list(MAP_CASES))
def test_map_casts(name, safe):
    """cast/map.rs (cast.py:1070-1109)."""
    make, to = MAP_CASES[name]
    check(make(), to, safe, name)


def _struct_col():
    return at.column(pa.array(
        [{"p": 1, "q": 2.5, "s": "x"}, None, {"p": None, "q": -1.0,
                                              "s": None},
         {"p": 300, "q": 1e40, "s": "7"}],
        pa.struct([("p", pa.int32()), ("q", pa.float64()),
                   ("s", pa.string())])))


STRUCT_CASES = {
    "widen": rdt.struct([rdt.Field("p", rdt.int64),
                         rdt.Field("q", rdt.float32),
                         rdt.Field("s", rdt.utf8)]),
    "rename": rdt.struct([rdt.Field("x", rdt.int64),
                          rdt.Field("y", rdt.float64),
                          rdt.Field("z", rdt.large_utf8)]),
    "narrow": rdt.struct([rdt.Field("p", rdt.int8),
                          rdt.Field("q", rdt.int64),
                          rdt.Field("s", rdt.int32)]),
    "arity": rdt.struct([rdt.Field("p", rdt.int64)]),
}


@pytest.mark.parametrize("safe", [True, False])
@pytest.mark.parametrize("name", list(STRUCT_CASES))
def test_struct_casts(name, safe):
    """Children cast by position under the target's names
    (cast.py:1111-1122)."""
    check(_struct_col(), STRUCT_CASES[name], safe, name)


def test_nested_struct_cast():
    arr = pa.array([{"in": {"v": 7}}, {"in": None}],
                   pa.struct([("in", pa.struct([("v", pa.int32())]))]))
    check(at.column(arr), rdt.struct([
        rdt.Field("in", rdt.struct([rdt.Field("v", rdt.float64)]))]))


@pytest.mark.parametrize("to", [rdt.binary, rdt.utf8, rdt.large_binary,
                                rdt.fixed_size_binary(3),
                                rdt.fixed_size_binary(4), rdt.int64])
def test_fixed_size_binary_casts(to):
    """Fixed-size binary -> binary / utf8 (cast.py:221-234)."""
    col = at.column(pa.array([b"abc", None, b"xyz", b"\x00\x01\x02"],
                             pa.binary(3)))
    check(col, to)


# ---- base64 and can_cast ---------------------------------------------------

def test_base64_round_trip():
    """base64.rs b64_encode / b64_decode, standard alphabet (the
    reference's test_base64_roundtrip)."""
    vals = [b"hello", b"", None, b"\x00\xff\x10", b"1" * 100]
    col = at.column(pa.array(vals, pa.binary()))
    enc = same_outcome(lambda: base64_encode(port_column(col)),
                       lambda: rc.base64_encode(col), "encode", masks=True)
    assert enc.to_pylist() == [
        None if v is None else base64.b64encode(v).decode() for v in vals]
    dec = base64_decode(base64_encode(port_column(col)))
    assert_columns_equal(dec, rc.base64_decode(enc), "decode", masks=True)
    with pytest.raises(Exception) as got:
        base64_decode(StringColumn.from_pylist(["!not-base64!"],
                                               device="cpu"))
    with pytest.raises(Exception) as want:
        rc.base64_decode(at.StringColumn.from_pylist(["!not-base64!"]))
    assert type(got.value).__name__ == type(want.value).__name__
    with pytest.raises(Exception):
        base64_encode(port_column(at.column([1])))


def test_base64_random_bytes():
    rng = _rng(11)
    vals = _nulls(rng, [rng.integers(0, 256, rng.integers(0, 40))
                        .astype(np.uint8).tobytes() for _ in range(N)])
    col = at.column(pa.array(vals, pa.binary()))
    enc = same_outcome(lambda: base64_encode(port_column(col)),
                       lambda: rc.base64_encode(col), "encode", masks=True)
    same_outcome(lambda: base64_decode(port_column(enc)),
                 lambda: rc.base64_decode(enc), "decode", masks=True)


NESTED_TYPES = {
    "int64": rdt.int64, "float32": rdt.float32, "utf8": rdt.utf8,
    "binary": rdt.binary, "date32": rdt.date32,
    "decimal128": rdt.decimal128(10, 2),
    "list<int64>": rdt.list_(rdt.int64),
    "large_list<float64>": rdt.large_list(rdt.float64),
    "list<utf8>": rdt.list_(rdt.utf8),
    "list_view<int64>": rdt.list_view(rdt.int64),
    "fixed_size_list<int64, 2>": rdt.fixed_size_list(rdt.int64, 2),
    "fixed_size_binary(4)": rdt.fixed_size_binary(4),
    "map<utf8, int64>": rdt.map_(rdt.utf8, rdt.int64),
    "struct<a: int64>": rdt.struct([rdt.Field("a", rdt.int64)]),
    "struct<b: float64>": rdt.struct([rdt.Field("b", rdt.float64)]),
    "struct<a, b>": rdt.struct([rdt.Field("a", rdt.int64),
                                rdt.Field("b", rdt.utf8)]),
    "ree<int32, int64>": rdt.run_end_encoded(rdt.int32, rdt.int64),
    "ree<int16, utf8>": rdt.run_end_encoded(rdt.int16, rdt.utf8),
    "ree<int32, list>": rdt.run_end_encoded(rdt.int32,
                                            rdt.list_(rdt.int64)),
    "dict<int32, utf8>": rdt.dictionary(rdt.int32, rdt.utf8),
    "interval[mdn]": rdt.interval("month_day_nano"),
    "interval[day_time]": rdt.interval("day_time"),
    "duration[s]": rdt.duration("s"),
    "null": rdt.null,
}


@pytest.mark.parametrize("src", list(NESTED_TYPES))
def test_can_cast_full_matrix(src):
    """can_cast with the run-end, list, map and struct arms
    (cast.py:59-122), against the reference on every pair."""
    f = NESTED_TYPES[src]
    for name, t in NESTED_TYPES.items():
        assert can_cast(port_dtype(f), port_dtype(t)) == rc.can_cast(f, t), \
            (src, name)


NULL_TARGETS = {
    "binary": rdt.binary, "large_utf8": rdt.large_utf8,
    "map": rdt.map_(rdt.utf8, rdt.int64),
    "fixed_size_binary": rdt.fixed_size_binary(3),
    "ree": rdt.run_end_encoded(rdt.int32, rdt.utf8),
}


@pytest.mark.parametrize("name", list(NULL_TARGETS))
def test_null_to_more_layouts(name):
    check(at.column(pa.nulls(5)), NULL_TARGETS[name])


def test_unsupported_pairs_raise_as_the_reference():
    """A pair the reference refuses raises ArrowNotImplementedError in
    the port too (the decimal -> bool arm, list -> int)."""
    col = port_column(at.column(pa.array([[1]], pa.list_(pa.int64()))))
    with pytest.raises(ArrowNotImplementedError):
        cast(col, pdt.int64)
    check(at.column(pa.array([1], pa.decimal128(5, 0))), rdt.bool_)


# ---- phase 28's casts of chip_smoke.py at a small size ---------------------

def test_phase28_casts_rehearsal():
    """The casts chip_smoke.py runs on the card, at 2,000 rows on the
    CPU: List<Int64> -> List<Int32> and LargeList<Int64>, a struct
    widened, RunEnd<Int32, Int64> -> RunEnd<Int64, Float64> with the
    runs kept, month_day_nano -> duration and back, and the text round
    trips (dates, int64, float64 bits, timestamps, intervals, base64)."""
    rng = _rng(28)
    n = 2000
    lst = _lists(rng, pa.list_(pa.int64()), n, 8)
    for to in (rdt.list_(rdt.int32), rdt.large_list(rdt.int64)):
        check(lst, to)
    st = at.column(pa.array(_nulls(rng, [
        {"i32": int(i), "f": float(f)} for i, f in
        zip(rng.integers(-2 ** 31, 2 ** 31, n), rng.standard_normal(n))]),
        pa.struct([("i32", pa.int32()), ("f", pa.float32())])))
    check(st, rdt.struct([rdt.Field("i32", rdt.int64),
                          rdt.Field("f", rdt.float64)]))
    ends = np.cumsum(rng.integers(1, 9, 300))
    ree = _ree(pa.array(rng.integers(-10 ** 12, 10 ** 12, 300)),
               ends.tolist())
    check(ree, rdt.run_end_encoded(rdt.int64, rdt.float64))
    mdn = _mdn(rng, n, zero_md=True)
    check(mdn, rdt.duration("ns"))
    check(rc.cast(mdn, rdt.duration("ns")), rdt.interval("month_day_nano"))
    f64 = at.column(rng.standard_normal(n) * 10.0 ** rng.integers(-300, 300,
                                                                   n))
    text = cast(port_column(f64), pdt.utf8)
    back = cast(text, pdt.float64)
    assert back.values.view(torch.int64).tolist() == \
        np.asarray(f64.values).view(np.int64).tolist()
    for col in (at.column(pa.array(rng.integers(8000, 11000, n).tolist(),
                                   pa.date32())),
                at.column(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                       dtype=np.int64)),
                _mdn(rng, n)):
        check(col, rdt.utf8)
        check(rc.cast(col, rdt.utf8), col.dtype)
    stamps = at.column([(datetime.datetime(1992, 1, 1) + datetime.timedelta(
        seconds=int(s))).isoformat() for s in rng.integers(0, 2 * 10 ** 8,
                                                            n)])
    check(stamps, rdt.timestamp("us"))
    words = at.column(pa.array([f"word-{i:04d}".encode()
                                for i in rng.integers(0, 1000, n)],
                               pa.binary()))
    same_outcome(lambda: base64_decode(base64_encode(port_column(words))),
                 lambda: rc.base64_decode(rc.base64_encode(words)),
                 "base64", masks=True)


def test_casts_keep_the_source_device():
    """Every new arm returns its column on the source's device (here the
    CPU): host formatting and parsing go back to it."""
    rng = _rng(1)
    cols = [port_column(at.column([1, 2])),
            port_column(_mdn(rng, 4)),
            port_column(_lists(rng, pa.list_view(pa.int64()), 4))]
    tos = [pdt.utf8, pdt.utf8, pdt.list_(pdt.int64)]
    for c, to in zip(cols, tos):
        assert cast(c, to).device == c.device
    assert isinstance(cast(port_column(at.column(["ab"])),
                           pdt.fixed_size_binary(2)),
                      pn.FixedSizeBinaryColumn)
    with pytest.raises(CastError):
        cast(port_column(at.column(["ab", "c"])), pdt.fixed_size_binary(2),
             CastOptions(safe=False))


@pytest.mark.parametrize("t", [pa.binary(), pa.large_binary(), pa.utf8()])
def test_binary_column_lists_bytes(t):
    """Port fault found in this slice (ROADMAP C13): StringColumn.to_pylist
    decoded every type as UTF-8, so a binary column listed str (and
    raised on bytes that are not UTF-8); the reference lists bytes for
    binary types (column.py:244-255), and so does the port now."""
    vals = [b"\xff\x00", None, b"ab"] if t != pa.utf8() else \
        ["é", None, "ab"]
    ref = at.column(pa.array(vals, t))
    got = port_column(ref).to_pylist()
    assert got == ref.to_pylist() == vals
    assert [type(v) for v in got] == [type(v) for v in vals]
