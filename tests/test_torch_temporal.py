"""Temporal compute of the port (arrow_tpu_torch/ops/temporal.py and the
temporal arms of ops/numeric.py) against the JAX package on the CPU.

Every date part over every temporal type and unit, with and without a
time zone (a fixed offset, and IANA zones read from the TZif files and
extended past their tables by the POSIX rule), over instants before
1970 and after 2037; the duration and interval parts (truncating, null
where a part leaves int32, a day_time interval's signed millis);
add_interval and sub_interval of the three interval kinds across month
ends and leap days; timestamp +- duration, duration + timestamp,
timestamp - timestamp, duration arithmetic and the negations.

Inputs come from a seed through numpy; every comparison is bitwise on
the storage (`storage_list`: the reference lists datetimes) and on the
validity, and errors compare by name.  No tolerance.
"""

import importlib

import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu_torch.core.nested import IntervalMDNColumn
from arrow_tpu_torch.errors import ArrowTypeError
from arrow_tpu_torch.ops import numeric as pn, temporal as pt
from torch_port_util import (assert_columns_equal, buffers,  # noqa: F401
                             cuda_device, port_column, port_scalar,
                             same_outcome, storage_list)

rt = importlib.import_module("arrow_tpu.ops.temporal")
rn = importlib.import_module("arrow_tpu.ops.numeric")
rdt = at.dtypes
N = 300
PARTS = ["year", "month", "day", "hour", "minute", "second", "millisecond",
         "microsecond", "nanosecond", "dow", "dow_sunday0", "doy", "quarter",
         "week", "week_iso", "year_iso"]
ZONES = [None, "UTC", "+05:30", "-03:00", "America/New_York",
         "Australia/Lord_Howe", "Asia/Kolkata", "Europe/Berlin"]
# storage ranges: instants from about 1500 to 2400, dates wider
_SEC = 10 ** 10
RANGES = {"date32": (-200_000, 200_000), "date64": (-10 ** 13, 10 ** 13),
          "time32[s]": (0, 86_400), "time32[ms]": (0, 86_400_000),
          "time64[us]": (0, 86_400 * 10 ** 6),
          "time64[ns]": (0, 86_400 * 10 ** 9),
          "s": (-_SEC, _SEC), "ms": (-_SEC * 10 ** 3, _SEC * 10 ** 3),
          "us": (-_SEC * 10 ** 6, _SEC * 10 ** 6),
          "ns": (-2 ** 63 + 1, 2 ** 63 - 1)}


def temporal_types():
    out = [("date32", rdt.date32), ("date64", rdt.date64),
           ("time32[s]", rdt.time32("s")), ("time32[ms]", rdt.time32("ms")),
           ("time64[us]", rdt.time64("us")), ("time64[ns]", rdt.time64("ns"))]
    for unit in ("s", "ms", "us", "ns"):
        for tz in ZONES:
            out.append((unit, rdt.timestamp(unit, tz)))
    return out


TYPES = temporal_types()


def ref_temporal(rng, key, dtype, n=N, nulls=0.1):
    lo, hi = RANGES[key]
    v = rng.integers(lo, hi, n, dtype=np.int64, endpoint=True)
    v[:4] = [0, -1, 1, lo]                   # the epoch and its neighbours
    return at.column(v.astype(np.dtype(dtype.to_jax())), dtype,
                     validity=rng.random(n) >= nulls)


def both(port_fn, ref_fn, what):
    """Same error name, or equal storage bits and validity."""
    same_outcome(port_fn, ref_fn, what, masks=True)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("case", range(len(TYPES)),
                         ids=[repr(t) for _, t in TYPES])
def test_date_part(rng, case, part):
    key, dtype = TYPES[case]
    col = ref_temporal(rng, key, dtype)
    both(lambda: pt.date_part(port_column(col), part),
         lambda: rt.date_part(col, part), f"{dtype!r} {part}")


@pytest.mark.parametrize("fn", ["year", "month", "day", "hour", "minute",
                                "second", "millisecond", "microsecond",
                                "nanosecond", "day_of_week", "day_of_year",
                                "quarter", "week", "iso_week", "iso_year"])
def test_named_extracts(rng, fn):
    col = ref_temporal(rng, "us", rdt.timestamp("us", "Europe/Berlin"))
    assert_columns_equal(getattr(pt, fn)(port_column(col)),
                         getattr(rt, fn)(col), fn, masks=True)


def test_post_2037_tz_extraction():
    """Instants past the TZif table take the POSIX footer's DST rule."""
    secs = np.array([2_524_608_000 + d * 86_400 + 3_600 * h
                     for d in range(0, 365, 7) for h in (3, 15)],
                    np.int64)                 # 2050, every week
    for tz in ("America/New_York", "Europe/Berlin", "Australia/Lord_Howe"):
        col = at.column(secs, rdt.timestamp("s", tz))
        for part in ("hour", "minute", "day"):
            assert_columns_equal(pt.date_part(port_column(col), part),
                                 rt.date_part(col, part), f"{tz} {part}")
    hours = pt.hour(port_column(at.column(secs, rdt.timestamp(
        "s", "America/New_York")))).values
    assert len(set(((hours - torch.tensor([3, 15] * 53)) % 24).tolist())) \
        == 2, "standard and daylight time both occur in 2050"


def test_tz_tables_cached_per_zone_and_device():
    a = pt._tz_tables("America/New_York", torch.device("cpu"))
    assert pt._tz_tables("America/New_York", torch.device("cpu")) is a
    trans, offs = a
    want = rt._tzif_table("America/New_York")
    np.testing.assert_array_equal(trans.numpy(), want[0])
    np.testing.assert_array_equal(offs.numpy(), want[1])
    with pytest.raises(ArrowTypeError):
        pt._tz_tables("../../etc/passwd", torch.device("cpu"))


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
@pytest.mark.parametrize("part", ["week", "day", "hour", "minute", "second",
                                  "millisecond", "microsecond",
                                  "nanosecond", "year"])
def test_duration_part(rng, unit, part):
    """Truncating toward zero (negative durations), null past int32."""
    v = rng.integers(-2 ** 62, 2 ** 62, N) // rng.choice(
        [1, 10 ** 3, 10 ** 6, 10 ** 9, 10 ** 12], N)
    col = at.column(v, rdt.duration(unit), validity=rng.random(N) > 0.1)
    both(lambda: pt.date_part(port_column(col), part),
         lambda: rt.date_part(col, part), f"duration[{unit}] {part}")


def _day_time(days, ms):
    return (np.asarray(days, np.int64) << 32) | (np.asarray(ms, np.int64)
                                                 & 0xFFFFFFFF)


def interval_columns(rng, n=N):
    ym = at.column(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
                   // rng.choice([1, 1000], n).astype(np.int32),
                   rdt.interval("year_month"), validity=rng.random(n) > 0.1)
    ms = rng.integers(-86_400_000, 86_400_000, n)
    ms[:3] = [-500, -1, 2_147_483_647]
    dt_ = at.column(_day_time(rng.integers(-10 ** 5, 10 ** 5, n), ms),
                    rdt.interval("day_time"), validity=rng.random(n) > 0.1)
    from arrow_tpu.core.nested import IntervalMDNColumn as RMDN
    import jax.numpy as jnp
    mdn = RMDN(jnp.asarray(rng.integers(-1200, 1200, n).astype(np.int32)),
               jnp.asarray(rng.integers(-10 ** 5, 10 ** 5, n)
                           .astype(np.int32)),
               jnp.asarray(rng.integers(-2 ** 62, 2 ** 62, n)
                           // rng.choice([1, 10 ** 6, 10 ** 9], n)),
               jnp.asarray(rng.random(n) > 0.1))
    return {"year_month": ym, "day_time": dt_, "month_day_nano": mdn}


@pytest.mark.parametrize("unit", ["year_month", "day_time",
                                  "month_day_nano"])
@pytest.mark.parametrize("part", ["year", "month", "week", "day", "hour",
                                  "minute", "second", "millisecond",
                                  "microsecond", "nanosecond", "dow"])
def test_interval_part(rng, unit, part):
    col = interval_columns(rng)[unit]
    both(lambda: pt.date_part(port_column(col), part),
         lambda: rt.date_part(col, part), f"interval[{unit}] {part}")


def test_day_time_negative_millis():
    """The low half of days << 32 | millis is signed."""
    col = at.column(_day_time([0, 1, -2], [-500, -1, 1500]),
                    rdt.interval("day_time"))
    for part in ("day", "second", "millisecond", "nanosecond"):
        assert_columns_equal(pt.date_part(port_column(col), part),
                             rt.date_part(col, part), part)
    ts = at.column(np.array([0, 0, 0]), rdt.timestamp("ms"))
    got = pt.add_interval(port_column(ts), port_column(col))
    want = np.array([-500, 86_399_999, -2 * 86_400_000 + 1500], np.int64)
    assert storage_list(got) == want.view(np.uint64).tolist()
    assert_columns_equal(got, rt.add_interval(ts, col), "add")


SHIFT_TYPES = [("date32", rdt.date32), ("date64", rdt.date64)] + [
    (u, rdt.timestamp(u, tz)) for u in ("s", "ms", "us", "ns")
    for tz in (None, "+05:30", "America/New_York")]


@pytest.mark.parametrize("negate", [False, True], ids=["add", "sub"])
@pytest.mark.parametrize("unit", ["year_month", "day_time",
                                  "month_day_nano"])
@pytest.mark.parametrize("case", range(len(SHIFT_TYPES)),
                         ids=[repr(t) for _, t in SHIFT_TYPES])
def test_add_sub_interval(rng, case, unit, negate):
    key, dtype = SHIFT_TYPES[case]
    lo, hi = RANGES[key]
    if key == "ns":
        lo, hi = -2 ** 62, 2 ** 62          # keep the shifts inside int64
    v = rng.integers(lo, hi, N)
    col = at.column(v.astype(np.dtype(dtype.to_jax())), dtype,
                    validity=rng.random(N) > 0.1)
    iv = interval_columns(rng)[unit]
    if unit == "year_month":
        iv = at.column(np.asarray(iv.values) % 4000 - 2000, iv.dtype,
                       validity=np.asarray(iv.validity))
    elif unit == "month_day_nano":
        from arrow_tpu.core.nested import IntervalMDNColumn as RMDN
        iv = RMDN(iv.months, iv.days, iv.nanos // 1000, iv.validity)
    fn = "sub_interval" if negate else "add_interval"
    both(lambda: getattr(pt, fn)(port_column(col), port_column(iv)),
         lambda: getattr(rt, fn)(col, iv), f"{dtype!r} {fn} {unit}")


@pytest.mark.parametrize("dtype", [rdt.date32, rdt.date64,
                                   rdt.timestamp("s", "Europe/Berlin")])
def test_month_end_clamping(dtype):
    """Jan 31 + 1 month is Feb 28 or 29; Mar 31 - 1 month likewise."""
    days = np.array([18_292, 18_657, 10_956, 10_956 + 59, 0, -1])
    scale = {"date32": 1, "date64": 86_400_000, "timestamp": 86_400}[
        dtype.name]
    col = at.column((days * scale).astype(np.dtype(dtype.to_jax())), dtype)
    for months in (1, -1, 13, -25):
        iv = at.column(np.full(len(days), months, np.int32),
                       rdt.interval("year_month"))
        for fn in ("add_interval", "sub_interval"):
            assert_columns_equal(
                getattr(pt, fn)(port_column(col), port_column(iv)),
                getattr(rt, fn)(col, iv), f"{fn} {months}")


def test_add_interval_errors():
    ts = port_column(at.column(np.arange(3), rdt.timestamp("s")))
    with pytest.raises(ArrowTypeError):
        pt.add_interval(port_column(at.column(np.arange(3), rdt.int64)),
                        IntervalMDNColumn(*(torch.zeros(3, dtype=d) for d in (
                            torch.int32, torch.int32, torch.int64))))
    with pytest.raises(ArrowTypeError):
        pt.add_interval(ts, ts)


# ---- temporal arms of add / sub / neg -----------------------------------------

def temporal_pair(rng, ltype, rtype, n=N, small=True):
    hi = 2 ** 40 if small else 2 ** 63 - 1
    lo = -hi
    cols = []
    for d in (ltype, rtype):
        v = rng.integers(lo, hi, n)
        cols.append(at.column(v, d, validity=rng.random(n) > 0.1))
    return cols


ARMS = [("add", "timestamp", "duration"), ("sub", "timestamp", "duration"),
        ("add", "duration", "timestamp"), ("sub", "timestamp", "timestamp"),
        ("add", "duration", "duration"), ("sub", "duration", "duration"),
        ("mul", "duration", "duration"), ("div", "duration", "duration"),
        ("rem", "duration", "duration"), ("add", "timestamp", "timestamp"),
        ("sub", "duration", "timestamp"), ("mul", "timestamp", "duration")]


def _type(name, unit, tz=None):
    return rdt.timestamp(unit, tz) if name == "timestamp" \
        else rdt.duration(unit)


# the checked ops, and the wrapping ones where the reference has them
CALLS = [(a, w) for a in ARMS for w in (False, True)
         if not w or a[0] in ("add", "sub", "mul")]


@pytest.mark.parametrize("unit", ["s", "ns"])
@pytest.mark.parametrize("arm,wrapping", CALLS,
                         ids=["-".join(a) + ("-wrapping" if w else "")
                              for a, w in CALLS])
def test_temporal_arithmetic(rng, arm, wrapping, unit):
    """The result type of `_temporal_out`, int64 arithmetic with checked
    overflow (or wrapping), a TypeError for other pairs."""
    op, lname, rname = arm
    small = not (op in ("add", "sub", "mul") and rng.random() < 0.5)
    l, r = temporal_pair(rng, _type(lname, unit, "UTC"),
                         _type(rname, unit), small=small)
    if op in ("div", "rem"):
        r = at.column(np.where(np.asarray(r.values) == 0, 3,
                               np.asarray(r.values)), r.dtype,
                      validity=np.asarray(r.validity))
    name = f"{op}_wrapping" if wrapping else op
    both(lambda: getattr(pn, name)(port_column(l), port_column(r)),
         lambda: getattr(rn, name)(l, r), f"{name} {lname} {rname}")


def test_temporal_overflow_and_units(rng):
    ts = at.column(np.array([2 ** 62, 5]), rdt.timestamp("ns"))
    du = at.column(np.array([2 ** 62, 1]), rdt.duration("ns"))
    both(lambda: pn.add(port_column(ts), port_column(du)),
         lambda: rn.add(ts, du), "overflow")
    du_s = at.column(np.array([1, 1]), rdt.duration("s"))
    both(lambda: pn.add(port_column(ts), port_column(du_s)),
         lambda: rn.add(ts, du_s), "unit mismatch")
    masked = at.column(np.array([2 ** 62, 5]), rdt.duration("ns"),
                       validity=np.array([False, True]))
    both(lambda: pn.add(port_column(ts), port_column(masked)),
         lambda: rn.add(ts, masked), "overflow under a null")
    scalar = rn.sub(ts, at.scalar(7, rdt.duration("ns")))
    got = pn.sub(port_column(ts), port_scalar(at.scalar(7, rdt.duration(
        "ns"))))
    assert_columns_equal(got, scalar, "scalar duration")


@pytest.mark.parametrize("kind", ["duration", "year_month", "day_time",
                                  "month_day_nano", "timestamp", "date32"])
def test_neg_temporal(rng, kind):
    """Checked negation of durations and intervals (each part of a
    day_time and month_day_nano one); timestamps cannot negate."""
    if kind in ("year_month", "day_time", "month_day_nano"):
        col = interval_columns(rng)[kind]
    elif kind == "duration":
        col = at.column(rng.integers(-2 ** 62, 2 ** 62, N),
                        rdt.duration("us"), validity=rng.random(N) > 0.1)
    else:
        col = ref_temporal(rng, "date32" if kind == "date32" else "s",
                           rdt.date32 if kind == "date32"
                           else rdt.timestamp("s"))
    both(lambda: pn.neg(port_column(col)), lambda: rn.neg(col), f"neg {kind}")


@pytest.mark.parametrize("kind", ["duration", "year_month", "day_time"])
def test_neg_temporal_overflow(kind):
    """MIN in any part of a valid slot raises; under a null it does
    not."""
    lo64, lo32 = -2 ** 63, -2 ** 31
    values = {"duration": (np.array([lo64, 1]), rdt.duration("s")),
              "year_month": (np.array([lo32, 1], np.int32),
                             rdt.interval("year_month")),
              "day_time": (_day_time([1, 1], [lo32, 1]),
                           rdt.interval("day_time"))}[kind]
    for valid in (None, np.array([False, True])):
        col = at.column(values[0], values[1], validity=valid)
        both(lambda: pn.neg(port_column(col)), lambda: rn.neg(col),
             f"neg {kind} MIN")


def test_temporal_on_the_card(rng, cuda_device):
    """Every part and an interval shift of a zoned timestamp on the card
    equal the CPU route; the zone's tables sit on each device once."""
    col = ref_temporal(rng, "us", rdt.timestamp("us", "America/New_York"),
                       n=5000)
    dev, host = port_column(col, cuda_device), port_column(col)
    for part in PARTS:
        assert buffers(pt.date_part(dev, part)) == \
            buffers(pt.date_part(host, part)), part
    iv = interval_columns(rng, 5000)["month_day_nano"]
    from arrow_tpu.core.nested import IntervalMDNColumn as RMDN
    iv = RMDN(iv.months, iv.days, iv.nanos // 1000, iv.validity)
    assert buffers(pt.add_interval(dev, port_column(iv, cuda_device))) == \
        buffers(pt.add_interval(host, port_column(iv)))
    t = pt._tz_tables("America/New_York", dev.device)
    assert t[0].device.type == "cuda" and \
        pt._tz_tables("America/New_York", dev.device) is t
