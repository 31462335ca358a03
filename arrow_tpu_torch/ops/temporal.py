"""Temporal kernels: date_part extraction and calendar-aware interval
arithmetic (counterpart of arrow_tpu/ops/temporal.py; arrow-arith/src/
temporal.rs:44,146 and numeric.rs's interval arms).

Extraction is branch-free civil-calendar arithmetic on the input's
device (Howard Hinnant's days-from-civil and its inverse), int64 torch
ops throughout; no host round trip.

  - date32 / date64 / timestamp / time32 / time64 split into days since
    the epoch and nanoseconds of the day by FLOOR division, so pre-epoch
    instants fall on the previous day (temporal.py:188-213); torch's
    `//` and `%` on integer tensors floor, as jnp's do.
  - durations and intervals (temporal.py:302-380) TRUNCATE, as the
    reference's lax.div / lax.rem do: torch.div(rounding_mode="trunc")
    and torch.fmod.  A part that does not fit int32 is null.  A day_time
    interval packs days << 32 | millis with the low half signed.
  - time zones: a fixed offset ('+05:30', 'UTC') is a one-entry table; an
    IANA zone's TZif file (the v2+ 64-bit block of /usr/share/zoneinfo)
    gives its transitions, extended past the table's end through 2120 by
    the file's POSIX footer rule.  The tables are built on the host once
    per zone and placed on each device once (`_tz_tables`); the UTC
    offset of each instant is one torch.searchsorted (right side) over
    the transitions.
  - add_interval / sub_interval shift timestamp, date32 and date64
    columns by year_month, day_time or month_day_nano intervals: months
    first with end-of-month clamping (chrono's checked_add_months), then
    days, then nanoseconds, in the column's local time when it has a
    zone (back to UTC through the local transition table).
"""

from __future__ import annotations

import datetime
import functools
import os
import re
import struct as _struct
from typing import Dict, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..core import validity as vd
from ..core.column import PrimitiveColumn
from ..errors import ArrowTypeError

__all__ = ["date_part", "year", "month", "day", "hour", "minute", "second",
           "millisecond", "microsecond", "nanosecond", "day_of_week",
           "day_of_year", "quarter", "week", "iso_week", "iso_year",
           "add_interval", "sub_interval"]

_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}
_DAY_NS = 86_400 * 1_000_000_000
_ZONEINFO = "/usr/share/zoneinfo"


# ---- time zones (host tables, cached) -----------------------------------

@functools.lru_cache(maxsize=None)
def _tzif_table(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """(transition seconds, UTC offset seconds after each), int64 numpy,
    from the zone's TZif file (temporal.py:39-95).  The first entry is
    -2**62 with the offset before the first transition."""
    path = os.path.join(_ZONEINFO, *name.split("/"))
    if not os.path.realpath(path).startswith(os.path.realpath(_ZONEINFO)):
        raise ArrowTypeError(f"bad timezone name {name!r}")
    with open(path, "rb") as f:
        data = f.read()

    def parse_block(off, wide):
        if data[off:off + 4] != b"TZif":
            raise ArrowTypeError(f"{name}: not a TZif file")
        version = data[off + 4:off + 5]
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = _struct.unpack_from(">6I", data, off + 20)
        p = off + 44
        tsize = 8 if wide else 4
        times = np.array(_struct.unpack_from(
            ">%d%s" % (timecnt, "q" if wide else "i"), data, p), np.int64)
        p += timecnt * tsize
        idxs = np.frombuffer(data, np.uint8, timecnt, p)
        p += timecnt
        offs = np.array([_struct.unpack_from(">i", data, p + 6 * t)[0]
                         for t in range(typecnt)], np.int64)
        p += 6 * typecnt + charcnt
        p += leapcnt * (tsize + 4) + isstdcnt + isutcnt
        return version, times, idxs, offs, p

    version, times, idxs, offs, end = parse_block(0, wide=False)
    footer_end = end
    if version >= b"2":
        version, times, idxs, offs, footer_end = parse_block(end, wide=True)
    # the v2+ footer's POSIX rule governs instants past the last stored
    # transition (slim tzdata stores few; fat tables end about 2037)
    tzstr = ""
    if footer_end < len(data) and data[footer_end:footer_end + 1] == b"\n":
        nl = data.find(b"\n", footer_end + 1)
        tzstr = data[footer_end + 1:nl if nl > 0 else len(data)] \
            .decode("ascii", "ignore")
    if len(times) == 0:
        return (np.array([-(1 << 62)], np.int64),
                np.array([offs[0] if len(offs) else 0], np.int64))
    trans_offs = offs[idxs]
    ft, fo = _posix_rule_transitions(tzstr, int(times[-1]))
    if ft:
        times = np.concatenate([times, np.asarray(ft, np.int64)])
        trans_offs = np.concatenate([trans_offs, np.asarray(fo, np.int64)])
    return (np.concatenate([[-(1 << 62)], times]).astype(np.int64),
            np.concatenate([[offs[0]], trans_offs]).astype(np.int64))


def _posix_rule_transitions(tz: str, after: int):
    """(utc seconds, offsets) of a POSIX TZ rule ('EST5EDT,M3.2.0,M11.1.0')
    for the years after `after`, through 2120 (temporal.py:98-161).  A
    constant offset or a Jn / n rule gives none."""
    name = r"(?:<[^>]+>|[A-Za-z]+)"
    off = r"[+-]?\d+(?::\d+(?::\d+)?)?"
    m = re.match(rf"^({name})({off})(({name})({off})?)?(?:,(.+),(.+))?$",
                 tz)
    if not m or not m.group(3) or not m.group(6):
        return [], []

    def secs(s):
        sign = -1 if s.startswith("-") else 1
        parts = [int(x) for x in s.lstrip("+-").split(":")]
        parts += [0] * (3 - len(parts))
        return sign * (parts[0] * 3600 + parts[1] * 60 + parts[2])

    std_off = -secs(m.group(2))       # POSIX offsets are west-positive
    dst_off = -secs(m.group(5)) if m.group(5) else std_off + 3600

    def parse_rule(s):
        t = 2 * 3600
        if "/" in s:
            s, tp = s.split("/", 1)
            t = secs(tp)
        if not s.startswith("M"):
            raise ValueError(f"TZ rule {s!r}")
        mo, wk, wd = (int(x) for x in s[1:].split("."))
        return mo, wk, wd, t

    try:
        r_start, r_end = parse_rule(m.group(6)), parse_rule(m.group(7))
    except ValueError:                # Jn and n rules: no extension
        return [], []

    def m_date(year, mo, wk, wd):
        if wk == 5:                   # the month's last weekday wd
            nxt = datetime.date(year + (mo == 12), mo % 12 + 1, 1)
            d = nxt - datetime.timedelta(days=1)
            return d - datetime.timedelta(
                days=((d.weekday() + 1) % 7 - wd) % 7)
        d = datetime.date(year, mo, 1)
        dow = (d.weekday() + 1) % 7   # 0 = Sunday, as POSIX counts
        return d + datetime.timedelta(days=(wd - dow) % 7 + 7 * (wk - 1))

    epoch = datetime.date(1970, 1, 1)
    y0 = (epoch + datetime.timedelta(seconds=after // 86400 * 86400)).year
    out_t, out_o = [], []
    for y in range(max(y0, 1971), 2121):
        mo, wk, wd, t = r_start       # DST begins, in standard time
        st = (m_date(y, mo, wk, wd) - epoch).days * 86400 + t - std_off
        mo, wk, wd, t = r_end         # DST ends, in daylight time
        en = (m_date(y, mo, wk, wd) - epoch).days * 86400 + t - dst_off
        for sec, o in sorted([(st, dst_off), (en, std_off)]):
            if sec > after:
                out_t.append(sec)
                out_o.append(o)
    return out_t, out_o


def _parse_fixed_offset(tz: str):
    """'+HH:MM' / '-HH:MM' / 'UTC' / 'GMT' -> offset seconds, else None."""
    if tz in ("UTC", "GMT", "utc", "Z", "+00:00", "-00:00"):
        return 0
    if len(tz) >= 3 and tz[0] in "+-" and tz[1:3].isdigit():
        sign = 1 if tz[0] == "+" else -1
        mm = int(tz[4:6]) if len(tz) >= 6 else 0
        return sign * (int(tz[1:3]) * 3600 + mm * 60)
    return None


_DEVICE_TABLES: Dict[Tuple[str, torch.device],
                     Tuple[torch.Tensor, torch.Tensor]] = {}


def _tz_tables(tz: str, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(transition seconds, offsets) int64 tensors of a zone on `device`,
    built once per zone and copied once per device."""
    key = (tz, torch.device(device))
    got = _DEVICE_TABLES.get(key)
    if got is None:
        fixed = _parse_fixed_offset(tz)
        trans, offs = (np.array([-(1 << 62)], np.int64),
                       np.array([fixed], np.int64)) if fixed is not None \
            else _tzif_table(tz)
        got = _DEVICE_TABLES[key] = (torch.from_numpy(trans).to(device),
                                     torch.from_numpy(offs).to(device))
    return got


def _offset_at(trans: torch.Tensor, offs: torch.Tensor,
               secs: torch.Tensor) -> torch.Tensor:
    """The offset of the regime each second falls in."""
    idx = torch.searchsorted(trans, secs, right=True) - 1
    return offs[idx.clamp(0, offs.shape[0] - 1)]


# ---- civil calendar -------------------------------------------------------

def _epoch_days_and_time_ns(v: torch.Tensor, tables, dname: str, unit):
    """(days since the epoch, nanoseconds of the day) of int64 storage,
    floor semantics (temporal.py:188-213); `tables` is a zone's
    (transitions, offsets) or None."""
    if dname == "date32":
        return v, torch.zeros_like(v)
    if dname == "date64":
        days = v // 86_400_000
        return days, (v - days * 86_400_000) * 1_000_000
    if dname == "timestamp":
        ns = v * _UNIT_NS[unit]
        if tables is not None:
            # local wall clock = instant + utc_offset(instant)
            ns = ns + _offset_at(*tables, ns // 1_000_000_000) \
                * 1_000_000_000
        days = ns // _DAY_NS
        return days, ns - days * _DAY_NS
    if dname in ("time32", "time64"):
        return torch.zeros_like(v), v * _UNIT_NS[unit]
    raise ArrowTypeError(f"date_part of {dname}")


def _civil_from_days(z: torch.Tensor):
    """days since the epoch -> (year, month, day), proleptic Gregorian."""
    z = z + 719_468
    era = z // 146_097
    doe = z - era * 146_097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)           # [0, 365]
    mp = (5 * doy + 2) // 153                                 # [0, 11]
    day = doy - (153 * mp + 2) // 5 + 1                       # [1, 31]
    month = torch.where(mp < 10, mp + 3, mp - 9)              # [1, 12]
    return torch.where(month <= 2, y + 1, y), month, day


def _days_from_civil(y, m, d):
    y = torch.where(m <= 2, y - 1, y)
    era = y // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = 365 * yoe + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def _jan1(y: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(y)
    return _days_from_civil(y, one, one)


def _iso_year_week(days: torch.Tensor):
    """(iso_year, iso_week) per ISO 8601 (temporal.py:231-253)."""
    yy, _, _ = _civil_from_days(days)
    dow1 = (days + 3) % 7 + 1                # Monday = 1 .. Sunday = 7
    w = (days - _jan1(yy) + 1 - dow1 + 10) // 7

    def weeks_in(y):
        # 52 + (jan 1 a Thursday, or a leap year's jan 1 a Wednesday)
        jd = (_jan1(y) + 3) % 7 + 1
        leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
        return 52 + ((jd == 4) | (leap & (jd == 3))).to(days.dtype)

    past = (w > 52) & (w > weeks_in(yy))
    week = torch.where(w < 1, weeks_in(yy - 1), w)
    week = torch.where(past, torch.ones_like(w), week)
    iso_year = torch.where(w < 1, yy - 1, torch.where(past, yy + 1, yy))
    return iso_year, week


def _date_part_values(v, tables, dname, unit, part) -> torch.Tensor:
    """One extraction over int64 storage -> int32 (temporal.py:256-296)."""
    days, t_ns = _epoch_days_and_time_ns(v, tables, dname, unit)
    if part in ("week", "week_iso", "year_iso"):
        iso_year, week = _iso_year_week(days)
        out = iso_year if part == "year_iso" else week
    elif part in ("year", "month", "day", "quarter", "doy"):
        yy, mm, dd = _civil_from_days(days)
        out = {"year": yy, "month": mm, "day": dd,
               "quarter": (mm - 1) // 3 + 1}.get(part)
        if part == "doy":
            out = days - _jan1(yy) + 1
    elif part == "dow":                      # DayOfWeekMonday0
        out = (days + 3) % 7
    elif part == "dow_sunday0":              # DayOfWeekSunday0
        out = (days + 4) % 7
    elif part == "hour":
        out = t_ns // (3_600 * 1_000_000_000)
    elif part == "minute":
        out = (t_ns // (60 * 1_000_000_000)) % 60
    elif part == "second":
        out = (t_ns // 1_000_000_000) % 60
    elif part == "millisecond":
        out = (t_ns // 1_000_000) % 1_000
    elif part == "microsecond":
        out = (t_ns // 1_000) % 1_000_000
    elif part == "nanosecond":
        out = t_ns % 1_000_000_000
    else:
        raise ArrowTypeError(f"unknown date part {part}")
    return out.to(torch.int32)


_I32_LO, _I32_HI = -2 ** 31, 2 ** 31 - 1


def _tdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="trunc")


def _duration_part(v: torch.Tensor, unit: str, part: str):
    """Duration parts (temporal.py:302-324): a truncating conversion to a
    coarser part, a checked multiply to a finer one; (int32, fits)."""
    tps = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}[unit]
    sec_num, sec_den = {
        "week": (604_800, 1), "day": (86_400, 1), "hour": (3_600, 1),
        "minute": (60, 1), "second": (1, 1), "millisecond": (1, 1_000),
        "microsecond": (1, 1_000_000), "nanosecond": (1, 1_000_000_000)}[part]
    num, den = sec_num * tps, sec_den
    if num % den == 0:
        q = _tdiv(v, num // den)
        ok = (q >= _I32_LO) & (q <= _I32_HI)
    else:
        mult = den // num
        # bound before multiplying: the int64 product may wrap
        lo, hi = -((-_I32_LO) // mult), _I32_HI // mult
        ok = (v >= lo) & (v <= hi)
        q = torch.where(ok, v, 0) * mult
    return q.to(torch.int32), ok


def _interval_part(months, days, nanos, unit: str, part: str):
    """Interval parts (temporal.py:327-375); for day_time `nanos` holds
    milliseconds and the sub-second parts scale them without a check,
    as the reference does.  (int32, fits)."""
    if part == "year":
        q = _tdiv(months, 12)
    elif part == "month":
        q = torch.fmod(months, 12)
    elif part == "week":
        q = _tdiv(days, 7)
    elif part == "day":
        q = days
    elif unit == "day_time":
        ms = nanos
        q = {"hour": lambda: _tdiv(ms, 3_600_000),
             "minute": lambda: torch.fmod(_tdiv(ms, 60_000), 60),
             "second": lambda: torch.fmod(_tdiv(ms, 1_000), 60),
             "millisecond": lambda: torch.fmod(ms, 60_000),
             "microsecond": lambda: torch.fmod(ms, 60_000) * 1_000,
             "nanosecond": lambda: torch.fmod(ms, 60_000) * 1_000_000,
             }[part]()
    else:                                    # month_day_nano
        minute_ns = 60_000_000_000
        q = {"hour": lambda: _tdiv(nanos, 3_600_000_000_000),
             "minute": lambda: torch.fmod(_tdiv(nanos, minute_ns), 60),
             "second": lambda: torch.fmod(_tdiv(nanos, 1_000_000_000), 60),
             "millisecond": lambda: _tdiv(torch.fmod(nanos, minute_ns),
                                          1_000_000),
             "microsecond": lambda: _tdiv(torch.fmod(nanos, minute_ns),
                                          1_000),
             "nanosecond": lambda: torch.fmod(nanos, minute_ns)}[part]()
    return q.to(torch.int32), (q >= _I32_LO) & (q <= _I32_HI)


_DURATION_PARTS = ("week", "day", "hour", "minute", "second",
                   "millisecond", "microsecond", "nanosecond")
_YM_PARTS = ("year", "month")
_MDN_PARTS = _YM_PARTS + _DURATION_PARTS


def _span_date_part(col, part: str) -> PrimitiveColumn:
    """date_part of a duration or interval column (temporal.py:386-419):
    a part that does not fit int32 is null (one host read of whether
    any does not)."""
    d = col.dtype
    allowed = _DURATION_PARTS if d.name == "duration" else \
        {"year_month": _YM_PARTS, "day_time": _DURATION_PARTS,
         "month_day_nano": _MDN_PARTS}[d.unit]
    if part not in allowed:
        raise ArrowTypeError(f"{part} does not support {d!r}")
    if d.name == "duration":
        q, ok = _duration_part(col.values.to(torch.int64), d.unit, part)
    elif d.unit == "year_month":
        m = col.values.to(torch.int64)
        q, ok = _interval_part(m, torch.zeros_like(m), torch.zeros_like(m),
                               "year_month", part)
    elif d.unit == "day_time":
        x = col.values
        days, ms = x >> 32, x.to(torch.int32).to(torch.int64)
        q, ok = _interval_part(torch.zeros_like(days), days, ms,
                               "day_time", part)
    else:
        q, ok = _interval_part(col.months.to(torch.int64),
                               col.days.to(torch.int64), col.nanos,
                               "month_day_nano", part)
    return PrimitiveColumn(q, dt.int32, vd.union(
        col.validity, None if bool(ok.all()) else ok))


def date_part(col, part: str) -> PrimitiveColumn:
    """One calendar or clock part of every row as int32 (temporal.rs:146).
    `part`: year, month, day, hour, minute, second, millisecond,
    microsecond, nanosecond, dow (Monday 0), dow_sunday0, doy, quarter,
    week / week_iso (ISO 8601), year_iso."""
    d = col.dtype
    if d.name in ("duration", "interval"):
        return _span_date_part(col, part)
    tz = d.tz if d.name == "timestamp" else None
    tables = _tz_tables(tz, col.device) if tz else None
    out = _date_part_values(col.values.to(torch.int64), tables, d.name,
                            d.unit, part)
    return PrimitiveColumn(out, dt.int32, col.validity,
                           _canonical=col.validity is None)


def year(col):
    return date_part(col, "year")


def month(col):
    return date_part(col, "month")


def day(col):
    return date_part(col, "day")


def hour(col):
    return date_part(col, "hour")


def minute(col):
    return date_part(col, "minute")


def second(col):
    return date_part(col, "second")


def millisecond(col):
    return date_part(col, "millisecond")


def microsecond(col):
    return date_part(col, "microsecond")


def nanosecond(col):
    return date_part(col, "nanosecond")


def day_of_week(col):
    return date_part(col, "dow")


def day_of_year(col):
    return date_part(col, "doy")


def quarter(col):
    return date_part(col, "quarter")


def week(col):
    """ISO 8601 week number (temporal.rs DatePart::Week == WeekISO)."""
    return date_part(col, "week")


def iso_week(col):
    return date_part(col, "week_iso")


def iso_year(col):
    return date_part(col, "year_iso")


# ---- interval arithmetic (numeric.rs interval arms) -----------------------

_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    base = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=m.device)
    return torch.where((m == 2) & leap, 29, base[m - 1])


def _shift(v, months, days, nanos, tables, dname: str, unit: str):
    """The calendar shift of int64 storage (temporal.py:522-563): months
    with end-of-month clamping, then days, then nanoseconds; with a zone
    in local wall-clock time, mapped back to UTC through the transitions
    as seen in local time (ambiguous and skipped wall-clock times take
    the later regime)."""
    ep_days, time_ns = _epoch_days_and_time_ns(v, tables, dname, unit)
    y, m, dd = _civil_from_days(ep_days)
    m2 = m - 1 + months
    y2 = y + m2 // 12
    m2 = m2 - (m2 // 12) * 12 + 1
    dd2 = torch.minimum(dd, _days_in_month(y2, m2))
    out_days = _days_from_civil(y2, m2, dd2) + days
    total_ns = time_ns + nanos
    carry = total_ns // _DAY_NS
    out_days = out_days + carry
    total_ns = total_ns - carry * _DAY_NS
    if dname == "date32":
        return out_days.to(torch.int32)
    if dname == "date64":
        return out_days * 86_400_000 + total_ns // 1_000_000
    ns = out_days * _DAY_NS + total_ns
    if tables is not None:
        trans, offs = tables
        ns = ns - _offset_at(trans + offs, offs,
                             ns // 1_000_000_000) * 1_000_000_000
    return ns // _UNIT_NS[unit]


def add_interval(col: PrimitiveColumn, interval, *, negate: bool = False
                 ) -> PrimitiveColumn:
    """timestamp / date32 / date64 + an interval column of the same length
    (year_month, day_time or month_day_nano), calendar-aware with
    end-of-month clamping (temporal.py:590-623); null where either is."""
    from ..core.nested import IntervalMDNColumn
    d = col.dtype
    if d.name not in ("timestamp", "date32", "date64"):
        raise ArrowTypeError(f"add_interval over {d!r}")
    if isinstance(interval, IntervalMDNColumn):
        months, days, nanos = (interval.months.to(torch.int64),
                               interval.days.to(torch.int64), interval.nanos)
    elif isinstance(interval, PrimitiveColumn) and \
            interval.dtype.name == "interval":
        x = interval.values.to(torch.int64)
        if interval.dtype.unit == "year_month":
            months, days, nanos = x, torch.zeros_like(x), torch.zeros_like(x)
        else:                     # day_time: days << 32 | signed millis
            days = x >> 32
            months = torch.zeros_like(days)
            nanos = x.to(torch.int32).to(torch.int64) * 1_000_000
    else:
        raise ArrowTypeError(f"not an interval: {type(interval)}")
    if negate:
        months, days, nanos = -months, -days, -nanos
    tz = d.tz if d.name == "timestamp" else None
    tables = _tz_tables(tz, col.device) if tz is not None else None
    out = PrimitiveColumn(
        _shift(col.values.to(torch.int64), months, days, nanos, tables,
               d.name, d.unit or "us"), d, col.validity,
        _canonical=col.validity is None)
    validity = vd.union(out.validity, interval.validity)
    return out if validity is out.validity else out.with_validity(validity)


def sub_interval(col: PrimitiveColumn, interval) -> PrimitiveColumn:
    return add_interval(col, interval, negate=True)
