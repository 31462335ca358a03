"""DataType string parser (counterpart of arrow_tpu/typeparse.py;
arrow-schema/src/datatype_parse.rs:22 parse_data_type), over the port's
dtypes.  Pure parsing: no tensor is made.

Accepts the reference's Debug-style type grammar and returns a
dtypes.DataType:

    Int32
    Timestamp(Nanosecond, None)
    Timestamp(Millisecond, Some("+08:00"))
    Dictionary(Int32, Utf8)
    List(FixedSizeBinary(2))
    Struct(a Int32, b Utf8)
    Decimal128(38, 10)
"""

from __future__ import annotations

import re
from typing import List, Optional

from . import dtypes as dt
from .errors import ArrowInvalid

__all__ = ["parse_data_type"]

_SIMPLE = {
    "Null": dt.null, "Boolean": dt.bool_,
    "Int8": dt.int8, "Int16": dt.int16, "Int32": dt.int32,
    "Int64": dt.int64,
    "UInt8": dt.uint8, "UInt16": dt.uint16, "UInt32": dt.uint32,
    "UInt64": dt.uint64,
    "Float16": dt.float16, "Float32": dt.float32, "Float64": dt.float64,
    "Utf8": dt.utf8, "LargeUtf8": dt.large_utf8, "Utf8View": dt.utf8_view,
    "Binary": dt.binary, "LargeBinary": dt.large_binary,
    "BinaryView": dt.binary_view,
    "Date32": dt.date32, "Date64": dt.date64,
}

_TIME_UNIT = {"Second": "s", "Millisecond": "ms", "Microsecond": "us",
              "Nanosecond": "ns"}
_INTERVAL_UNIT = {"YearMonth": "year_month", "DayTime": "day_time",
                  "MonthDayNano": "month_day_nano"}

_TOKEN_RE = re.compile(
    r'\s*(?:(?P<str>"[^"]*")|(?P<num>-?\d+)|(?P<word>\w+)|(?P<punct>[(),]))')


def _tokenize(s: str) -> List[str]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            rest = s[pos:].strip()
            if not rest:
                break
            raise ArrowInvalid(f"Unsupported type {s!r}: cannot tokenize "
                               f"at {rest!r}")
        out.append(m.group(m.lastgroup))
        pos = m.end()
    return out


class _Parser:
    def __init__(self, val: str):
        self.val = val
        self.toks = _tokenize(val)
        self.i = 0

    def _err(self, msg: str):
        raise ArrowInvalid(f"Unsupported type {self.val!r}. Must be a "
                           f"supported arrow type name such as 'Int32' or "
                           f"'Timestamp(Nanosecond, None)'. Error {msg}")

    def next(self) -> str:
        if self.i >= len(self.toks):
            self._err("unexpected end of input")
        t = self.toks[self.i]
        self.i += 1
        return t

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def expect(self, tok: str):
        t = self.next()
        if t != tok:
            self._err(f"expected {tok!r}, got {t!r}")

    def parse(self) -> dt.DataType:
        t = self.parse_type()
        if self.i != len(self.toks):
            self._err(f"trailing content after parsing {t!r}")
        return t

    def _int(self, lo: int, hi: int, ctx: str) -> int:
        t = self.next()
        try:
            v = int(t)
        except ValueError:
            self._err(f"expected an integer for {ctx}, got {t!r}")
        if not lo <= v <= hi:
            self._err(f"{ctx} value {v} out of range")
        return v

    def _time_unit(self, ctx: str) -> str:
        t = self.next()
        if t not in _TIME_UNIT:
            self._err(f"expected a TimeUnit for {ctx}, got {t!r}")
        return _TIME_UNIT[t]

    def parse_type(self) -> dt.DataType:
        w = self.next()
        if w in _SIMPLE:
            return _SIMPLE[w]
        if w == "Timestamp":
            self.expect("(")
            unit = self._time_unit("Timestamp")
            self.expect(",")
            t = self.next()
            tz = None
            if t == "Some":
                self.expect("(")
                s = self.next()
                if not (s.startswith('"') and s.endswith('"')):
                    self._err(f"expected a quoted timezone, got {s!r}")
                tz = s[1:-1]
                self.expect(")")
            elif t != "None":
                self._err(f"expected Some/None timezone, got {t!r}")
            self.expect(")")
            return dt.timestamp(unit, tz)
        if w == "Time32":
            self.expect("(")
            unit = self._time_unit("Time32")
            self.expect(")")
            return dt.time32(unit)
        if w == "Time64":
            self.expect("(")
            unit = self._time_unit("Time64")
            self.expect(")")
            return dt.time64(unit)
        if w == "Duration":
            self.expect("(")
            unit = self._time_unit("Duration")
            self.expect(")")
            return dt.duration(unit)
        if w == "Interval":
            self.expect("(")
            t = self.next()
            if t not in _INTERVAL_UNIT:
                self._err(f"expected an IntervalUnit, got {t!r}")
            self.expect(")")
            return dt.interval(_INTERVAL_UNIT[t])
        if w == "FixedSizeBinary":
            self.expect("(")
            n = self._int(0, 2**31 - 1, "FixedSizeBinary")
            self.expect(")")
            return dt.fixed_size_binary(n)
        if w in ("Decimal32", "Decimal64", "Decimal128", "Decimal256"):
            self.expect("(")
            p = self._int(0, 255, w)
            self.expect(",")
            s = self._int(-128, 127, w)
            self.expect(")")
            return getattr(dt, w.lower())(p, s)
        if w == "Dictionary":
            self.expect("(")
            k = self.parse_type()
            self.expect(",")
            v = self.parse_type()
            self.expect(")")
            return dt.dictionary(k, v)
        if w in ("List", "LargeList", "ListView", "LargeListView"):
            self.expect("(")
            inner = self.parse_type()
            self.expect(")")
            ctor = {"List": dt.list_, "LargeList": dt.large_list,
                    "ListView": dt.list_view,
                    "LargeListView": dt.large_list_view}[w]
            return ctor(inner)
        if w == "FixedSizeList":
            self.expect("(")
            n = self._int(0, 2**31 - 1, "FixedSizeList")
            self.expect(",")
            inner = self.parse_type()
            self.expect(")")
            return dt.fixed_size_list(inner, n)
        if w == "Struct":
            self.expect("(")
            fields: List[dt.Field] = []
            if self.peek() == ")":
                self.next()
                return dt.struct(fields)
            while True:
                name = self.next()
                if name in (",", "(", ")"):
                    self._err(f"expected a field name, got {name!r}")
                fields.append(dt.Field(name, self.parse_type()))
                t = self.next()
                if t == ")":
                    break
                if t != ",":
                    self._err(f"expected ',' or ')' in Struct, got {t!r}")
            return dt.struct(fields)
        self._err(f"unrecognized word: {w!r}")


def parse_data_type(val: str) -> dt.DataType:
    """parse_data_type (datatype_parse.rs:22)."""
    return _Parser(val).parse()
