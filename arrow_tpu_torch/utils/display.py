"""Value formatting and ASCII tables (counterpart of
arrow_tpu/utils/display.py; arrow-cast/src/display.rs:269 ArrayFormatter
and FormatOptions, arrow-cast/src/pretty.rs:63 pretty_format_batches).

A host-side presentation layer: each column's values come to the host
once (`to_pylist`, which lists temporal values as date and datetime
objects, as the reference's does) and are formatted row by row into
the reference's strings.
"""

from __future__ import annotations

import datetime as _datetime
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import dtypes as dt
from ..core.column import Column
from ..core.table import Table

__all__ = ["FormatOptions", "ArrayFormatter", "pretty_format_table",
           "pretty_format_columns"]


@dataclass(frozen=True)
class FormatOptions:
    """display.rs:57 FormatOptions subset."""
    null: str = ""                 # reference default renders nulls as ""
    safe: bool = True
    date_format: Optional[str] = None
    timestamp_format: Optional[str] = None


class ArrayFormatter:
    """Per-column value formatter (display.rs:269): value(i) -> str."""

    def __init__(self, col: Column, options: FormatOptions = FormatOptions()):
        self.col = col
        self.options = options
        self._pylist = None

    def _values(self):
        if self._pylist is None:
            self._pylist = self.col.to_pylist()
        return self._pylist

    def value(self, i: int) -> str:
        v = self._values()[i]
        return self._fmt(v, self.col.dtype)

    def _fmt(self, v, d: dt.DataType) -> str:
        if v is None:
            return self.options.null
        name = d.name
        if name == "bool":
            return "true" if v else "false"
        if d.is_floating:
            return repr(float(v))
        if name == "timestamp" and isinstance(v, (int, np.integer)):
            # exact integer us (float roundtrips lose the last us digit
            # on ns-epoch magnitudes)
            scale = {"s": 1_000_000, "ms": 1_000, "us": 1, "ns": 1}[d.unit]
            us = int(v) * scale if d.unit != "ns" else int(v) // 1_000
            s = _datetime.datetime(1970, 1, 1,
                                   tzinfo=_datetime.timezone.utc) \
                + _datetime.timedelta(microseconds=us)
            fmt = self.options.timestamp_format or "%Y-%m-%dT%H:%M:%S.%f"
            return s.strftime(fmt)
        if isinstance(v, _datetime.datetime):
            fmt = self.options.timestamp_format or "%Y-%m-%dT%H:%M:%S.%f"
            return v.strftime(fmt)
        if isinstance(v, _datetime.date):
            return v.strftime(self.options.date_format or "%Y-%m-%d")
        if isinstance(v, bytes):
            return v.hex()
        if isinstance(v, list):
            inner = ", ".join(self._fmt(x, d.value_type or dt.null)
                              if not isinstance(x, tuple)
                              else f"{x[0]}: {x[1]}" for x in v)
            return f"[{inner}]"
        if isinstance(v, dict):
            inner = ", ".join(f"{k}: {self._fmt(x, dt.null)}"
                              for k, x in v.items())
            return "{" + inner + "}"
        return str(v)


def pretty_format_columns(name: str, col: Column,
                          options: FormatOptions = FormatOptions()) -> str:
    """pretty.rs pretty_format_columns: one-column table."""
    t = Table([col], dt.Schema((dt.Field(name, col.dtype),)))
    return pretty_format_table(t, options)


def pretty_format_table(table: Table,
                        options: FormatOptions = FormatOptions()) -> str:
    """ASCII art table (pretty.rs:63 pretty_format_batches; same +---+
    box style as the reference's comfy-table output)."""
    headers = list(table.schema.names)
    fmts = [ArrayFormatter(c, options) for c in table.columns]
    n = table.num_rows
    rows: List[List[str]] = [[f.value(i) for f in fmts] for i in range(n)]

    widths = [len(h) for h in headers]
    for r in rows:
        for j, cell in enumerate(r):
            widths[j] = max(widths[j], len(cell))

    def sep():
        return "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def line(cells):
        return "| " + " | ".join(c.ljust(w)
                                 for c, w in zip(cells, widths)) + " |"

    out = [sep(), line(headers), sep()]
    out += [line(r) for r in rows]
    out.append(sep())
    return "\n".join(out)
