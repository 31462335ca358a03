"""Column invariant validation (counterpart of arrow_tpu/core/validate.py;
arrow-data/src/data.rs:750 validate, :1196 validate_full).

`validate` checks the structure cheaply (lengths of buffers, children
and offsets); `validate_full` also reads the offsets, codes, type ids
and run ends on the host and checks what depends on the data: offsets
non-decreasing and in bounds, dictionary codes in range, union type ids
registered and dense offsets in range, run ends strictly increasing and
ending at the length, and UTF-8 well-formed.
"""

from __future__ import annotations

import numpy as np

from ..errors import ArrowInvalid
from .column import (Column, DictionaryColumn, ListColumn, StringColumn,
                     StructColumn)
from .nested import FixedSizeListColumn, MapColumn, RunEndColumn, UnionColumn

__all__ = ["validate", "validate_full"]


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def validate(col: Column) -> None:
    """Cheap structural checks (data.rs:750)."""
    n = len(col)
    if col.validity is not None and int(col.validity.shape[0]) != n:
        raise ArrowInvalid("validity length != column length")
    if isinstance(col, (StringColumn, ListColumn)):
        if int(col.offsets.shape[0]) != n + 1:
            raise ArrowInvalid("offsets length != len + 1")
    if isinstance(col, StructColumn):
        for c in col.children:
            if len(c) != n:
                raise ArrowInvalid("struct child length mismatch")
            validate(c)
    if isinstance(col, ListColumn):
        validate(col.child)
    if isinstance(col, DictionaryColumn):
        validate(col.values)
    if isinstance(col, FixedSizeListColumn):
        if len(col.child) != n * col.list_size:
            raise ArrowInvalid("fixed-size list child length mismatch")
        validate(col.child)
    if isinstance(col, MapColumn):
        if int(col.offsets.shape[0]) != n + 1:
            raise ArrowInvalid("map offsets length != len + 1")
        validate(col.entries)
    if isinstance(col, UnionColumn):
        if col.offsets is None:
            for c in col.children:
                if len(c) != n:
                    raise ArrowInvalid("sparse union child length")
        for c in col.children:
            validate(c)
    if isinstance(col, RunEndColumn):
        if col.num_runs and len(col.values) != col.num_runs:
            raise ArrowInvalid("run values length != run count")


def validate_full(col: Column) -> None:
    """Deep data-dependent checks (data.rs:1196-1303)."""
    validate(col)
    n = len(col)
    if isinstance(col, (StringColumn, ListColumn)):
        offs = _host(col.offsets)
        if n and offs[0] < 0:
            raise ArrowInvalid("negative offset")
        if np.any(np.diff(offs) < 0):
            raise ArrowInvalid("offsets not monotonically non-decreasing")
        limit = int(col.data.shape[0]) if isinstance(col, StringColumn) \
            else len(col.child)
        if n and offs[-1] > limit:
            raise ArrowInvalid("offsets exceed child/data length")
    if isinstance(col, StringColumn) and col.dtype.is_string:
        data = _host(col.data).tobytes()
        offs = _host(col.offsets)
        valid = None if col.validity is None else _host(col.validity)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            try:
                data[offs[i]:offs[i + 1]].decode("utf-8")
            except UnicodeDecodeError:
                raise ArrowInvalid(f"invalid UTF-8 at row {i}")
    if isinstance(col, DictionaryColumn):
        codes = _host(col.codes)
        valid = None if col.validity is None else _host(col.validity)
        live = codes if valid is None else codes[valid]
        if live.size and (live.min() < 0 or live.max() >= len(col.values)):
            raise ArrowInvalid("dictionary code out of range")
        validate_full(col.values)
    if isinstance(col, (StructColumn, ListColumn)):
        for c in col.children if isinstance(col, StructColumn) \
                else (col.child,):
            validate_full(c)
    if isinstance(col, RunEndColumn):
        re = _host(col.run_ends)
        if re.size:
            if re[0] <= 0 or np.any(np.diff(re) <= 0):
                raise ArrowInvalid("run ends must be strictly increasing")
            if int(re[-1]) != n:
                raise ArrowInvalid("last run end != length")
        validate_full(col.values)
    if isinstance(col, UnionColumn):
        tids = _host(col.type_ids)
        if tids.size and not np.isin(tids, np.asarray(col.ids)).all():
            raise ArrowInvalid("union type id not in registered ids")
        if col.offsets is not None:
            offs = _host(col.offsets)
            for i, tid in enumerate(col.ids):
                sel = offs[tids == tid]
                if sel.size and (sel.min() < 0
                                 or sel.max() >= len(col.children[i])):
                    raise ArrowInvalid("dense union offset out of range")
        for c in col.children:
            validate_full(c)
