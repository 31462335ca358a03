"""Seeded data generators for tests and benches (counterpart of
arrow_tpu/utils/bench_util.py; arrow/src/util/bench_util.rs:36-577):
primitive, boolean, string, string-dictionary and timestamp columns
with a share of nulls, and a random mixed-type table.

Each draws from a numpy Generator seeded by `seed`, in the reference's
order, so a seed gives the reference's values; the column is built on
the `device` the caller names.  A string dictionary lists its distinct
values in first-occurrence order, as pyarrow's dictionary_encode does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import dtypes as dt
from ..config import DeviceLike, resolve_device
from ..core.column import (Column, DictionaryColumn, StringColumn, column,
                           from_numpy)
from ..core.table import Table

__all__ = [
    "create_primitive_array", "create_boolean_array", "create_string_array",
    "create_string_dict_array", "create_timestamp_array",
    "create_random_batch",
]


def _mask(rng, size, null_density):
    if null_density <= 0.0:
        return None
    return rng.random(size) >= null_density  # True = valid


def create_primitive_array(size: int, null_density: float = 0.0,
                           dtype=np.int64, seed: int = 42, lo=None, hi=None,
                           *, device: DeviceLike) -> Column:
    """Integers in [lo, hi) (default [-1000, 1000), unsigned from 0) or
    floats in [0, 1000)."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        lo = -1000 if lo is None and dtype.kind == "i" else (lo or 0)
        hi = 1000 if hi is None else hi
        vals = rng.integers(lo, hi, size=size, dtype=dtype)
    else:
        vals = (rng.random(size) * 1000).astype(dtype)
    return from_numpy(vals, _mask(rng, size, null_density), device=device)


def create_boolean_array(size: int, null_density: float = 0.0,
                         true_density: float = 0.5, seed: int = 42, *,
                         device: DeviceLike) -> Column:
    rng = np.random.default_rng(seed)
    vals = rng.random(size) < true_density
    return from_numpy(vals, _mask(rng, size, null_density), device=device)


def _string_values(size, null_density, cardinality, max_len, seed):
    rng = np.random.default_rng(seed)
    pool = ["".join(rng.choice(list("abcdefghij"),
                               size=rng.integers(1, max_len)))
            for _ in range(cardinality)]
    idx = rng.integers(0, cardinality, size=size)
    valid = _mask(rng, size, null_density)
    return [pool[i] if valid is None or valid[k] else None
            for k, i in enumerate(idx)]


def create_string_array(size: int, null_density: float = 0.0,
                        cardinality: int = 100, max_len: int = 12,
                        seed: int = 42, *, device: DeviceLike
                        ) -> StringColumn:
    """Utf8 words of 1 to max_len - 1 letters a-j from a pool of
    `cardinality`."""
    return StringColumn.from_pylist(_string_values(
        size, null_density, cardinality, max_len, seed), device=device)


def create_string_dict_array(size: int, null_density: float = 0.0,
                             cardinality: int = 100, seed: int = 42, *,
                             device: DeviceLike) -> DictionaryColumn:
    """create_string_array's values dictionary-encoded: int32 codes over
    the distinct values in first-occurrence order, nulls not in the
    dictionary."""
    vals = _string_values(size, null_density, cardinality, 12, seed)
    first = {}
    for v in vals:
        if v is not None:
            first.setdefault(v, len(first))
    codes = np.array([0 if v is None else first[v] for v in vals], np.int32)
    valid = np.array([v is not None for v in vals], bool)
    return from_numpy(codes, None if valid.all() else valid,
                      dictionary=StringColumn.from_pylist(list(first),
                                                          device=device),
                      device=device)


def create_timestamp_array(size: int, null_density: float = 0.0,
                           unit: str = "us", seed: int = 42, *,
                           device: DeviceLike) -> Column:
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2_000_000_000, size=size, dtype=np.int64)
    return from_numpy(vals, _mask(rng, size, null_density),
                      dt.timestamp(unit), device=device)


def create_random_batch(size: int, seed: int = 0, null_density: float = 0.1,
                        *, device: DeviceLike) -> Table:
    """A random mixed-type Table (the reference's data_gen.rs:37 role):
    int64, float64, bool, a utf8 dictionary of 64 words and a
    timestamp[us], each with nulls."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def mask():
        return None if null_density == 0 else \
            rng.random(size) >= null_density

    words = [f"w{i:03d}" for i in range(64)]
    cols = {
        "i64": from_numpy(rng.integers(-10**12, 10**12, size).astype(
            np.int64), mask(), device=dev),
        "f64": from_numpy(rng.normal(0, 1e6, size), mask(), device=dev),
        "flag": from_numpy(rng.random(size) < 0.5, mask(), device=dev),
    }
    codes = torch.from_numpy(rng.integers(0, 64, size).astype(np.int32))
    wmask = mask()
    cols["word"] = DictionaryColumn(
        codes.to(dev), column(words, device=dev),
        None if wmask is None else torch.from_numpy(wmask).to(dev))
    cols["ts"] = from_numpy(rng.integers(0, 2**40, size).astype(np.int64),
                            mask(), dt.timestamp("us"), device=dev)
    return Table.from_pydict(cols, device=dev)
