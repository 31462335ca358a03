"""Memory observability (counterpart of arrow_tpu/core/pool.py;
arrow-buffer/src/pool.rs:73 MemoryPool / TrackingMemoryPool, arrow-array
get_array_memory_size, dictionary occupancy dictionary_array.rs:563).

The allocator is PyTorch's caching allocator, so the pool here is an
accounting layer: columns register their tensors' byte sizes into a
pool, and TrackingMemoryPool keeps the running and peak totals.
`device_memory_stats` reads the allocator's own counters on a CUDA
device (`torch.cuda.memory_stats`) and returns None on the CPU.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch
from torch.utils import _pytree as pytree

from ..config import DeviceLike
from .column import Column, DictionaryColumn
from .table import Table

__all__ = ["MemoryPool", "TrackingMemoryPool", "MemoryReservation",
           "column_memory_size", "table_memory_size",
           "dictionary_occupancy", "device_memory_stats"]


def column_memory_size(col: Column) -> int:
    """get_array_memory_size: the bytes of every tensor reachable from the
    column (buffers, validity, children, a dictionary's values)."""
    leaves = pytree.tree_leaves(col)
    if isinstance(col, DictionaryColumn):
        leaves += pytree.tree_leaves(col.values)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def table_memory_size(table: Table) -> int:
    return sum(column_memory_size(c) for c in table.columns)


def dictionary_occupancy(col: DictionaryColumn) -> float:
    """Share of the dictionary's entries a valid code refers to
    (dictionary_array.rs:563 occupancy, as a ratio)."""
    size = len(col.values)
    if size == 0:
        return 0.0
    codes = col.codes.to(torch.int64)
    if col.validity is not None:
        codes = codes[col.validity]
    used = torch.zeros(size, dtype=torch.bool, device=codes.device)
    used[codes[(codes >= 0) & (codes < size)]] = True
    return float(used.sum()) / size


class MemoryPool:
    """pool.rs:73: register, unregister and resize through reservations."""

    def reserve(self, size: int) -> "MemoryReservation":
        return MemoryReservation(self, size)

    def _grow(self, size: int):
        pass

    def _shrink(self, size: int):
        pass

    def used(self) -> int:
        return 0


class TrackingMemoryPool(MemoryPool):
    """pool.rs:93: tracks current and peak use (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._used = 0
        self._peak = 0

    def _grow(self, size: int):
        with self._lock:
            self._used += size
            self._peak = max(self._peak, self._used)

    def _shrink(self, size: int):
        with self._lock:
            self._used -= size

    def used(self) -> int:
        with self._lock:
            return self._used

    def peak(self) -> int:
        with self._lock:
            return self._peak


class MemoryReservation:
    """A reservation that resizes like pool.rs MemoryReservation."""

    def __init__(self, pool: MemoryPool, size: int):
        self._pool = pool
        self._size = size
        pool._grow(size)

    @property
    def size(self) -> int:
        return self._size

    def resize(self, new_size: int):
        delta = new_size - self._size
        if delta > 0:
            self._pool._grow(delta)
        else:
            self._pool._shrink(-delta)
        self._size = new_size

    def free(self):
        self._pool._shrink(self._size)
        self._size = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.free()

    @classmethod
    def for_column(cls, pool: MemoryPool, col: Column
                   ) -> "MemoryReservation":
        return cls(pool, column_memory_size(col))


def device_memory_stats(device: DeviceLike) -> Optional[Dict[str, int]]:
    """The caching allocator's counters of a CUDA device
    (torch.cuda.memory_stats), None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    s = torch.cuda.memory_stats(dev)
    return {k: int(v) for k, v in s.items() if isinstance(v, int)} or None
