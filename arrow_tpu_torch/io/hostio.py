"""The file layer's crossing between host bytes and device columns.

The codecs of io/ (C Data Interface, IPC, Parquet) work on numpy
buffers on the host.  Everything crosses here, once each way:

  - `to_host(x, site=None)`: a column or table with every tensor on the
    CPU (a dictionary's values too): one device-to-host copy per buffer,
    none when it is there already.  Writers take their host view through
    it once per batch, row group or export, and read that view only.
    With a `site`, each copy is a `readback` of the query path
    (utils/trace.py::to_host) under that name.
  - `tensor(a, device)`: a host buffer (often a read-only view of file
    bytes) as a tensor on `device`, always a copy, so no column aliases
    a file's or a producer's memory.
  - `to_device(x, device)`: a tensor, column or table of host tensors on
    `device`; onto a card each buffer goes through pinned memory and is
    queued on the stream, so the host does not wait for the card's
    earlier work (a plain copy from pageable memory does).
  - `values(col)`: a host PrimitiveColumn's values in their logical
    numpy dtype (unsigned types are held on signed storage).
  - `pool_map(fn, items)`: the one thread pool of the file layer's
    host codecs (Parquet decode and encode, IPC compression), sized by
    ARROW_TPU_PARQUET_THREADS (0 = one thread, N = at most N; default
    the core count).  Its workers take and return host buffers: the
    copies to and from a card stay on the calling thread.
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.column import DictionaryColumn

__all__ = ["tensor", "to_device", "to_host", "values", "host", "pool_map"]


def tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`: one copy, writable, never a
    view of `a`."""
    if device.type == "cpu":
        return torch.from_numpy(np.array(a, order="C"))
    with warnings.catch_warnings():       # read-only: copied just below
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_device(x, device: torch.device):
    """`x` (a tensor, column or table) with its host tensors on `device`
    (see the module's docstring); tensors elsewhere stay."""
    if device.type != "cuda":
        return _move(x, lambda t: t.to(device))

    def copy(t):
        if t.device.type != "cpu":
            return t
        return t.pin_memory().to(device, non_blocking=True)
    return _move(x, copy)


def _move(x, copy):
    def move(t):
        if isinstance(t, DictionaryColumn):
            return DictionaryColumn(
                copy(t.codes), _move(t.values, copy),
                None if t.validity is None else copy(t.validity),
                _canonical=True, ordered=bool(t.dtype.ordered))
        return copy(t) if isinstance(t, torch.Tensor) else t
    return pytree.tree_map(move, x, is_leaf=_is_dict)


def _is_dict(t) -> bool:
    return isinstance(t, DictionaryColumn)


def _tensors(x):
    """Every tensor of `x`, a dictionary's values included."""
    for leaf in pytree.tree_leaves(x, is_leaf=_is_dict):
        if _is_dict(leaf):
            yield leaf.codes
            if leaf.validity is not None:
                yield leaf.validity
            yield from _tensors(leaf.values)
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def to_host(x, site: Optional[str] = None):
    """`x` (a column or table) with every tensor on the CPU; with `site`,
    each buffer is read through utils/trace.py::to_host, a `readback` of
    that site while spans record (as the query path's reads are, on the
    CPU too)."""
    if site is not None:
        from ..utils.trace import to_host as read
        return _move(x, lambda t: read(site, t))
    cpu = torch.device("cpu")
    on_host = all(t.device == cpu for t in _tensors(x))
    return x if on_host else _move(x, lambda t: t.to(cpu))


def host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's storage as numpy (no copy)."""
    if t.device.type != "cpu":
        raise ValueError("the file layer reads host views: call to_host "
                         "first")
    return t.numpy()


def values(col) -> np.ndarray:
    """A host PrimitiveColumn's values in the logical numpy dtype."""
    return host(col.values).view(col.dtype.to_numpy())


def pool_map(fn, items) -> list:
    """fn over items on the file layer's thread pool (numpy, the native
    codecs and zstandard release the interpreter lock); the results in
    order."""
    items = list(items)
    env = os.environ.get("ARROW_TPU_PARQUET_THREADS", "")
    workers = min(int(env) if env else (os.cpu_count() or 4), len(items))
    if workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, items))
