"""Pipeline fusion: one device program per query, not per op
(counterpart of arrow_tpu/fuse.py).

    from arrow_tpu_torch.fuse import fuse
    from arrow_tpu_torch.ops import cast, cmp

    @fuse
    def query(x, y):
        return cmp.lt(cast.cast(x, dt.float64), y)

    mask = query(x_col, y_col)

On the CPU `fuse(fn)` is `fn`.  On the card it captures `fn` into one
`torch.cuda.CUDAGraph` per input signature (the pytree structure of the
arguments, with each tensor's shape, dtype and device, and every other
argument by value): a warm-up run on a side stream, then the capture.
Each call copies its arguments into the graph's static inputs and
replays the graph, so the ops' launches cost one replay.  Columns,
Scalars and Tables are torch pytree nodes; a host tensor among the
arguments (a Scalar's value) gets a static copy on the card.

CUDA graphs take the place of the reference's `jax.jit`, under the same
rules (fuse.py:18-31):
  * shapes are static: one capture per input signature;
  * nothing inside may read device values on the host: filter, take
    with check_bounds, partition and cast(safe=False) raise a clear
    RuntimeError there (already in the warm-up run), and checked
    arithmetic behaves as wrapping;
  * a dictionary predicate's per-code table is built in the warm-up run
    and cached on the dictionary's values (ops/strings.py), which must
    be the same object in every call.
Each call returns fresh tensors (copies of the graph's outputs), as
`jax.jit` returns fresh arrays.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Tuple

import torch
from torch.utils import _pytree as pytree

from .config import fused_region

__all__ = ["fuse"]


def _signature(leaves: List[Any]) -> Tuple:
    return tuple((tuple(x.shape), x.dtype, x.device)
                 if isinstance(x, torch.Tensor) else ("value", x)
                 for x in leaves)


class _Captured:
    """One input signature's graph, its static inputs and outputs."""

    def __init__(self, fn: Callable, spec, leaves: List[Any],
                 device: torch.device):
        self.slots = [i for i, x in enumerate(leaves)
                      if isinstance(x, torch.Tensor)]
        self.inputs = list(leaves)
        for i in self.slots:
            self.inputs[i] = leaves[i].to(device, copy=True)
        args, kwargs = pytree.tree_unflatten(self.inputs, spec)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with fused_region():
            with torch.cuda.stream(side):
                fn(*args, **kwargs)              # warm-up: builds, caches
            torch.cuda.current_stream(device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*args, **kwargs)

    def __call__(self, leaves: List[Any]):
        for i in self.slots:
            self.inputs[i].copy_(leaves[i])
        self.graph.replay()
        return pytree.tree_map(
            lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
            self.outputs)


def fuse(fn: Callable = None, *, static_argnums=()):
    """Capture a column pipeline into a CUDA graph on the card; a plain
    call on the CPU.  Usable bare (`@fuse`) or parameterised
    (`@fuse(static_argnums=1)`: those positional arguments are passed to
    `fn` as they are and select a capture by value)."""
    if fn is None:
        return lambda f: fuse(f, static_argnums=static_argnums)
    static = {static_argnums} if isinstance(static_argnums, int) \
        else set(static_argnums)
    graphs = {}

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        traced = tuple(_Static(a) if i in static else a
                       for i, a in enumerate(args))
        leaves, spec = pytree.tree_flatten((traced, kwargs))
        devices = {x.device for x in leaves if isinstance(x, torch.Tensor)}
        cuda = [d for d in devices if d.type == "cuda"]
        if not cuda:
            return fn(*args, **kwargs)
        if len(cuda) > 1:
            raise ValueError(f"fuse: arguments on several cards: {cuda}")
        key = (spec, _signature(leaves))
        captured = graphs.get(key)
        if captured is None:
            captured = graphs[key] = _Captured(
                lambda *a, **k: fn(*_unwrap(a), **k), spec, leaves, cuda[0])
        return captured(leaves)

    wrapper.graphs = graphs
    return wrapper


class _Static:
    """A static argument: a pytree leaf compared by value."""

    def __init__(self, value):
        self.value = value

    def __eq__(self, other):
        return isinstance(other, _Static) and self.value == other.value

    def __hash__(self):
        return hash(self.value)


def _unwrap(args):
    return tuple(a.value if isinstance(a, _Static) else a for a in args)
