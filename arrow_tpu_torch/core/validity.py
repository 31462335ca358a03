"""Validity-mask algebra (counterpart of arrow_tpu/core/validity.py).

A mask is a dense torch.bool tensor on the column's device, or None for
"all valid" (the reference's elided null buffer).  Bit-packing would
only add unpack traffic to every consuming kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.trace import to_host

Mask = Optional[torch.Tensor]  # dense bool tensor or None (= all valid)


def union(a: Mask, b: Mask) -> Mask:
    """Validity of a binary kernel's output: valid iff both inputs valid
    (NullBuffer::union, arrow-buffer/src/buffer/null.rs:78)."""
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


def intersect_all(*masks: Mask) -> Mask:
    """Validity of an n-ary kernel's output: valid where every input is."""
    out: Mask = None
    for m in masks:
        out = union(out, m)
    return out


def null_count(mask: Mask, length: int) -> int:
    """Number of null slots (syncs one scalar)."""
    if mask is None:
        return 0
    return length - int(to_host("validity.null_count", mask.sum()))


def is_all_valid_host(mask: Mask) -> bool:
    """Whether every slot is valid: reads the mask on the host (a sync);
    for eager callers only (arrow_tpu/core/validity.py:52)."""
    return mask is None or bool(to_host("validity.all", mask.all()))


def valid_count(mask: Mask, length: int):
    """Number of valid slots: `length` when there is no mask, else a 0-d
    int64 tensor on the mask's device (no sync)."""
    if mask is None:
        return length
    return mask.sum(dtype=torch.int64)


# torch's uint16/32/64 lack `where` in some releases: select their bits
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}


def canonicalize(values: torch.Tensor, mask: Mask) -> torch.Tensor:
    """Zero values under null slots, so (values, validity) pairs are
    bitwise-deterministic (arrow_tpu/core/validity.py:57)."""
    if mask is None:
        return values
    signed = _SIGNED.get(values.dtype)
    if signed is not None:
        return canonicalize(values.view(signed), mask).view(values.dtype)
    return torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                                 device=values.device))


def make_mask(length: int, mask: Mask, device) -> torch.Tensor:
    """Materialize an explicit mask (all-True when None)."""
    if mask is None:
        return torch.ones((length,), dtype=torch.bool, device=device)
    return mask
