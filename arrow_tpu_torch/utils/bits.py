"""u64 bit helpers on int64 storage (torch's uint64 has no `>>`), shared
by the hash join, the shuffle's partitioner and string equality."""

from __future__ import annotations

import torch

__all__ = ["lsr", "mix64"]

_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)      # splitmix64's multipliers,
_M2 = 0x94D049BB133111EB - (1 << 64)      # as int64


def lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical shift right of u64 bits on int64 storage."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser; multiply and xor wrap the same on int64 as
    on u64."""
    x = (x ^ lsr(x, 30)) * _M1
    x = (x ^ lsr(x, 27)) * _M2
    return x ^ lsr(x, 31)
