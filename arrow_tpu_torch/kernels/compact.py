"""K1: order-preserving stream compaction (counterpart of
arrow_tpu/kernels/compact.py: `_compact_impl`, `compact_planes`,
`compact_mask_arrays`).

`compact(keep, arrays, out_cap, positions)` packs the kept rows of every
array to the front, in their original order, and returns the kept count
as an int64 tensor on the device.  All arrays of a batch ride one launch
at their native widths (1, 2, 4 or 8 bytes: bool, f16 and f64 included)
-- the reference's u32 limb planes, its 6-plane threshold and its
f64/f16 exclusion were TPU limits.  With `positions` (torch.int32 or
torch.int64) the kept rows' indices come out as one more output,
computed by the kernel: the reference compacts an iota for that.

Outputs have `out_cap` rows (n when None); rows at or past the count are
unspecified.  `out_cap` is a proven upper bound on the count that
shrinks the outputs, as in the reference (compact.py:173-181); a cap
below the true count raises and never writes out of bounds.

Routing is by device: CPU tensors take `compact_plain` (a stable
partition: `keep.nonzero()` then index); CUDA tensors launch the kernel
in csrc/compact.cu or raise.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..config import on_cuda
from ..errors import ArrowInvalid
from ..utils.trace import span, to_host
from . import native

__all__ = ["compact", "compact_plain"]

_POSITION_DTYPES = (torch.int32, torch.int64)


def _check_args(keep: torch.Tensor, arrays: Sequence[torch.Tensor],
                positions: Optional[torch.dtype]) -> None:
    if keep.dim() != 1 or keep.dtype != torch.bool \
            or not keep.is_contiguous():
        raise ArrowInvalid("keep must be a contiguous 1-D bool tensor")
    n = keep.shape[0]
    for a in arrays:
        if a.dim() != 1 or a.shape[0] != n:
            raise ArrowInvalid(f"compact: array of shape {tuple(a.shape)} "
                               f"does not match keep ({n},)")
        if a.device != keep.device:
            raise ArrowInvalid(f"compact: array on {a.device}, keep on "
                               f"{keep.device}")
        if not a.is_contiguous() or a.element_size() not in (1, 2, 4, 8):
            raise ArrowInvalid("compact: arrays must be contiguous with "
                               "1, 2, 4 or 8-byte elements")
    if positions is not None and positions not in _POSITION_DTYPES:
        raise ArrowInvalid(f"compact: positions must be torch.int32 or "
                           f"torch.int64, got {positions}")
    if positions == torch.int32 and n > 2 ** 31:
        raise ArrowInvalid(f"compact: int32 positions of {n} rows")


def compact_plain(keep: torch.Tensor, arrays: Sequence[torch.Tensor],
                  cap: int, positions: Optional[torch.dtype] = None
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The kernel's plain PyTorch version (same contract)."""
    idx = keep.nonzero().squeeze(1)
    count = idx.numel()
    if count > cap:
        raise ArrowInvalid(f"compact: {count} kept rows exceed out_cap {cap}")
    outs = []
    for a in arrays:
        out = torch.empty(cap, dtype=a.dtype, device=a.device)
        out[:count] = a[idx]
        outs.append(out)
    if positions is not None:
        out = torch.empty(cap, dtype=positions, device=keep.device)
        out[:count] = idx
        outs.append(out)
    return outs, torch.tensor(count, dtype=torch.int64, device=keep.device)


def _launch(keep: torch.Tensor, arrays: Sequence[torch.Tensor], cap: int,
            positions: Optional[torch.dtype]
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    lib = native.library().lib
    if len(arrays) > lib.atp_compact_max_cols():
        raise ArrowInvalid(f"compact: at most {lib.atp_compact_max_cols()} "
                           f"arrays per launch, got {len(arrays)}")
    dev = keep.device
    n = keep.shape[0]
    ntiles = -(-n // lib.atp_compact_tile_rows())
    outs = [torch.empty(cap, dtype=a.dtype, device=dev) for a in arrays]
    pos = None if positions is None else \
        torch.empty(cap, dtype=positions, device=dev)
    # read by the C entry before it returns: host memory, no upload
    desc = (ctypes.c_longlong * max(3 * len(arrays), 1))(
        *[v for a, o in zip(arrays, outs)
          for v in (a.data_ptr(), o.data_ptr(), a.element_size())])
    scratch = torch.empty(ntiles + 2, dtype=torch.int64, device=dev)
    status = lib.atp_compact(
        dev.index, keep.data_ptr(), n, desc, len(arrays), cap,
        0 if pos is None else pos.data_ptr(),
        0 if pos is None else pos.element_size(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    compact.launches += 1
    native.check(status, "compact kernel")
    return outs + ([] if pos is None else [pos]), scratch[ntiles + 1]


def compact(keep: torch.Tensor, arrays: Sequence[torch.Tensor],
            out_cap: Optional[int] = None,
            positions: Optional[torch.dtype] = None
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pack the rows where `keep` of every array to the front, in order.

    Returns (outputs of `out_cap` rows -- n when None -- whose rows at or
    past the count are unspecified, kept count as a 0-d int64 tensor).
    With `positions` (torch.int32 or torch.int64), the last output holds
    the kept rows' indices in that type, as `keep.nonzero()` gives them.
    Given an `out_cap`, the count is synced and checked against it.
    """
    arrays = tuple(arrays)
    _check_args(keep, arrays, positions)
    cap = keep.shape[0] if out_cap is None else int(out_cap)
    if cap < 0:
        raise ArrowInvalid(f"compact: negative out_cap {cap}")
    with span("kernel.k1", rows=keep.shape[0]):
        if not on_cuda(keep):
            return compact_plain(keep, arrays, cap, positions)
        outs, count = _launch(keep, arrays, cap, positions)
        if out_cap is not None:
            kept = int(to_host("compact(out_cap=...)", count, guard=True))
            if kept > cap:
                raise ArrowInvalid(f"compact: {kept} kept rows exceed "
                                   f"out_cap {cap}")
        return outs, count


compact.launches = 0     # kernel launches; plain calls add nothing
