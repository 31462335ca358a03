"""K1: order-preserving stream compaction (counterpart of
arrow_tpu/kernels/compact.py: `_compact_impl`, `compact_planes`,
`compact_mask_arrays`).

`compact(keep, arrays, out_cap)` packs the kept rows of every array to
the front, in their original order, and returns the kept count as an
int64 tensor on the device.  All arrays of a batch ride one launch
sequence at their native widths (1, 2, 4 or 8 bytes: bool, f16 and f64
included) -- the reference's u32 limb planes, its 6-plane threshold and
its f64/f16 exclusion were TPU limits.

Outputs have `out_cap` rows (n when None); rows at or past the count are
unspecified.  `out_cap` is a proven upper bound on the count that
shrinks the outputs, as in the reference (compact.py:173-181); a cap
below the true count raises and never writes out of bounds.

Routing is by device: CPU tensors take `compact_plain` (a stable
partition: `keep.nonzero()` then index); CUDA tensors launch the kernel
in csrc/compact.cu or raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..config import on_cuda
from ..errors import ArrowInvalid
from . import native

__all__ = ["compact", "compact_plain"]


def _check_args(keep: torch.Tensor, arrays: Sequence[torch.Tensor]) -> None:
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


def compact_plain(keep: torch.Tensor, arrays: Sequence[torch.Tensor],
                  cap: int) -> Tuple[List[torch.Tensor], torch.Tensor]:
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
    return outs, torch.tensor(count, dtype=torch.int64, device=keep.device)


def _launch(keep: torch.Tensor, arrays: Sequence[torch.Tensor], cap: int
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    lib = native.library().lib
    if len(arrays) > lib.atp_compact_max_cols():
        raise ArrowInvalid(f"compact: at most {lib.atp_compact_max_cols()} "
                           f"arrays per launch, got {len(arrays)}")
    dev = keep.device
    n = keep.shape[0]
    ntiles = max(1, -(-n // lib.atp_compact_tile_rows()))
    outs = [torch.empty(cap, dtype=a.dtype, device=dev) for a in arrays]
    desc = torch.tensor([[a.data_ptr(), o.data_ptr(), a.element_size()]
                         for a, o in zip(arrays, outs)] or [[0, 0, 0]],
                        dtype=torch.int64).to(dev)
    scratch = torch.empty(2 * ntiles + 1, dtype=torch.int64, device=dev)
    count = scratch[2 * ntiles]
    status = lib.atp_compact(
        dev.index, keep.data_ptr(), n, desc.data_ptr(), len(arrays), cap,
        scratch.data_ptr(), scratch[ntiles:].data_ptr(), count.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    compact.launches += 1
    native.check(status, "compact kernel")
    return outs, count


def compact(keep: torch.Tensor, arrays: Sequence[torch.Tensor],
            out_cap: Optional[int] = None
            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pack the rows where `keep` of every array to the front, in order.

    Returns (outputs of `out_cap` rows -- n when None -- whose rows at or
    past the count are unspecified, kept count as a 0-d int64 tensor).
    Given an `out_cap`, the count is synced and checked against it.
    """
    arrays = tuple(arrays)
    _check_args(keep, arrays)
    cap = keep.shape[0] if out_cap is None else int(out_cap)
    if cap < 0:
        raise ArrowInvalid(f"compact: negative out_cap {cap}")
    if not on_cuda(keep):
        return compact_plain(keep, arrays, cap)
    outs, count = _launch(keep, arrays, cap)
    if out_cap is not None and int(count) > cap:
        raise ArrowInvalid(f"compact: {int(count)} kept rows exceed "
                           f"out_cap {cap}")
    return outs, count


compact.launches = 0     # kernel launch sequences; plain calls add nothing
