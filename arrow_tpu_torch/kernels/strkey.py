"""K3: one sort key of every string row, the key of one pass of the
device dictionary encode (ops/strings.py).  The reference has no
counterpart: it interns strings on the host.

`strkey(offsets, data, k, rows)` gives n int64 keys, one of row `rows[i]`
(of row i without a row list): bytes [7k, 7k + 7) of the row, big-endian,
zero past its end, in bits 4-59, and in bits 0-3 how many of its bytes
from 7k on remain, 0 to 7, or 8 for more than 7 (`BYTES + 1`).  A sort of
the keys orders the rows by those bytes as unsigned, a row that ends in
them before a longer row with the same bytes; a key whose low bits are
under 8 ends its row.  Offsets are int32 or int64 (n + 1 of them), the
bytes uint8, the row list int64.

Routing is by device: CPU tensors take `strkey_plain`; CUDA tensors
launch the kernel in csrc/strkey.cu or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import on_cuda
from ..errors import ArrowInvalid
from . import native

__all__ = ["BYTES", "strkey", "strkey_plain"]

BYTES = 7                           # bytes of a row a key holds


def _check_args(offsets: torch.Tensor, data: torch.Tensor, k: int,
                rows: Optional[torch.Tensor]) -> None:
    if offsets.dim() != 1 or offsets.dtype not in (torch.int32, torch.int64) \
            or not offsets.is_contiguous() or offsets.shape[0] < 1:
        raise ArrowInvalid("strkey: offsets must be a contiguous 1-D int32 "
                           "or int64 tensor of n + 1 entries")
    if data.dim() != 1 or data.dtype != torch.uint8 \
            or not data.is_contiguous():
        raise ArrowInvalid("strkey: data must be a contiguous 1-D uint8 "
                           "tensor")
    if rows is not None and (rows.dim() != 1 or rows.dtype != torch.int64
                             or not rows.is_contiguous()):
        raise ArrowInvalid("strkey: rows must be a contiguous 1-D int64 "
                           "tensor")
    for t in (data,) + (() if rows is None else (rows,)):
        if t.device != offsets.device:
            raise ArrowInvalid(f"strkey: tensors on {t.device} and "
                               f"{offsets.device}")
    if k < 0:
        raise ArrowInvalid(f"strkey: negative key {k}")


def strkey_plain(offsets: torch.Tensor, data: torch.Tensor, k: int,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain PyTorch version (same contract)."""
    offs = offsets.to(torch.int64)
    n = offs.shape[0] - 1
    idx = torch.arange(n, device=offs.device) if rows is None else rows
    start = offs[idx] + BYTES * k
    left = offs[idx + 1] - start
    last = max(data.shape[0] - 1, 0)
    acc = torch.zeros(idx.shape[0], dtype=torch.int64, device=offs.device)
    for b in range(BYTES):
        byte = data[(start + b).clamp(0, last)].to(torch.int64) \
            if data.numel() else torch.zeros_like(acc)
        acc = acc * 256 + torch.where(b < left, byte, 0)
    return acc * 16 + left.clamp(0, BYTES + 1)


def _launch(offsets: torch.Tensor, data: torch.Tensor, k: int,
            rows: Optional[torch.Tensor]) -> torch.Tensor:
    lib = native.library().lib
    dev = offsets.device
    n = offsets.shape[0] - 1 if rows is None else rows.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=dev)
    status = lib.atp_strkey(
        dev.index, offsets.data_ptr(), offsets.element_size(),
        data.data_ptr(), n, k, 0 if rows is None else rows.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    strkey.launches += 1
    native.check(status, "strkey kernel")
    return out


def strkey(offsets: torch.Tensor, data: torch.Tensor, k: int,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Key `k` of every row (of `rows[i]` when given) as int64, in the
    order of the rows asked for; see the module's docstring."""
    _check_args(offsets, data, k, rows)
    if not on_cuda(offsets):
        return strkey_plain(offsets, data, k, rows)
    return _launch(offsets, data, int(k), rows)


strkey.launches = 0     # kernel launches; plain calls add nothing
