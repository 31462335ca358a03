"""K3: the ranking of a string column in byte order by sort refinement,
the loop of the device dictionary encode (ops/strings.py).  The
reference has no counterpart: it interns strings on the host.

`strrank(offsets, data, passes)` gives (at, passes run, drops made):
`at[r]` is row r's sorted position, the number of rows whose bytes sort
before its own, so equal rows share it; int32 below 2^31 rows, int64
from there.  `passes` is the longest row's bytes over `BYTES`, rounded
up.  Every row starts in one group.  Pass k orders the rows of each
group by their key k and splits the group where the key differs: key k
of a row (`strkey_plain`) holds bytes [7k, 7k + 7) of the row,
big-endian, zero past its end, in bits 4-59, and in bits 0-3 how many of
its bytes from 7k on remain, 0 to 7, or 8 for more than 7 (`BYTES + 1`),
so a sort of the keys orders the rows by those bytes as unsigned, a row
that ends in them before a longer row with the same bytes ("ab" before
"ab\\0").  A row is finished once its group is itself alone, or once its
key says its bytes ended (its group then holds only copies of it).
After passes 1, 2, 4, 8, ... each row is given its group's sorted
position and the finished rows are dropped from later passes (a drop),
while at least as many passes remain as have run: the work follows the
bytes that still tell rows apart, within a few times, not n times the
longest row, and a column whose rows all finish early stops early (the
passes run may be fewer than `passes`).  Offsets are int32 or int64 (n
+ 1 of them), the bytes uint8.

Routing is by device: CPU tensors take `strrank_plain`, the loop in
PyTorch; CUDA tensors make one call into csrc/strkey.cu, which runs
every pass and drop on the current stream (its scratch from the caching
allocator, the rows left after each drop read through pinned host
words) and makes no torch op a pass, or raise.  Where a drop finds every
group left at 64 rows or fewer, its later passes sort each group in one
thread instead of sorting the whole list: the same positions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..config import on_cuda
from ..errors import ArrowInvalid
from ..utils import trace
from . import native

__all__ = ["BYTES", "strkey_plain", "strrank", "strrank_plain"]

BYTES = 7                           # bytes of a row a key holds


def _check_args(offsets: torch.Tensor, data: torch.Tensor,
                passes: int) -> None:
    if offsets.dim() != 1 or offsets.dtype not in (torch.int32, torch.int64) \
            or not offsets.is_contiguous() or offsets.shape[0] < 1:
        raise ArrowInvalid("strrank: offsets must be a contiguous 1-D int32 "
                           "or int64 tensor of n + 1 entries")
    if data.dim() != 1 or data.dtype != torch.uint8 \
            or not data.is_contiguous():
        raise ArrowInvalid("strrank: data must be a contiguous 1-D uint8 "
                           "tensor")
    if data.device != offsets.device:
        raise ArrowInvalid(f"strrank: tensors on {data.device} and "
                           f"{offsets.device}")
    if passes < 0:
        raise ArrowInvalid(f"strrank: negative passes {passes}")


def strkey_plain(offsets: torch.Tensor, data: torch.Tensor, k: int,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Key `k` of every row (of `rows[i]` when given, int64) as int64, in
    the order of the rows asked for; see the module's docstring."""
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


def strrank_plain(offsets: torch.Tensor, data: torch.Tensor, passes: int
                  ) -> Tuple[torch.Tensor, int, int]:
    """The routine's plain PyTorch version (same contract), on any
    device."""
    n, dev = offsets.shape[0] - 1, offsets.device
    at = torch.zeros(n, dtype=_index_type(n), device=dev)
    # the rows still refined (None: every row), grouped; their group ids,
    # ascending; the rows finished before each one's group (None: none)
    rows = group = before = None
    done = drops = 0
    for k in range(passes):
        rows, group, step, key = _refine(rows, group,
                                         strkey_plain(offsets, data, k, rows))
        done = k + 1
        # drop finished rows after passes 1, 2, 4, ... while at least as
        # many passes remain
        drop = not done & (done - 1) and 2 * done <= passes
        if done < passes and not drop:
            continue
        place = _first_index(group)
        if before is not None:
            place += before
        at[rows] = place
        if not drop:
            break
        drops += 1
        alone = step.clone()
        alone[:-1] &= step[1:]
        keep = ~(alone | ((key & 15) <= BYTES))
        rows, group, place = rows[keep], group[keep], place[keep]
        if rows.shape[0] == 0:
            break
        before = place - _first_index(group)
    return at, done, drops


def _index_type(n: int) -> torch.dtype:
    return torch.int32 if n < 2 ** 31 else torch.int64


def _refine(rows: Optional[torch.Tensor], group: Optional[torch.Tensor],
            key: torch.Tensor):
    """One pass of `strrank_plain`: `rows` (None: every row, in one
    group), grouped by their ascending `group` ids, ordered within each
    group by `key` (a stable sort by the key, then a stable sort by the
    group, which leaves each group where it was).  Returns the rows in
    that order, their new group ids (ascending), where a new group
    starts, and the sorted keys."""
    key, order = torch.sort(key, stable=True)
    step = torch.ones_like(key, dtype=torch.bool)
    if rows is None:                 # one group: the order is the key's
        rows = order
        step[1:] = key[1:] != key[:-1]
        itype = _index_type(key.shape[0])
    else:
        group, by = torch.sort(group[order], stable=True)
        key, rows = key[by], rows[order[by]]
        step[1:] = (key[1:] != key[:-1]) | (group[1:] != group[:-1])
        itype = group.dtype
    return rows, torch.cumsum(step, 0, dtype=itype), step, key


def _first_index(group: torch.Tensor) -> torch.Tensor:
    """For each entry of an ascending tensor, the index of the first
    entry equal to it."""
    return torch.searchsorted(group, group,
                              out_int32=group.dtype == torch.int32)


def _launch(offsets: torch.Tensor, data: torch.Tensor, passes: int
            ) -> Tuple[torch.Tensor, int, int]:
    lib = native.library().lib
    dev = offsets.device
    n = offsets.shape[0] - 1
    size = ctypes.c_longlong()
    native.check(lib.atp_strrank_scratch(dev.index, n,
                                         ctypes.addressof(size)),
                 "strrank scratch")
    at = torch.empty(n, dtype=_index_type(n), device=dev)
    scratch = torch.empty(size.value, dtype=torch.uint8, device=dev)
    left = torch.empty(2, dtype=torch.int64, pin_memory=True)
    out = (ctypes.c_longlong * 2)()
    status = lib.atp_strrank(
        dev.index, offsets.data_ptr(), offsets.element_size(),
        data.data_ptr(), n, passes, at.data_ptr(), scratch.data_ptr(),
        size.value, left.data_ptr(), ctypes.addressof(out),
        torch.cuda.current_stream(dev).cuda_stream)
    strrank.launches += 1
    native.check(status, "strrank")
    trace.count("strings.native_passes", out[0])
    return at, out[0], out[1]


def strrank(offsets: torch.Tensor, data: torch.Tensor, passes: int
            ) -> Tuple[torch.Tensor, int, int]:
    """(each row's sorted position, the passes run, the drops made); see
    the module's docstring."""
    _check_args(offsets, data, passes)
    if not on_cuda(offsets):
        return strrank_plain(offsets, data, passes)
    return _launch(offsets, data, int(passes))


strrank.launches = 0    # native calls; plain calls add nothing
