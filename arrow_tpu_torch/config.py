"""Device helpers for the PyTorch port.

Counterpart of arrow_tpu/config.py.  Two things of the reference do not
carry over: the x64 switch (torch has native 64-bit types) and the
`use_pallas()` auto-routing.  Routing here is by tensor device only: a
tensor on the CPU takes a kernel's plain PyTorch version, a CUDA tensor
takes the hand-written kernel.  There is no global device detection and
no switch that sends CUDA tensors to the plain version.

`fused_region` and `in_fused_region` carry `fuse`'s rules (fuse.py)
down to the ops: inside a fused pipeline checked ops do not sync, and an
op that must read a device value on the host raises (the guarded reads
of utils/trace.py::to_host).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """The torch.device a caller named.  There is no default: host data
    is placed where the caller says, and asking for a card that is not
    there raises."""
    if device is None:
        raise ValueError("an explicit device is required (e.g. 'cuda', 'cpu')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """Whether `t` takes the kernel route."""
    return t.device.type == "cuda"


_FUSED = threading.local()       # depth of `fuse`'s runs, per thread


@contextlib.contextmanager
def fused_region():
    """Mark the calls inside, on this thread, as a fused pipeline's
    (`fuse`'s warm-up and capture)."""
    _FUSED.depth = getattr(_FUSED, "depth", 0) + 1
    try:
        yield
    finally:
        _FUSED.depth -= 1


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def in_fused_region() -> bool:
    """Inside `fuse`'s warm-up run or its capture: checked ops skip
    their flag's sync, and ops that read device values on the host
    raise (`to_host(..., guard=True)`)."""
    return getattr(_FUSED, "depth", 0) > 0 or capturing()
