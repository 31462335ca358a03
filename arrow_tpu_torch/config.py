"""Device helpers for the PyTorch port.

Counterpart of arrow_tpu/config.py.  Two things of the reference do not
carry over: the x64 switch (torch has native 64-bit types) and the
`use_pallas()` auto-routing.  Routing here is by tensor device only: a
tensor on the CPU takes a kernel's plain PyTorch version, a CUDA tensor
takes the hand-written kernel.  There is no global device detection and
no switch that sends CUDA tensors to the plain version.
"""

from __future__ import annotations

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
