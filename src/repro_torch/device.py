"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU by name.
A CUDA request on a machine without a usable GPU raises; nothing falls
back to the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and
    no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' explicitly to run on the CPU")
    return dev
