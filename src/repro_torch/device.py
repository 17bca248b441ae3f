"""Device resolution for the port's entry points.

There is no fallback: an entry point asked for CUDA on a host without a
usable CUDA device raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` -> ``torch.device``; raises
    ``RuntimeError`` when CUDA is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or "
                         f"'cpu'")
    return dev
