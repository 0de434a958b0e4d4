"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for another device; with
no device given and no CUDA they raise rather than drop to the CPU.
"""
from __future__ import annotations

import torch

from .core.errors import KampingError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise KampingError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)
