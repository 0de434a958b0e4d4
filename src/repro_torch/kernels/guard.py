"""The CUDA route of the kernel wrappers has no backward yet (ROADMAP A2).

Each wrapper fills its output through ctypes, outside autograd, so on a
CUDA input that requires grad its result would carry no ``grad_fn`` and
cut the graph without a word.  :func:`refuse_grad` makes that an error
instead.  The CPU route (the plain versions) stays differentiable.
"""
from __future__ import annotations

import torch

from ..core.errors import KampingError

__all__ = ["refuse_grad"]


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise :class:`KampingError` when grad mode is on and any of
    ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KampingError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP A2), so "
            "its result would be cut from the autograd graph; an input "
            "requires grad. Call it under torch.no_grad() or on CPU tensors."
        )
