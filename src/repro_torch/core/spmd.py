"""Emulated ranks: the PyTorch counterpart of a JAX named vmap axis.

One card has no peers, so ranks are emulated as in the JAX package's CPU
path (DESIGN.md §6): a per-rank body runs under :func:`torch.func.vmap`
over a stacked ``(p, ...)`` rank dimension.  JAX names that dimension
(``jax.vmap(f, axis_name="x")``) and its collectives find it by name;
``torch.func.vmap`` has no names, so :func:`spmd` binds one while the body
runs.  A binding records the axis size, the per-rank index (a batched
scalar, what ``lax.axis_index`` returns) and the functorch level of the
vmap, so a collective can check that the rank dimension it is about to
reduce over is the innermost one.

:func:`~repro_torch.core.shard.shard_map` binds a name per rank thread
instead (:func:`bind_rank`): the index is this rank's own 0-d tensor, no
vmap level is recorded, and ``ranks`` is the rank's side of the host
rendezvous the per-device collectives meet at.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from .errors import KampingError

__all__ = ["spmd", "bound_axis", "bind_rank", "rank_tensor"]


@dataclasses.dataclass(frozen=True)
class _Axis:
    name: str
    size: int
    index: torch.Tensor  # per-rank index (0-d int64 per rank)
    level: Optional[int]  # vmap level; None for a per-device rank
    ranks: Any = None  # shard.Rank of a per-device rank, else None


_BOUND: contextvars.ContextVar[Tuple[_Axis, ...]] = contextvars.ContextVar(
    "repro_torch_spmd_axes", default=()
)


def _innermost_vmap_level():
    """Level of the innermost active vmap (grad levels in between do not
    move the rank dimension), or None outside any vmap."""
    from torch._C._functorch import TransformType, get_interpreter_stack

    for interp in reversed(get_interpreter_stack() or []):
        if interp.key() == TransformType.Vmap:
            return interp.level()
    return None


def spmd(fn: Callable, *args, axis_name: str = "x"):
    """Run ``fn`` as one program per rank over the leading dimension of
    every argument (each must have the same leading size ``p``).

    Inside ``fn``, ``Communicator(axis_name)`` collectives exchange data
    between the ``p`` emulated ranks; results come back stacked
    ``(p, ...)``.  The counterpart of ``jax.vmap(fn, axis_name=...)``.
    """
    sizes = {int(a.shape[0]) for a in args}
    if len(sizes) != 1:
        raise KampingError(
            f"spmd({axis_name!r}): every argument needs the same leading "
            f"rank dimension; got sizes {sorted(sizes)}"
        )
    p = sizes.pop()
    device = args[0].device
    others = sorted({str(a.device) for a in args if a.device != device})
    if others:
        raise KampingError(
            f"spmd({axis_name!r}): every argument must be on the device of "
            f"the first, {device}; got arguments on {others}"
        )

    def body(idx, *a):
        ax = _Axis(axis_name, p, idx, _innermost_vmap_level())
        token = _BOUND.set(_BOUND.get() + (ax,))
        try:
            return fn(*a)
        finally:
            _BOUND.reset(token)

    return torch.func.vmap(body)(torch.arange(p, device=device), *args)


@contextlib.contextmanager
def bind_rank(name: str, rank, index: torch.Tensor):
    """Bind ``name`` to one per-device rank (``rank``, a
    :class:`~repro_torch.core.shard.Rank`) while the block runs."""
    token = _BOUND.set(_BOUND.get() + (_Axis(name, rank.size, index, None,
                                             rank),))
    try:
        yield
    finally:
        _BOUND.reset(token)


def bound_axis(name) -> _Axis:
    """The binding of ``name``; raises unless ``name`` is the innermost
    vmap level at the call (a collective must see its own rank dim)."""
    for ax in reversed(_BOUND.get()):
        if ax.name == name:
            if _innermost_vmap_level() != ax.level:
                raise KampingError(
                    f"collective over axis {name!r} called inside a nested "
                    "vmap: the rank dimension must be the innermost vmap "
                    "level at the call"
                )
            return ax
    raise KampingError(
        f"unbound axis name {name!r}: collectives run inside "
        "repro_torch.core.spmd or repro_torch.core.shard_map(fn, ..., "
        "axis_name=...)"
    )


def rank_tensor(x, device, what, dtype=None):
    """``x`` as a tensor on ``device``, the device the ranks run on.

    A value that is not a tensor yet (a Python scalar, a list, a NumPy
    array) is put there.  A tensor on another device raises: copying it
    would quietly move ``what``'s work off the ranks' device (a CUDA
    payload reduced on the host, say)."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=dtype, device=device)
    if x.device != device:
        raise KampingError(
            f"{what}: tensor on {x.device}, but the ranks run on {device}; "
            f"move it there before the call"
        )
    return x if dtype is None else x.to(dtype)
