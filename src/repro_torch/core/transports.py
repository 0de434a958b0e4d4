"""Transport registry: interchangeable collective backends (DESIGN.md §7).

A :class:`Transport` supplies the data-movement primitives the op-spec
lowerings are written against.  The engine resolves it per call:
``transport("name")`` parameter > communicator default > ``"native"``.

Backends ported so far:

* ``native`` (alias ``xla``, so the JAX package's call sites and test
  parametrizations port verbatim) — torch ops over the stacked rank
  dimension.  Each primitive is a :class:`torch.autograd.Function` whose
  ``vmap`` staticmethod sees the whole ``(p, ...)`` tensor of the emulated
  ranks (:mod:`repro_torch.core.spmd`) and computes every rank's result
  from it.  Reductions fold in rank order, so sums match the NumPy oracle
  bit for bit.

The ring backend (``ring``, alias ``pallas``) rides on the ring kernels
and comes with slice 2 (ROADMAP A1, kernels B1-B3); naming it raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from .errors import KampingError
from .spmd import bound_axis

__all__ = [
    "Transport",
    "NativeTransport",
    "register_transport",
    "get_transport",
    "available_transports",
    "resolve_transport",
]

_FOLDS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}

_UNPORTED = {
    "ring": "the ring transport (ring kernels B1-B3) is not ported yet: "
            "ROADMAP A1, slice 2",
}
_UNPORTED["pallas"] = _UNPORTED["ring"]


def _stacked(info, in_dim, x):
    """The rank-stacked ``(p, ...)`` view of ``x`` at this vmap level."""
    if in_dim is None:  # same value on every rank
        return x.unsqueeze(0).expand((info.batch_size,) + tuple(x.shape))
    return x.movedim(in_dim, 0)


def _group_rows(X, members):
    """(p, g, ...) rows of each rank's group; ``members`` is the static
    (p, g) member table, or None for the flat communicator."""
    if members is None:
        p = X.shape[0]
        return X.unsqueeze(0).expand((p,) + tuple(X.shape))
    idx = torch.as_tensor(members, device=X.device)
    return X[idx]


class _StackedReduce(torch.autograd.Function):
    """allreduce over the rank dimension: left fold in group-rank order."""

    @staticmethod
    def forward(x, kind, members):
        raise KampingError("collective called outside an spmd region")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.kind, ctx.members = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        if ctx.kind != "sum":
            raise NotImplementedError(
                f"gradient of a {ctx.kind} allreduce is not ported yet "
                "(ROADMAP A2, slice 2)"
            )
        return _StackedReduce.apply(g, "sum", ctx.members), None, None

    @staticmethod
    def vmap(info, in_dims, x, kind, members):
        X = _stacked(info, in_dims[0], x)
        fn = _FOLDS[kind]
        if members is None:
            acc = X[0]
            for j in range(1, X.shape[0]):
                acc = fn(acc, X[j])
            return acc.unsqueeze(0).expand_as(X).contiguous(), 0
        rows = _group_rows(X, members)
        acc = rows[:, 0]
        for j in range(1, rows.shape[1]):
            acc = fn(acc, rows[:, j])
        return acc, 0


class _StackedGather(torch.autograd.Function):
    """allgather over the rank dimension (group-scoped by ``members``)."""

    @staticmethod
    def forward(x, tiled, members):
        raise KampingError("collective called outside an spmd region")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "gradient of allgather is not ported yet (ROADMAP A2, slice 2)"
        )

    @staticmethod
    def vmap(info, in_dims, x, tiled, members):
        X = _stacked(info, in_dims[0], x)
        rows = _group_rows(X, members)  # (p, g, ...)
        if tiled:
            rows = rows.reshape(
                (rows.shape[0], rows.shape[1] * rows.shape[2])
                + tuple(rows.shape[3:])
            )
        return rows.contiguous(), 0


class Transport:
    """Abstract collective backend.  Every primitive takes the
    communicator first and honours its group scope (``comm.groups``)."""

    name: str = "abstract"

    def all_gather(self, comm, x, *, tiled: bool = True):
        raise NotImplementedError

    def allreduce_sum(self, comm, x):
        raise NotImplementedError

    def allreduce_max(self, comm, x):
        raise NotImplementedError

    def allreduce_min(self, comm, x):
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"<transport {self.name}>"


class NativeTransport(Transport):
    """Torch ops over the stacked rank dimension (see module docstring)."""

    name = "native"

    @staticmethod
    def _members(comm):
        bound_axis(comm.axis)
        if comm.groups is None:
            return None
        return tuple(tuple(int(v) for v in row)
                     for row in comm._group_tables().members)

    def all_gather(self, comm, x, *, tiled: bool = True):
        return _StackedGather.apply(x, bool(tiled), self._members(comm))

    def allreduce_sum(self, comm, x):
        return _StackedReduce.apply(x, "sum", self._members(comm))

    def allreduce_max(self, comm, x):
        return _StackedReduce.apply(x, "max", self._members(comm))

    def allreduce_min(self, comm, x):
        return _StackedReduce.apply(x, "min", self._members(comm))


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_TRANSPORTS: Dict[str, Transport] = {}


def register_transport(transport: Transport, *, name: Optional[str] = None):
    """Register a backend; its name becomes valid everywhere the
    ``transport(...)`` parameter is accepted (paper §III-F)."""
    name = name or transport.name
    existing = _TRANSPORTS.get(name)
    if existing is not None and existing is not transport:
        raise KampingError(f"transport '{name}' already registered")
    _TRANSPORTS[name] = transport
    return transport


def available_transports():
    return tuple(sorted(_TRANSPORTS))


def get_transport(name: Union[str, Transport]) -> Transport:
    """Lookup with a readable diagnostic (paper §III-G)."""
    if isinstance(name, Transport):
        return name
    if name in _UNPORTED:
        raise NotImplementedError(f"transport {name!r}: {_UNPORTED[name]}")
    t = _TRANSPORTS.get(name)
    if t is None:
        raise KampingError(
            f"unknown transport {name!r}; registered transports: "
            f"{', '.join(available_transports())}"
        )
    return t


def resolve_transport(comm, override=None) -> Transport:
    """Per-call resolution: explicit parameter > communicator default >
    ``native``."""
    default = getattr(comm, "transport_name", None)
    name = override if override is not None else (
        default if default is not None else "native"
    )
    return get_transport(name)


_NATIVE = register_transport(NativeTransport())
register_transport(_NATIVE, name="xla")
