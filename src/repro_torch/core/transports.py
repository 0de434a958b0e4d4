"""Transport registry: interchangeable collective backends (DESIGN.md §7).

A :class:`Transport` supplies the four data-movement primitives the
op-spec lowerings are written against:

* ``all_gather``      — gather one chunk per rank,
* ``all_to_all``      — dense personalized exchange of (p, ...) buckets,
* ``reduce_scatter_sum`` / ``allreduce_sum`` — the sum reductions.

The engine resolves it per call: ``transport("name")`` parameter >
communicator default > ``"native"``.  Every primitive honours the
communicator's group scope (``comm.groups``).

Every primitive is one :class:`torch.autograd.Function` whose ``vmap``
staticmethod sees the whole ``(p, ...)`` tensor of the emulated ranks
(:mod:`repro_torch.core.spmd`) and computes every rank's result from it.
Under :func:`~repro_torch.core.shard.shard_map` (per-device ranks, one
thread each) a primitive has a per-device form instead: each rank
computes its own result from its own tensor and what the other ranks
share at a rendezvous.

Backends:

* ``native`` (alias ``xla``, so the JAX package's call sites and test
  parametrizations port verbatim) — torch ops over the stacked rank
  dimension.  Reductions fold in rank order, so sums match the NumPy
  oracle bit for bit.
* ``ring`` (alias ``pallas``) — the ring kernels of
  :mod:`repro_torch.kernels.collectives`: a CUDA tensor goes to the CUDA
  kernel, a CPU tensor to its plain version.  Reductions fold in the ring
  order (chunk r sums sources r+1, ..., r), so sums are bitwise equal to
  ``native`` whenever the payload sums exactly, and data movement always
  is.  A ``split_by(block=g)`` communicator's groups are contiguous, so
  the rule views ``(p, ...)`` as ``p/g`` independent rings of length
  ``g`` and runs one kernel over the batch.

Per-device forms:

* ``native`` — each rank posts its tensor (and, on CUDA, an event on its
  stream), its stream waits on the others' events, and it folds or picks
  its own result in rank order from every rank's tensor; then all ranks
  meet once more, so no rank overwrites a tensor another still reads.
  Results are bitwise equal to the emulated ranks'.
* ``ring`` — ``all_gather`` is B8a and ``reduce_scatter_sum`` B8b, the
  per-device ring kernels; ``allreduce_sum`` is B8b then B8a;
  ``all_to_all`` is native's per-device exchange (the JAX package has
  no per-device alltoall kernel either: its ``ref.ring_alltoall`` is a
  ``ppermute`` schedule with the same result).  Only flat
  communicators: the per-device ring is the ranks' own order, so a split
  communicator raises, as the JAX package's ``_check_device_groups``
  does.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from ..kernels.collectives import ops as ring_ops
from .errors import KampingError
from .spmd import bound_axis, rank_tensor

__all__ = [
    "Transport",
    "NativeTransport",
    "RingTransport",
    "register_transport",
    "get_transport",
    "available_transports",
    "resolve_transport",
]

_FOLDS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _stacked(info, in_dim, x):
    """The rank-stacked ``(p, ...)`` view of ``x`` at this vmap level."""
    if in_dim is None:  # same value on every rank
        return x.unsqueeze(0).expand((info.batch_size,) + tuple(x.shape))
    return x.movedim(in_dim, 0)


class _Primitive(torch.autograd.Function):
    """One collective over the stacked rank dimension: ``rule`` maps the
    ``(p, ...)`` stack of every rank's input to the ``(p, ...)`` stack of
    their results.

    ``index`` is the rank index of the bound axis, batched on every rank:
    it makes the ``vmap`` rule run even when ``x`` is the same on every
    rank (unbatched), which torch would otherwise hand to ``forward``.
    ``adjoint`` is the rule of the gradient, or the collective's name when
    its gradient is not ported yet.
    """

    @staticmethod
    def forward(x, index, rule, adjoint):
        raise KampingError("collective called outside an spmd region")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])
        ctx.adjoint = inputs[3]

    @staticmethod
    def backward(ctx, g):
        if not callable(ctx.adjoint):
            raise NotImplementedError(
                f"gradient of {ctx.adjoint} is not ported yet (ROADMAP A2, "
                "slice 2b)"
            )
        (index,) = ctx.saved_tensors
        return _Primitive.apply(g, index, ctx.adjoint, ctx.adjoint), None, \
            None, None

    @staticmethod
    def vmap(info, in_dims, x, index, rule, adjoint):
        return rule(_stacked(info, in_dims[0], x)), 0


class _Local(torch.autograd.Function):
    """One collective on one per-device rank: ``local(x, ranks)`` computes
    this rank's result, meeting the other ranks through ``ranks``."""

    @staticmethod
    def forward(x, ranks, local, name):
        return local(x, ranks)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name = inputs[3]

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            f"gradient of {ctx.name} on per-device ranks (shard_map) is not "
            "ported yet (ROADMAP A2)")


def _apply(comm, x, rule, name, adjoint=None, local=None):
    """Run ``rule`` over the stacked ranks of ``comm``'s bound axis, or
    ``local`` on this rank when the axis is bound to per-device ranks."""
    ax = bound_axis(comm.axis)
    x = rank_tensor(x, ax.index.device, name)
    if ax.ranks is not None:
        return _Local.apply(x, ax.ranks, local, name)
    return _Primitive.apply(x, ax.index, rule,
                            adjoint if adjoint is not None else name)


# --------------------------------------------------------------------------
# Static group tables of the stacked layout
# --------------------------------------------------------------------------
def _tables(comm):
    """The static group tables of a split communicator, None when flat."""
    return None if comm.groups is None else comm._group_tables()


def _gather_rows(X, tables):
    """(P, g, ...): row ``[w, j]`` is group-rank ``j``'s input of rank
    ``w``'s group."""
    if tables is None:
        return X.unsqueeze(0).expand((X.shape[0],) + tuple(X.shape))
    return X[torch.as_tensor(tables.members, device=X.device)]


def _exchange_rows(X, tables):
    """(P, g, ...) personalized exchange: ``[w, j]`` is what group-rank
    ``j`` put in its bucket for rank ``w``."""
    if tables is None:
        return X.transpose(0, 1).contiguous()
    src = torch.as_tensor(tables.members, device=X.device)
    slot = torch.as_tensor(tables.group_rank, device=X.device)[:, None]
    return X[src, slot.expand_as(src)]


def _fold_rows(rows, fn):
    """Left fold over dim 1 of (P, g, ...) rows, in group-rank order."""
    acc = rows[:, 0]
    for j in range(1, rows.shape[1]):
        acc = fn(acc, rows[:, j])
    return acc


# Per-device counterparts: rank r's own rows from every rank's tensor xs.
def _local_rows(tables, xs, r, exchange=False):
    """Rank ``r``'s row of ``_gather_rows`` (``exchange=False``) or of
    ``_exchange_rows`` (``exchange=True``), as a list over its group."""
    members = range(len(xs)) if tables is None else tables.members[r]
    if not exchange:
        return [xs[int(j)] for j in members]
    slot = r if tables is None else int(tables.group_rank[r])
    return [xs[int(j)][slot] for j in members]


def _fold_list(rows, fn):
    """Left fold in group-rank order; a fresh tensor even for one row."""
    acc = rows[0]
    for row in rows[1:]:
        acc = fn(acc, row)
    return acc.clone() if len(rows) == 1 else acc


def _on_ranks(compute):
    """The per-device form of a native primitive: ``compute(xs, r)`` is
    rank ``r``'s result from every rank's tensor ``xs``."""
    def local(x, ranks):
        out = compute(ranks.share(x), ranks.rank)
        ranks.barrier()  # every rank has read before any writes again
        return out

    return local


class Transport:
    """Abstract collective backend.  Every primitive takes the
    communicator first and honours its group scope (``comm.groups``):
    ``comm.size()`` is already the group size."""

    name: str = "abstract"

    def all_gather(self, comm, x, *, tiled: bool = True):
        """Gather ``x`` from every rank.  ``tiled=True`` concatenates along
        axis 0; ``tiled=False`` stacks a new leading rank axis."""
        raise NotImplementedError

    def all_to_all(self, comm, x):
        """Dense personalized exchange: (p, ...) buckets by destination ->
        (p, ...) buckets by source."""
        raise NotImplementedError

    def reduce_scatter_sum(self, comm, x):
        """Sum-reduce (p, chunk...) contributions; return this rank's
        reduced chunk."""
        raise NotImplementedError

    def allreduce_sum(self, comm, x):
        """Sum-reduce ``x`` over the communicator; same value on all
        ranks."""
        raise NotImplementedError

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"<transport {self.name}>"


def _tile(out, tiled):
    """A rank's ``(g, d0, ...)`` gather as ``(g*d0, ...)`` when tiled."""
    return out.flatten(0, 1) if tiled and out.dim() >= 2 else out


class NativeTransport(Transport):
    """Torch ops over the stacked rank dimension (see module docstring).

    Besides the four primitives it provides the helpers every transport's
    lowerings share: the max/min folds and the static permutation."""

    name = "native"

    def all_gather(self, comm, x, *, tiled: bool = True):
        tables = _tables(comm)
        out = _apply(comm, x, lambda X: _gather_rows(X, tables).contiguous(),
                     "allgather", local=_on_ranks(
                         lambda xs, r: torch.stack(_local_rows(tables, xs,
                                                               r))))
        return _tile(out, tiled)

    def all_to_all(self, comm, x):
        tables = _tables(comm)
        return _apply(comm, x, lambda X: _exchange_rows(X, tables),
                      "alltoall", local=_on_ranks(
                          lambda xs, r: torch.stack(
                              _local_rows(tables, xs, r, exchange=True))))

    def reduce_scatter_sum(self, comm, x):
        tables = _tables(comm)
        return _apply(
            comm, x,
            lambda X: _fold_rows(_exchange_rows(X, tables), torch.add),
            "reduce_scatter", local=_on_ranks(
                lambda xs, r: _fold_list(
                    _local_rows(tables, xs, r, exchange=True), torch.add)),
        )

    def _fold(self, comm, x, kind):
        tables = _tables(comm)
        fn = _FOLDS[kind]

        def rule(X):
            if tables is None:
                acc = _fold_rows(X.unsqueeze(0), fn)[0]
                return acc.unsqueeze(0).expand_as(X).contiguous()
            return _fold_rows(_gather_rows(X, tables), fn)

        # The sum allreduce is its own adjoint: d/dx_r of sum_q f(sum_j x_j)
        # is the allreduce of the per-rank cotangents.
        return _apply(comm, x, rule, f"a {kind} allreduce",
                      adjoint=rule if kind == "sum" else None,
                      local=_on_ranks(lambda xs, r: _fold_list(
                          _local_rows(tables, xs, r), fn)))

    def allreduce_sum(self, comm, x):
        return self._fold(comm, x, "sum")

    def allreduce_max(self, comm, x):
        return self._fold(comm, x, "max")

    def allreduce_min(self, comm, x):
        return self._fold(comm, x, "min")

    def ppermute(self, comm, x, perm):
        """``out[dst] = x[src]`` for each communicator-relative pair (per
        group on a split communicator); ranks no pair reaches get zeros."""
        if comm.groups is None:
            pairs = [(int(s), int(d)) for s, d in perm]
        else:
            pairs = [(grp[int(s)], grp[int(d)]) for grp in comm.groups
                     for s, d in perm]
        src = [s for s, _ in pairs]
        dst = [d for _, d in pairs]

        def rule(X):
            out = torch.zeros_like(X)
            if pairs:
                out[torch.as_tensor(dst, device=X.device)] = \
                    X[torch.as_tensor(src, device=X.device)]
            return out

        def pick(xs, r):
            srcs = [s for s, d in pairs if d == r]
            return xs[srcs[-1]].clone() if srcs else torch.zeros_like(xs[r])

        return _apply(comm, x, rule, "send_recv", local=_on_ranks(pick))


class RingTransport(Transport):
    """The ring kernels B1, B2, B4 and their composition B3, and on
    per-device ranks B8a and B8b (see module docstring).  Single-axis communicators only: the ring order is defined
    over one axis."""

    name = "ring"

    def _rings(self, comm) -> int:
        """Number of independent rings in the stacked layout."""
        if isinstance(comm.axis, (tuple, list)):
            raise KampingError(
                "transport('ring') requires a single-axis communicator (the "
                f"ring order is defined over one axis); got axes "
                f"{comm.axis!r}. Use transport('native')."
            )
        P, g = comm.world_size(), comm.size()
        if comm.groups is not None and comm.groups != tuple(
            tuple(range(b * g, (b + 1) * g)) for b in range(P // g)
        ):
            raise NotImplementedError(
                "transport('ring') runs contiguous rank blocks "
                "(split_by(block=)) only; other groups are not ported yet "
                "(ROADMAP A4)"
            )
        return P // g

    def _run(self, comm, x, kernel, local_kernel, name):
        rings = self._rings(comm)

        def local(v, ranks):
            if comm.groups is not None:
                raise KampingError(
                    f"{name}: the per-device ring kernels do not support "
                    "process groups (the ring is the ranks' own order); use "
                    "transport('native') on the split communicator")
            return local_kernel(v.contiguous(), ranks)

        # A value that is the same on every rank arrives unbatched and
        # _stacked expands it with stride 0; the kernels read a dense
        # stack, so .contiguous() materialises it — a real copy of p times
        # the payload (2.48 GB per rank for a qwen1.5-0.5B gradient).  For
        # a batched value it is free.
        return _apply(comm, x,
                      lambda X: kernel(X.contiguous(), rings=rings),
                      f"{name} (ring)", local=local)

    def all_gather(self, comm, x, *, tiled: bool = True):
        return _tile(self._run(comm, x, ring_ops.ring_allgather,
                               ring_ops.device_ring_allgather, "allgather"),
                     tiled)

    def all_to_all(self, comm, x):
        return self._run(comm, x, ring_ops.ring_alltoall, _on_ranks(
            lambda xs, r: torch.stack(_local_rows(None, xs, r,
                                                  exchange=True))),
            "alltoall")

    def reduce_scatter_sum(self, comm, x):
        return self._run(comm, x, ring_ops.ring_reduce_scatter,
                         ring_ops.device_ring_reduce_scatter,
                         "reduce_scatter")

    def allreduce_sum(self, comm, x):
        return self._run(comm, x, ring_ops.ring_allreduce,
                         ring_ops.device_ring_allreduce, "a sum allreduce")


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


NATIVE = register_transport(NativeTransport())
register_transport(NATIVE, name="xla")
_RING = register_transport(RingTransport())
register_transport(_RING, name="pallas")
