"""The KaMPIng-style Communicator over emulated ranks.

A :class:`Communicator` names one rank axis bound by
:func:`repro_torch.core.spmd` and provides collective operations inside
the per-rank body.  Calls take named parameters
(:mod:`repro_torch.core.params`); every collective is one row of the
op-spec table (:mod:`repro_torch.core.opspec`).

Ported rows: ``allreduce`` and ``allgather`` (with ``iallreduce`` /
``iallgather``).  The remaining 14 rows of the JAX package's table come
with slice 2 (ROADMAP A1).
"""
from __future__ import annotations

import builtins
import operator
from typing import Any, Optional, Tuple

import torch

from . import groups as _groups
from .errors import KampingError
from .opspec import Lowering, OpSpec, attach_ops
from .params import ParamKind as K
from .spmd import bound_axis
from .transports import get_transport, resolve_transport

__all__ = ["Communicator", "CORE_SPECS"]

# STL-functor -> transport-reduction mapping (paper §II).
_SUM_FNS = {operator.add, torch.add, builtins.sum, "sum", "+", "plus"}
_MAX_FNS = {builtins.max, torch.maximum, "max"}
_MIN_FNS = {builtins.min, torch.minimum, "min"}


def _try_hash_lookup(fn, table) -> bool:
    try:
        return fn in table
    except TypeError:  # unhashable
        return False


class Communicator:
    """Collective operations over one emulated rank axis.

    Instantiate *inside* a per-rank body run by ``spmd``::

        def step(x):
            comm = Communicator("data")
            return comm.allreduce(send_buf(x), op(operator.add))

        spmd(step, xs, axis_name="data")
    """

    def __init__(self, axis: Any = "data", transport: Optional[str] = None,
                 compression: Optional[str] = None,
                 deterministic: Optional[str] = None, plan=None):
        if isinstance(axis, (tuple, list)):
            raise NotImplementedError(
                "multi-axis communicators are not ported yet (ROADMAP A6)"
            )
        if compression is not None or deterministic is not None:
            raise NotImplementedError(
                "Communicator(compression=/deterministic=): codecs and the "
                "deterministic schedule are not ported yet (ROADMAP A5)"
            )
        if plan is not None:
            raise NotImplementedError(
                "Communicator(plan=): the planner is not ported yet "
                "(ROADMAP A7)"
            )
        self.axis = axis
        if transport is not None:
            get_transport(transport)
        self.transport_name = transport
        self.groups = None  # set by split_by: static tuple of rank tuples
        self._gt_cache = None

    # -- topology ----------------------------------------------------------
    def _group_tables(self) -> _groups.GroupTables:
        if self.groups is None:
            raise KampingError("flat communicator has no group tables")
        if self._gt_cache is None:
            self._gt_cache = _groups.GroupTables(self.groups,
                                                 self.world_size())
        return self._gt_cache

    def world_size(self) -> int:
        """Size of the underlying rank axis."""
        return bound_axis(self.axis).size

    def size(self) -> int:
        """Communicator size (the *group* size when split)."""
        if self.groups is not None:
            return self._group_tables().group_size
        return self.world_size()

    def global_rank(self):
        """This rank's index on the underlying axis (a per-rank tensor)."""
        return bound_axis(self.axis).index

    def rank(self):
        """This rank's index; group-relative on a split communicator."""
        if self.groups is not None:
            table = torch.as_tensor(self._group_tables().group_rank,
                                    device=self.global_rank().device)
            return table[self.global_rank()]
        return self.global_rank()

    # -- process groups -----------------------------------------------------
    def split_by(self, *, block: Optional[int] = None,
                 stride: Optional[int] = None) -> "Communicator":
        """``split_by(block=g)``: contiguous blocks of ``g`` ranks (color =
        ``rank // g``), the intra-group communicator of a hierarchical
        scheme.  ``g`` must divide ``size()``."""
        if stride is not None:
            raise NotImplementedError(
                "comm.split_by(stride=...) is not ported yet (ROADMAP A4)"
            )
        if block is None:
            raise KampingError("comm.split_by: pass block=...")
        p = self.size()
        g = int(block)
        if g <= 0 or p % g:
            raise KampingError(
                f"comm.split_by: block={g} must be a positive divisor of "
                f"the communicator size {p}"
            )
        comm = type(self).__new__(type(self))
        comm.__dict__.update(self.__dict__)
        comm.groups = _groups.split_groups(
            self.groups, self.world_size(), [r // g for r in range(p)]
        )
        comm._gt_cache = None
        return comm

    # -- reduction ------------------------------------------------------------
    def _reduce_impl(self, x, op_param, transport=None):
        t = transport if transport is not None else resolve_transport(self)
        fn = op_param.value
        x = torch.as_tensor(x)
        if _try_hash_lookup(fn, _SUM_FNS):
            return t.allreduce_sum(self, x)
        if _try_hash_lookup(fn, _MAX_FNS):
            return t.allreduce_max(self, x)
        if _try_hash_lookup(fn, _MIN_FNS):
            return t.allreduce_min(self, x)
        if not callable(fn):
            raise KampingError(
                f"kamping.op: {fn!r} is neither a recognized functor name "
                "(operator.add, torch.maximum, 'sum', 'max', ...) nor "
                "callable; pass an STL-style functor, a torch function, or "
                "a binary lambda"
            )
        # Reduction via lambda: left fold in rank order over the gathered
        # contributions (pure data movement, then local folds).
        gathered = t.all_gather(self, x, tiled=False)
        acc = gathered[0]
        for j in range(1, gathered.shape[0]):
            acc = fn(acc, gathered[j])
        return acc


# --------------------------------------------------------------------------
# Lowerings
# --------------------------------------------------------------------------
def _lower_allgather(low: Lowering):
    if low.has(K.SEND_RECV_BUF):
        # Simplified MPI_IN_PLACE (paper §III-G): one slot per rank, this
        # rank's slot at index `rank`.
        x = low.value(K.SEND_RECV_BUF)
        p = low.p
        if x.shape[0] != p:
            raise KampingError(
                f"kamping.{low.spec.name}(send_recv_buf): leading dim "
                f"{x.shape[0]} != communicator size {p}"
            )
        mine = torch.index_select(x, 0, low.rank().reshape(1))[0]
        return low.all_gather(mine, tiled=False).reshape(x.shape)
    return low.all_gather(low.value(K.SEND_BUF))


def _lower_allreduce(low: Lowering):
    x = low.value(K.SEND_BUF, low.value(K.SEND_RECV_BUF))
    return low.reduce(x, low.pack[K.OP])


CORE_SPECS: Tuple[OpSpec, ...] = (
    OpSpec(
        name="allgather",
        lower=_lower_allgather,
        required=((K.SEND_BUF, K.SEND_RECV_BUF),),
        accepted=(K.RECV_BUF,),
        in_place_ignored=(K.SEND_COUNT,),
        doc="MPI_Allgather. Accepts send_buf or send_recv_buf (in-place).",
    ),
    OpSpec(
        name="allreduce",
        lower=_lower_allreduce,
        required=((K.SEND_BUF, K.SEND_RECV_BUF), K.OP),
        accepted=(K.RECV_BUF,),
        compressible=True,
        deterministic=True,
        doc="MPI_Allreduce with functor mapping / reduction-via-lambda.",
    ),
)

attach_ops(Communicator, CORE_SPECS)
