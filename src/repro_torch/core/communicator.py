"""The KaMPIng-style Communicator over emulated ranks.

A :class:`Communicator` names one rank axis bound by
:func:`repro_torch.core.spmd` and provides collective operations inside
the per-rank body.  Calls take named parameters
(:mod:`repro_torch.core.params`); any omitted parameter is inferred — with
nothing launched when the information is static, and with exactly the
communication a hand-rolled implementation would launch otherwise (paper
§III-A).

Every collective is one row of the declarative op-spec table
(:mod:`repro_torch.core.opspec`): the spec names the parameter interface,
a small ``lower`` function does the data movement, and the shared engine
provides parameter collection, the static/per-rank count paths, capacity
policies, leveled assertions, result packing and the auto-generated
non-blocking ``i*`` variants.  The 16 rows are those of the JAX package's
``core/communicator.py:750-950``.

Variable collectives (``*v``) use *capacity policies* in place of the
paper's resize policies because the emulated rank programs share static
shapes: buffers are fixed-capacity, counts are element counts.  See
``params.ResizePolicy``.
"""
from __future__ import annotations

import builtins
import functools
import operator
from typing import Any, Optional, Tuple

import numpy as np
import torch

from . import groups as _groups
from .errors import KampingError
from .opspec import Lowering, OpSpec, attach_ops, is_static, static_int
from .params import ParamKind as K
from .spmd import bound_axis, rank_tensor
from .transports import NATIVE, get_transport, resolve_transport

__all__ = ["Communicator", "CORE_SPECS"]

# STL-functor -> transport-reduction mapping (paper §II).
_SUM_FNS = {operator.add, torch.add, builtins.sum, "sum", "+", "plus"}
_MAX_FNS = {builtins.max, torch.maximum, "max"}
_MIN_FNS = {builtins.min, torch.minimum, "min"}
_AND_FNS = {operator.and_, torch.logical_and, "and", "land"}
_OR_FNS = {operator.or_, torch.logical_or, "or", "lor"}


def _try_hash_lookup(fn, table) -> bool:
    try:
        return fn in table
    except TypeError:  # unhashable
        return False


def _at(x, i):
    """``x[i]`` along dim 0 for a per-rank index tensor ``i``."""
    return torch.index_select(x, 0, i.reshape(1))[0]


class Communicator:
    """Collective operations over one emulated rank axis.

    Instantiate *inside* a per-rank body run by ``spmd``::

        def step(x):
            comm = Communicator("data")
            return comm.allreduce(send_buf(x), op(operator.add))

        spmd(step, xs, axis_name="data")

    The collective methods (``allgather`` ... ``send_recv``) and their
    non-blocking ``i*`` variants are generated from ``CORE_SPECS``.
    ``transport`` selects the default backend for every op on this
    communicator (``"native"`` | ``"ring"`` | any registered name); a
    per-call ``transport(...)`` parameter overrides it::

        comm = Communicator("data", transport="ring")    # ring kernels
        comm.allgather(send_buf(x), transport("native"))  # per-call
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

    # -- group-aware helpers on the native transport ------------------------
    # The scalar collectives every lowering shares run on `native` under
    # every transport, as the JAX package keeps them on XLA's psum/pmax/
    # pmin: they are latency-bound and one lowering keeps them bitwise
    # transport-invariant.
    def _psum(self, x):
        return NATIVE.allreduce_sum(self, x)

    def _pmax(self, x):
        return NATIVE.allreduce_max(self, x)

    def _pmin(self, x):
        return NATIVE.allreduce_min(self, x)

    def _tensor(self, x):
        """``x`` as a tensor on the ranks' device; a tensor on another
        device raises (:func:`~repro_torch.core.spmd.rank_tensor`)."""
        return rank_tensor(x, self.global_rank().device, "kamping")

    def _ppermute(self, x, perm):
        """ppermute with communicator-relative ``perm``."""
        return NATIVE.ppermute(self, x, perm)

    # -- reduction ------------------------------------------------------------
    def _reduce_impl(self, x, op_param, transport=None):
        t = transport if transport is not None else resolve_transport(self)
        fn = op_param.value
        x = self._tensor(x)
        if _try_hash_lookup(fn, _SUM_FNS):
            return t.allreduce_sum(self, x)
        if _try_hash_lookup(fn, _MAX_FNS):
            return self._pmax(x)
        if _try_hash_lookup(fn, _MIN_FNS):
            return self._pmin(x)
        if _try_hash_lookup(fn, _AND_FNS):
            return self._pmin(x.to(torch.int32)).to(x.dtype)
        if _try_hash_lookup(fn, _OR_FNS):
            return self._pmax(x.to(torch.int32)).to(x.dtype)
        if not callable(fn):
            raise KampingError(
                f"kamping.op: {fn!r} is neither a recognized functor name "
                "(operator.add, torch.maximum, 'sum', 'max', ...) nor "
                "callable; pass an STL-style functor, a torch function, or "
                "a binary lambda"
            )
        # Reduction via lambda: left fold in rank order over the gathered
        # contributions (pure data movement, then local folds), so the
        # result is bitwise the same whichever transport moved it.
        gathered = t.all_gather(self, x, tiled=False)
        acc = gathered[0]
        for j in range(1, gathered.shape[0]):
            acc = fn(acc, gathered[j])
        return acc

    # -- rooted value distribution -------------------------------------------
    def _bcast_value(self, x, r):
        """Root ``r``'s value on every rank of its group: a masked sum, as
        the JAX package does off the TPU (``r`` may be a per-rank tensor;
        it is group-relative, so every group broadcasts its own root)."""
        from .serialization import Serialized, deserialize_like

        if isinstance(x, Serialized):
            return deserialize_like(x, self._bcast_value(x.buffer, r))
        x = self._tensor(x)
        mask = self.rank() == r
        if x.dtype == torch.bool:
            return self._pmax((x & mask).to(torch.int32)).to(torch.bool)
        return self._psum(x * mask.to(x.dtype))


# --------------------------------------------------------------------------
# Lowerings: the data movement of each op, one small function per row.
# Everything else (packs, counts, policies, assertions, results, i*) is
# the engine.
# --------------------------------------------------------------------------
def _lower_allgather(low: Lowering):
    if low.has(K.SEND_RECV_BUF):
        # Simplified MPI_IN_PLACE (paper §III-G): one slot per rank, this
        # rank's slot at index `rank`.
        x = low.tensor(low.value(K.SEND_RECV_BUF))
        p = low.p
        if x.shape[0] != p:
            raise KampingError(
                f"kamping.{low.spec.name}(send_recv_buf): leading dim "
                f"{x.shape[0]} != communicator size {p}"
            )
        return low.all_gather(_at(x, low.rank()), tiled=False).reshape(
            x.shape)
    return low.all_gather(low.value(K.SEND_BUF))


def _lower_gatherv(low: Lowering):
    """Shared allgatherv/gatherv lowering: three count regimes.

    * static uniform ``send_count`` (default: capacity) — exact concat,
      inferred counts/displs are constants, nothing extra launched;
    * static per-rank ``recv_counts`` (NumPy array) — the true
      variable-count path: exact *ragged* concatenation with exclusive
      prefix displacements, still nothing extra launched;
    * per-rank tensor ``send_count`` — padded layout (rank i's data at
      displacement ``i*cap``); the counts gather is launched only when
      ``recv_counts_out()`` asked for it (paper Fig. 2's exchange).
    """
    x = low.tensor(low.value(K.SEND_BUF))
    cap, p = x.shape[0], low.p
    n = low.value(K.SEND_COUNT, cap)

    rc_param = low.pack.get(K.RECV_COUNTS)
    rc_in = (rc_param.value
             if (rc_param is not None and not rc_param.is_out) else None)
    if rc_in is not None and is_static(rc_in):
        counts = np.asarray(rc_in, np.int64).reshape(-1)
        if counts.shape[0] != p:
            raise KampingError(
                f"kamping.{low.spec.name}: recv_counts must have one entry "
                f"per rank (p={p}); got {counts.shape[0]}"
            )
        if (counts < 0).any() or (counts > cap).any():
            raise KampingError(
                f"kamping.{low.spec.name}: static recv_counts must lie in "
                f"[0, capacity={cap}]; got {counts.tolist()}"
            )
        if low.has(K.SEND_COUNT):
            n_static = static_int(n)
            if n_static is None:
                raise KampingError(
                    f"kamping.{low.spec.name}: traced send_count cannot be "
                    f"combined with static recv_counts (the exact ragged "
                    f"path is resolved before launch); drop send_count or "
                    f"supply it statically"
                )
            if (counts > n_static).any():
                raise KampingError(
                    f"kamping.{low.spec.name}: recv_counts "
                    f"{counts.tolist()} exceed send_count({n_static}) — "
                    f"data beyond the sender's declared valid prefix"
                )
        if counts.sum():
            # Gather only up to the largest count: the wire volume is
            # max(counts), not the full capacity.
            g = low.all_gather(x[: int(counts.max())], tiled=False)
            buf = torch.cat([g[i, : int(c)] for i, c in enumerate(counts)
                             if c], 0)
        else:
            buf = x[:0]
        displs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        low.emit("recv_counts",
                 lambda: low.tensor(counts, torch.int32))
        low.emit("recv_displs",
                 lambda: low.tensor(displs, torch.int32))
        return buf

    n_static = static_int(n)
    if n_static is not None:
        # Zero-overhead path: counts known before launch -> exact concat,
        # inferred counts/displs are constants.
        buf = low.all_gather(x[:n_static])
        low.emit("recv_counts",
                 lambda: torch.full((p,), n_static, dtype=torch.int32,
                                    device=low.device))
        low.emit("recv_displs",
                 lambda: torch.arange(p, dtype=torch.int32,
                                      device=low.device) * n_static)
        return buf

    buf = low.all_gather(x)  # padded layout
    low.emit(
        "recv_counts",
        lambda: low.all_gather(low.tensor(n, torch.int32),
                               tiled=False),
    )
    low.emit("recv_displs", lambda: torch.arange(
        p, dtype=torch.int32, device=low.device) * cap)
    return buf


def _lower_gather(low: Lowering):
    return low.all_gather(low.value(K.SEND_BUF))


def _lower_alltoall(low: Lowering):
    x = low.tensor(low.value(K.SEND_BUF))
    p = low.p
    if x.dim() < 1 or x.shape[0] != p:
        raise KampingError(
            f"kamping.{low.spec.name}: send_buf leading dim "
            f"{x.shape[0] if x.dim() else 0} must equal communicator size {p}"
        )
    return low.alltoall(x)


def _lower_alltoallv(low: Lowering):
    x = low.tensor(low.value(K.SEND_BUF))
    buf = low.alltoall(x)
    low.emit("recv_displs",
             lambda: torch.arange(low.p, dtype=torch.int32,
                                  device=low.device) * buf.shape[1])
    low.emit("send_displs",
             lambda: torch.arange(low.p, dtype=torch.int32,
                                  device=low.device) * x.shape[1])
    if low.value(K.SEND_COUNTS) is not None:  # supplied, not *_out()
        def _recv_counts():
            sc = low.value(K.SEND_COUNTS)
            if is_static(sc):
                # Zero-overhead inference: a static send_counts vector is
                # the same constant on every rank, so rank j's count
                # toward me is sc[rank] — a local lookup, *no* launch.
                scv = low.tensor(np.asarray(sc).reshape(-1), torch.int32)
                return _at(scv, low.rank()).expand(low.p)
            # Per-rank counts: the counts transpose (the paper's
            # default-parameter communication) on the op's own transport.
            return low.counts_transpose(sc)

        low.emit("recv_counts", _recv_counts)
    return buf


def _lower_allreduce(low: Lowering):
    x = low.value(K.SEND_BUF, low.value(K.SEND_RECV_BUF))
    return low.reduce(x, low.pack[K.OP])


def _lower_reduce_scatter(low: Lowering):
    """MPI_Reduce_scatter_block: send_buf (p, chunk, ...) — slot j is this
    rank's contribution to rank j; each rank receives the op-reduction of
    its slot over all ranks.  Sums go to the transport's reduce-scatter;
    other functors reduce then extract."""
    x = low.tensor(low.value(K.SEND_BUF, low.value(K.SEND_RECV_BUF)))
    p = low.p
    if x.dim() < 1 or x.shape[0] != p:
        raise KampingError(
            f"kamping.{low.spec.name}: send_buf leading dim "
            f"{x.shape[0] if x.dim() else 0} must equal communicator size "
            f"{p} (slot j holds this rank's contribution to rank j)"
        )
    fn = low.pack[K.OP].value
    if _try_hash_lookup(fn, _SUM_FNS):
        return low.reduce_scatter_sum(x)
    return _at(low.reduce(x, low.pack[K.OP]), low.rank())


def _lower_scan(low: Lowering, inclusive: bool):
    x = low.tensor(low.value(K.SEND_BUF))
    fn = low.pack[K.OP].value
    gathered = low.all_gather(x, tiled=False)
    if _try_hash_lookup(fn, _SUM_FNS):
        csum = torch.cumsum(gathered, 0, dtype=gathered.dtype)
        pref = csum if inclusive else torch.cat(
            [torch.zeros_like(gathered[:1]), csum[:-1]], 0)
    else:
        # True rank-order fold (no identity seed, so non-commutative /
        # non-zero-identity functors follow textbook MPI_Scan semantics;
        # exscan's rank-0 value — undefined in MPI — is zeros).
        acc, outs = gathered[0], []
        for j in range(1, gathered.shape[0]):
            nxt = fn(acc, gathered[j])
            outs.append(nxt if inclusive else acc)
            acc = nxt
        head = gathered[:1] if inclusive else torch.zeros_like(gathered[:1])
        pref = torch.cat([head] + [o.unsqueeze(0) for o in outs], 0)
    return _at(pref, low.rank())


def _lower_bcast(low: Lowering):
    return low.comm._bcast_value(low.value(K.SEND_RECV_BUF),
                                 low.value(K.ROOT, 0))


def _lower_scatter(low: Lowering):
    x = low.comm._bcast_value(low.value(K.SEND_BUF), low.value(K.ROOT, 0))
    return _at(x, low.rank())


def _lower_scatterv(low: Lowering):
    """Root's bucketed (p, cap, ...) buffer + per-rank counts; rank i
    receives bucket i (capacity-policy semantics matching alltoallv)."""
    r = low.value(K.ROOT, 0)
    comm = low.comm
    mine = _at(comm._bcast_value(low.value(K.SEND_BUF), r), low.rank())

    def _recv_count():
        sc = low.value(K.SEND_COUNTS)
        if sc is None:
            raise KampingError(
                f"kamping.{low.spec.name}: recv_count_out() requires "
                f"send_counts(...) to infer from"
            )
        if is_static(sc):
            # Zero-overhead path: static counts are the same constant on
            # all ranks (MPI: counts significant only at root), so the
            # lookup is local — nothing launched.
            scb = low.tensor(sc, torch.int32)
        else:
            scb = comm._bcast_value(low.tensor(sc, torch.int32), r)
        return _at(scb, low.rank())

    low.emit("recv_count", _recv_count)
    return mine


def _lower_barrier(low: Lowering):
    return low.comm._psum(torch.zeros((), dtype=torch.int32,
                                      device=low.device))


def _lower_send_recv(low: Lowering):
    from .serialization import Serialized, deserialize_like

    x = low.value(K.SEND_BUF)
    perm = low.kw.get("perm")
    if perm is None:
        if not low.has(K.DEST):
            raise KampingError(
                f"kamping.{low.spec.name}: pass perm=[(src,dst),...] or "
                "dest(fn)"
            )
        dfn = low.value(K.DEST)
        p = low.p
        perm = [(i, int(dfn(i)) % p) for i in range(p)]
    # perm is communicator-relative: on a split communicator the pairs
    # are group-rank indices, mapped to one static global permutation.
    if isinstance(x, Serialized):
        return deserialize_like(x, low.ppermute(x.buffer, perm))
    return low.ppermute(x, perm)


# --------------------------------------------------------------------------
# The core table.  One row per collective; the surface (blocking methods,
# i* variants, result packing, assertions) is generated from it.
# --------------------------------------------------------------------------
_ALLTOALLV_HINT = (
    "Use with_flattened(...) to build buckets from destination->data "
    "mappings."
)

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
        name="allgatherv",
        lower=_lower_gatherv,
        required=(K.SEND_BUF,),
        accepted=(K.SEND_COUNT, K.RECV_COUNTS, K.RECV_DISPLS, K.RECV_BUF),
        doc=(
            "MPI_Allgatherv with parameter inference (paper Fig. 1/3).\n\n"
            "``send_buf(x)`` — x has static capacity ``cap = x.shape[0]``;\n"
            "``send_count(n)`` — valid prefix length (default: cap, static);\n"
            "``recv_counts(c)`` / ``recv_counts_out()`` — supplied or "
            "inferred (inference launches one all-gather of the scalar "
            "count — exactly the exchange in paper Fig. 2);\n"
            "``recv_displs(...)`` / ``recv_displs_out()``.\n\n"
            "With static counts the result is the exact concatenation and "
            "*no* extra communication is launched (the zero-overhead "
            "path); a static per-rank ``recv_counts`` array gives the exact "
            "*ragged* concatenation.  With per-rank tensor counts the "
            "result uses the padded layout: rank i's data at displacement "
            "``i*cap``."
        ),
    ),
    OpSpec(
        name="gather",
        lower=_lower_gather,
        required=(K.SEND_BUF,),
        accepted=(K.ROOT, K.RECV_BUF),
        doc=(
            "MPI_Gather — SPMD note: result materializes on *all* ranks "
            "(an all-gather); `root` kept for API parity."
        ),
    ),
    OpSpec(
        name="gatherv",
        lower=_lower_gatherv,
        required=(K.SEND_BUF,),
        accepted=(
            K.SEND_COUNT, K.RECV_COUNTS, K.RECV_DISPLS, K.RECV_BUF, K.ROOT,
        ),
        doc=(
            "MPI_Gatherv: true variable-count gather. Same count regimes "
            "as allgatherv — in particular a static per-rank "
            "``recv_counts(np.array([...]))`` yields the exact ragged "
            "concatenation with exclusive-prefix displacements, with zero "
            "count communication.  SPMD note: the result materializes on "
            "all ranks; ``root`` kept for API parity."
        ),
    ),
    OpSpec(
        name="alltoall",
        lower=_lower_alltoall,
        required=(K.SEND_BUF,),
        accepted=(K.RECV_BUF,),
        doc="MPI_Alltoall: send_buf shaped (p, chunk, ...).",
    ),
    OpSpec(
        name="alltoallv",
        lower=_lower_alltoallv,
        required=(K.SEND_BUF,),
        accepted=(
            K.SEND_COUNTS, K.RECV_COUNTS, K.RECV_DISPLS, K.SEND_DISPLS,
            K.RECV_BUF,
        ),
        bucketed=True,
        bucket_hint=_ALLTOALLV_HINT,
        heavy_count_check=True,
        doc=(
            "MPI_Alltoallv with capacity policies.\n\n"
            "``send_buf(x)`` — bucketed layout ``(p, cap, ...)``: ``x[j]`` "
            "is the (padded) bucket destined for rank ``j``;\n"
            "``send_counts(sc)`` — (p,) valid element counts per "
            "destination (static NumPy arrays take the zero-overhead "
            "path);\n"
            "``recv_counts(...)``/``recv_counts_out()`` — supplied, or "
            "inferred with one counts all_to_all (paper's "
            "default-parameter communication);\n"
            "``recv_buf(policy)`` — capacity policy for the receive side.\n\n"
            "Returns recv_buf ``(p, cap_r, ...)`` (+ requested outs); entry "
            "``[j]`` is what rank j sent here."
        ),
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
    OpSpec(
        name="reduce",
        lower=_lower_allreduce,
        required=((K.SEND_BUF, K.SEND_RECV_BUF), K.OP),
        accepted=(K.ROOT, K.RECV_BUF),
        compressible=True,
        deterministic=True,
        doc=(
            "MPI_Reduce: like allreduce; `root(...)` kept for API parity.\n\n"
            "Under SPMD every rank computes the value (documented "
            "deviation: there is no cheaper root-only reduction over "
            "emulated ranks)."
        ),
    ),
    OpSpec(
        name="reduce_scatter",
        lower=_lower_reduce_scatter,
        required=((K.SEND_BUF, K.SEND_RECV_BUF), K.OP),
        accepted=(K.RECV_BUF,),
        compressible=True,
        deterministic=True,
        doc=(
            "MPI_Reduce_scatter_block: ``send_buf(x)`` with x shaped "
            "``(p, chunk, ...)`` — slot j is this rank's contribution to "
            "rank j; returns the op-reduction of this rank's slot over all "
            "ranks, shaped ``(chunk, ...)``.  ``op(operator.add)`` goes to "
            "the transport's reduce-scatter; other functors reduce then "
            "extract."
        ),
    ),
    OpSpec(
        name="scan",
        lower=functools.partial(_lower_scan, inclusive=True),
        required=(K.SEND_BUF, K.OP),
        doc="MPI_Scan (inclusive prefix) over ranks.",
    ),
    OpSpec(
        name="exscan",
        lower=functools.partial(_lower_scan, inclusive=False),
        required=(K.SEND_BUF, K.OP),
        doc="MPI_Exscan (exclusive prefix) over ranks.",
    ),
    OpSpec(
        name="bcast",
        lower=_lower_bcast,
        required=(K.SEND_RECV_BUF,),
        accepted=(K.ROOT,),
        doc="MPI_Bcast. ``send_recv_buf`` on all ranks; ``root`` defaults 0.",
    ),
    OpSpec(
        name="scatter",
        lower=_lower_scatter,
        required=(K.SEND_BUF,),
        accepted=(K.ROOT,),
        doc=(
            "MPI_Scatter: root's (p, chunk, ...) buffer; each rank gets "
            "[rank]."
        ),
    ),
    OpSpec(
        name="scatterv",
        lower=_lower_scatterv,
        required=(K.SEND_BUF,),
        accepted=(K.ROOT, K.SEND_COUNTS, K.RECV_COUNT, K.RECV_BUF),
        bucketed=True,
        doc=(
            "MPI_Scatterv: root's bucketed ``(p, cap, ...)`` buffer + "
            "per-rank ``send_counts``; rank i receives bucket i "
            "(``(cap_r, ...)``) with capacity-policy semantics matching "
            "alltoallv (``recv_buf(grow_only(c))`` resizes, NORMAL-level "
            "overflow assertion on shrink).  ``recv_count_out()`` returns "
            "this rank's valid element count; ``root`` defaults 0."
        ),
    ),
    OpSpec(
        name="barrier",
        lower=_lower_barrier,
        nonblocking=False,
        doc=(
            "Semantic no-op under SPMD bulk-synchronous execution; runs a "
            "trivial sum so program order is kept where it matters."
        ),
    ),
    OpSpec(
        name="send_recv",
        lower=_lower_send_recv,
        required=(K.SEND_BUF,),
        accepted=(K.DEST, K.TAG),
        kw_accepted=("perm",),
        doc=(
            "Combined send+recv (SPMD p2p = a static permutation).\n\n"
            "Either pass ``perm=[(src, dst), ...]`` or ``dest(fn)`` where "
            "fn maps rank -> destination rank (a static schedule)."
        ),
    ),
)

attach_ops(Communicator, CORE_SPECS)
