"""Declarative collective op specs + the single lowering engine.

Every collective is described ONCE by an :class:`OpSpec`: its
named-parameter interface (required / accepted / in-place-ignored kinds),
which assertion tiers it takes part in, and a ``lower`` function that does
*only the data movement*.  One engine, :func:`execute`, does the rest for
every op:

* parameter-pack collection and validation before launch,
* the zero-overhead static-count path vs. the per-rank-count padded path
  (a lowering emits out-fields lazily; nothing is launched unless the
  corresponding ``*_out()`` parameter was requested),
* capacity (resize) policies on bucketed ``(p, cap, ...)`` send buffers,
  with the NORMAL-level overflow assertion,
* the HEAVY-level communication assertion (global sent == received),
* :class:`~repro_torch.core.result.Result` packing in request order,
* the auto-generated non-blocking ``i*`` variant (paper §III-E).

A value is *static* when it is a Python or NumPy integer or a NumPy
array (the same constant on every rank); a tensor is a per-rank value, the
counterpart of a traced value in the JAX package.

Specs are attached to a class with :func:`attach_ops`.  Every row accepts
the ``transport(...)`` parameter selecting the collective backend
(:mod:`repro_torch.core.transports`).  The engine-level hooks of the JAX
package that belong to later slices accept only ``None`` here:
``compression(...)`` and ``deterministic(...)`` (ROADMAP A5) and
``plan(...)`` (ROADMAP A7); the trace-time IR recorder (A7) has no hook
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import params as kp
from .errors import AssertionLevel, KampingError, check_enabled
from .nonblocking import NonBlockingResult
from .params import ParamKind as K
from .params import collect_params
from .result import make_result
from .spmd import rank_tensor
from .transports import resolve_transport

__all__ = [
    "OpSpec", "Lowering", "OP_TABLE", "attach_ops", "execute", "is_static",
    "static_int",
]

# Method-name -> spec, across the communicator and every plugin.
OP_TABLE: Dict[str, "OpSpec"] = {}

# Out-requestable parameter kinds and the result field each one fills.
_OUT_FIELDS = {
    K.RECV_COUNTS: "recv_counts",
    K.RECV_COUNT: "recv_count",
    K.RECV_DISPLS: "recv_displs",
    K.SEND_COUNTS: "send_counts",
    K.SEND_DISPLS: "send_displs",
}

# Engine-level parameters whose only ported value is None, with the
# ROADMAP item that ports the rest.
_NONE_ONLY = {
    K.COMPRESSION: "compression codecs are not ported yet (ROADMAP A5)",
    K.DETERMINISTIC: "deterministic reduction is not ported yet (ROADMAP A5)",
    K.PLAN: "the cost-model planner is not ported yet (ROADMAP A7)",
}


def is_static(value) -> bool:
    """True when a count-like value is a constant known before launch."""
    return isinstance(value, (int, np.integer, np.ndarray))


def static_int(value) -> Optional[int]:
    return int(value) if isinstance(value, (int, np.integer)) else None


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One row of the collective table.

    ``lower`` does the data movement for the op and returns the receive
    buffer; side information (counts, displacements) is *emitted* on the
    :class:`Lowering` as thunks, computed only when the caller requested
    them.
    """

    name: str
    lower: Callable[["Lowering"], Any]
    required: Tuple = ()
    accepted: Tuple = ()
    in_place_ignored: Tuple = ()
    # (p, cap, ...) bucketed send layout: the engine validates the shape
    # and applies the recv_buf capacity policy (+ NORMAL overflow check).
    bucketed: bool = False
    bucket_hint: str = ""
    # HEAVY tier: check global sent == received when send_counts are
    # given (costs one counts transpose and two sum allreduces).
    heavy_count_check: bool = False
    # Reduction rows additionally accept compression(...) and
    # deterministic(...) (None only, see module docstring).
    compressible: bool = False
    deterministic: bool = False
    # Auto-generate the non-blocking ``i<name>`` variant.
    nonblocking: bool = True
    # Python keyword arguments the generated method accepts.
    kw_accepted: Tuple[str, ...] = ()
    doc: str = ""


class Lowering:
    """Per-call context handed to a spec's ``lower``: the collected pack,
    the topology, the transport-aware collective helpers and the out-field
    emit machinery."""

    def __init__(self, comm, spec: OpSpec, pack, kw):
        self.comm = comm
        self.spec = spec
        self.pack = pack
        self.kw = kw
        for kind, why in _NONE_ONLY.items():
            param = pack.get(kind)
            if param is not None and param.value is not None:
                raise NotImplementedError(f"kamping.{spec.name}: {why}")
        tparam = pack.get(K.TRANSPORT)
        self.transport = resolve_transport(
            comm, tparam.value if tparam is not None else None
        )
        self._emitted: Dict[str, Callable[[], Any]] = {}
        self._overrides: Dict[Any, Any] = {}

    # -- topology ----------------------------------------------------------
    @property
    def p(self) -> int:
        """Communicator size — the *group* size on a split communicator,
        so every count/capacity/bucket rule is group-scoped for free."""
        return self.comm.size()

    def rank(self):
        """Communicator-relative rank (group-relative when split)."""
        return self.comm.rank()

    @property
    def device(self) -> torch.device:
        """The device the ranks run on."""
        return self.comm.global_rank().device

    def tensor(self, x, dtype=None):
        """``x`` as a tensor on the ranks' device; a tensor on another
        device raises (:func:`~repro_torch.core.spmd.rank_tensor`)."""
        return rank_tensor(x, self.device, f"kamping.{self.spec.name}", dtype)

    # -- parameter access --------------------------------------------------
    def has(self, kind) -> bool:
        return kind in self.pack

    def value(self, kind, default=None):
        if kind in self._overrides:
            return self._overrides[kind]
        p = self.pack.get(kind)
        return p.value if p is not None else default

    def override(self, kind, value):
        """Replace a parameter's value for the rest of this lowering
        (used by the engine's capacity-policy resize)."""
        self._overrides[kind] = value

    def requested(self, kind) -> bool:
        p = self.pack.get(kind)
        return p is not None and p.is_out

    # -- transport-aware collective helpers --------------------------------
    def alltoall(self, x):
        """The op's dense personalized exchange on the resolved transport."""
        return self.transport.all_to_all(self.comm, x)

    def all_gather(self, x, tiled=True):
        return self.transport.all_gather(self.comm, x, tiled=tiled)

    def reduce(self, x, op_param):
        return self.comm._reduce_impl(x, op_param, transport=self.transport)

    def reduce_scatter_sum(self, x):
        return self.transport.reduce_scatter_sum(self.comm, x)

    def ppermute(self, x, perm):
        """Communicator-relative ``ppermute`` — group-relative pairs map
        to one static global permutation on a split communicator."""
        return self.comm._ppermute(x, perm)

    def counts_transpose(self, sc):
        """recv_counts[j] = send_counts of rank j towards me (one alltoall
        on the op's own transport)."""
        sc = self.tensor(sc, torch.int32).reshape(self.p, 1)
        return self.alltoall(sc).reshape(self.p)

    # -- out-field machinery ------------------------------------------------
    def emit(self, field: str, thunk: Callable[[], Any]):
        """Offer an out-field; ``thunk`` runs only if requested — this is
        how the static path stays zero-overhead."""
        self._emitted[field] = thunk

    def resolve(self, field: str):
        thunk = self._emitted.get(field)
        if thunk is None:
            if field in ("recv_counts", "recv_count"):
                raise KampingError(
                    f"kamping.{self.spec.name}: {field}_out() requires "
                    f"send_counts(...) to infer from"
                )
            raise KampingError(
                f"kamping.{self.spec.name}: {field}_out() is not inferable "
                f"for this operation; pass {field}(...) as an input instead"
            )
        return thunk()


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------
def execute(comm, spec: OpSpec, args, kw=None):
    """Collect the pack, lower the op, pack the result — for every op."""
    if kw:
        unknown = set(kw) - set(spec.kw_accepted)
        if unknown:
            raise TypeError(
                f"kamping.{spec.name}: unexpected keyword argument(s) "
                f"{sorted(unknown)}; collective arguments are the named "
                f"parameter objects (send_buf(...), send_counts(...), ...)"
                + (
                    f" — accepted keywords: {sorted(spec.kw_accepted)}"
                    if spec.kw_accepted
                    else ""
                )
            )
    pack = collect_params(
        spec.name,
        args,
        required=spec.required,
        accepted=tuple(spec.accepted)
        + (K.TRANSPORT, K.PLAN)
        + ((K.COMPRESSION,) if spec.compressible else ())
        + ((K.DETERMINISTIC,) if spec.deterministic else ()),
        in_place_ignored=spec.in_place_ignored,
    )
    low = Lowering(comm, spec, pack, kw or {})

    if spec.bucketed:
        _validate_and_resize_buckets(low)

    buf = spec.lower(low)

    out_fields = [("recv_buf", buf)]
    for param in pack.values():  # request order == result unpack order
        field = _OUT_FIELDS.get(param.kind)
        if field is not None and param.is_out:
            out_fields.append((field, low.resolve(field)))

    if (
        spec.heavy_count_check
        and check_enabled(AssertionLevel.HEAVY)
        and low.has(K.SEND_COUNTS)
    ):
        out_fields[0] = ("recv_buf", _stage_global_count_check(low, buf))

    return make_result(out_fields)


def _validate_and_resize_buckets(low: Lowering):
    """Shared bucketed-layout validation + capacity-policy application."""
    spec, p = low.spec, low.p
    x = low.value(K.SEND_BUF)
    if x is None:
        return  # in-place variant; lowering handles layout itself
    x = low.tensor(x)
    if x.dim() < 2 or x.shape[0] != p:
        hint = f" {spec.bucket_hint}" if spec.bucket_hint else ""
        raise KampingError(
            f"kamping.{spec.name}: send_buf must be bucketed (p, cap, ...) "
            f"with p={p}; got shape {tuple(x.shape)}.{hint}"
        )
    rb = low.pack.get(K.RECV_BUF)
    policy = rb.policy if rb is not None else kp.resize_to_fit
    if isinstance(policy, kp.grow_only):
        cap, cap_r = x.shape[1], policy.capacity
        sc = low.value(K.SEND_COUNTS)
        if cap_r > cap:
            pad = torch.zeros((p, cap_r - cap) + tuple(x.shape[2:]),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], 1)
        elif cap_r < cap:
            if check_enabled(AssertionLevel.NORMAL) and sc is not None:
                x = _check_counts_fit(x, sc, cap_r)
            x = x[:, :cap_r]
        low.override(K.SEND_BUF, x)
    # resize_to_fit / no_resize: symmetric capacity (= send capacity).


def _stage_global_count_check(low: Lowering, buf):
    """Communication-level assertion (paper §III-G): total elements sent
    == total elements received, checked over the communicator
    (group-scoped on a split communicator)."""
    sc = low.tensor(low.value(K.SEND_COUNTS), torch.int32)
    total_sent = low.comm._psum(sc.sum())
    total_recv = low.comm._psum(low.counts_transpose(sc).sum())
    return _poison_unless(total_sent == total_recv, buf)


# --------------------------------------------------------------------------
# Runtime checks (NORMAL / HEAVY tiers)
# --------------------------------------------------------------------------
def _poison_unless(ok, buf):
    """``buf`` where ``ok``, else NaN (floats) or the dtype's max (ints):
    the failure is visible in the data without a host round trip."""
    bad = float("nan") if buf.is_floating_point() else torch.iinfo(
        buf.dtype).max
    return torch.where(ok, buf, torch.full_like(buf, bad))


def _check_counts_fit(x, counts, cap):
    """NORMAL-level assertion: counts <= capacity (overflow check).  On
    failure the buffer is poisoned instead of raising."""
    ok = (rank_tensor(counts, x.device, "kamping: send_counts") <= cap).all()
    return _poison_unless(ok, x)


# --------------------------------------------------------------------------
# Method generation (the composable surface is generated from the table)
# --------------------------------------------------------------------------
def _make_op_method(spec: OpSpec):
    def method(self, *args, **kw):
        return execute(self, spec, args, kw)

    method.__name__ = method.__qualname__ = spec.name
    method.__doc__ = spec.doc
    return method


def _make_nb_method(spec: OpSpec):
    def method(self, *args, **kw):
        moved = [a for a in args if isinstance(a, kp.Param) and a.moved]
        value = execute(self, spec, args, kw)
        return NonBlockingResult(value, moved_params=moved, op_name=spec.name)

    method.__name__ = method.__qualname__ = "i" + spec.name
    method.__doc__ = (
        f"Non-blocking {spec.name} (auto-generated from the op-spec "
        f"table; paper §III-E). Returns a NonBlockingResult."
    )
    return method


def attach_ops(cls, specs):
    """Register ``specs`` in OP_TABLE and attach the generated blocking
    method + non-blocking ``i*`` variant to ``cls``."""
    for spec in specs:
        existing = OP_TABLE.get(spec.name)
        if existing is not None and existing is not spec:
            raise KampingError(f"collective '{spec.name}' already registered")
        OP_TABLE[spec.name] = spec
        setattr(cls, spec.name, _make_op_method(spec))
        if spec.nonblocking:
            setattr(cls, "i" + spec.name, _make_nb_method(spec))
    return cls
