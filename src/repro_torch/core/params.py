"""Named parameters and capacity (resize) policies (paper §III-A/B/C).

Every communicator method accepts *named parameter objects* created by the
factory functions in this module — order-free, presence checked before
launch, defaults computed only for omitted parameters. This is the Python
realization of KaMPIng's template-metaprogramming parameter packs: a
parameter that is supplied statically removes the corresponding inference
work from the launched program entirely.

Resize policies (paper §III-C) become *capacity policies* here, because the
emulated rank programs share static shapes: a "ragged" buffer is a fixed-capacity buffer
plus a (possibly dynamic) element count.

* :data:`resize_to_fit` — the library determines capacity itself.  When the
  relevant counts are static Python ints this costs nothing; when they are
  traced values a counts exchange is staged (exactly the communication the
  paper's default-parameter inference performs).
* :func:`grow_only` — user supplies a static capacity bound; **no**
  additional communication is staged; a leveled runtime assertion checks
  for overflow.
* :data:`no_resize` — caller guarantees the buffer is exactly sized; nothing
  is staged and nothing is checked (the zero-overhead fast path).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

from .errors import (
    KampingError,
    MissingParameterError,
    ParameterConflictError,
    UnsupportedParameterError,
)

__all__ = [
    # parameter factories
    "send_buf", "recv_buf", "send_recv_buf",
    "send_counts", "recv_counts", "send_displs", "recv_displs", "send_count",
    "recv_count", "recv_count_out",
    "send_counts_out", "recv_counts_out", "send_displs_out", "recv_displs_out",
    "op", "root", "dest", "source", "tag", "axis", "transport",
    "compression", "deterministic", "plan",
    # policies
    "ResizePolicy", "resize_to_fit", "grow_only", "no_resize",
    # machinery
    "ParamKind", "Param", "collect_params", "move",
]


class ParamKind(enum.Enum):
    SEND_BUF = "send_buf"
    RECV_BUF = "recv_buf"
    SEND_RECV_BUF = "send_recv_buf"
    SEND_COUNT = "send_count"
    RECV_COUNT = "recv_count"
    SEND_COUNTS = "send_counts"
    RECV_COUNTS = "recv_counts"
    SEND_DISPLS = "send_displs"
    RECV_DISPLS = "recv_displs"
    OP = "op"
    ROOT = "root"
    DEST = "dest"
    SOURCE = "source"
    TAG = "tag"
    AXIS = "axis"
    NEIGHBORS = "neighbors"  # plugin-defined (sparse neighborhoods)
    TRANSPORT = "transport"  # collective backend selector (DESIGN.md §7)
    COMPRESSION = "compression"  # payload codec selector (DESIGN.md §10)
    DETERMINISTIC = "deterministic"  # fixed reduction schedule (DESIGN.md §12)
    PLAN = "plan"  # cost-model transport planning (DESIGN.md §13)


# --------------------------------------------------------------------------
# Capacity (resize) policies
# --------------------------------------------------------------------------
class ResizePolicy:
    """Base class for capacity policies. See module docstring."""

    kind: str = "abstract"

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"<policy {self.kind}>"


class _ResizeToFit(ResizePolicy):
    kind = "resize_to_fit"


class _NoResize(ResizePolicy):
    kind = "no_resize"


@dataclasses.dataclass(frozen=True)
class grow_only(ResizePolicy):
    """Static per-peer capacity bound supplied by the caller.

    ``capacity`` bounds the number of elements exchanged with any single
    peer.  Nothing is staged to discover sizes; a NORMAL-level assertion
    verifies counts <= capacity.
    """

    capacity: int
    kind: str = dataclasses.field(default="grow_only", init=False, repr=False)


resize_to_fit = _ResizeToFit()
no_resize = _NoResize()


# --------------------------------------------------------------------------
# Moved buffers (ownership transfer, paper §III-E)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Moved:
    """Marks a buffer whose ownership is transferred into the call.

    The value becomes inaccessible through this handle once consumed
    (trace-time enforcement of the paper's move semantics); non-blocking
    results re-return it on completion.
    """

    _value: Any
    consumed: bool = False

    def take(self):
        from .errors import MovedBufferError

        if self.consumed:
            raise MovedBufferError(
                "buffer was already moved into a communication call; "
                "it can only be re-acquired from the operation's result"
            )
        self.consumed = True
        v = self._value
        self._value = None
        return v


def move(value) -> Moved:
    """``std::move`` analogue: transfer buffer ownership into the call."""
    return Moved(value)


# --------------------------------------------------------------------------
# Parameter objects
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Param:
    kind: ParamKind
    value: Any = None
    is_out: bool = False
    policy: ResizePolicy = no_resize
    moved: bool = False

    @property
    def name(self) -> str:
        return self.kind.value


def _mk(kind: ParamKind, value, *, is_out=False, policy=no_resize):
    moved = isinstance(value, Moved)
    if moved:
        value = value.take()
    return Param(kind, value, is_out=is_out, policy=policy, moved=moved)


def send_buf(data) -> Param:
    """In-parameter: the data this rank contributes."""
    return _mk(ParamKind.SEND_BUF, data)


def recv_buf(policy: ResizePolicy = resize_to_fit, out=None) -> Param:
    """Out-parameter: where/how the received data is materialized."""
    return Param(ParamKind.RECV_BUF, out, is_out=True, policy=policy)


def send_recv_buf(data) -> Param:
    """In-out parameter: simplified MPI_IN_PLACE semantics (paper §III-G)."""
    return _mk(ParamKind.SEND_RECV_BUF, data)


def send_count(n) -> Param:
    """Number of valid elements in ``send_buf`` (default: its capacity)."""
    return _mk(ParamKind.SEND_COUNT, n)


def recv_count(n) -> Param:
    """Number of valid elements this rank receives (scatterv-style ops)."""
    return _mk(ParamKind.RECV_COUNT, n)


def recv_count_out() -> Param:
    """Ask the library to compute & return this rank's receive count."""
    return Param(ParamKind.RECV_COUNT, is_out=True)


def send_counts(c) -> Param:
    return _mk(ParamKind.SEND_COUNTS, c)


def recv_counts(c) -> Param:
    return _mk(ParamKind.RECV_COUNTS, c)


def send_displs(d) -> Param:
    return _mk(ParamKind.SEND_DISPLS, d)


def recv_displs(d) -> Param:
    return _mk(ParamKind.RECV_DISPLS, d)


def send_counts_out() -> Param:
    return Param(ParamKind.SEND_COUNTS, is_out=True)


def recv_counts_out(container=None) -> Param:
    """Ask the library to compute & return receive counts (paper Fig. 1)."""
    return Param(ParamKind.RECV_COUNTS, container, is_out=True)


def send_displs_out() -> Param:
    return Param(ParamKind.SEND_DISPLS, is_out=True)


def recv_displs_out() -> Param:
    return Param(ParamKind.RECV_DISPLS, is_out=True)


def op(fn: Callable, commutative: Optional[bool] = None) -> Param:
    """Reduction operation: an STL-style functor, torch function, or lambda.

    Well-known functors (``operator.add``, ``torch.add``, ``min``, ``max``…)
    map to the transport's sum/max/min reductions, mirroring
    Boost.MPI/KaMPIng's ``std::plus`` -> ``MPI_SUM`` mapping; arbitrary
    callables fall back to a left fold in rank order that applies the
    callable directly (the paper's "reduction via lambda").
    """
    p = _mk(ParamKind.OP, fn)
    p.commutative = commutative  # type: ignore[attr-defined]
    return p


def root(r: int) -> Param:
    return _mk(ParamKind.ROOT, r)


def dest(d) -> Param:
    return _mk(ParamKind.DEST, d)


def source(s) -> Param:
    return _mk(ParamKind.SOURCE, s)


def tag(t: int) -> Param:
    return _mk(ParamKind.TAG, t)


def axis(name) -> Param:
    return _mk(ParamKind.AXIS, name)


def transport(name) -> Param:
    """Collective backend for this call (DESIGN.md §7): ``"native"`` (the
    default; ``"xla"`` is its alias), ``"ring"`` (alias ``"pallas"``: the
    ring kernels) or any backend registered via
    :func:`repro_torch.core.transports.register_transport`.  Resolution is
    explicit parameter > communicator default > ``"native"``, checked
    before launch."""
    return _mk(ParamKind.TRANSPORT, name)


def compression(name, state=None, scale=None) -> Param:
    """Payload codec for a sum reduction (DESIGN.md §10).  Accepted by the
    reduction rows; only ``compression(None)`` is ported — a codec raises
    ``NotImplementedError`` naming ROADMAP item A5."""
    p = _mk(ParamKind.COMPRESSION, name)
    p.state = state  # type: ignore[attr-defined]
    p.scale = scale  # type: ignore[attr-defined]
    return p


_DETERMINISTIC_SCHEMES = ("tree",)


def deterministic(scheme: str = "tree", leaves: Optional[int] = None) -> Param:
    """Deterministic (p-invariant) reduction schedule (paper §V-C,
    DESIGN.md §12).  Accepted by the reduction rows; only
    ``deterministic(None)`` is ported — the canonical tree raises
    ``NotImplementedError`` naming ROADMAP item A5."""
    if scheme is not None and scheme not in _DETERMINISTIC_SCHEMES:
        raise KampingError(
            f"deterministic({scheme!r}): unknown scheme; registered "
            f"schemes: {', '.join(_DETERMINISTIC_SCHEMES)} (or None to "
            "disable a communicator default)"
        )
    p = _mk(ParamKind.DETERMINISTIC, scheme)
    p.leaves = leaves  # type: ignore[attr-defined]
    return p


def plan(value) -> Param:
    """Cost-model planning for this call (DESIGN.md §13).  Accepted by every
    table-generated collective; only ``plan(None)`` is ported — a plan
    raises ``NotImplementedError`` naming ROADMAP item A7."""
    return _mk(ParamKind.PLAN, value)


# --------------------------------------------------------------------------
# Parameter pack collection (the "template metaprogramming")
# --------------------------------------------------------------------------
def collect_params(op_name: str, args, *, required=(), accepted=(), in_place_ignored=()):
    """Validate and index a named-parameter pack.

    Raises human-readable errors for duplicate, unknown, or
    missing parameters (paper §III-G).  ``in_place_ignored`` lists kinds
    that are *rejected* when ``send_recv_buf`` is present because the
    underlying in-place call would ignore them (paper's simplified
    MPI_IN_PLACE: passing an ignored argument is a compile error).
    """
    accepted = set(accepted)
    for k in required:
        accepted |= set(k) if isinstance(k, tuple) else {k}
    pack = {}
    for a in args:
        if not isinstance(a, Param):
            raise UnsupportedParameterError(
                op_name,
                repr(a),
                {k.value for k in accepted},
            )
        if a.kind in pack:
            raise ParameterConflictError(op_name, a.name)
        if a.kind not in accepted:
            raise UnsupportedParameterError(op_name, a.name, {k.value for k in accepted})
        pack[a.kind] = a

    if ParamKind.SEND_RECV_BUF in pack:
        for k in in_place_ignored:
            if k in pack:
                raise ParameterConflictError(
                    op_name,
                    k.value,
                    "would be ignored by the in-place call (send_recv_buf "
                    "was passed); remove it",
                )

    for k in required:
        if isinstance(k, tuple):  # any-of group
            if not any(kk in pack for kk in k):
                raise MissingParameterError(
                    op_name, " | ".join(kk.value for kk in k)
                )
        elif k not in pack:
            raise MissingParameterError(op_name, k.value)
    return pack
