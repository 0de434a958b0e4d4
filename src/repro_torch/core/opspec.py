"""Declarative collective op specs + the single lowering engine.

Every collective is described ONCE by an :class:`OpSpec` — its
named-parameter interface and a ``lower`` function that does only the
data movement.  One engine, :func:`execute`, does the rest for every op:
parameter-pack collection and validation, transport resolution, result
packing, and the auto-generated non-blocking ``i*`` variant (paper
§III-E).  Specs are attached to a class with :func:`attach_ops`.

Ported rows so far: ``allreduce`` and ``allgather`` (the JAX package's
``communicator.py:838`` and ``:751``).  The engine-level hooks of the JAX
package that belong to later slices accept only ``None`` here:
``compression(...)`` and ``deterministic(...)`` (ROADMAP A5) and
``plan(...)`` (ROADMAP A7); the trace-time IR recorder (A7) has no hook
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

from . import params as kp
from .errors import KampingError
from .nonblocking import NonBlockingResult
from .params import ParamKind as K
from .params import collect_params
from .result import make_result
from .transports import resolve_transport

__all__ = ["OpSpec", "Lowering", "OP_TABLE", "attach_ops", "execute"]

# Method-name -> spec, across the communicator and every plugin.
OP_TABLE: Dict[str, "OpSpec"] = {}

# Engine-level parameters whose only ported value is None, with the
# ROADMAP item that ports the rest.
_NONE_ONLY = {
    K.COMPRESSION: "compression codecs are not ported yet (ROADMAP A5)",
    K.DETERMINISTIC: "deterministic reduction is not ported yet (ROADMAP A5)",
    K.PLAN: "the cost-model planner is not ported yet (ROADMAP A7)",
}


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One row of the collective table."""

    name: str
    lower: Callable[["Lowering"], Any]
    required: Tuple = ()
    accepted: Tuple = ()
    in_place_ignored: Tuple = ()
    # Reduction rows additionally accept compression(...) and
    # deterministic(...) (None only, see module docstring).
    compressible: bool = False
    deterministic: bool = False
    doc: str = ""


class Lowering:
    """Per-call context handed to a spec's ``lower``: the collected pack,
    the topology, and the transport-aware collective helpers."""

    def __init__(self, comm, spec: OpSpec, pack):
        self.comm = comm
        self.spec = spec
        self.pack = pack
        for kind, why in _NONE_ONLY.items():
            param = pack.get(kind)
            if param is not None and param.value is not None:
                raise NotImplementedError(f"kamping.{spec.name}: {why}")
        tparam = pack.get(K.TRANSPORT)
        self.transport = resolve_transport(
            comm, tparam.value if tparam is not None else None
        )

    @property
    def p(self) -> int:
        """Communicator size (the group size on a split communicator)."""
        return self.comm.size()

    def rank(self):
        return self.comm.rank()

    def has(self, kind) -> bool:
        return kind in self.pack

    def value(self, kind, default=None):
        p = self.pack.get(kind)
        return p.value if p is not None else default

    def all_gather(self, x, tiled=True):
        return self.transport.all_gather(self.comm, x, tiled=tiled)

    def reduce(self, x, op_param):
        return self.comm._reduce_impl(x, op_param, transport=self.transport)


def execute(comm, spec: OpSpec, args, kw=None):
    """Collect the pack, lower the op, pack the result — for every op."""
    if kw:
        raise TypeError(
            f"kamping.{spec.name}: unexpected keyword argument(s) "
            f"{sorted(kw)}; collective arguments are the named parameter "
            "objects (send_buf(...), op(...), ...)"
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
    low = Lowering(comm, spec, pack)
    buf = spec.lower(low)
    return make_result([("recv_buf", buf)])


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
        setattr(cls, "i" + spec.name, _make_nb_method(spec))
    return cls
