"""Result objects returned by communicator calls (paper §III-B).

The receive buffer is always implicitly returned; every explicitly
requested out-parameter is added to the result.  The object supports

* attribute access (``r.recv_counts``),
* C++ structured-bindings-style unpacking (``buf, counts = comm.allgatherv(...)``)
  — out-parameters unpack in the order they were requested, receive buffer
  first,
* collapsing to the bare receive buffer when nothing else was requested
  (so ``v = comm.allgatherv(send_buf(x))`` is a one-liner, Fig. 1).
"""
from __future__ import annotations

from typing import Any, Dict, List


class Result:
    """Ordered bag of named output values."""

    def __init__(self, fields: List[str], values: Dict[str, Any]):
        self._fields = list(fields)
        self._values = dict(values)

    def __getattr__(self, name):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(
            f"result has no field '{name}'; available: {list(values)} "
            f"(request it with {name}_out() on the call)"
        )

    def extract(self, name):
        """Move a field out of the result (paper's extract_* methods)."""
        return self._values.pop(name)

    def __iter__(self):
        return iter(self._values[f] for f in self._fields)

    def __len__(self):
        return len(self._fields)

    def fields(self):
        return tuple(self._fields)

    def __contains__(self, name) -> bool:
        return name in self._values

    def items(self):
        """(field, value) pairs in request order (receive buffer first)."""
        return tuple((f, self._values[f]) for f in self._fields)

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Result({', '.join(self._fields)})"


def make_result(ordered_pairs):
    """Build a Result; collapse to the bare value when only one field."""
    fields = [k for k, _ in ordered_pairs]
    values = {k: v for k, v in ordered_pairs}
    if len(fields) == 1:
        return values[fields[0]]
    return Result(fields, values)
