"""Error handling and leveled assertions (paper §III-G).

KaMPIng catches usage errors at *compile time* whenever possible and uses
leveled runtime assertions, some of which require additional communication.
In this PyTorch port "compile time" is *Python time before launch*: every
check that raises a Python exception happens before any collective runs —
the analogue of the paper's ``static_assert`` + human-readable diagnostics.

Runtime assertions are grouped in levels:

* ``NONE``    — no staged checks at all (release mode).
* ``LIGHT``   — cheap local checks (e.g. count non-negativity).
* ``NORMAL``  — local invariant checks (e.g. counts fit capacity).
* ``HEAVY``   — checks requiring *additional communication* (e.g. global
  send/recv count matching), mirroring the paper's communication-level
  assertion tier.

Levels are orderable; a check is staged iff its level <= the active level.
"""
from __future__ import annotations

import enum
import os

__all__ = [
    "KampingError",
    "MissingParameterError",
    "ParameterConflictError",
    "UnsupportedParameterError",
    "PendingRequestError",
    "MovedBufferError",
    "AssertionLevel",
    "assertion_level",
    "set_assertion_level",
    "check_enabled",
]


class KampingError(Exception):
    """Base class for all trace-time errors raised by the communicator."""


class MissingParameterError(KampingError, TypeError):
    """A required named parameter was not supplied.

    The message names the missing parameter and the operation — the JAX
    analogue of the paper's readable compile-time diagnostics.
    """

    def __init__(self, op: str, param: str, hint: str = ""):
        msg = (
            f"kamping.{op}: missing required parameter '{param}'. "
            f"Pass it as `{param}(...)`."
        )
        if hint:
            msg += f" Hint: {hint}"
        super().__init__(msg)


class ParameterConflictError(KampingError, TypeError):
    def __init__(self, op: str, param: str, why: str = "given more than once"):
        super().__init__(f"kamping.{op}: parameter '{param}' {why}.")


class UnsupportedParameterError(KampingError, TypeError):
    def __init__(self, op: str, param: str, allowed):
        allowed_s = ", ".join(sorted(allowed))
        super().__init__(
            f"kamping.{op}: parameter '{param}' is not accepted by this "
            f"operation (it would be silently ignored by the underlying "
            f"call). Accepted parameters: {allowed_s}."
        )


class PendingRequestError(KampingError, RuntimeError):
    """Result of a non-blocking operation accessed before ``wait()``."""


class MovedBufferError(KampingError, RuntimeError):
    """A buffer moved into a non-blocking call was used before completion."""


class AssertionLevel(enum.IntEnum):
    NONE = 0
    LIGHT = 1
    NORMAL = 2
    HEAVY = 3  # assertions involving additional communication


_level = AssertionLevel[os.environ.get("KAMPING_ASSERTION_LEVEL", "NORMAL").upper()]


def assertion_level() -> AssertionLevel:
    return _level


def set_assertion_level(level) -> AssertionLevel:
    """Set the global assertion level; returns the previous one."""
    global _level
    prev = _level
    if isinstance(level, str):
        level = AssertionLevel[level.upper()]
    _level = AssertionLevel(level)
    return prev


def check_enabled(level: AssertionLevel) -> bool:
    return _level >= level
