"""Safety for non-blocking communication (paper §III-E).

MPI returns a bare request handle and trusts the user not to touch buffers
until completion.  KaMPIng instead returns a *non-blocking result* that owns
both the request and the (moved) buffers; data is only accessible after
``wait()`` / a successful ``test()``.

Under PyTorch every launch is already asynchronous on the CUDA stream, so
the "request" has no device-side handle of its own — but the *safety
property* (no access to in-flight buffers) is enforced in Python, where all
user code runs.  A :class:`NonBlockingResult`:

* hides the operation's value until ``wait()`` is called,
* re-returns buffers that were ``move(...)``d into the call (ownership
  round-trip, zero copies — they are the same traced values),
* supports ``test()`` returning an optional-style ``(ready, value)``.

:class:`RequestPool` collects results for bulk completion (paper's request
pools), including a fixed-slot variant that bounds the number of in-flight
operations (the paper mentions this as work in progress — we implement it).
The pool speaks MPI's completion vocabulary — :meth:`RequestPool.waitall`
(MPI_Waitall), :meth:`RequestPool.testany` (MPI_Testany) — and is the
substrate of the communication–computation overlap engine
(the overlap engine of the JAX package, DESIGN.md §8).
"""
from __future__ import annotations

import weakref
from typing import Any, List, Optional, Sequence, Tuple

from .errors import KampingError, PendingRequestError

__all__ = ["NonBlockingResult", "RequestPool"]


class NonBlockingResult:
    """Owner of one in-flight operation's value (paper §III-E).

    Returned by every auto-generated ``i*`` collective.  The wrapped value
    is *inaccessible* until the request is completed exactly once with
    :meth:`wait` or :meth:`test`; buffers that were ``move(...)``d into the
    call ride along and are re-returned on completion (ownership
    round-trip).  ``op_name`` records the originating collective so
    double-completion diagnostics can name the ``i*`` call.
    """

    def __init__(self, value: Any, moved_params: Sequence = (),
                 op_name: str = ""):
        self._value = value
        self._moved = list(moved_params)
        self._completed = False
        self.op_name = op_name  # originating collective (i* variants)

    def __repr__(self):  # pragma: no cover - cosmetic
        state = "completed" if self._completed else "pending"
        op = f" {self.op_name}" if self.op_name else ""
        return f"<NonBlockingResult{op} {state}>"

    # -- paper API -----------------------------------------------------------
    def wait(self):
        """Complete the request and release the value (+ moved buffers)."""
        if self._completed:
            op = f" i{self.op_name}" if self.op_name else ""
            what = (
                "the value and the moved buffers were"
                if self._moved
                else "the value was"
            )
            raise PendingRequestError(
                f"non-blocking{op} result already completed: wait() / "
                f"test() complete a request exactly once; {what} already "
                "released by the first completion"
            )
        self._completed = True
        if self._moved:
            return (self._value, *(p.value for p in self._moved))
        return self._value

    def test(self):
        """Optional-style completion test.

        Stream-ordered model: completion is decided by the CUDA stream, so
        at the program level ``test()`` conservatively reports ready (any
        later read of the value is ordered after the work anyway).  Returns
        ``(True, value)``; after the value is taken the result is spent.
        """
        return True, self.wait()

    def cancel(self):
        """Complete the request *without* delivering its value.

        The ULFM drain path (DESIGN.md §15): after a device failure the
        in-flight value is garbage — the collective never completed on
        the failed ranks — so recovery marks the request spent and drops
        the value and the moved buffers.  Idempotent on an already
        completed request (returns ``False``); returns ``True`` when a
        pending request was actually cancelled.
        """
        if self._completed:
            return False
        self._completed = True
        self._value = None
        self._moved = []
        return True

    # -- safety --------------------------------------------------------------
    @property
    def value(self):
        raise PendingRequestError(
            "result of a non-blocking operation accessed before wait(); "
            "call .wait() (or .test()) to complete the request first"
        )

    @property
    def completed(self) -> bool:
        return self._completed


class RequestPool:
    """Bulk completion of non-blocking results (paper §III-E).

    Two flavours, selected at construction:

    * ``slots=None`` — the **unbounded** pool from the paper: requests
      accumulate until a bulk completion call drains them.
    * ``slots=k`` — the **fixed-slot** variant (the paper lists it as work
      in progress; we implement it): at most ``k`` requests are in flight.
      :meth:`submit` on a full pool first completes — and returns the value
      of — the *oldest* request, providing backpressure for pipelined
      communication loops (the overlap engine's ``max_inflight`` bound,
      DESIGN.md §8).  The evicted value is also stashed so a caller that
      tracks requests by handle can still retrieve it through
      :meth:`collect` (exactly once — whichever channel takes it first).
      The stash holds the evicted request *weakly*: a stashed value lives
      exactly as long as some caller still holds the handle that could
      ``collect`` it, so submit-only loops that consume :meth:`submit`'s
      return and drop the handle keep O(slots) memory, not O(N).

    Completion API, in MPI vocabulary:

    * :meth:`waitall` — complete every in-flight request in submission
      order (MPI_Waitall).  A drained pool is immediately reusable; a
      second ``waitall`` on an already-drained pool returns ``[]``.
    * :meth:`testany` — complete at most one request (MPI_Testany).  Under
      the trace-time completion model (see
      :meth:`NonBlockingResult.test`) the oldest in-flight request always
      reports ready; on an empty pool this returns
      ``(True, None, None)`` — MPI's ``flag=true, index=MPI_UNDEFINED``
      convention for "no active requests".
    * :meth:`collect` — complete one *specific* submitted request by
      handle (the targeted MPI_Wait within a pool); used by callers that
      interleave unrelated requests in one pool (MoE dispatch/combine).

    Indices returned by :meth:`testany` are stable *submission sequence
    numbers* (0 for the first request ever submitted, 1 for the next, …),
    not positions in the live queue — the analogue of an index into MPI's
    request array.
    """

    def __init__(self, slots: Optional[int] = None):
        if slots is not None and slots <= 0:
            raise KampingError("RequestPool: slots must be positive or None")
        self._slots = slots
        self._pending: List[Tuple[int, NonBlockingResult]] = []
        # Evicted-by-backpressure values, weakly keyed by the result object
        # itself: identity-hashed (a recycled id can never alias a dead
        # request into a stale value) and auto-dropped once no caller holds
        # a handle that could still collect() it.
        self._drained = weakref.WeakKeyDictionary()
        self._seq = 0

    def submit(self, result: NonBlockingResult):
        """Add a request; returns the evicted request's value (or None).

        On a full fixed-slot pool the oldest in-flight request is completed
        to make room (backpressure).  Its value is returned *and* stashed
        for :meth:`collect`; it is released through whichever channel takes
        it first.
        """
        evicted = None
        if self._slots is not None and len(self._pending) >= self._slots:
            _, oldest = self._pending.pop(0)
            evicted = oldest.wait()
            self._drained[oldest] = evicted
        self._pending.append((self._seq, result))
        self._seq += 1
        return evicted

    def waitall(self) -> List[Any]:
        """Complete every in-flight request; values in submission order
        (MPI_Waitall).  Values already handed out by fixed-slot eviction
        are not repeated, and stashed evicted values belonging to callers
        that still hold their handles survive for their ``collect`` (a
        shared pool's ``waitall`` must not destroy other owners' values).
        The pool is empty (and reusable) afterwards."""
        out = [r.wait() for _, r in self._pending]
        self._pending.clear()
        return out

    # Original spelling, kept as an alias of the MPI-vocabulary name.
    wait_all = waitall

    def testany(self) -> Tuple[bool, Optional[int], Optional[Any]]:
        """Complete at most one request (MPI_Testany).

        Returns ``(flag, index, value)``: on an empty pool
        ``(True, None, None)`` (MPI's flag=true / MPI_UNDEFINED); otherwise
        the oldest in-flight request is completed and removed, and
        ``index`` is its submission sequence number.
        """
        if not self._pending:
            return True, None, None
        seq, r = self._pending.pop(0)
        return True, seq, r.wait()

    def collect(self, result: NonBlockingResult):
        """Complete one specific submitted request and remove it.

        If backpressure already evicted it, the stashed value is released
        (once).  Raises :class:`KampingError` for a request this pool does
        not hold.
        """
        for i, (_, r) in enumerate(self._pending):
            if r is result:
                del self._pending[i]
                return result.wait()
        if result in self._drained:
            return self._drained.pop(result)
        raise KampingError(
            "RequestPool.collect: request is not held by this pool "
            "(never submitted, or already completed and collected)"
        )

    def abort(self) -> int:
        """Cancel every in-flight request without delivering values.

        The ULFM failure-drain verb (DESIGN.md §15): when a rank dies
        mid-collective the in-flight bucket values are garbage, so the
        recovery path *drains* the pool — each pending request is marked
        spent (its value and moved buffers dropped), the eviction stash
        is cleared, and the pool is immediately reusable for the
        replayed step on the shrunken communicator.  Returns the number
        of requests that were actually in flight (the count the
        fault-tolerance events report as drained buckets).
        """
        n = 0
        for _, r in self._pending:
            if r.cancel():
                n += 1
        self._pending.clear()
        self._drained = weakref.WeakKeyDictionary()
        return n

    def __len__(self):
        """Number of requests currently in flight."""
        return len(self._pending)
