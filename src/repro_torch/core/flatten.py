"""``with_flattened`` — the paper's BFS helper (§IV-B, Fig. 9).

Flattens a destination->messages mapping into the contiguous bucketed
layout expected by ``alltoallv`` while also providing send counts.  Two
modes:

* **host mode** (dict of arrays or tensors, outside ``spmd``): exact
  ragged flatten, returns a ``(p, cap, ...)`` bucket tensor padded to the
  max bucket plus the exact counts — what irregular discrete algorithms
  (BFS, sample sort) use between steps.
* **per-rank mode** (``(n,)`` data + ``(n,)`` destination ranks inside
  ``spmd``): a sort-by-destination bucketization with a static per-peer
  capacity.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from . import params as kp

__all__ = ["with_flattened", "flatten_buckets", "bucketize_by_destination"]


class _FlattenedCall:
    """Callable wrapper mirroring ``with_flattened(...).call(lambda ...)``."""

    def __init__(self, buckets, counts):
        self.buckets = buckets
        self.counts = counts

    def call(self, fn: Callable):
        return fn(kp.send_buf(self.buckets), kp.send_counts(self.counts))

    def __iter__(self):
        return iter((self.buckets, self.counts))


def flatten_buckets(messages: Dict[int, Any], comm_size: int, pad_value=0):
    """Host-side ragged flatten: dict rank->array -> ((p,cap,...), counts)."""
    arrays = {}
    trailing = None
    dtype = None
    for r, v in messages.items():
        a = torch.as_tensor(v)
        arrays[int(r)] = a
        t = tuple(a.shape[1:])
        if trailing is None:
            trailing, dtype = t, a.dtype
        elif t != trailing:
            raise ValueError(
                f"with_flattened: inconsistent message trailing shapes "
                f"{t} vs {trailing}"
            )
    if trailing is None:
        trailing, dtype = (), torch.int32
    cap = max((a.shape[0] for a in arrays.values()), default=0)
    cap = max(cap, 1)  # zero-capacity buffers break collectives; keep 1 slot
    buckets = torch.full((comm_size, cap) + trailing, pad_value, dtype=dtype)
    counts = torch.zeros((comm_size,), dtype=torch.int32)
    for r, a in arrays.items():
        if not 0 <= r < comm_size:
            raise ValueError(f"with_flattened: destination {r} out of range")
        buckets[r, : a.shape[0]] = a
        counts[r] = a.shape[0]
    return buckets, counts


def bucketize_by_destination(data, dest_ranks, comm_size: int, capacity: int,
                             pad_value=0):
    """Per-rank bucketization: sort data by destination rank.

    ``data``: (n, ...); ``dest_ranks``: (n,) ints in [0, comm_size).
    Returns ``(p, capacity, ...)`` buckets + ``(p,)`` int32 counts.
    Elements beyond ``capacity`` for a peer are dropped (capacity-policy
    semantics — callers choose capacity via napkin math or grow_only
    asserts).  Every op has a vmap rule, so it runs per rank under
    ``spmd``.
    """
    data = torch.as_tensor(data)
    dest = torch.as_tensor(dest_ranks, device=data.device).to(torch.int64)
    n = data.shape[0]
    order = torch.argsort(dest, stable=True)
    sdata = data[order]
    sdest = dest[order]
    counts = torch.zeros((comm_size,), dtype=torch.int64,
                         device=data.device).scatter_add(
        0, sdest, torch.ones_like(sdest))
    displs = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=data.device) - displs[sdest]
    # past capacity -> the extra slot at the end, which is cut off
    flat_idx = torch.where(pos < capacity, sdest * capacity + pos,
                           comm_size * capacity)
    buckets = torch.full((comm_size * capacity + 1,) + tuple(data.shape[1:]),
                         pad_value, dtype=data.dtype, device=data.device)
    buckets = buckets.index_put((flat_idx,), sdata)
    buckets = buckets[:-1].reshape((comm_size, capacity)
                                   + tuple(data.shape[1:]))
    return buckets, torch.clamp(counts, max=capacity).to(torch.int32)


def with_flattened(messages, comm_size: int, **kw) -> _FlattenedCall:
    """Paper Fig. 9: ``with_flattened(frontier, comm.size()).call(...)``."""
    if isinstance(messages, dict):
        buckets, counts = flatten_buckets(messages, comm_size, **kw)
    else:
        raise TypeError(
            "with_flattened expects a dict rank->messages on the host path; "
            "inside spmd use bucketize_by_destination(...)"
        )
    return _FlattenedCall(buckets, counts)
