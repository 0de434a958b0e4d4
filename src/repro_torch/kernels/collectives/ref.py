"""Plain PyTorch versions of the ring collectives (DESIGN.md §7).

The port's counterparts of the JAX package's stacked oracles
(``kernels/collectives/ref.py:189-231``), written over the stacked rank
dimension: ``rings`` independent rings of ``p`` ranks, ring ``b``'s rank
``r`` at row ``b*p + r`` (the layout of a ``split_by(block=p)``
communicator; ``rings=1`` is the flat one).  They are the plain versions
the CUDA kernels in ``csrc/ring_collectives.cu`` are held against, bit for
bit, and what the wrappers in ``ops.py`` compute for a CPU tensor.

The reduce-scatter keeps the ring's fold order: chunk ``r`` starts at
rank ``(r+1) % p`` and adds sources ``r+1, r+2, ..., r`` (mod p) left to
right, each add rounded to the payload's dtype.

The ``device_*`` functions are the per-device forms, run by every rank of
a :func:`~repro_torch.core.shard.shard_map` on its own tensor: the
counterparts of the JAX package's SPMD ring references
(``kernels/collectives/ref.py:105`` ``ring_allgather`` and ``:128``
``ring_reduce_scatter``), step for step in the arrival and fold order of
the per-device kernels B8a and B8b (``csrc/device_ring.cu``).  ``ring`` is
this rank's side of the rendezvous (``core.shard.Rank``): ``rank``,
``size``, ``share(t)`` (every rank's ``t``, readable on this rank's
stream) and ``barrier()`` (every rank's stream has reached this point).
A step pushes into the right neighbour's buffer, then all ranks meet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "allreduce_chunk",
    "compose_allreduce",
    "allgather_stacked_ref",
    "reduce_scatter_stacked_ref",
    "allreduce_stacked_ref",
    "alltoall_stacked_ref",
    "device_allgather_ref",
    "device_reduce_scatter_ref",
]


def allreduce_chunk(n: int, p: int) -> int:
    """Per-rank chunk length of the ring-allreduce composition.  Every
    implementation (kernels, plain versions, the JAX package) must chunk
    identically or the bitwise contract breaks — this is the single
    definition."""
    return max(1, math.ceil(n / p))


def compose_allreduce(xs, p: int, reduce_scatter_fn, allgather_fn):
    """Ring allreduce = reduce-scatter + allgather over each rank's
    flattened payload, zero-padded to ``p`` equal chunks.

    ``xs`` is the stacked ``(rings*p, ...)`` payload of every rank;
    ``reduce_scatter_fn`` maps ``(rings*p, p, chunk)`` blocks to
    ``(rings*p, chunk)`` and ``allgather_fn`` maps those back to
    ``(rings*p, p, chunk)``."""
    rows = xs.shape[0]
    flat = xs.reshape(rows, -1)
    n = flat.shape[1]
    chunk = allreduce_chunk(n, p)
    if p * chunk != n:
        flat = F.pad(flat, (0, p * chunk - n))
    mine = reduce_scatter_fn(flat.reshape(rows, p, chunk))
    full = allgather_fn(mine).reshape(rows, p * chunk)
    return full[:, :n].reshape(xs.shape)


def _ring_rows(xs, rings: int, lead: int):
    """``xs`` as (rings, p, ...) with ``p = xs.shape[0] // rings``; ``lead``
    names the kernel whose layout is checked."""
    rows = xs.shape[0]
    if rings < 1 or rows % rings:
        raise ValueError(f"{lead}: leading dim {rows} is not a multiple of "
                         f"rings={rings}")
    return xs.reshape((rings, rows // rings) + tuple(xs.shape[1:]))


def allgather_stacked_ref(xs, rings: int = 1):
    """``(rings*p, ...)`` -> ``(rings*p, p, ...)``: every rank of a ring
    receives the rows of all ``p`` ranks of its ring."""
    X = _ring_rows(xs, rings, "allgather")
    p = X.shape[1]
    out = X.unsqueeze(1).expand((rings, p) + tuple(X.shape[1:]))
    return out.contiguous().reshape((rings * p, p) + tuple(X.shape[2:]))


def reduce_scatter_stacked_ref(xs, rings: int = 1):
    """``(rings*p, p, ...)`` -> ``(rings*p, ...)``: ``out[r]`` is the sum
    of ``xs[:, r]`` over the ring's ranks, folded left in ring source
    order ``r+1, r+2, ..., r`` (mod p)."""
    X = _ring_rows(xs, rings, "reduce_scatter")
    p = X.shape[1]
    if X.dim() < 3 or X.shape[2] != p:
        raise ValueError(f"reduce_scatter: expected (rings*p, p, ...) with "
                         f"p={p}; got {tuple(xs.shape)}")
    outs = []
    for r in range(p):
        acc = X[:, (r + 1) % p, r]
        for k in range(1, p):
            acc = acc + X[:, (r + 1 + k) % p, r]
        outs.append(acc)
    out = torch.stack(outs, 1)
    return out.reshape((rings * p,) + tuple(X.shape[3:]))


def allreduce_stacked_ref(xs, rings: int = 1):
    """``(rings*p, ...)`` -> ``(rings*p, ...)``: each rank's ring allreduce
    (reduce-scatter in ring order, then allgather, chunked like the
    kernels)."""
    p = _ring_rows(xs, rings, "allreduce").shape[1]
    return compose_allreduce(
        xs, p,
        lambda blocks: reduce_scatter_stacked_ref(blocks, rings),
        lambda mine: allgather_stacked_ref(mine, rings),
    )


def alltoall_stacked_ref(xs, rings: int = 1):
    """``(rings*p, p, ...)`` buckets by (source, destination) ->
    ``(rings*p, p, ...)`` by (destination, source): ``out[r, j] = xs[j, r]``
    within each ring."""
    X = _ring_rows(xs, rings, "alltoall")
    p = X.shape[1]
    if X.dim() < 3 or X.shape[2] != p:
        raise ValueError(f"alltoall: expected (rings*p, p, ...) with p={p}; "
                         f"got {tuple(xs.shape)}")
    return X.transpose(1, 2).contiguous().reshape(xs.shape)


def device_allgather_ref(x, ring):
    """This rank's ``(...)`` -> ``(p, ...)``, slot ``j`` holding rank
    ``j``'s ``x``.  Step ``s`` pushes slot ``(me - s) % p`` into the right
    neighbour's output at the same slot: the chunk of the s-th left
    neighbour, which arrived at step ``s - 1``."""
    p, me = ring.size, ring.rank
    if p == 1:
        return x[None].clone()
    out = torch.empty((p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[me] = x
    right = ring.share(out)[(me + 1) % p]
    for s in range(p - 1):
        src = (me - s) % p
        right[src].copy_(out[src])
        ring.barrier()
    return out


def device_reduce_scatter_ref(x, ring):
    """This rank's ``(p, ...)`` contributions by destination -> its reduced
    ``(...)`` chunk.  Step 0 sends chunk ``(me - 1) % p`` of ``x`` to the
    right neighbour's receive slot 0; step ``s`` adds chunk
    ``(me - 1 - s) % p`` to the partial that arrived in slot
    ``(s - 1) % 2`` and sends the sum on to slot ``s % 2`` (the last step
    keeps it).  Chunk ``j`` thus folds sources ``j+1, ..., j``: B1's and
    the JAX reference's order."""
    p, me = ring.size, ring.rank
    if x.dim() == 0 or x.shape[0] != p:
        raise ValueError(f"device reduce_scatter: expected ({p}, ...); got "
                         f"{tuple(x.shape)}")
    if p == 1:
        return x[0].clone()
    buf = torch.empty((2,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    right = ring.share(buf)[(me + 1) % p]
    right[0].copy_(x[(me - 1) % p])
    ring.barrier()
    for s in range(1, p):
        acc = buf[(s - 1) % 2] + x[(me - 1 - s) % p]
        if s == p - 1:
            return acc
        right[s % 2].copy_(acc)
        ring.barrier()

