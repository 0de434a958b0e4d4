"""Ring-collective wrappers: the CUDA kernels on CUDA tensors, the plain
versions on CPU tensors.

Every wrapper takes the stacked layout of ``ref.py``: ``rings``
independent rings of ``p`` ranks, ring ``b``'s rank ``r`` at row
``b*p + r``.  For a CUDA tensor it launches its kernel from
``csrc/ring_collectives.cu`` (built with nvcc at first use, bound through
ctypes) or raises; it never falls back to the plain version.  For a CPU
tensor it computes the plain version.  ``force_ref=True`` computes the
plain version on any device; ``chip_smoke.py`` and the tests use it to
hold a kernel against its plain version, and the transports never set it.
Each kernel wrapper counts its launches in ``<wrapper>.launches``.

* :func:`ring_reduce_scatter` — B1, ``(rings*p, p, ...) -> (rings*p, ...)``
* :func:`ring_allgather` — B2, ``(rings*p, ...) -> (rings*p, p, ...)``
* :func:`ring_allreduce` — B3, B1 then B2 through ``ref.compose_allreduce``
* :func:`ring_alltoall` — B4, ``(rings*p, p, ...) -> (rings*p, p, ...)``
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from ..build import load
from . import ref

__all__ = [
    "SOURCE",
    "ring_reduce_scatter",
    "ring_allgather",
    "ring_allreduce",
    "ring_alltoall",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ring_collectives.cu"
_DTYPES = {
    torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3,
    torch.int32: 4, torch.int64: 5,
}
_ENTRIES = ("ring_reduce_scatter", "ring_allgather", "ring_alltoall")


@functools.cache
def _library():
    """The bound C entry points, built and loaded once per process."""
    lib = load(SOURCE)
    for name in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _plain(xs) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel); anything else raises."""
    if xs.device.type == "cpu":
        return True
    if xs.device.type != "cuda":
        raise ValueError(f"ring collectives: no kernel for device "
                         f"{xs.device}")
    return False


def _check(name, xs, rings, square):
    """Validate a CUDA input; returns (p, m) of the stacked layout."""
    if xs.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {xs.dtype} not in "
                         f"{sorted(str(d)[6:] for d in _DTYPES)}")
    if not xs.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    rows = xs.shape[0] if xs.dim() else 0
    if rings < 1 or rows == 0 or rows % rings:
        raise ValueError(f"{name}: leading dim {rows} is not a positive "
                         f"multiple of rings={rings}")
    p = rows // rings
    rest = tuple(xs.shape[2:] if square else xs.shape[1:])
    if square and (xs.dim() < 2 or xs.shape[1] != p):
        raise ValueError(f"{name}: expected (rings*p, p, ...) with p={p}; "
                         f"got {tuple(xs.shape)}")
    if p > 65535 or rings > 65535:
        raise ValueError(f"{name}: p={p}, rings={rings} exceed the grid "
                         "limit 65535")
    return p, math.prod(rest)


def _launch(name, xs, out, rings, p, m):
    fn = getattr(_library(), name)
    with torch.cuda.device(xs.device):
        err = fn(xs.data_ptr(), out.data_ptr(), rings, p, m,
                 _DTYPES[xs.dtype],
                 torch.cuda.current_stream(xs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def ring_reduce_scatter(xs, *, rings=1, force_ref=False):
    """B1: ``out[b*p + r]`` = left fold of ``xs[b*p + (r+1+k) % p, r]`` for
    k = 0..p-1, rounded to the dtype after every add."""
    if force_ref or _plain(xs):
        return ref.reduce_scatter_stacked_ref(xs, rings)
    p, m = _check("ring_reduce_scatter", xs, rings, square=True)
    out = torch.empty((xs.shape[0],) + tuple(xs.shape[2:]), dtype=xs.dtype,
                      device=xs.device)
    if m:
        _launch("ring_reduce_scatter", xs, out, rings, p, m)
        ring_reduce_scatter.launches += 1
    return out


def ring_allgather(xs, *, rings=1, force_ref=False):
    """B2: ``out[b*p + r, j] = xs[b*p + j]``."""
    if force_ref or _plain(xs):
        return ref.allgather_stacked_ref(xs, rings)
    p, m = _check("ring_allgather", xs, rings, square=False)
    out = torch.empty((xs.shape[0], p) + tuple(xs.shape[1:]), dtype=xs.dtype,
                      device=xs.device)
    if m:
        _launch("ring_allgather", xs, out, rings, p, m)
        ring_allgather.launches += 1
    return out


def ring_alltoall(xs, *, rings=1, force_ref=False):
    """B4: ``out[b*p + r, j] = xs[b*p + j, r]``."""
    if force_ref or _plain(xs):
        return ref.alltoall_stacked_ref(xs, rings)
    p, m = _check("ring_alltoall", xs, rings, square=True)
    out = torch.empty_like(xs)
    if m:
        _launch("ring_alltoall", xs, out, rings, p, m)
        ring_alltoall.launches += 1
    return out


def ring_allreduce(xs, *, rings=1, force_ref=False):
    """B3: every rank's ring allreduce of its ``(...)`` payload — B1 on the
    zero-padded ``(rings*p, p, chunk)`` blocks, then B2 on the reduced
    chunks (one launch of each), unpadded."""
    # B1 and B2 (or their plain versions) reject a bad stacked layout.
    return ref.compose_allreduce(
        xs, xs.shape[0] // rings,
        lambda blocks: ring_reduce_scatter(blocks, rings=rings,
                                           force_ref=force_ref),
        lambda mine: ring_allgather(mine, rings=rings, force_ref=force_ref),
    )


ring_reduce_scatter.launches = 0
ring_allgather.launches = 0
ring_alltoall.launches = 0
