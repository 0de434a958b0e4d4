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

The per-device wrappers run on one rank of a
:func:`~repro_torch.core.shard.shard_map` (``ring`` is that rank's
``core.shard.Rank``) and launch the kernels of ``csrc/device_ring.cu``,
one launch per rank per call, on the rank's stream:

* :func:`device_ring_allgather` — B8a, this rank's ``(...)`` -> ``(p, ...)``
* :func:`device_ring_reduce_scatter` — B8b, ``(p, ...)`` -> ``(...)``
* :func:`device_ring_allreduce` — B8b then B8a through
  ``ref.compose_allreduce``

Before a launch the ranks meet to exchange their buffers' pointers; after
it they meet again, so that every rank's kernel is launched before any
rank thread goes on (a device-wide synchronising call in between, a
``cudaFree`` say, would wait for a kernel that spins on one not launched
yet).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
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
    "DEVICE_SOURCE",
    "device_ring_allgather",
    "device_ring_reduce_scatter",
    "device_ring_allreduce",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ring_collectives.cu"
DEVICE_SOURCE = SOURCE.parent / "device_ring.cu"
# Bound of every spin of the device ring kernels: a rank whose neighbour
# has not arrived after this long writes its status word and gives up.
SPIN_TIMEOUT_S = 5.0
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


_DEVICE_LOCK = threading.Lock()  # build once; count launches exactly
_DEVICE_LIB = None


def _device_library():
    """The per-device ring entry points, built, loaded and every kernel
    preloaded (see csrc/device_ring.cu) once per process; the rank threads
    call this together."""
    global _DEVICE_LIB
    with _DEVICE_LOCK:
        if _DEVICE_LIB is None:
            lib = load(DEVICE_SOURCE)
            lib.device_ring_preload.argtypes = []
            lib.device_ring_preload.restype = ctypes.c_int
            err = lib.device_ring_preload()
            if err != 0:
                raise RuntimeError(f"device ring kernels failed to load: "
                                   f"cudaError {err}")
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            ring = [i32, i32, i32, i32, ptr, ptr, ptr, i64, ctypes.c_uint,
                    i64, ptr]
            lib.device_ring_allgather.argtypes = [ptr, ptr, ptr, i64] + ring
            lib.device_ring_reduce_scatter.argtypes = [ptr, ptr, ptr, ptr,
                                                       i64, i32] + ring
            for fn in (lib.device_ring_allgather,
                       lib.device_ring_reduce_scatter):
                fn.restype = ctypes.c_int
            _DEVICE_LIB = lib
        return _DEVICE_LIB


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


def _device_call(name, ring, x, mine, own, launch):
    """One per-device kernel call of this rank: meet the other ranks with
    ``mine`` (the buffer the left neighbour writes into), ``x``'s shape and
    dtype, and whether all of ``own`` (this rank's buffers) is 16-byte
    aligned; launch ``launch(lib, right's buffer, ring args)`` on this
    rank's stream, and meet again once every rank has launched.  The kernel
    takes its 16-byte path only if every rank's buffers allow it, so all
    ranks cut the same tiles."""
    lib = _device_library()
    epoch = ring.next_epoch()
    aligned = all(t.data_ptr() % 16 == 0 for t in own)
    posts = ring.exchange((mine, (tuple(x.shape), x.dtype, epoch), aligned))
    if len({meta for _, meta, _ in posts}) != 1:
        raise ValueError(f"{name}: the ranks called with different shapes, "
                         f"dtypes or call counts: "
                         f"{[meta for _, meta, _ in posts]}")
    vec = int(all(a for _, _, a in posts))
    p, me = ring.size, ring.rank
    right = posts[(me + 1) % p][0]
    stream = torch.cuda.current_stream(x.device)
    right.record_stream(stream)  # this rank's kernel writes into it
    sems = [ring.sem(r).data_ptr() for r in (me, (me - 1) % p, (me + 1) % p)]
    err = 0
    try:
        if x.numel():
            with torch.cuda.device(x.device):
                err = launch(lib, right, [
                    vec, p, me, ring.blocks, *sems, ring.blocks, epoch,
                    int(SPIN_TIMEOUT_S * 1e9), stream.cuda_stream])
    finally:
        ring.exchange(None)  # every rank has launched
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return bool(x.numel())


def _count(fn):
    with _DEVICE_LOCK:
        fn.launches += 1


def _check_local(name, x, ring, dtypes=None):
    """Validate this rank's CUDA input."""
    if dtypes is not None and x.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {x.dtype} not in "
                         f"{sorted(str(d)[6:] for d in dtypes)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device != ring.device:
        raise ValueError(f"{name}: input on {x.device}, but the ranks run "
                         f"on {ring.device}")


def device_ring_allgather(x, ring, *, force_ref=False):
    """B8a: this rank's ``(...)`` -> ``(p, ...)``, slot ``j`` rank ``j``'s
    ``x`` (any dtype: the kernel moves bytes)."""
    if ring.size == 1 or force_ref or _plain(x):
        return ref.device_allgather_ref(x, ring)
    _check_local("device_ring_allgather", x, ring)
    out = torch.empty((ring.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)

    def launch(lib, right, args):
        return lib.device_ring_allgather(
            x.data_ptr(), out.data_ptr(), right.data_ptr(),
            x.numel() * x.element_size(), *args)

    if _device_call("device_ring_allgather", ring, x, out, (x, out),
                    launch):
        _count(device_ring_allgather)
    return out


def device_ring_reduce_scatter(x, ring, *, force_ref=False):
    """B8b: this rank's ``(p, ...)`` contributions by destination -> its
    ``(...)`` chunk, folded in sources ``me+1, ..., me`` like B1."""
    if ring.size == 1 or force_ref or _plain(x):
        return ref.device_reduce_scatter_ref(x, ring)
    p = ring.size
    _check_local("device_ring_reduce_scatter", x, ring, _DTYPES)
    if x.dim() == 0 or x.shape[0] != p:
        raise ValueError(f"device_ring_reduce_scatter: expected ({p}, ...); "
                         f"got {tuple(x.shape)}")
    m = math.prod(x.shape[1:])
    out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    buf = torch.empty((2, m), dtype=x.dtype, device=x.device)

    def launch(lib, right, args):
        return lib.device_ring_reduce_scatter(
            x.data_ptr(), out.data_ptr(), buf.data_ptr(), right.data_ptr(),
            m, _DTYPES[x.dtype], *args)

    if _device_call("device_ring_reduce_scatter", ring, x, buf,
                    (x, out, buf), launch):
        _count(device_ring_reduce_scatter)
    return out


def device_ring_allreduce(x, ring):
    """This rank's sum allreduce: B8b on its zero-padded ``(p, chunk)``
    blocks, then B8a on its reduced chunk (one launch of each), chunked
    exactly as B3 and the JAX package."""
    return ref.compose_allreduce(
        x.unsqueeze(0), ring.size,
        lambda blocks: device_ring_reduce_scatter(blocks[0], ring)[None],
        lambda mine: device_ring_allgather(mine[0], ring)[None],
    )[0]


ring_reduce_scatter.launches = 0
ring_allgather.launches = 0
ring_alltoall.launches = 0
device_ring_allgather.launches = 0
device_ring_reduce_scatter.launches = 0
