"""RG-LRU scan wrapper: the CUDA kernel on CUDA tensors, the plain version
on CPU tensors.

For a CUDA tensor :func:`lru_scan` launches ``csrc/lru_scan.cu`` (built
with nvcc at first use, bound through ctypes) or raises; it never falls
back to the plain version; under grad mode it refuses CUDA inputs that
require grad (no backward yet, ROADMAP A2).  For a CPU tensor it computes
:func:`~.ref.lru_scan_ref`.  ``force_ref=True`` computes the plain version
on any device; ``chip_smoke.py`` uses it to hold the kernel against its
plain version, and the serve path never sets it.  ``lru_scan.launches``
counts kernel launches.  Any S and any C are taken.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load
from ..guard import refuse_grad
from .ref import lru_scan_ref, lru_sequential_ref

__all__ = ["lru_scan", "lru_scan_ref", "lru_sequential_ref", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"
CHUNK = 64  # time steps per (channel, chunk) thread of the kernel


@functools.cache
def _library():
    """The bound C entry point, built and loaded once per process."""
    fn = load(SOURCE).lru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, b):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"lru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be (B, S, C)")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"lru_scan: dtypes a {a.dtype}, b {b.dtype}; "
                         "expected float32")
    if a.device != b.device:
        raise ValueError("lru_scan: a and b on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("lru_scan: a and b must be contiguous")


def lru_scan(a, b, *, force_ref=False):
    """a, b: (B, S, C) fp32 -> h: (B, S, C) fp32, h_t = a_t h_{t-1} + b_t
    from h_0 = 0."""
    if force_ref or a.device.type == "cpu":
        return lru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"lru_scan: no kernel for device {a.device}")
    refuse_grad("lru_scan", a, b)
    _check(a, b)
    B, S, C = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    nsum = (S + CHUNK - 1) // CHUNK - 1
    sums = torch.empty((2, B, max(nsum, 1), C), dtype=torch.float32,
                       device=a.device)
    fn = _library()
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), sums[0].data_ptr(),
                 sums[1].data_ptr(), B, S, C, CHUNK,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed: cudaError {err}")
    lru_scan.launches += 1
    return h


lru_scan.launches = 0
