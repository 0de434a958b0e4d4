"""RG-LRU scan wrapper: the CUDA kernel on CUDA tensors, the plain version
on CPU tensors.

For a CUDA tensor :func:`lru_scan` launches ``csrc/lru_scan.cu`` (built
with nvcc at first use, bound through ctypes) or raises; it never falls
back to the plain version; under grad mode it refuses CUDA inputs that
require grad (no backward yet, ROADMAP A2).  For a CPU tensor it computes
:func:`~.ref.lru_scan_ref`.  ``force_ref=True`` computes the plain version
on any device; ``chip_smoke.py`` uses it to hold the kernel against its
plain version, and the serve path never sets it.  ``lru_scan.launches``
counts kernel calls (one a call; each is a memset of the look-back
workspace and the one-pass kernel).  Any S and any C are taken.

:func:`plan` picks the kernel's chunk length and workspace for a shape;
:func:`use_vec` whether it may copy 16 bytes at a time.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from ..build import load
from ..guard import refuse_grad
from .ref import lru_chunked_ref, lru_scan_ref, lru_sequential_ref

__all__ = ["lru_scan", "lru_scan_ref", "lru_sequential_ref",
           "lru_chunked_ref", "plan", "use_vec", "Plan", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "lru_scan.cu"
# Time steps a chunk, at every S.  The carries round at chunk boundaries,
# so h's bits depend on it (and on nothing else of the launch): a new
# value is a new arithmetic, to be held to the plain version again.
CHUNK = 64
TILE = 32  # channels a block, kTile in the source
MAX_GRID = 2**31 - 1  # CUDA's limit on gridDim.x


class Plan(NamedTuple):
    """One call's launch: ``T`` steps a chunk, ``blocks`` tiles of
    ``TILE`` channels (one block each), ``ws_bytes`` of workspace (each
    chunk's aggregate and inclusive carry by channel, and the tile
    counter)."""
    T: int
    nchunks: int
    blocks: int
    ws_bytes: int


def plan(B: int, S: int, C: int) -> Plan:
    """The kernel's launch for a (B, S, C) scan."""
    nchunks = -(-S // CHUNK)
    blocks = B * nchunks * -(-C // TILE)
    if blocks > MAX_GRID:
        raise ValueError(f"lru_scan: {blocks} blocks exceed CUDA's grid")
    return Plan(T=CHUNK, nchunks=nchunks, blocks=blocks,
                ws_bytes=12 * (nchunks - 1) * B * C + 4)


def use_vec(a, b) -> bool:
    """16-byte copies take whole quads of channels from aligned bases."""
    return (a.shape[-1] % 4 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0)


@functools.cache
def _library():
    """The bound C entry point, built and loaded once per process."""
    fn = load(SOURCE).lru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
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
    p = plan(B, S, C)
    # the workspace stays referenced until the launch is enqueued
    ws = torch.empty(p.ws_bytes, dtype=torch.uint8, device=a.device)
    fn = _library()
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), ws.data_ptr(),
                 B, S, C, p.T, int(use_vec(a, b)),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lru_scan kernel launch failed: cudaError {err}")
    lru_scan.launches += 1
    return h


lru_scan.launches = 0
