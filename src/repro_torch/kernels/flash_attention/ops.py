"""Flash-attention wrapper: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors.

For a CUDA tensor :func:`flash_attention` launches
``csrc/flash_attention.cu`` (built with nvcc at first use, bound through
ctypes) or raises; it never falls back to the plain version.  The dtype
picks the kernel: bf16 runs on the tensor cores (wgmma, TMA), fp32 on the
SIMT cores.  Under grad mode it refuses CUDA inputs that require grad
(no backward yet, ROADMAP A2).  For a CPU tensor it computes
:func:`~.ref.flash_attention_ref`.  ``force_ref=True``
computes the plain version on any device; ``chip_smoke.py`` uses it to
hold the kernel against its plain version, and the serve path never sets
it.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from ..build import load
from ..guard import refuse_grad
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


@functools.cache
def _library():
    """The bound C entry point, built and loaded once per process (the
    build hashes the source, which must not happen on every launch)."""
    fn = load(SOURCE).flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
            f"must be (B={B}, Skv, KV, D={D})"
        )
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
            "expected all float32 or all bfloat16"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window={window} < 0")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k, v must be 16-byte "
                         "aligned (the kernel reads them with TMA)")


def flash_attention(q, k, v, *, causal=True, window=None, force_ref=False):
    """q: (B, Sq, H, D); k/v: (B, Skv, KV, D) -> (B, Sq, H, D)."""
    if force_ref or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if Sq == 0:
        return out
    fn = _library()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KV, D, int(bool(causal)),
            -1 if window is None else int(window), 1.0 / math.sqrt(D),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
