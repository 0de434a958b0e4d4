"""SSD chunked-scan wrapper: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors.

For a CUDA tensor :func:`ssd_scan` launches ``csrc/ssd_scan.cu`` (built
with nvcc at first use, bound through ctypes) or raises; it never falls
back to the plain version.  The dtype picks the kernels: bf16 runs the
chunks in parallel, with the state path on the tensor cores and the
intra-chunk products in fp32 FMAs in the plain version's order (three
CUDA launches, two when S equals the chunk: the chunk states and C B^T,
the carry across chunks, the outputs; the wrapper allocates their
workspaces), fp32 one SIMT kernel that loops over the chunks.  Under grad
mode it refuses CUDA inputs that require grad (no backward yet, ROADMAP
A2).  For a CPU tensor it computes :func:`~.ref.ssd_scan_ref`.
``force_ref=True`` computes the plain version on any device;
``chip_smoke.py`` uses it to hold the kernel against its plain version,
and the serve path never sets it.  ``ssd_scan.launches`` counts calls
that launched the kernel (one per call, whatever the dtype).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load
from ..guard import refuse_grad
from .ref import chunk_len, ssd_scan_ref, ssd_sequential_ref

__all__ = ["ssd_scan", "ssd_scan_ref", "ssd_sequential_ref", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128  # the kernel's largest Q and N (shared-memory tiles)
MAX_STATE = 128
P_TILE = 64  # P columns per tensor-core block (kPW in the source)
PIECES = 2  # bf16 pieces of each fp32 tensor-core operand (kPieces)


@functools.cache
def _library():
    """The bound C entry point, built and loaded once per process."""
    fn = load(SOURCE).ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, a, Bm, C, chunk):
    """Shapes, dtypes, device and layout the kernel takes; returns Q."""
    if x.dim() != 4 or a.dim() != 3 or Bm.dim() != 4 or C.dim() != 4:
        raise ValueError("ssd_scan: x (B, S, H, P), a (B, S, H), Bm and C "
                         "(B, S, G, N) expected")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(a.shape) != (B, S, H):
        raise ValueError(f"ssd_scan: a {tuple(a.shape)}, expected "
                         f"{(B, S, H)}")
    if Bm.shape != C.shape or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"ssd_scan: Bm {tuple(Bm.shape)} and C "
                         f"{tuple(C.shape)} must both be (B={B}, S={S}, G, N)")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: H={H} is not a multiple of G={G}")
    Q = chunk_len(S, chunk)
    if Q > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {Q} or state {N} above the "
                         f"kernel's {MAX_CHUNK}")
    if (x.dtype not in _DTYPES or Bm.dtype != x.dtype
            or C.dtype != x.dtype or a.dtype != torch.float32):
        raise ValueError(
            f"ssd_scan: dtypes x {x.dtype}, a {a.dtype}, Bm {Bm.dtype}, C "
            f"{C.dtype}; expected x/Bm/C all float32 or all bfloat16 and a "
            "float32"
        )
    if not (x.device == a.device == Bm.device == C.device):
        raise ValueError("ssd_scan: x, a, Bm, C on different devices")
    if not all(t.is_contiguous() for t in (x, a, Bm, C)):
        raise ValueError("ssd_scan: x, a, Bm, C must be contiguous")
    return Q


def _workspaces(x, Bm, Q):
    """The bf16 kernels' workspaces (layouts in the source's header): la
    (B, H, S) fp32, the chunk states (B, nc, H, PT, Nw, 64) fp32, each
    chunk's incoming state as its bf16 pieces (B, nc, H, PT, PIECES, Nw,
    64) and C B^T as a packed triangle (B, G, nc, tri) fp32."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, PT = S // Q, -(-P // P_TILE)
    Nw, Qp = -(-N // 16) * 16, -(-Q // 16) * 16
    tri = Qp * Qp - 8 * (Qp // 4) * (Qp // 4 - 1)  # tri_row(Qp) in the source
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((B, H, S), **f32),
            torch.empty((B, nc, H, PT, Nw, P_TILE), **f32),
            torch.empty((B, nc, H, PT, PIECES, Nw, P_TILE),
                        dtype=torch.bfloat16, device=x.device),
            torch.empty((B, G, nc, tri), **f32))


def ssd_scan(x, a, Bm, C, *, chunk, force_ref=False):
    """x: (B,S,H,P); a: (B,S,H) fp32; Bm/C: (B,S,G,N) -> y: (B,S,H,P)."""
    if force_ref or x.device.type == "cpu":
        return ssd_scan_ref(x, a, Bm, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    refuse_grad("ssd_scan", x, a, Bm, C)
    Q = _check(x, a, Bm, C, chunk)
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    # the workspaces stay referenced until the launch is enqueued
    ws = _workspaces(x, Bm, Q) if x.dtype == torch.bfloat16 else ()
    ws_ptrs = [t.data_ptr() for t in ws] or [0, 0, 0, 0]
    # 16-byte loads and stores need whole 8-element rows and aligned bases
    vec = int(N % 8 == 0 and P % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, Bm, C, y)))
    fn = _library()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), a.data_ptr(), Bm.data_ptr(), C.data_ptr(),
                 y.data_ptr(), *ws_ptrs, B, S, H, P, G, N, Q,
                 _DTYPES[x.dtype], vec,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
