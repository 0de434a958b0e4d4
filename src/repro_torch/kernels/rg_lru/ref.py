"""Plain PyTorch versions of the RG-LRU scan kernel.

Both compute the gated linear recurrence ``h_t = a_t * h_{t-1} + b_t``
with ``h_0 = 0`` (elementwise over channels, sequential over time) in
fp32:

* :func:`lru_sequential_ref` is the loop over time, the ground truth
  (the JAX package's ``repro/kernels/rg_lru/ref.py``
  ``lru_sequential_ref``);
* :func:`lru_scan_ref` is a log-depth doubling scan over the whole time
  axis: the composition of affine maps that the Pallas kernel's body runs
  inside one time block (``repro/kernels/rg_lru/rg_lru.py`` ``_kernel``),
  and that ``associative_scan`` runs in ``repro/models/rglru.py``
  ``rglru_scan_ref``;
* :func:`lru_chunked_ref` is the CUDA kernel's own order: each chunk's
  affine map from h = 0, the fold of the maps in time order into the
  carry entering each chunk, then each chunk walked from its carry.

The wrapper (``ops.py``) takes :func:`lru_scan_ref` for CPU tensors;
``chip_smoke.py`` holds the CUDA kernel against it on the card.

Shapes: ``a``, ``b`` (B, S, C) fp32 -> ``h`` (B, S, C) fp32.
"""
from __future__ import annotations

import torch

__all__ = ["lru_scan_ref", "lru_sequential_ref", "lru_chunked_ref"]


def lru_scan_ref(a, b):
    """Doubling scan: after the pass with shift ``k`` each position holds
    the composition of the affine maps of the ``2k`` positions ending at
    it, ``(A, B) -> (A * A_shift, A * B_shift + B)``."""
    A, Bv = a.float(), b.float()
    S = A.shape[1]
    k = 1
    while k < S:
        A_shift = torch.cat([torch.ones_like(A[:, :k]), A[:, :-k]], dim=1)
        B_shift = torch.cat([torch.zeros_like(Bv[:, :k]), Bv[:, :-k]], dim=1)
        Bv = A * B_shift + Bv
        A = A * A_shift
        k *= 2
    return Bv


def lru_sequential_ref(a, b):
    """The loop over time with an fp32 carry (fp64 inputs keep fp64: the
    loop is then exact to fp32's eye, the yardstick of a long near-1
    decay, where every fp32 order of the sums drifts)."""
    dt = torch.promote_types(a.dtype, torch.float32)
    a, b = a.to(dt), b.to(dt)
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    if not hs:
        return torch.empty_like(a)
    return torch.stack(hs, dim=1)


def lru_chunked_ref(a, b, chunk):
    """The kernel's order with ``chunk`` steps a chunk: each chunk's map
    (A = prod a in time order, H = the walk from h = 0), the carry
    entering chunk k folded as ``carry = A_{k-1} carry + H_{k-1}`` from
    0, then each chunk walked from its carry.  A ragged last chunk is
    padded with a = 1, b = 0, which leave every map as it was."""
    a, b = a.float(), b.float()
    B, S, C = a.shape
    if S == 0:
        return torch.empty_like(a)
    n = -(-S // chunk)
    pad = n * chunk - S
    a = torch.cat([a, a.new_ones(B, pad, C)], 1).view(B, n, chunk, C)
    b = torch.cat([b, b.new_zeros(B, pad, C)], 1).view(B, n, chunk, C)
    A, H = torch.ones_like(a[:, :, 0]), torch.zeros_like(a[:, :, 0])
    for t in range(chunk):  # every chunk's map at once
        H = a[:, :, t] * H + b[:, :, t]
        A = A * a[:, :, t]
    carry, enter = torch.zeros_like(A[:, 0]), []
    for k in range(n):
        enter.append(carry)
        carry = A[:, k] * carry + H[:, k]
    h, out = torch.stack(enter, 1), []
    for t in range(chunk):
        h = a[:, :, t] * h + b[:, :, t]
        out.append(h)
    return torch.stack(out, 2).reshape(B, n * chunk, C)[:, :S]
