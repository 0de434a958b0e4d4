"""Plain PyTorch version of the flash-attention kernel.

The same function as ``csrc/flash_attention.cu`` and as the JAX package's
Pallas kernel (``repro/kernels/flash_attention/flash_attention.py``
``flash_attention_pallas``): online softmax over KV tiles in fp32, masked
scores filled with ``-1e30``, masked probabilities set to 0, the
normaliser floored at ``1e-30`` — so a fully-masked row gives 0.  The
wrapper takes it for CPU tensors; ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "NEG_INF"]

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=None, block_k=64):
    """q: (B, Sq, H, D); k/v: (B, Skv, KV, D) -> (B, Sq, H, D) in q's dtype.

    Positions of q and k both start at 0; the KV head of query head ``h``
    is ``h // (H // KV)``.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, KV, G, D)
    dev = q.device
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    for start in range(0, Skv, block_k):
        kb = k[:, start:start + block_k].float()
        vb = v[:, start:start + block_k].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kb) * scale
        k_pos = start + torch.arange(kb.shape[1], device=dev)[None, :]
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Sq, H, D).to(q.dtype)
