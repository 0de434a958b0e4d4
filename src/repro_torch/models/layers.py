"""Shared neural building blocks (functional style, explicit param dicts).

Port of the JAX package's ``models/layers.py``.  Differences a reader of
both should know:

* ``dense`` weights are stored ``(d_out, d_in)`` and applied with
  ``F.linear`` (PyTorch's habit); the JAX package stores ``(d_in, d_out)``
  (``repro_torch.convert`` transposes).
* ``attention_forward`` chooses its attention by the tensor's device, not
  by a config flag: a CUDA tensor goes through the hand-written flash
  kernel, a CPU tensor through :func:`chunked_attention`, the JAX
  package's CPU path.  (The JAX package runs its kernel only when
  ``cfg.use_pallas`` on a TPU, and every full config leaves that off.)
* ``gelu`` is the tanh approximation, which is what ``jax.nn.gelu`` does
  by default.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import ops as flash_ops

__all__ = [
    "rms_norm",
    "make_rotary",
    "apply_rotary",
    "init_dense",
    "dense",
    "init_mlp",
    "gated_mlp",
    "causal_conv1d",
    "chunked_attention",
    "init_attention",
    "attention_forward",
    "attention_output",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def rms_norm(x, w, eps=1e-6):
    """RMS norm scaled by ``(1 + w)``: ``w`` is initialised to zeros (the
    JAX package's convention, not Hugging Face's plain ``w``)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


# -- rotary -------------------------------------------------------------------
def make_rotary(positions, head_dim, theta=10000.0):
    """positions: (...,) int -> (cos, sin) of shape (..., head_dim//2), fp32.

    The inverse frequencies are computed in float64 on the positions'
    device, then rounded to fp32 (as the JAX package rounds its float64
    numpy table); building them on the host would cost a host-to-device
    copy, which waits for the stream, in every layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=positions.device) / head_dim
    inv = (1.0 / (theta ** exps)).float()
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin):
    """Rotate-half rotary (the head splits into two halves, not interleaved
    pairs), computed in fp32.  x: (B, S, H, D); cos/sin: (B, S, D//2) or
    (S, D//2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    x1f, x2f = x1.float(), x2.float()
    return torch.cat(
        [x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1
    ).to(x.dtype)


# -- dense / mlp --------------------------------------------------------------
def init_dense(generator, d_in, d_out, bias=False, dtype="bfloat16",
               scale=None, device=None):
    """Truncated-normal (±2σ) weight of shape (d_out, d_in), times
    ``scale`` (default 1/sqrt(d_in)); zero bias."""
    device = generator.device if device is None else device
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.empty((d_out, d_in), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    p = {"w": (w * scale).to(torch_dtype(dtype))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch_dtype(dtype), device=device)
    return p


def dense(p, x):
    return F.linear(x, p["w"], p.get("b"))


def init_mlp(generator, d_model, d_ff, dtype="bfloat16", device=None):
    return {
        "wi": init_dense(generator, d_model, d_ff, dtype=dtype, device=device),
        "wg": init_dense(generator, d_model, d_ff, dtype=dtype, device=device),
        "wo": init_dense(generator, d_ff, d_model, dtype=dtype, device=device),
    }


_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def gated_mlp(p, x, act="silu"):
    a = dense(p["wi"], x)
    g = dense(p["wg"], x)
    return dense(p["wo"], _ACTS[act](g) * a)


# -- depthwise causal conv ----------------------------------------------------
def causal_conv1d(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).

    Returns ``(y, new_state)``: ``y`` sums the K shifted products in x's
    dtype, as the JAX function does, and ``new_state`` is the trailing
    ``(B, K-1, C)`` inputs, the decode carry.  With ``state`` given and
    ``S == 1`` this is the decode step.
    """
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else torch.zeros_like(pad)
    return y.to(x.dtype), new_state


# -- memory-efficient attention (the CPU path) --------------------------------
def chunked_attention(q, k, v, *, q_offset=0, causal=True,
                      window: Optional[int] = None, chunk: int = 512):
    """Online-softmax attention over KV chunks, the JAX package's CPU path.

    q: (B, Sq, H, D); k/v: (B, Skv, KV, D) with H % KV == 0 (GQA).  Masks
    with ``-inf`` and floors the normaliser at ``1e-37``, as the JAX
    function does (the flash kernel uses ``-1e30`` and ``1e-30``).
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D).float()
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Skv)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, KV, G), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    for start in range(0, Skv, chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kb) * scale
        k_pos = start + torch.arange(kb.shape[1], device=dev)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # fully-masked rows (m_new = -inf): exp(-inf - -inf) -> use 0
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    return out.reshape(B, Sq, H, D).to(q.dtype)


# -- full attention layer ------------------------------------------------------
def init_attention(generator, cfg, device=None):
    d, dt, qb = cfg.d_model, cfg.param_dtype, cfg.qkv_bias
    return {
        "wq": init_dense(generator, d, cfg.q_dim, qb, dt, device=device),
        "wk": init_dense(generator, d, cfg.kv_dim, qb, dt, device=device),
        "wv": init_dense(generator, d, cfg.kv_dim, qb, dt, device=device),
        "wo": init_dense(generator, cfg.q_dim, d, dtype=dt, device=device),
    }


def _project_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = dense(p["wk"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = dense(p["wv"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    cos, sin = make_rotary(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    return q, k, v


def uses_kernel(device) -> bool:
    """Whether prefill attention on ``device`` goes through the flash
    kernel: on every CUDA device, whatever the config says."""
    return torch.device(device).type == "cuda"


def _attend(q, k, v, cfg, *, causal, window, force_ref):
    """The attention of a prefill: the flash kernel for CUDA tensors (or
    its plain version when ``force_ref``), ``chunked_attention`` for CPU
    tensors.  Chosen by device only."""
    if uses_kernel(q.device):
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         window=window, force_ref=force_ref)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=cfg.attn_chunk)


def attention_output(p, q, k, v, cfg, *, causal, window, force_ref=False):
    """Attention of projected ``q``/``k``/``v`` followed by the output
    projection: (B, S, d_model)."""
    B, S = q.shape[:2]
    out = _attend(q, k.contiguous(), v.contiguous(), cfg, causal=causal,
                  window=window, force_ref=force_ref)
    return dense(p["wo"], out.reshape(B, S, cfg.q_dim))


def attention_forward(p, x, cfg, *, window=None, causal=True, kv=None,
                      positions=None, force_ref=False):
    """Training/prefill attention.  kv: optional external (k, v) for
    cross-attention.  ``force_ref`` routes a CUDA tensor through the
    kernel's plain version (for checks; the serve path never sets it)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
    else:
        q = dense(p["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)
        k, v = kv
        causal = False
    return attention_output(p, q, k, v, cfg, causal=causal, window=window,
                            force_ref=force_ref)
