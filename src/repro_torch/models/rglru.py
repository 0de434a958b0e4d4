"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

Port of the JAX package's ``models/rglru.py``.  Recurrence:
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-8 softplus(lam) r_t)``; ``r_t`` and ``i_t`` are elementwise
sigmoid gates.  The block is Griffin's recurrent block: a GeLU gate
branch times a conv1d + RG-LRU branch, then the output projection.

The sequence scan goes through ``kernels.rg_lru.ops.lru_scan`` on every
device: a CUDA tensor launches the hand-written kernel, a CPU tensor
computes its plain version.  (The JAX package runs its Pallas kernel only
under ``cfg.use_pallas`` on a TPU and its ``associative_scan`` otherwise.)
Decode is a plain torch step, as in the JAX package.  Dense weights are
stored ``(d_out, d_in)`` (``layers.dense``); ``conv_w`` is ``(K, w)`` and
the ``lru`` vectors are ``(w,)`` fp32, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rg_lru import ops as lru_ops
from .layers import causal_conv1d, dense, init_dense, rms_norm, torch_dtype

__all__ = [
    "rglru_gates",
    "init_rglru_block",
    "rglru_block_forward",
    "rglru_block_prefill",
    "init_rglru_decode_state",
    "rglru_block_decode",
]

_C = 8.0  # Griffin's fixed scaling constant


def rglru_gates(p, x):
    """x: (..., w) -> (a, b) recurrence coefficients in fp32, with the
    JAX function's arithmetic: ``log_a = -8 softplus(lam) r`` and
    ``sqrt(1 - a^2)`` as ``sqrt(max(1 - exp(2 log_a), 1e-12))``."""
    xf = x.float()
    r = torch.sigmoid(xf * p["w_a"] + p["b_a"])
    i = torch.sigmoid(xf * p["w_x"] + p["b_x"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = beta * (i * xf)
    return a, b


def init_rglru_block(generator, cfg, device=None):
    """Random block parameters drawn from ``generator`` (the JAX
    function's shapes, dtypes and initialisers)."""
    device = generator.device if device is None else device
    d, w, dt = cfg.d_model, cfg.lru_width, cfg.param_dtype

    def normal(shape, scale):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.normal_(generator=generator) * scale

    return {
        "norm": torch.zeros((d,), dtype=torch.float32, device=device),
        "gate_proj": init_dense(generator, d, w, dtype=dt, device=device),
        "rec_proj": init_dense(generator, d, w, dtype=dt, device=device),
        "conv_w": normal((cfg.ssm_conv_width, w), 0.1).to(torch_dtype(dt)),
        "lru": {
            "lam": torch.linspace(0.5, 4.0, w, dtype=torch.float32,
                                  device=device),
            "w_a": normal((w,), 0.1),
            "b_a": torch.zeros((w,), dtype=torch.float32, device=device),
            "w_x": normal((w,), 0.1),
            "b_x": torch.zeros((w,), dtype=torch.float32, device=device),
        },
        "out_proj": init_dense(generator, w, d, dtype=dt, device=device),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def rglru_block_prefill(p, x, cfg, force_ref=False):
    """The block over a whole sequence.  x: (B, S, d) -> ``(out, hseq,
    rec)``: the residual output (B, S, d), the fp32 recurrence (B, S, w)
    and the raw ``rec_proj`` output (B, S, w), whose last K-1 rows are the
    decode's conv window.  ``force_ref`` sends a CUDA tensor's scan
    through the kernel's plain version (for checks; the serve path never
    sets it)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    gate = _gelu(dense(p["gate_proj"], h))
    rec = dense(p["rec_proj"], h)
    conv, _ = causal_conv1d(rec, p["conv_w"])
    a, b = rglru_gates(p["lru"], conv)
    hseq = lru_ops.lru_scan(a, b, force_ref=force_ref)
    y = hseq.to(x.dtype) * gate
    return x + dense(p["out_proj"], y), hseq, rec


def rglru_block_forward(p, x, cfg, force_ref=False):
    """x: (B, S, d) -> (B, S, d) residual block."""
    return rglru_block_prefill(p, x, cfg, force_ref=force_ref)[0]


def init_rglru_decode_state(cfg, batch, device, layers=None):
    """Zero decode state: ``h`` (batch, w) fp32 and ``conv`` (batch, K-1,
    w) in ``cfg.dtype``; with ``layers`` the states of that many layers
    stacked on dim 1."""
    w = cfg.lru_width
    lead = (batch,) if layers is None else (batch, layers)
    return {
        "h": torch.zeros(lead + (w,), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (cfg.ssm_conv_width - 1, w),
                            dtype=torch_dtype(cfg.dtype), device=device),
    }


def rglru_block_decode(p, x, state, cfg):
    """One-token step.  x: (B, 1, d); state from init_rglru_decode_state.
    Returns (out, new_state); the inputs are not modified."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    gate = _gelu(dense(p["gate_proj"], h))
    rec = dense(p["rec_proj"], h)
    rec, conv_state = causal_conv1d(rec, p["conv_w"], state["conv"])
    a, b = rglru_gates(p["lru"], rec[:, 0])
    h_new = a * state["h"] + b
    y = h_new[:, None, :].to(x.dtype) * gate
    return x + dense(p["out_proj"], y), {"h": h_new, "conv": conv_state}
