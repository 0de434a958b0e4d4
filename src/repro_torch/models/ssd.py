"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

Port of the JAX package's ``models/ssd.py``.  Within chunks of length Q
the scan is a masked quadratic product; across chunks a small (H, N, P)
state is carried.  The scan goes by the tensor's device, as attention
does: a CUDA tensor runs the hand-written kernel
(``kernels/ssd/csrc/ssd_scan.cu``), a CPU tensor its plain version, the
JAX package's chunked oracle.  (The JAX package runs its kernel only
when ``cfg.use_pallas`` on a TPU.)  The one-token decode recurrence stays
plain torch, as in the reference, which has no kernel there.

Shapes: x (B, S, H, P) head-split inner activations; a (B, S, H) per-head
decay exp(dt.A); Bm/C (B, S, G, N) input/output projections of the state
(G groups broadcast over H).  Dense weights are ``(d_out, d_in)``
(``layers.dense``); the conv weights ``(K, channels)`` are the JAX
package's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ops as ssd_ops
from .layers import causal_conv1d, dense, init_dense, rms_norm, torch_dtype

__all__ = ["init_ssd_block", "ssd_block_forward", "ssd_block_decode",
           "init_ssd_decode_state", "ssd_terminal_state"]


# ---------------------------------------------------------------------------
def init_ssd_block(generator, cfg, device=None):
    """Random SSD block on ``device``: the fused ``in_proj`` layout, or the
    split ``wz``/``wx``/``wB``/``wC``/``wdt`` layout with one conv per
    component when ``cfg.ssm_split_proj``."""
    device = generator.device if device is None else device
    d, di = cfg.d_model, cfg.ssm_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    pd = cfg.param_dtype

    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    def dense_(d_in, d_out):
        return init_dense(generator, d_in, d_out, dtype=pd, device=device)

    def conv(c):
        w = torch.empty((cfg.ssm_conv_width, c), dtype=torch.float32,
                        device=device)
        w.normal_(generator=generator)
        return (w * 0.1).to(torch_dtype(pd))

    common = {
        "norm": f32(torch.zeros((d,))),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, H))),
        "dt_bias": f32(torch.zeros((H,))),
        "D": f32(torch.ones((H,))),
        "out_norm": f32(torch.zeros((di,))),
        "out_proj": dense_(di, d),
    }
    if cfg.ssm_split_proj:
        return {
            **common,
            "wz": dense_(d, di),
            "wx": dense_(d, di),
            "wB": dense_(d, G * N),
            "wC": dense_(d, G * N),
            "wdt": dense_(d, H),
            "conv_x": conv(di),
            "conv_b": conv(G * N),
            "conv_c": conv(G * N),
        }
    return {
        **common,
        "in_proj": dense_(d, 2 * di + 2 * G * N + H),
        "conv_w": conv(di + 2 * G * N),
    }


def _ssd_pre(p, x, cfg):
    """Fused projection + split: (z, xbc, dt)."""
    di, G, N = cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state
    proj = dense(p["in_proj"], x)
    z, xbc, dt = torch.split(proj, [di, di + 2 * G * N, cfg.ssm_heads],
                             dim=-1)
    return z, xbc, dt


def _ssd_project(p, h, cfg):
    """The raw projections (z, xbc, dt) of either layout; ``xbc`` is in the
    concatenated (x|B|C) channel layout, the conv cache's layout in both."""
    if "in_proj" in p:
        return _ssd_pre(p, h, cfg)
    xbc = torch.cat([dense(p["wx"], h), dense(p["wB"], h),
                     dense(p["wC"], h)], dim=-1)
    return dense(p["wz"], h), xbc, dense(p["wdt"], h)


def _conv_weight(p):
    """(K, di + 2GN) conv weight in the (x|B|C) channel layout.  The conv
    is depthwise, so the split layout's three convs are its column blocks
    and give the same values channel by channel."""
    if "in_proj" in p:
        return p["conv_w"]
    return torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)


def _ssd_conv(p, xbc, cfg, conv_state=None):
    """Conv + activate the raw (x|B|C) projections.  Returns
    (xs, Bm, C, new_conv_state)."""
    di, G, N = cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state
    xbc, ncs = causal_conv1d(xbc, _conv_weight(p), conv_state)
    xs, Bm, C = torch.split(F.silu(xbc), [di, G * N, G * N], dim=-1)
    return xs, Bm, C, ncs


def _ssd_mix_inputs(p, h, cfg, conv_state=None):
    """Project + conv + activate.  Returns (z, xs, Bm, C, dt_raw,
    new_conv) for both projection layouts."""
    z, xbc, dt = _ssd_project(p, h, cfg)
    xs, Bm, C, ncs = _ssd_conv(p, xbc, cfg, conv_state)
    return z, xs, Bm, C, dt, ncs


def _ssd_post(p, y, z, cfg):
    B, S = y.shape[0], y.shape[1]
    y = y.reshape(B, S, cfg.ssm_inner)
    y = y * F.silu(z)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    return dense(p["out_proj"], y)


def _decay(p, dt_raw):
    """(dt, a): softplus(dt + dt_bias) and the decay exp(dt * -exp(A_log)),
    both fp32."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    return dt, torch.exp(dt * -torch.exp(p["A_log"]))


def _ssd_scan_out(p, x, z, xs, Bm, C, dt, a, cfg, force_ref=False):
    """The mixer's output from the conv'd inputs and the fp32 (dt, a): the
    chunked scan (the kernel on a CUDA tensor) plus the D skip, gated,
    normed, projected and added to the residual ``x``."""
    B, S, _ = x.shape
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs = xs.reshape(B, S, H, P)
    Bm = Bm.reshape(B, S, G, N).contiguous()
    C = C.reshape(B, S, G, N).contiguous()
    xdt = xs * dt[..., None].to(xs.dtype)
    y = ssd_ops.ssd_scan(xdt, a, Bm, C, chunk=cfg.ssm_chunk,
                         force_ref=force_ref)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    return x + _ssd_post(p, y, z, cfg)


def ssd_block_forward(p, x, cfg, force_ref=False):
    """Full-sequence SSD mixer.  x: (B, S, d) -> (B, S, d).  ``force_ref``
    sends a CUDA tensor's scan through the kernel's plain version (for
    checks; the serve path never sets it)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    z, xs, Bm, C, dt_raw, _ = _ssd_mix_inputs(p, h, cfg)
    dt, a = _decay(p, dt_raw)
    return _ssd_scan_out(p, x, z, xs, Bm, C, dt, a, cfg, force_ref)


def ssd_terminal_state(xs, Bm, dt, a, cfg):
    """The state after the whole sequence, (B, H, N, P) fp32, from the
    conv'd xs/Bm and the fp32 (dt, a), with the JAX package's arithmetic
    (``transformer.py`` ``_ssd_terminal_state``): the whole-sequence
    cumsum of log(max(a, 1e-37)) and the fp32 ``xs * dt``."""
    B, S = xs.shape[:2]
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    la = torch.cumsum(torch.log(torch.clamp_min(a, 1e-37)), dim=1)  # (B,S,H)
    tail = torch.exp(la[:, -1:, :] - la)
    Bh = Bm.reshape(B, S, G, N).float().repeat_interleave(H // G, dim=2)
    xdt = xs.reshape(B, S, H, P).float() * dt[..., None]
    return torch.einsum("bsh,bshk,bshp->bhkp", tail, Bh, xdt)


def init_ssd_decode_state(cfg, batch, device, layers=None):
    """Zero decode state: ``ssm`` (batch, H, N, P) fp32 and ``conv``
    (batch, K-1, di + 2GN) in ``cfg.dtype``; with ``layers`` the states of
    that many layers stacked on dim 1."""
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_dim = cfg.ssm_inner + 2 * G * N
    lead = (batch,) if layers is None else (batch, layers)
    return {
        "ssm": torch.zeros(lead + (H, N, P), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros(lead + (cfg.ssm_conv_width - 1, conv_dim),
                            dtype=torch_dtype(cfg.dtype), device=device),
    }


def ssd_block_decode(p, x, state, cfg):
    """One-token SSD step.  x: (B, 1, d); state from init_ssd_decode_state.
    Returns (out, new_state); the inputs are not modified."""
    B = x.shape[0]
    di = cfg.ssm_inner
    G, N, H, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    z, xs, Bm, C, dt, conv_state = _ssd_mix_inputs(p, h, cfg, state["conv"])
    xs = xs.reshape(B, H, P)
    rep = H // G
    Bh = Bm.reshape(B, G, N).float().repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = C.reshape(B, G, N).float().repeat_interleave(rep, dim=1)
    dt, a = _decay(p, dt.reshape(B, H))
    xdt = xs.float() * dt[..., None]
    new_ssm = state["ssm"] * a[..., None, None] + torch.einsum(
        "bhk,bhp->bhkp", Bh, xdt)
    y = torch.einsum("bhk,bhkp->bhp", Ch, new_ssm)
    y = y + xs.float() * p["D"][None, :, None]
    y = y.to(x.dtype).reshape(B, 1, di)
    out = x + _ssd_post(p, y, z, cfg)
    return out, {"ssm": new_ssm, "conv": conv_state}
