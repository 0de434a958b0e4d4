"""Decoder stack of the port — the dense and ssm families.

Port of the JAX package's ``models/transformer.py`` for the dense family
(``block_pattern == ("attn_mlp",)``: prefill with padded ``true_len`` and
decode over a ring-buffer KV cache) and the ssm family (mamba2,
``("ssd",)``: prefill producing each layer's terminal state, decode over
that recurrent state): parameter init from a ``torch.Generator``, the
embedding and output head.  Other families raise, naming the ROADMAP item
that ports them.

Layouts (the JAX package stacks layers for ``lax.scan``; eager PyTorch
runs a plain loop):

* params: ``{"embed": (V, d), "layers": [block, ...], "final_norm": (d,),
  "lm_head": {"w": (V, d)}}``; ``repro_torch.convert`` turns the JAX
  pytree into this.
* decode caches, per family: dense ``{"k": (B, n_layers, L, KV, D),
  "v": ..., "pos": (B,)}``; ssm ``{"ssm": (B, n_layers, H, N, P) fp32,
  "conv": (B, n_layers, K-1, di + 2GN) in cfg.dtype, "pos": (B,)}``.
  :func:`decode_step` writes each new K/V row, or each layer's new state,
  **in place** (the JAX function returns new arrays) and returns a new
  dict whose ``pos`` is advanced by one.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.errors import KampingError
from ..device import resolve_device
from . import ssd as ssd_mod
from .config import ModelConfig
from .layers import (
    _project_qkv,
    attention_forward,
    attention_output,
    dense,
    gated_mlp,
    init_attention,
    init_dense,
    init_mlp,
    rms_norm,
    torch_dtype,
)

__all__ = [
    "init_params",
    "block_pattern",
    "embed_tokens",
    "lm_logits",
    "init_decode_caches",
    "supports_padded_prefill",
    "prefill",
    "decode_step",
]

# The block kind of each ported family; a family's blocks are all of its
# kind, so every layer's decode cache has one layout.
_FAMILY_KIND = {"dense": "attn_mlp", "ssm": "ssd"}
_ATTN_CACHE_KINDS = ("attn_mlp",)


# ---------------------------------------------------------------------------
# pattern / structure helpers
# ---------------------------------------------------------------------------
def block_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    """The repeating block pattern; the dense and ssm families are
    ported."""
    kind = _FAMILY_KIND.get(cfg.family)
    pattern = tuple(cfg.block_pattern) if cfg.block_pattern else (kind,)
    if kind is None or cfg.is_encoder_decoder or set(pattern) != {kind}:
        raise NotImplementedError(
            f"config {cfg.name!r} (family {cfg.family!r}): only the dense "
            "and ssm families are ported; the other families come with "
            "ROADMAP A9 (moe) and A11 (hybrid with B7, audio, vlm)"
        )
    return pattern


def _attn_window(cfg, kind):
    if kind == "attn_local":
        return cfg.local_window
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _init_block(generator, kind, cfg, device):
    if kind == "ssd":
        return ssd_mod.init_ssd_block(generator, cfg, device=device)
    d = cfg.d_model
    zero = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    return {
        "ln1": zero(),
        "attn": init_attention(generator, cfg, device=device),
        "ln2": zero(),
        "mlp": init_mlp(generator, d, cfg.d_ff, dtype=cfg.param_dtype,
                        device=device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator = None, *,
                device=None):
    """Random parameters drawn from ``generator`` on ``device``.

    ``device=None`` means CUDA (and raises without it).  Without a
    generator one seeded with 0 is made on the device.  The numbers differ
    from the JAX package's for the same seed; tests carry JAX weights over
    with ``repro_torch.convert`` instead.  On the ``meta`` device the
    parameters have shapes and dtypes but no data (a CPU generator, or
    none, is taken): counting a model's parameters allocates nothing.
    """
    pattern = block_pattern(cfg)
    device = resolve_device(device)
    gen_type = "cpu" if device.type == "meta" else device.type
    if generator is None:
        generator = torch.Generator(device=gen_type).manual_seed(0)
    if generator.device.type != gen_type:
        raise KampingError(
            f"init_params: generator on {generator.device}, device {device}"
        )
    dt = torch_dtype(cfg.param_dtype)
    embed = torch.empty((cfg.vocab_size, cfg.d_model), dtype=torch.float32,
                        device=device)
    torch.nn.init.trunc_normal_(embed, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    params = {
        "embed": (embed * 0.02).to(dt),
        "layers": [
            _init_block(generator, pattern[i % len(pattern)], cfg, device)
            for i in range(cfg.num_layers)
        ],
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(generator, cfg.d_model, cfg.vocab_size,
                                       dtype=cfg.param_dtype, device=device)
    return params


# ---------------------------------------------------------------------------
# embedding / output head
# ---------------------------------------------------------------------------
def embed_tokens(params, batch, cfg):
    return params["embed"][batch["tokens"]]


def lm_logits(params, hidden, cfg):
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return dense(params["lm_head"], hidden)


def _block_forward(p, x, kind, cfg, force_ref=False):
    """Residual attention + gated-MLP block over (B, S, d)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attention_forward(p["attn"], h, cfg,
                              window=_attn_window(cfg, kind), causal=True,
                              force_ref=force_ref)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h, cfg.act)


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------
def _cache_len(cfg, kind, max_len):
    """Windowed attention keeps a ring of the window, full attention
    keeps max_len."""
    w = _attn_window(cfg, kind)
    if w is not None and w < max_len:
        return w
    return max_len


def supports_padded_prefill(cfg, seq_len, max_len=None):
    """True when right-padded (bucketed) prefill is exact: every block is
    causal attention and every cache holds at least ``seq_len`` rows (see
    the JAX function for the argument).  A recurrent block carries a
    terminal state that padding would corrupt."""
    max_len = max_len or seq_len
    kinds = set(block_pattern(cfg))
    if not kinds <= set(_ATTN_CACHE_KINDS):
        return False
    return all(_cache_len(cfg, k, max_len) >= seq_len for k in kinds)


def init_decode_caches(cfg, batch, max_len, device):
    kind = block_pattern(cfg)[0]  # one kind, so one layout, per family
    if kind == "ssd":
        caches = ssd_mod.init_ssd_decode_state(cfg, batch, device,
                                               layers=cfg.num_layers)
    else:
        L = _cache_len(cfg, kind, max_len)
        dt = torch_dtype(cfg.dtype)
        shape = (batch, cfg.num_layers, L, cfg.num_kv_heads, cfg.head_dim)
        caches = {"k": torch.zeros(shape, dtype=dt, device=device),
                  "v": torch.zeros(shape, dtype=dt, device=device)}
    caches["pos"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return caches


def _ssd_prefill(p, x, cfg, caches, i, force_ref=False):
    """SSD forward over the prompt AND layer ``i``'s terminal state,
    written into the (fresh) caches: ``ssm`` as the JAX package's
    ``_ssd_terminal_state`` computes it, ``conv`` the last K-1 raw
    projections.  The projections are computed once and shared (the JAX
    package computes them twice and leaves XLA to merge them).  A prompt
    shorter than K-1 keeps the leading rows 0, the window of a zero
    history."""
    S = x.shape[1]
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    z, xbc_raw, dt_raw = ssd_mod._ssd_project(p, h, cfg)
    xs, Bm, C, _ = ssd_mod._ssd_conv(p, xbc_raw, cfg)
    dt, a = ssd_mod._decay(p, dt_raw)
    out = ssd_mod._ssd_scan_out(p, x, z, xs, Bm, C, dt, a, cfg, force_ref)
    caches["ssm"][:, i] = ssd_mod.ssd_terminal_state(xs, Bm, dt, a, cfg)
    conv = caches["conv"][:, i]
    keep = min(S, conv.shape[1])
    if keep:
        conv[:, conv.shape[1] - keep:] = xbc_raw[:, S - keep:].to(conv.dtype)
    return out


def _block_prefill(p, x, kind, cfg, caches, i, force_ref=False):
    """Forward a block over the prompt AND write its decode cache into
    layer ``i`` of the (fresh) caches: for attention the last min(L, S)
    positions go to ring slots ``pos % L``."""
    if kind == "ssd":
        return _ssd_prefill(p, x, cfg, caches, i, force_ref=force_ref)
    B, S, _ = x.shape
    L = caches["k"].shape[2]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    # one projection serves both the cache and the attention (under jit
    # the JAX package's XLA merges its two; eager torch would run both)
    q, k, v = _project_qkv(p["attn"], h, cfg, torch.arange(S, device=x.device))
    n_keep = min(L, S)
    idx = torch.arange(S - n_keep, S, device=x.device) % L
    caches["k"][:, i, idx] = k[:, S - n_keep:].to(caches["k"].dtype)
    caches["v"][:, i, idx] = v[:, S - n_keep:].to(caches["v"].dtype)
    x = x + attention_output(p["attn"], q, k, v, cfg, causal=True,
                             window=_attn_window(cfg, kind),
                             force_ref=force_ref)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h, cfg.act)


def prefill(params, batch, cfg, max_len=None, true_len=None,
            force_ref=False):
    """Run the prompt, build decode caches, return last-token logits.

    ``true_len`` ((B,) int) enables padded prefill: ``batch["tokens"]`` is
    right-padded, logits are taken at ``true_len - 1`` and ``pos`` starts
    at ``true_len``.  ``force_ref`` sends a CUDA prefill's attention or
    SSD scan through the kernel's plain version (for checks only).
    """
    pattern = block_pattern(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    if true_len is not None and not supports_padded_prefill(cfg, S, max_len):
        raise ValueError(
            f"prefill(true_len=...): padded prefill is not exact for config "
            f"{cfg.name!r} at padded length {S} (recurrent blocks or a KV "
            "window shorter than the padded prompt); call prefill with the "
            "exact prompt length"
        )
    caches = init_decode_caches(cfg, B, max_len, tokens.device)
    x = embed_tokens(params, batch, cfg)
    for i, p in enumerate(params["layers"]):
        x = _block_prefill(p, x, pattern[i % len(pattern)], cfg, caches, i,
                           force_ref=force_ref)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if true_len is None:
        logits = lm_logits(params, x[:, -1:, :], cfg)
        caches["pos"] = torch.full((B,), S, dtype=torch.int32,
                                   device=tokens.device)
    else:
        tl = torch.as_tensor(true_len, dtype=torch.int32,
                             device=tokens.device).reshape(-1)
        # per-row last *real* token; pad rows are causal downstream of it
        idx = torch.clamp(tl.long() - 1, 0, S - 1)
        last = x[torch.arange(B, device=x.device), idx][:, None, :]
        logits = lm_logits(params, last, cfg)
        caches["pos"] = tl.clone()
    return logits, caches


def _ring_positions(positions, L):
    """Absolute position held by each ring slot: slot s holds
    ``pos - ((pos - s) mod L)``, negative when never written.  ``%`` on
    torch integer tensors floors like ``jnp``'s (``torch.fmod`` would
    truncate toward zero)."""
    s_idx = torch.arange(L, device=positions.device)
    return positions[:, None] - ((positions[:, None] - s_idx[None, :]) % L)


def _decode_attention_abs(q, k_cache, v_cache, qpos, pos, window):
    """fp32 decode attention with explicit absolute positions per slot
    (plain torch, as the JAX function is plain jnp on every backend)."""
    B, L, KV, D = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float())
    s = s / math.sqrt(D)
    mask = (qpos >= 0) & (qpos <= pos[:, None])
    if window is not None:
        mask = mask & (qpos > pos[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def _attn_decode_ring(p, x, cfg, k_cache, v_cache, pos, window):
    """Decode attention with an in-place ring-buffer cache update.

    ``k_cache``/``v_cache`` are this layer's (B, L, KV, D) views; the new
    token's row is written at slot ``pos % L``."""
    B = x.shape[0]
    L = k_cache.shape[1]
    positions = pos.long()
    qr, kr, v = _project_qkv(p, x, cfg, positions[:, None])
    rows = torch.arange(B, device=x.device)
    slot = positions % L
    k_cache[rows, slot] = kr[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    qpos = _ring_positions(positions, L)
    out = _decode_attention_abs(qr, k_cache, v_cache, qpos, positions, window)
    return dense(p["wo"], out.reshape(B, 1, cfg.q_dim))


def _block_decode(p, x, kind, cfg, caches, i, pos):
    """One-token decode for block ``i`` (updates its cache rows, or its
    recurrent state, in place)."""
    if kind == "ssd":
        x, new = ssd_mod.ssd_block_decode(
            p, x, {"ssm": caches["ssm"][:, i], "conv": caches["conv"][:, i]},
            cfg)
        caches["ssm"][:, i] = new["ssm"]
        caches["conv"][:, i] = new["conv"]
        return x
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attn_decode_ring(p["attn"], h, cfg, caches["k"][:, i],
                              caches["v"][:, i], pos, _attn_window(cfg, kind))
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h, cfg.act)


def decode_step(params, caches, tokens, cfg):
    """One decode step.  tokens: (B,) int -> (logits (B, 1, V), caches).

    K/V rows and recurrent states are written in place; the returned dict
    shares those tensors and carries ``pos + 1``."""
    pattern = block_pattern(cfg)
    pos = caches["pos"]
    x = params["embed"][tokens[:, None]]
    for i, p in enumerate(params["layers"]):
        x = _block_decode(p, x, pattern[i % len(pattern)], cfg, caches, i,
                          pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params, x, cfg)
    return logits, {**caches, "pos": pos + 1}
