"""Shared helpers for architecture configs."""
from __future__ import annotations

import dataclasses

from ..models import ModelConfig

__all__ = ["make_smoke"]


def make_smoke(full: ModelConfig, **overrides) -> ModelConfig:
    """Derive the reduced same-family smoke config from the full config
    (a copy of the JAX package's, so both packages size smoke configs
    alike)."""
    pattern = full.block_pattern
    n_layers = len(pattern) + min(2, full.num_layers % len(pattern) or 2) if pattern else 2
    base = dict(
        name=full.name + "-smoke",
        num_layers=n_layers if pattern else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(4, max(1, full.num_kv_heads)),
        d_ff=128 if full.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        sliding_window=8 if full.sliding_window else None,
        local_window=8 if full.local_window else None,
        lru_width=64 if full.lru_width else None,
        num_experts=8 if full.num_experts else 0,
        num_shared_experts=min(2, full.num_shared_experts),
        top_k=min(2, full.top_k),
        moe_d_ff=48 if full.num_experts else None,
        ssm_state=16 if full.ssm_state else 0,
        ssm_head_dim=16 if full.ssm_state else 64,
        ssm_chunk=8,
        num_encoder_layers=2 if full.is_encoder_decoder else 0,
        encoder_seq_len=16 if full.is_encoder_decoder else 1500,
        num_patches=8 if full.frontend == "vision_stub" else full.num_patches,
        attn_chunk=64,
    )
    base.update(overrides)
    return dataclasses.replace(full, **base)
