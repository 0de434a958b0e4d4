"""Unified model configuration for all assigned architecture families.

A copy of the JAX package's ``models/config.py`` without ``use_pallas``:
the port picks its attention kernel by the tensor's device
(``layers.attention_forward``), and without ``remat``/``scan_layers``,
which steer JAX tracing and mean nothing to eager PyTorch.  The family
fields of unported families stay, so every config can be described; the
model refuses the ones it cannot run yet (``transformer.block_pattern``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # mixtral SWA
    rope_theta: float = 10000.0

    # hybrid (recurrentgemma): repeating block pattern, e.g.
    # ("rglru", "rglru", "attn") with local attention of width local_window
    block_pattern: Optional[Tuple[str, ...]] = None
    local_window: Optional[int] = None
    lru_width: Optional[int] = None  # RG-LRU recurrent width (default d_model)

    # moe
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None
    moe_mode: str = "ep_alltoall"  # ep_alltoall | tp | dense
    capacity_factor: float = 1.25

    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1
    # TP-shardable SSD: separate z/x/B/C/dt projections + per-component
    # convs instead of one fused in_proj (identical math, different init;
    # the fused projection's channel concat defeats tensor parallelism)
    ssm_split_proj: bool = False

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper: 30s audio -> 1500 frames

    # modality frontend stubs (vlm/audio): precomputed embeddings
    frontend: Optional[str] = None  # "vision_stub" | "audio_stub" | None
    num_patches: int = 256  # vlm: patch embeddings prepended to the sequence

    # numerics / implementation
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    act: str = "silu"
    attn_chunk: int = 512  # kv-chunk for memory-efficient attention

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.family in ("moe",) and self.moe_d_ff is None:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.family == "hybrid" and self.lru_width is None:
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        per_layer = 0
        pattern = self.block_pattern or (self._default_block(),)
        # count per pattern-unit and scale
        unit = 0
        for kind in pattern:
            unit += self._block_params(kind)
        n_units, rem = divmod(L, len(pattern))
        per_layer = unit * n_units + sum(
            self._block_params(k) for k in pattern[:rem]
        )
        n += per_layer
        if self.is_encoder_decoder:
            # encoder self-attn + mlp, decoder adds cross-attention
            enc = self.num_encoder_layers * (
                self._attn_params() + self._mlp_params(self.d_ff)
            )
            n += enc + L * self._attn_params()  # cross-attn per decoder layer
        return n

    def active_param_count(self) -> int:
        """N_active for MoE (6*N_active*D)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        all_expert = self.num_experts * self._mlp_params(self.moe_d_ff)
        active_expert = self.top_k * self._mlp_params(self.moe_d_ff)
        return full - self.num_layers * (all_expert - active_expert)

    def _default_block(self) -> str:
        return {"ssm": "ssd", "moe": "moe"}.get(self.family, "attn_mlp")

    def _attn_params(self) -> int:
        d = self.d_model
        n = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            n += self.q_dim + 2 * self.kv_dim
        return n

    def _mlp_params(self, ff) -> int:
        return 3 * self.d_model * ff  # gated (swiglu/geglu)

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        if kind in ("attn", "attn_mlp", "attn_local", "attn_nc_mlp",
                    "attn_cross_mlp"):
            n = self._attn_params()
            if kind != "attn":
                n += self._mlp_params(self.d_ff)
            if kind == "attn_cross_mlp":
                n += self._attn_params()
            return n + 2 * d
        if kind == "moe":
            n = self._attn_params()
            n += self.num_experts * self._mlp_params(self.moe_d_ff)
            n += self.num_shared_experts * self._mlp_params(self.moe_d_ff)
            n += d * self.num_experts  # router
            return n + 2 * d
        if kind == "ssd":
            di, H, N = self.ssm_inner, self.ssm_heads, self.ssm_state
            G = self.ssm_groups
            n = d * (2 * di + 2 * G * N + H)  # in_proj (z,x,B,C,dt)
            n += di * self.ssm_conv_width  # depthwise conv (x only)
            n += H  # A_log
            n += di * d  # out_proj
            n += di  # D skip
            return n + d  # norm
        if kind == "rglru":
            w = self.lru_width
            d_ff = self.d_ff
            # recurrent block: 2 branch projections + conv + lru gates + out
            n = d * w * 2 + w * self.ssm_conv_width + 3 * w + w * d
            n += self._mlp_params(d_ff)  # paired MLP
            return n + 2 * d
        raise ValueError(f"unknown block kind {kind!r}")
