"""repro_torch.models — the dense decoder family on PyTorch."""
from .config import ModelConfig
from .transformer import (
    block_pattern,
    decode_step,
    init_decode_caches,
    init_params,
    prefill,
    supports_padded_prefill,
)

__all__ = [
    "ModelConfig", "block_pattern", "decode_step", "init_decode_caches",
    "init_params", "prefill", "supports_padded_prefill",
]
