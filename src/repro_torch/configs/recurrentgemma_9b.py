"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2
[arXiv:2402.19427].  38 blocks in (rglru, rglru, local-attn) repeating
units; d_model=4096, MQA (kv=1) head_dim=256, d_ff=12288, vocab=256000,
local window 2048, lru_width=4096.
"""
from ..models import ModelConfig
from ._base import make_smoke

FULL = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn_local"),
    local_window=2048,
    lru_width=4096,
    act="gelu",
)
SMOKE = make_smoke(FULL, num_layers=5, num_kv_heads=1)
