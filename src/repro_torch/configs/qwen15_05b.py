"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936, rope theta 1e6.
"""
from ..models import ModelConfig
from ._base import make_smoke

FULL = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
)
SMOKE = make_smoke(FULL, num_layers=2, qkv_bias=True)
