"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-360M].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, head_dim=64.
"""
from ..models import ModelConfig
from ._base import make_smoke

FULL = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
)
SMOKE = make_smoke(FULL, num_layers=2, num_heads=3, num_kv_heads=1)
