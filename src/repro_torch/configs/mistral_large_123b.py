"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768, head_dim=128.
246 GB of bf16 parameters: full width does not fit on one card, and
waits for the sharded layouts (ROADMAP A12); the smoke config runs.
"""
from ..models import ModelConfig
from ._base import make_smoke

FULL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
)
SMOKE = make_smoke(FULL, num_layers=2)
