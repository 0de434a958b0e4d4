"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, attention-free (d_ff=0), vocab=50280, ssm_state=128;
expand=2 -> d_inner=2048, head_dim=64 -> 32 SSD heads, conv width 4.
"""
from ..models import ModelConfig
from ._base import make_smoke

FULL = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=16,       # unused (attention-free)
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=128,
    ssm_groups=1,
)
SMOKE = make_smoke(FULL, num_layers=3)
