"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, vocab=512,
    ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk=32),
)
