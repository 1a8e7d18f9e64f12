"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,          # GQA kv=32 (full MHA in the shared block)
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    hybrid=HybridConfig(attn_every=6, shared_attn=True),
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk=32),
    hybrid=HybridConfig(attn_every=2, shared_attn=True),
)
