"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,          # GQA kv=8
    d_ff=16384,
    vocab=32768,
    window=4096,           # sliding-window attention → long_500k is runnable
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
    window=64, moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256),
)
