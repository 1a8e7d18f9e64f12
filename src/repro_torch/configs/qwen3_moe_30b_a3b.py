"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,          # GQA kv=4
    head_dim=128,          # explicit head_dim (32*128 != d_model)
    d_ff=768,              # MoE expert intermediate size
    vocab=151936,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    skip_shapes=("long_500k",),
    skip_reasons={"long_500k": "pure full attention (no SWA/SSM); "
                               "O(seq) KV at 500k is out of scope per brief"},
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
)
