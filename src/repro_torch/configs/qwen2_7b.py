"""qwen2-7b [dense] — GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,           # GQA kv=4
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    skip_shapes=("long_500k",),
    skip_reasons={"long_500k": "pure full attention"},
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
)
