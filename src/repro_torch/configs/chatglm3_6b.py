"""chatglm3-6b [dense] — 2d (partial) RoPE, extreme GQA kv=2.
[arXiv:2406.12793; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,           # GQA kv=2
    d_ff=13696,
    vocab=65024,
    qkv_bias=True,
    rope_fraction=0.5,      # "RoPE 2d": rotate half of each head dim
    skip_shapes=("long_500k",),
    skip_reasons={"long_500k": "pure full attention"},
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
)
