"""qwen1.5-0.5b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # GQA kv=16 (full MHA)
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
    skip_reasons={"long_500k": "pure full attention"},
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
)
