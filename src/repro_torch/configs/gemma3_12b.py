"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,           # GQA kv=8
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    local_global=5,         # 5 local (SWA) layers per 1 global layer
    local_window=1024,
    rope_theta=1e6,
    # long_500k decode is runnable: 5/6 of layers cap KV at the window and
    # the 1/6 global layers are linear-cost at decode.
)

SMOKE = CONFIG.scaled(
    n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, local_global=2, local_window=64,
)
