"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP stub frontend.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,          # GQA kv=32 (full MHA)
    d_ff=8192,
    vocab=32064,
    rope_theta=10000.0,
    vision=VisionConfig(n_patches=576, patch_dim=1024),
    skip_shapes=("long_500k",),
    skip_reasons={"long_500k": "pure full attention backbone"},
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    vision=VisionConfig(n_patches=16, patch_dim=64),
)
