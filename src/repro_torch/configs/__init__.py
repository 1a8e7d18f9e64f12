"""Config registry: ``--arch <id>`` resolution for all assigned architectures.

The port's own copy of ``repro.configs`` (pure dataclasses), kept so that
``repro_torch`` imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict

from .base import (  # noqa: F401
    EncDecConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    TrainConfig,
    VisionConfig,
)
from . import (
    chatglm3_6b,
    gemma3_12b,
    mamba2_370m,
    mixtral_8x22b,
    phi_3_vision_4_2b,
    qwen1_5_0_5b,
    qwen2_7b,
    qwen3_moe_30b_a3b,
    whisper_tiny,
    zamba2_2_7b,
)

_MODULES = (
    mixtral_8x22b,
    qwen3_moe_30b_a3b,
    zamba2_2_7b,
    mamba2_370m,
    phi_3_vision_4_2b,
    gemma3_12b,
    qwen1_5_0_5b,
    chatglm3_6b,
    qwen2_7b,
    whisper_tiny,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE_ARCHS if smoke else ARCHS
    try:
        return table[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}") from None


def cells(include_skipped: bool = False):
    """All (arch × shape) dry-run cells; skipped ones carry their reason."""
    out = []
    for arch, cfg in ARCHS.items():
        for shape_name, shape in SHAPES.items():
            skipped = shape_name in cfg.skip_shapes
            if skipped and not include_skipped:
                continue
            out.append((arch, shape_name,
                        cfg.skip_reasons.get(shape_name) if skipped else None))
    return out
