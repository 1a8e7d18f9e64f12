"""Model / run configuration system.

One ``ModelConfig`` describes any of the assigned architectures; family-
specific knobs live in optional sub-configs. ``ShapeConfig`` describes the
four assigned input shapes. ``RunConfig`` binds (arch × shape × mesh ×
training knobs) — the unit the launcher and dry-run consume.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0            # expert hidden size (≠ dense d_ff)
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128            # N (per-head SSM state)
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256                # SSD chunk length
    n_groups: int = 1               # B/C groups (GVA analogue)


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + one *shared* attention block applied
    every ``attn_every`` layers (same weights each application)."""

    attn_every: int = 6
    shared_attn: bool = True


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder–decoder; the conv/mel frontend is a stub that
    delivers precomputed frame embeddings."""

    n_encoder_layers: int = 4
    n_frames: int = 1500            # encoder positions after conv stride


@dataclass(frozen=True)
class VisionConfig:
    """Phi-3-vision-style stub frontend: precomputed patch embeddings are
    prepended to the token sequence."""

    n_patches: int = 576
    patch_dim: int = 1024           # CLIP output dim before projection


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # chatglm rotates half the head dim
    window: int = 0                 # sliding-window size; 0 = full attention
    local_global: int = 0           # gemma3: N local layers per 1 global
    local_window: int = 1024
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vision: Optional[VisionConfig] = None
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # which input shapes this arch supports (skips recorded in DESIGN.md)
    skip_shapes: Tuple[str, ...] = ()
    skip_reasons: Dict[str, str] = field(default_factory=dict, hash=False)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        return (self.family in ("ssm", "hybrid") or self.window > 0
                or self.local_global > 0)

    def scaled(self, **overrides: Any) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    # ---- analytic parameter counts (→ MODEL_FLOPS in §Roofline) ----
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim_
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    b = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + b


def _mlp_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff       # SwiGLU: gate, up, down


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    assert s is not None
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    in_proj = cfg.d_model * (2 * d_in + 2 * s.n_groups * s.state_dim + nh)
    conv = (d_in + 2 * s.n_groups * s.state_dim) * s.conv_width
    out = d_in * cfg.d_model
    return in_proj + conv + out + 2 * nh + d_in   # A, dt_bias, D, norm


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab * cfg.d_model                     # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model                # lm head
    per_layer_norms = 2 * cfg.d_model
    if cfg.family in ("dense", "vlm"):
        layer = _attn_params(cfg) + _mlp_params(cfg.d_model, cfg.d_ff) + per_layer_norms
        n += cfg.n_layers * layer
        if cfg.vision is not None:
            n += cfg.vision.patch_dim * cfg.d_model     # projection
    elif cfg.family == "moe":
        m = cfg.moe
        assert m is not None
        n_e = m.top_k if active_only else m.n_experts
        layer = (
            _attn_params(cfg)
            + n_e * _mlp_params(cfg.d_model, m.d_ff_expert or cfg.d_ff)
            + cfg.d_model * m.n_experts               # router
            + per_layer_norms
        )
        n += cfg.n_layers * layer
    elif cfg.family == "ssm":
        n += cfg.n_layers * (_ssm_params(cfg) + cfg.d_model)
    elif cfg.family == "hybrid":
        n += cfg.n_layers * (_ssm_params(cfg) + cfg.d_model)
        if cfg.hybrid is not None and cfg.hybrid.shared_attn:
            n += _attn_params(cfg) + _mlp_params(cfg.d_model, cfg.d_ff) + per_layer_norms
    elif cfg.family == "audio":
        e = cfg.encdec
        assert e is not None
        enc_layer = _attn_params(cfg) + _mlp_params(cfg.d_model, cfg.d_ff) + per_layer_norms
        dec_layer = 2 * _attn_params(cfg) + _mlp_params(cfg.d_model, cfg.d_ff) + 3 * cfg.d_model
        n += e.n_encoder_layers * enc_layer + cfg.n_layers * dec_layer
    else:
        raise ValueError(f"unknown family {cfg.family}")
    n += cfg.d_model                                  # final norm
    return n


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    microbatch_per_device: int = 1   # grad-accum chunk size
    remat: str = "block"             # none | block | full
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True               # shard optimizer state over data axis
    zero2: bool = True               # accumulate grads in the ZeRO sharding
    opt_dtype: str = "bfloat16"      # moments dtype (master stays f32)
    grad_compression: str = "none"   # none | int8 (cross-pod all-reduce)
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    multi_pod: bool = False
    use_pallas: bool = False         # TPU only; CPU dry-run uses XLA ref path
