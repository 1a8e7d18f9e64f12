"""whisper-tiny [audio] — encoder-decoder; conv/mel frontend stubbed to
precomputed frame embeddings via input_specs(). [arXiv:2212.04356; unverified]

Note: real whisper caps decoder positions at 448; decode_32k/long_500k are
architecturally meaningless for it. decode_32k is still *lowered* (the
position table is sized to the request) to maximise dry-run coverage;
long_500k is skipped (pure full attention + enc-dec)."""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,             # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    encdec=EncDecConfig(n_encoder_layers=4, n_frames=1500),
    skip_shapes=("long_500k",),
    skip_reasons={"long_500k": "enc-dec full attention; decoder positions "
                               "are bounded by design (448 in the paper)"},
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=512,
    encdec=EncDecConfig(n_encoder_layers=2, n_frames=32),
)
