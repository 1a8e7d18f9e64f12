# AdamW of the port (f32 master, moments in the configured dtype), a copy of
# repro.optim.adamw's arithmetic over dicts of tensors; int8 gradient
# compression with error feedback (repro.optim.compress).
from .adamw import AdamW, AdamWState, global_norm, warmup_cosine  # noqa: F401
from .compress import (  # noqa: F401
    compressed_psum_pod,
    dequantize_int8,
    error_feedback_update,
    quantize_int8,
)
