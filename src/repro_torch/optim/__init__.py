# AdamW of the port (f32 master, moments in the configured dtype), a copy of
# repro.optim.adamw's arithmetic over dicts of tensors.
from .adamw import AdamW, AdamWState, global_norm, warmup_cosine  # noqa: F401
