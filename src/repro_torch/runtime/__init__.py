# Runtime of the port: serving (step factories, continuous batching) and
# the train step (microbatch accumulation, remat, AdamW).
from .serve import (  # noqa: F401
    ContinuousBatcher,
    Request,
    make_prefill_step,
    make_serve_step,
)
from .train import init_state, make_train_step, n_microbatches  # noqa: F401
