# Serving runtime of the port: step factories and continuous batching.
from .serve import (  # noqa: F401
    ContinuousBatcher,
    Request,
    make_prefill_step,
    make_serve_step,
)
