# The port's copy of repro.data (pure numpy): the same seed gives the same
# batches in both frameworks.
from .pipeline import DataConfig, TokenPipeline, synthetic_extras  # noqa: F401
