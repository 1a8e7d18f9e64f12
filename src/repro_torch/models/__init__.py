# Model substrate of the port: the dense, MoE, VLM, SSM, hybrid and audio
# families, whose parameters are nested dicts of tensors on repro's key paths.
from .layers import count_params, init_params, param_specs  # noqa: F401
from .model import Model, build_model  # noqa: F401
