"""Carry a ``repro`` parameter (or cache) tree, or a whole train state, given
as numpy arrays, into the port's tensors on the same key paths.

The scan-stacked ``(groups, pattern, ...)`` layout is kept as it is. bf16
arrays arrive as numpy arrays of ``ml_dtypes.bfloat16``; they cross as
int16 bits and are viewed as ``torch.bfloat16``, so the values are exact
and ``ml_dtypes`` is never imported here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import DEFAULT_DEVICE
from .optim.adamw import AdamWState


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """A copy of ``a`` on ``device`` (default ``cuda``)."""
    a = np.array(a, order="C")           # a writable copy the tensor owns
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device if device is not None else DEFAULT_DEVICE)


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays → nested dicts of tensors on ``device``
    (default ``cuda``)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)


def state_from_numpy(state: Any, device=None) -> Any:
    """A ``repro`` train state as numpy (``{"params", "opt", "data_step"}``,
    ``opt`` its ``AdamWState(step, master, m, v)`` or any 4-tuple in that
    order) → the port's state on ``device`` (default ``cuda``), so that both
    frameworks can start from one state."""
    step, master, m, v = state["opt"]
    return {"params": params_from_numpy(state["params"], device),
            "opt": AdamWState(tensor_from_numpy(np.asarray(step), device),
                              *(params_from_numpy(t, device) for t in (master, m, v))),
            "data_step": tensor_from_numpy(np.asarray(state["data_step"]), device)}
