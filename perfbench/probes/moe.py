"""The grouped expert product (``kernels/moe_gmm.py``) alone: a train
microbatch's forward, dX and dW, and a decode round's forward, the gate/up
(D → F) and down (F → D) products apart, on random bf16 operands."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..counts import gmm_least_s
from ..families.moe import capacity
from ..trace import kernel_times


def _operands(E: int, C: int, D: int, F: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    return r(E, C, D), r(E, C, F), r(E, D, F), r(E, F, D)


def train(a: Any, mix: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """At a microbatch's capacity (its T tokens under the capacity rule)."""
    from repro_torch.kernels import ops
    E, D, F = a.n_experts, a.d, a.d_expert
    C = capacity(mix["sequences_per_step"] // mix["microbatches"] * mix["seq_len"], a)
    x_d, x_f, w_df, w_fd = _operands(E, C, D, F)
    least = gmm_least_s(E, C, D, F)         # the same for D → F and F → D
    return kernel_times({
        "fwd_up": (lambda: ops.moe_gmm_fwd(x_d, w_df), least),
        "fwd_down": (lambda: ops.moe_gmm_fwd(x_f, w_fd), least),
        "dx_up": (lambda: ops.moe_gmm_bwd(x_d, w_df, x_f, True, False), least),
        "dx_down": (lambda: ops.moe_gmm_bwd(x_f, w_fd, x_d, True, False), least),
        "dw_up": (lambda: ops.moe_gmm_bwd(x_d, w_df, x_f, False, True), least),
        "dw_down": (lambda: ops.moe_gmm_bwd(x_f, w_fd, x_d, False, True), least),
    })


def serve(a: Any, mix: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """At a decode round of every slot (C = slots: a round never drops),
    every expert's rows full."""
    from repro_torch.kernels import ops
    E, D, F, C = a.n_experts, a.d, a.d_expert, mix["slots"]
    x_d, x_f, w_df, w_fd = _operands(E, C, D, F)
    least = gmm_least_s(E, C, D, F)         # the same for D → F and F → D
    return kernel_times({
        "fwd_up": (lambda: ops.moe_gmm_fwd(x_d, w_df), least),
        "fwd_down": (lambda: ops.moe_gmm_fwd(x_f, w_fd), least),
    })
