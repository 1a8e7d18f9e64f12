"""Operations and bytes, counted by the benchmark from the configuration:
the model FLOPs of a train step, a prefill and a decode token, and the
least time of a grouped expert product on the card.

Model FLOPs are the matmul FLOPs of the parameters a token takes part in
(the family's count: for a mixture of experts, the K experts a token is
routed to, not the capacity padding), with causal attention counted exactly (query i
reads min(i + 1, window) keys); a train step counts forward and backward
(3x the forward) and no recomputation. The arithmetic is the analytic
model of ``repro_torch.launch.analysis``, frozen here.
"""
from __future__ import annotations

from ..arch import Arch
from ..families import family

# NVIDIA's data sheet for one H100 SXM (dense bf16, HBM3)
PEAK_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def matmul_params(a: Arch) -> int:
    """Parameters that take part in a token's products (the family's
    count)."""
    return family(a.family).matmul_params(a)


def attended_keys(S: int, window: int) -> int:
    """Σ over the S queries of a causal pass of the keys each reads."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_flops(a: Arch, keys: int) -> float:
    """Scores and the weighted sum, over every layer, for ``keys``
    query-key pairs a head."""
    return 4.0 * a.n_layers * a.n_heads * a.head_dim * keys


def prefill_flops(a: Arch, T: int) -> float:
    return 2.0 * matmul_params(a) * T + attention_flops(a, attended_keys(T, a.window))


def train_step_flops(a: Arch, sequences: int, seq_len: int) -> float:
    return 3.0 * sequences * prefill_flops(a, seq_len)


def gmm_flops(E: int, C: int, D: int, F: int) -> float:
    return 2.0 * E * C * D * F


def gmm_bytes(E: int, C: int, D: int, F: int) -> float:
    """bf16: each operand read once, the result written once (the same
    three sizes for the forward (E,C,D)·(E,D,F), dX and dW)."""
    return 2.0 * (E * C * D + E * D * F + E * C * F)


def gmm_least_s(E: int, C: int, D: int, F: int) -> float:
    return max(gmm_flops(E, C, D, F) / PEAK_FLOPS, gmm_bytes(E, C, D, F) / HBM_BYTES_PER_S)
