"""Public kernel entry points of the port: dispatch by the tensor's device.

A CPU tensor takes the kernel's plain PyTorch version (the tests run there);
a CUDA tensor launches the hand-written kernel or raises. There is no
fallback from one to the other and no switch. Each CUDA wrapper counts its
launches; ``launch_counts`` reads the counts and ``reset_launch_counts``
sets them to 0, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .flash_attention import flash_attention_cuda, flash_attention_plain
from .rmsnorm import rmsnorm_cuda, rmsnorm_plain

_CUDA_WRAPPERS = {"rmsnorm": rmsnorm_cuda, "flash_fwd": flash_attention_cuda}


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel for device {t.device}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim, f32 statistics, one cast to x's dtype."""
    if _on_cuda(x, "rmsnorm"):
        return rmsnorm_cuda(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int,
                        kv_len: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (O (B, S, Hq, D), lse (B*Hq, S) f32); see ``kernels.flash_attention``."""
    if _on_cuda(q, "flash_attention_fwd"):
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    kv_len=kv_len)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len)


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _CUDA_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _CUDA_WRAPPERS.values():
        fn.launches = 0
