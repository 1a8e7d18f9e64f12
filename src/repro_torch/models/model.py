"""Model API (port of ``repro.models.model``): the dense, MoE, VLM, SSM,
hybrid and audio families.

``Model`` is a stateless ``nn.Module``: parameters are nested dicts of
tensors passed to each call, as in ``repro``, so the public functions keep
``repro``'s signatures (``init``, ``param_specs``, ``logits``, ``loss``,
``init_cache``, ``prefill``, ``decode_step``) and dispatch by family as
``repro``'s does. The model's device is the one its tensors are made on:
``cuda`` unless the caller passes another. A VLM's ``logits`` take the
batch's ``patches``, an audio model's its ``frames``. Unlike ``repro``'s,
``prefill`` and ``prefill_into`` serve the SSM and hybrid families too:
they leave in the cache the state that feeding the prompt token by token
would. The audio family has neither, as in ``repro``: its serving cache
comes from ``runtime.serve.encdec_serve_cache``.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from .. import DEFAULT_DEVICE
from ..configs.base import ModelConfig
from . import encdec, hybrid, mamba2, transformer
from .layers import Schema, count_params, init_params, param_specs

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _no_prefill(cfg: ModelConfig, *args: Any, **kwargs: Any) -> Any:
    raise NotImplementedError(
        f"prefill-with-cache for family {cfg.family}: its serving cache comes from "
        f"runtime.serve.encdec_serve_cache (the encoder's cross K/V), then decode steps")


# each family's functions, as repro's model.py dispatches them; ``inputs``
# names the batch entries ``logits`` passes to ``forward`` after the tokens
_FAMILIES = {
    "dense": SimpleNamespace(schema=transformer.lm_schema, forward=transformer.forward,
                             inputs=(), cache_shapes=transformer.cache_shapes,
                             init_cache=transformer.init_cache,
                             decode_step=transformer.decode_step,
                             prefill=transformer.prefill,
                             prefill_into=transformer.prefill_into),
    "ssm": SimpleNamespace(schema=mamba2.ssm_lm_schema, forward=mamba2.ssm_forward,
                           inputs=(),
                           cache_shapes=mamba2.ssm_cache_shapes,
                           init_cache=mamba2.ssm_init_cache,
                           decode_step=mamba2.ssm_decode_step,
                           prefill=mamba2.ssm_prefill,
                           prefill_into=mamba2.ssm_prefill_into),
    "hybrid": SimpleNamespace(schema=hybrid.hybrid_schema, forward=hybrid.forward,
                              inputs=(), cache_shapes=hybrid.cache_shapes,
                              init_cache=hybrid.init_cache,
                              decode_step=hybrid.decode_step, prefill=hybrid.prefill,
                              prefill_into=hybrid.prefill_into),
    "audio": SimpleNamespace(schema=encdec.encdec_schema, forward=encdec.forward,
                             inputs=("frames",), cache_shapes=encdec.cache_shapes,
                             init_cache=encdec.init_cache, decode_step=encdec.decode_step,
                             prefill=_no_prefill, prefill_into=_no_prefill),
}
_FAMILIES["moe"] = _FAMILIES["dense"]
_FAMILIES["vlm"] = SimpleNamespace(**{**vars(_FAMILIES["dense"]), "inputs": ("patches",)})


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        if cfg.family not in _FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        self.device = torch.device(device if device is not None else DEFAULT_DEVICE)
        self.param_dtype = _DTYPES[cfg.param_dtype]
        self.family = _FAMILIES[cfg.family]
        self.schema: Schema = self.family.schema(cfg)

    # ---------------- params ----------------
    def init(self, rng: torch.Generator) -> Dict[str, Any]:
        """Truncated-normal fan-in init from ``rng`` (a generator on the
        model's device), in the config's param dtype."""
        return init_params(self.schema, rng, self.param_dtype, self.device)

    def param_specs(self) -> Dict[str, Any]:
        """The parameter tree as tensors on the ``meta`` device."""
        return param_specs(self.schema, self.param_dtype)

    def n_params(self) -> int:
        return count_params(self.param_specs())

    # ---------------- forward ----------------
    def logits(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
               remat: str = "block") -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (logits over the token positions, aux loss). A VLM's batch
        holds ``patches``, an audio model's ``frames``, beside the tokens."""
        return self.family.forward(self.cfg, params, batch["tokens"],
                                   *(batch[k] for k in self.family.inputs), remat=remat)

    forward = logits

    def loss(self, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             remat: str = "block") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux = self.logits(params, batch, remat)
        lg = logits.float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, batch["labels"][..., None].long())[..., 0]
        ce = (lse - gold).mean()
        total = ce
        if self.cfg.moe is not None:
            total = total + self.cfg.moe.aux_loss_weight * aux
        return total, {"ce": ce, "aux": aux,
                    "ppl_proxy": torch.exp(torch.clamp(ce, 0, 20.0))}

    # ---------------- serving ----------------
    def cache_shapes(self, batch: int, max_len: int) -> Dict[str, Any]:
        """The cache's leaf shapes (nested dicts of tuples)."""
        return self.family.cache_shapes(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        return self.family.init_cache(self.cfg, batch, max_len, self.param_dtype,
                                      self.device)

    def decode_step(self, params: Dict[str, Any], cache: Dict[str, Any],
                    token: torch.Tensor, pos: Union[int, torch.Tensor],
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Updates ``cache`` in place; ``pos`` is an int or per row (see
        ``transformer.decode_step``; an SSM does not read it)."""
        return self.family.decode_step(self.cfg, params, cache, token, pos)

    def prefill(self, params: Dict[str, Any], tokens: torch.Tensor,
                max_len: int, extra: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """→ (last-position logits, cache of ``max_len`` slots). A VLM takes
        ``extra["patches"]``: the cache then holds the patch rows before the
        prompt. The audio family raises, as in ``repro``."""
        return self.family.prefill(self.cfg, params, tokens, max_len, **(extra or {}))

    def prefill_into(self, params: Dict[str, Any], tokens: torch.Tensor,
                     cache: Dict[str, Any], row: int = 0) -> torch.Tensor:
        """Prefill into rows ``row ..`` of an existing cache, in place; →
        last-position logits. See each family's ``prefill_into``."""
        return self.family.prefill_into(self.cfg, params, tokens, cache, row)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
