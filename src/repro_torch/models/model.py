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

import functools
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import DEFAULT_DEVICE
from ..configs.base import ModelConfig, ShapeConfig
from ..shards import local_shape_and_offset, place
from . import encdec, hybrid, mamba2, transformer
from .layers import Schema, count_params, init_params, param_axes, param_specs

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

    def param_axes(self) -> Dict[str, Any]:
        """Each parameter's logical axes (the schema's), for
        ``runtime.sharding``."""
        return param_axes(self.schema)

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
        if isinstance(lg, DTensor):
            lse, gold = _sharded_lse_and_gold(lg, batch["labels"])
        else:
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

    def cache_specs(self, batch: int, max_len: int) -> Dict[str, Any]:
        """The cache as tensors on the ``meta`` device, in the param dtype."""
        return _meta_tree(self.cache_shapes(batch, max_len), self.param_dtype)

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

    # ---------------- dry-run inputs ----------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``meta`` stand-ins for every model input of this cell, with
        ``repro``'s shapes and dtypes (tokens int32)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")  # noqa: E731
        if shape.kind in ("train", "prefill"):
            specs = {"tokens": meta((B, S), i32)}
            if shape.kind == "train":
                specs["labels"] = meta((B, S), i32)
            if cfg.family == "vlm":
                specs["patches"] = meta((B, cfg.vision.n_patches, cfg.vision.patch_dim),
                                        self.param_dtype)
            if cfg.family == "audio":
                specs["frames"] = meta((B, cfg.encdec.n_frames, cfg.d_model),
                                       self.param_dtype)
            return specs
        # decode: one new token against a seq_len cache
        return {"cache": self.cache_specs(B, S), "token": meta((B,), i32),
                "pos": meta((), i32)}

    # ---------------- analytics ----------------
    def model_flops_per_token(self) -> float:
        """6·N (dense) / 6·N_active (MoE): FLOPs per trained token."""
        return 6.0 * self.cfg.active_param_count()


def _lse_and_gold_parts(lg: torch.Tensor, labels: torch.Tensor, v0: int,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's vocab columns ``[v0, v0 + V)`` of the logits (B, S, V):
    → (their logsumexp, the label's logit where the label falls among
    them, else 0), each (B, S, 1)."""
    idx = labels.long()[..., None] - v0
    inside = (idx >= 0) & (idx < lg.shape[-1])
    gold = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1))
    return (torch.logsumexp(lg, dim=-1, keepdim=True),
            torch.where(inside, gold, torch.zeros_like(gold)))


def _sharded_lse_and_gold(lg: DTensor, labels: DTensor) -> Tuple[DTensor, DTensor]:
    """The loss's logsumexp and gold logit over a vocab that may be sharded
    (``"vocab"`` on "model"): each rank reduces its own columns, and the
    ranks' parts (one per vocab shard, a new last dim) are gathered and
    combined, a logsumexp of the logsumexps and a sum of the golds (one
    part holds the label). The rows keep the logits' placements."""
    mesh = lg.device_mesh
    keep = tuple(p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
                 for p in lg.placements)
    lg = place(lg, keep)
    lab_pl = tuple(Replicate() if p == Shard(2) else p for p in keep)
    labels = place(labels, lab_pl)
    v0 = local_shape_and_offset(lg.shape, mesh, keep)[1][2]
    lse, gold = local_map(functools.partial(_lse_and_gold_parts, v0=v0),
                          out_placements=(list(keep), list(keep)),
                          in_placements=(keep, lab_pl), device_mesh=mesh)(lg, labels)
    if lse.shape[-1] == 1:                  # the vocab is whole on every rank
        return lse[..., 0], gold[..., 0]
    # the parts' all-gather over the vocab-splitting mesh dims
    whole = tuple(Replicate() if p == Shard(2) else p for p in keep)
    lse, gold = place(lse, whole), place(gold, whole)
    return torch.logsumexp(lse, dim=-1), gold.sum(-1)


def _meta_tree(shapes: Any, dtype: torch.dtype) -> Any:
    if isinstance(shapes, dict):
        return {k: _meta_tree(v, dtype) for k, v in shapes.items()}
    return torch.empty(shapes, dtype=dtype, device="meta")


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
