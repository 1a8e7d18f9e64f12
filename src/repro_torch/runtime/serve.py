"""Serving runtime (port of ``repro.runtime.serve``): step factories and
continuous batching.

``make_serve_step`` and ``make_prefill_step`` return ``repro``'s triple
(step, shardings, specs). With a ``DeviceMesh`` the shardings place the
params and the step's inputs (decode: ``decode_rules``, with expert
parallelism for an MoE model of 64 experts or more; prefill:
``train_rules``), and the step runs on DTensors; with ``mesh=None`` they
are ``None`` and the step runs on plain tensors, as on one card.

``ContinuousBatcher`` keeps a position per slot. A request is admitted by
one causal prefill of ``prompt[:-1]`` into its slot's cache row (the token
sequence ``repro``'s teacher-forced feed gives), and every engine round
decodes all active slots in one ``decode_step`` with per-slot positions.
``repro``'s batcher instead decodes every row at one slot's position and
feeds token 0 to the other rows, which overwrites their KV entries; this
one serves each request as if it were alone. For an SSM or hybrid model the
prefill also leaves the slot's conv and SSM state, which have no positions:
an admission overwrites them (a 1-token prompt zeroes them), so a reused
slot keeps nothing of its last request.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ShapeConfig
from ..models import encdec
from ..models.layers import tree_leaves
from ..models.model import Model
from ..models.moe import ep_mode
from ..shards import place
from ..spans import span
from .sharding import decode_rules, input_axes, shardings_for_tree, train_rules
from .train import mesh_context


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row; a vocab-sharded DTensor's logits are
    gathered over the vocab first (the batch keeps its placement)."""
    if isinstance(logits, DTensor):
        keep = tuple(p if p == Shard(0) else Replicate() for p in logits.placements)
        logits = place(logits, keep)
    return logits.argmax(-1).to(torch.int32)


def make_serve_step(model: Model, shape: ShapeConfig, mesh: Any = None,
                    multi_pod: bool = False) -> Tuple[Callable, Any, Dict[str, Any]]:
    """→ (serve_step, shardings, specs). ``serve_step(params, cache, token,
    pos) -> (next_token (B,), cache)``: one greedy decode step against a
    ``shape.seq_len`` cache. ``shardings`` (``None`` without a mesh) has
    ``repro``'s keys: ``params``, ``cache``, ``token``, ``pos``; ``specs``
    the same keys on ``meta``. Contexts past 100k tokens spread the cache's
    slots over every axis; an MoE model of 64 experts or more runs in
    ``ep_mode`` on a mesh."""
    long_ctx = shape.seq_len > 100_000
    n_exp = model.cfg.moe.n_experts if model.cfg.moe else 0
    use_ep = mesh is not None and model.cfg.family == "moe" and n_exp >= 64
    specs = {"params": model.param_specs(), **model.input_specs(shape)}
    shardings = None
    if mesh is not None:
        rules = decode_rules(multi_pod, long_ctx, model.cfg.family, n_exp)
        shardings = {"params": shardings_for_tree(specs["params"], model.param_axes(),
                                                  rules, mesh),
                     **shardings_for_tree(model.input_specs(shape),
                                          input_axes(model.cfg, "decode"), rules, mesh)}

    def serve_step(params, cache, token, pos):
        with mesh_context(mesh), (ep_mode() if use_ep else contextlib.nullcontext()):
            logits, cache = model.decode_step(params, cache, token, pos)
            return _argmax(logits), cache

    return serve_step, shardings, specs


def make_prefill_step(model: Model, shape: ShapeConfig, mesh: Any = None,
                      multi_pod: bool = False) -> Tuple[Callable, Any, Dict[str, Any]]:
    """→ (prefill_step, shardings, specs). ``prefill_step({"params",
    "tokens", ...}) -> (next_token (B,), state)``. Every family but audio
    builds a cache of ``shape.seq_len`` slots (a VLM takes ``"patches"``
    too, and its cache ``n_patches`` more slots for them). An audio model
    has no prefill-with-cache: as in ``repro``, the step runs its forward
    pass (``remat="none"``) over the tokens and ``"frames"`` and returns the
    last position's token with the aux loss (its serving cache comes from
    ``encdec_serve_cache``). On a mesh the params and inputs are placed by
    ``train_rules`` (``repro``'s measured choice: no expert parallelism for
    prefill); ``shardings`` has the keys ``params`` and the inputs'."""
    cfg = model.cfg
    specs = {"params": model.param_specs(), **model.input_specs(shape)}
    shardings = None
    if mesh is not None:
        rules = train_rules(multi_pod, cfg.family)
        shardings = {"params": shardings_for_tree(specs["params"], model.param_axes(),
                                                  rules, mesh),
                     **shardings_for_tree(model.input_specs(shape),
                                          input_axes(cfg, "prefill"), rules, mesh)}

    def prefill_step(args: Dict[str, Any]):
        params = args["params"]
        inputs = {k: v for k, v in args.items() if k != "params"}
        with mesh_context(mesh):
            if cfg.family == "audio":
                logits, aux = model.logits(params, {**inputs, "labels": inputs["tokens"]},
                                           remat="none")
                return _argmax(logits[:, -1, :]), aux
            extra = {k: v for k, v in inputs.items() if k != "tokens"}
            max_len = shape.seq_len
            if cfg.family == "vlm" and cfg.vision is not None:
                max_len += cfg.vision.n_patches
            logits, cache = model.prefill(params, inputs["tokens"], max_len, extra or None)
            return _argmax(logits), cache

    return prefill_step, shardings, specs


def encdec_serve_cache(model: Model, params: Any, frames: torch.Tensor,
                       max_len: int) -> Dict[str, torch.Tensor]:
    """An audio model's serving cache for ``frames`` (B, n_frames, d): empty
    self-attention K/V of ``max_len`` slots, and the cross K/V that the
    encoder gives (``encdec.prefill_cross_kv``), as ``repro``'s
    ``tests/test_models.py`` builds it. Decode steps from position 0 then
    take the prompt and generate."""
    ck, cv = encdec.prefill_cross_kv(model.cfg, params, frames)
    return {**model.init_cache(frames.shape[0], max_len), "cross_k": ck, "cross_v": cv}


def greedy_decode(model: Model, params: Any, cache: Dict[str, Any], prompt: torch.Tensor,
                  start: int, steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` decode steps of every row from ``cache`` (updated in place),
    step i at position ``start + i``: the first P feed ``prompt`` (B, P),
    the rest the greedy token of the step before. → (logits (steps, B, V),
    the fed tokens (B, steps)). From a prefill's cache, ``prompt`` is its
    next token (P = 1) and ``start`` the prompt's length; from
    ``encdec_serve_cache`` the prompt goes in at ``start`` 0."""
    B, P = prompt.shape
    fed = torch.empty(B, steps, dtype=torch.int64, device=prompt.device)
    logits: List[torch.Tensor] = []
    for i in range(steps):
        fed[:, i] = prompt[:, i] if i < P else logits[-1].argmax(-1)
        out, cache = model.decode_step(params, cache, fed[:, i], start + i)
        logits.append(out)
    return torch.stack(logits), fed


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------
@dataclass
class Request:
    req_id: str
    prompt: List[int]
    max_new_tokens: int = 32
    # seconds on the span clock (``time.time()``); ``submit`` stamps it
    # where the caller left it 0
    submitted_at: float = 0.0
    tokens_out: List[int] = field(default_factory=list)
    done: bool = False
    # logits (V,) of the first generated token, kept for checks
    first_logits: Optional[torch.Tensor] = None


class ContinuousBatcher:
    """Slot-based continuous batching over a fixed decode batch.

    Slots hold independent requests at their own positions; each engine
    round decodes one token for every active slot in one batched step.
    Finished slots are refilled from the admission queue between rounds
    (the queue order is the caller's, e.g. shortest-predicted-first under
    the Lotaru predictor). The KV cache is updated in place.
    """

    def __init__(self, model: Model, params: Any, batch_slots: int,
                 max_len: int, eos_token: int = 2) -> None:
        self.model = model
        self.params = params
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.max_len = max_len
        self.eos = eos_token
        self.cache = model.init_cache(batch_slots, max_len)
        self.pos = np.zeros(batch_slots, np.int64)      # per-slot lengths
        self.queue: List[Request] = []
        self.steps = 0                                  # decode rounds
        self.prefills = 0                               # admission prefills
        self._finite = torch.ones((), dtype=torch.bool, device=model.device)
        # each cache leaf's batch dim, from the cache shapes at two batch
        # sizes (as repro's batcher finds it)
        a = tree_leaves(model.cache_shapes(batch_slots, max_len))
        b = tree_leaves(model.cache_shapes(batch_slots + 1, max_len))
        self._batch_dims = [next(i for i, (x, y) in enumerate(zip(sa, sb)) if x != y)
                            for sa, sb in zip(a, b)]

    def submit(self, req: Request) -> None:
        if not 1 <= len(req.prompt) < self.max_len:
            raise ValueError(f"{req.req_id}: prompt of {len(req.prompt)} tokens; "
                             f"want 1..{self.max_len - 1}")
        if not req.submitted_at:
            req.submitted_at = time.time()
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                with span("batcher.admit", key=req.req_id, prompt_len=len(req.prompt)) as adm:
                    if adm.recording:
                        adm.set(queue_wait_us=int((time.time() - req.submitted_at) * 1e6))
                    self.slots[i] = req
                    self._load_slot(i, req.prompt[:-1])
                    self.pos[i] = len(req.prompt) - 1

    def _load_slot(self, slot: int, prefix: List[int]) -> None:
        """Prefill ``prefix`` into the slot's cache row in place (K/V, and
        for an SSM or hybrid model its conv and SSM state); the rest of the
        row is cleared. An empty prefix clears the whole row."""
        if not prefix:
            for c, d in zip(tree_leaves(self.cache), self._batch_dims):
                c.select(d, slot).zero_()
            return
        with span("batcher.upload", wait=True):
            tokens = torch.tensor([prefix], dtype=torch.int64, device=self.model.device)
        with span("model.prefill_into", key=self.slots[slot].req_id, device=self.model.device):
            self.model.prefill_into(self.params, tokens, self.cache, slot)
        self.prefills += 1

    def step(self) -> int:
        """One engine round: admit, decode one token per active slot."""
        with span("batcher.round", key=self.steps) as round_span:
            queued = len(self.queue)
            self._admit()
            active = [i for i, r in enumerate(self.slots) if r is not None]
            if round_span.recording:
                round_span.set(active=len(active), admitted=queued - len(self.queue))
            if not active:
                return 0
            tok = np.zeros(len(self.slots), np.int64)     # idle rows: token 0 at
            for i in active:                              # pos 0 of their own row
                req = self.slots[i]
                tok[i] = req.tokens_out[-1] if req.tokens_out else req.prompt[-1]
            with span("batcher.upload", wait=True):
                token = torch.from_numpy(tok).to(self.model.device)
            with span("model.decode_step", key=self.steps, device=self.model.device):
                logits, self.cache = self.model.decode_step(
                    self.params, self.cache, token, torch.from_numpy(self.pos.copy()))
            self._finite &= torch.isfinite(logits).all()
            with span("batcher.readback", wait=True):
                nxt = logits.argmax(-1).tolist()
            self.steps += 1
            for i in active:
                req = self.slots[i]
                if req.first_logits is None:
                    req.first_logits = logits[i].float().clone()
                req.tokens_out.append(nxt[i])
                self.pos[i] += 1
                if (nxt[i] == self.eos or len(req.tokens_out) >= req.max_new_tokens
                        or self.pos[i] >= self.max_len - 1):
                    req.done = True
                    self.slots[i] = None
                    self.pos[i] = 0      # the row is cleared when the slot is reused
            return len(active)

    def all_logits_finite(self) -> bool:
        """Whether every logit of every round so far was finite."""
        return bool(self._finite)

    def drain(self, max_rounds: int = 10_000) -> None:
        rounds = 0
        while (self.queue or any(s is not None for s in self.slots)):
            if self.step() == 0 and not self.queue:
                break
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError("batcher did not drain")
