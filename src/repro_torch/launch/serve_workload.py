"""End-to-end serving entry point: continuous batching under Lotaru ordering.

    PYTHONPATH=src python -m repro_torch.launch.serve_workload [--device cpu] [--smoke]
        [--config qwen3-moe-30b-a3b|mamba2-370m|zamba2-2.7b|phi-3-vision-4.2b]

A model (``--config``, default qwen1.5-0.5b; a dense, MoE, SSM, hybrid or
VLM config) serves a burst of requests through the ContinuousBatcher. A
VLM's requests are text only, as ``repro``'s batcher serves one (a
``Request`` carries no patches). An audio model is refused: its decode
needs the encoder's cross K/V (``runtime.serve.encdec_serve_cache``), which
the batcher does not fill, in ``repro`` either.
Admission order is shortest-predicted-first: the Lotaru runtime predictor
ranks each request by its predicted decode time (the CWS rank_min analogue
for serving), which minimises mean latency. The engine decodes one token
per active slot per round and refills slots as requests finish.

Without ``--smoke`` the model is the full-width config in bf16 with random
weights from ``--seed``: 16 requests with prompts of 32-512 tokens and
16-64 new tokens each, 8 slots, a 2048-token cache. With ``--smoke`` it is
the smoke config: 12 requests with prompts of 4-11 tokens, 4 slots, 96
tokens of cache.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config
from ..core.predict import LotaruPredictor
from ..models import build_model
from ..models.model import Model
from ..runtime.serve import ContinuousBatcher, Request

# (requests, batch slots, cache length, prompt lengths [lo, hi), new tokens)
BURSTS = {
    "smoke": (12, 4, 96, (4, 12), (8, 16, 32)),
    "full": (16, 8, 2048, (32, 513), (16, 32, 64)),
}


def make_requests(vocab: int, rng: np.random.Generator, smoke: bool) -> List[Request]:
    n, _, _, (lo, hi), new_tokens = BURSTS["smoke" if smoke else "full"]
    reqs = []
    for i in range(n):
        n_new = int(rng.choice(new_tokens))
        prompt = rng.integers(2, vocab, size=int(rng.integers(lo, hi))).tolist()
        reqs.append(Request(req_id=f"r{i:02d}", prompt=prompt, max_new_tokens=n_new))
    return reqs


def shortest_predicted_first(reqs: List[Request], new_tokens) -> List[Request]:
    """Order requests by the Lotaru-predicted decode time of their length."""
    pred = LotaruPredictor()
    for nt in new_tokens:
        pred.observe(f"gen{nt}", nt, nt * 0.05)
    return sorted(reqs, key=lambda r: pred.predict(
        f"gen{r.max_new_tokens}", r.max_new_tokens)[0])


def run(model: Model, params: Any, smoke: bool, seed: int = 0) -> Dict[str, Any]:
    """Serve the burst on ``model``; → the requests (in creation and in
    admission order), the batcher and times."""
    _, slots, max_len, _, new_tokens = BURSTS["smoke" if smoke else "full"]
    rng = np.random.default_rng(seed)
    reqs = make_requests(model.cfg.vocab, rng, smoke)
    batcher = ContinuousBatcher(model, params, batch_slots=slots, max_len=max_len)
    t0 = time.perf_counter()
    order = shortest_predicted_first(reqs, new_tokens)
    for r in order:
        batcher.submit(r)
    batcher.drain()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    seconds = time.perf_counter() - t0
    tokens = sum(len(r.tokens_out) for r in reqs)
    return {"requests": reqs, "order": order, "batcher": batcher, "seconds": seconds,
            "tokens": tokens, "served": sum(r.done for r in reqs),
            "engine_steps": batcher.steps}


DEFAULT_CONFIG = "qwen1.5-0.5b"


def main(device: Optional[str] = None, smoke: bool = False, seed: int = 0,
         config: str = DEFAULT_CONFIG) -> Dict[str, Any]:
    cfg = get_config(config, smoke=smoke)
    if cfg.family == "audio":
        raise SystemExit(f"{config}: the batcher serves no audio model (it does not "
                         f"fill the encoder's cross K/V); see runtime.serve.encdec_serve_cache")
    model = build_model(cfg, device)
    params = model.init(torch.Generator(model.device).manual_seed(seed))
    out = run(model, params, smoke, seed)
    reqs = out["requests"]
    print(f"served {out['served']}/{len(reqs)} requests, {out['tokens']} tokens "
          f"in {out['seconds']:.3f}s on {model.device} "
          f"({out['tokens'] / out['seconds']:.1f} tok/s, "
          f"{out['engine_steps']} engine rounds)")
    for r in reqs[:3]:
        print(f"  {r.req_id}: prompt[:4]={r.prompt[:4]} -> out[:6]={r.tokens_out[:6]}")
    if out["served"] != len(reqs) or not all(r.tokens_out for r in reqs):
        raise RuntimeError("not every request was served")
    if not out["batcher"].all_logits_finite():
        raise RuntimeError("a decode round produced non-finite logits")
    print("OK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    ap.add_argument("--smoke", action="store_true", help="smoke-size config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", default=DEFAULT_CONFIG, help="model config name")
    a = ap.parse_args()
    main(a.device, a.smoke, a.seed, a.config)
