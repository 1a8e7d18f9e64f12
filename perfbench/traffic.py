"""The one traffic generator. A mix is a JSON file under ``traffic/`` whose
``kind`` picks one of three generators:

- ``train``: ``sequences_per_step`` rows of ``seq_len`` random tokens a
  step (labels are the next tokens), in ``microbatches`` microbatches;
- ``open_loop``: requests due at Poisson arrivals of ``rate_per_s``;
- ``backlog``: ``requests`` requests, all due at t = 0.

Every seed gets the same work: lengths are the quantiles of their
lognormal at (i + 0.5) / n and the gaps between arrivals those of the
exponential, so that a seed only reorders them and draws the token ids.
A mix with an ``order_seed`` orders them by that seed for every run (one
schedule, replayed), so that a tail measures the program and not the luck
of an order; the run's seed still draws the token ids and the weights.
A mix's ``smoke`` entry replaces its sizes for the CPU tests. A mix holds
only what the generator implements (``KEYS``, ``METHODS``): ``resolve``
refuses any other key or method, such as prefix sharing or bursts, which
need a generator of their own.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Any, Dict, List

import numpy as np

from .common import sub_seed

# every key a mix of each kind may have; ``smoke`` may replace any of them
KEYS = {
    "train": {"sequences_per_step", "seq_len", "microbatches", "checked_steps"},
    "open_loop": {"arrivals", "order_seed", "rate_per_s", "prompt", "output", "slots",
                  "max_len", "check_requests"},
    "backlog": {"requests", "order_seed", "prompt", "output", "slots", "max_len",
                "check_requests"},
}
# the only value the generator implements of each key that names a method
METHODS = {"arrivals": "poisson", "dist": "lognormal"}
LENGTH_KEYS = {"dist", "median", "sigma", "min", "max"}


def resolve(mix: Dict[str, Any], smoke: bool = False) -> Dict[str, Any]:
    """The mix's parameters, with its ``smoke`` entry laid over them.
    Raises on a kind, a key or a method the generator does not implement,
    so that no setting is silently ignored."""
    kind = mix.get("kind")
    if kind not in KEYS:
        raise ValueError(f"traffic kind {kind!r}: want one of {sorted(KEYS)}")
    out = {k: v for k, v in mix.items() if k != "smoke"}
    if smoke:
        out.update(mix.get("smoke", {}))
    unknown = set(out) - KEYS[kind] - {"kind"}
    for part in ("prompt", "output"):
        if part in out:
            unknown |= {f"{part}.{k}" for k in set(out[part]) - LENGTH_KEYS}
    if unknown:
        raise ValueError(f"a {kind} mix has no keys {sorted(unknown)}")
    methods = [("arrivals", out.get("arrivals"))] + [
        ("dist", out[part].get("dist")) for part in ("prompt", "output") if part in out]
    for key, value in methods:
        if value is not None and value != METHODS[key]:
            raise ValueError(f"{key} {value!r}: the generator implements {METHODS[key]!r} only")
    return out


@dataclass
class RequestSpec:
    index: int
    due_s: float                    # seconds after the window opens
    prompt: List[int]
    max_new_tokens: int


def lognormal_lengths(dist: Dict[str, Any], n: int) -> List[int]:
    """n lengths: the quantiles at (i + 0.5) / n of a lognormal of
    ``median`` and ``sigma``, rounded and clipped to [``min``, ``max``]."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = dist["median"] * math.exp(dist["sigma"] * z)
        out.append(int(min(max(round(x), dist["min"]), dist["max"])))
    return out


def _permuted(xs: List[Any], seed: int, label: str) -> List[Any]:
    order = np.random.default_rng(sub_seed(seed, label)).permutation(len(xs))
    return [xs[i] for i in order]


def _requests(spec: Dict[str, Any], seed: int, n: int, due: List[float],
              vocab: int) -> List[RequestSpec]:
    order = spec.get("order_seed", seed)
    prompts = _permuted(lognormal_lengths(spec["prompt"], n), order, "prompt_lengths")
    outputs = _permuted(lognormal_lengths(spec["output"], n), order, "output_lengths")
    rng = np.random.default_rng(sub_seed(seed, "prompt_tokens"))
    return [RequestSpec(i, due[i], rng.integers(0, vocab, size=p).tolist(), o)
            for i, (p, o) in enumerate(zip(prompts, outputs))]


def open_loop(spec: Dict[str, Any], seed: int, seconds: float,
              vocab: int) -> List[RequestSpec]:
    """round(rate · seconds) requests due in [0, seconds): the n + 1 gaps
    are the exponential's quantiles, in the seed's order, scaled to sum to
    ``seconds``."""
    n = max(1, round(spec["rate_per_s"] * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / (n + 1)) for i in range(n + 1)]
    gaps = _permuted(gaps, spec.get("order_seed", seed), "gaps")
    scale = seconds / sum(gaps)
    due, t = [], 0.0
    for g in gaps[:n]:
        t += g * scale
        due.append(t)
    return _requests(spec, seed, n, due, vocab)


def backlog(spec: Dict[str, Any], seed: int, vocab: int) -> List[RequestSpec]:
    n = spec["requests"]
    return _requests(spec, seed, n, [0.0] * n, vocab)


def train_batch(spec: Dict[str, Any], seed: int, step: int, vocab: int):
    """Step ``step``'s batch: (tokens, labels), each (sequences_per_step,
    seq_len) int64 on the host, from one draw of seq_len + 1 tokens a row."""
    rng = np.random.default_rng(sub_seed(seed, f"train_batch/{step}"))
    rows = rng.integers(0, vocab, size=(spec["sequences_per_step"], spec["seq_len"] + 1))
    return rows[:, :-1].copy(), rows[:, 1:].copy()
