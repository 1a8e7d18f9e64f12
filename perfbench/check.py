"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference, number by number, each under the limit
``checks/<workload>.json`` sets for it (with the readings it was set
from)."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

from .arch import Arch
from .reference import serve as ref_serve
from .reference import train as ref_train
from .reference.model import Prec, strict_f32
from .traffic import train_batch


def train_reference(a: Arch, cfg_file: Dict[str, Any], mix: Dict[str, Any], seed: int,
                    steps: int, device: str, prec: str = "f32", batches=None) -> Dict[str, Any]:
    """The reference's first ``steps`` steps on the seed's batches (or on
    ``batches``)."""
    strict_f32()
    if batches is None:
        batches = [train_batch(mix, seed, j, a.vocab) for j in range(steps)]
    return ref_train.run(a, cfg_file["train"], seed, batches, mix["microbatches"], device,
                         Prec(prec))


# the output head: its first gradient reads every token's probability of its
# own label, and the hidden state it multiplies has the size RMSNorm gives
# it, so a routing choice that rounding flips moves its norm little, and a
# coarser rounding of the logits moves it much (PERF.md, "correct")
HEAD = "lm_head"


def train_compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The program's first steps (``prog``: losses, first gradient's and
    last change's leaf norms) against the reference's: → {"loss_gap": worst
    step's |Δloss| / loss, "grad_gap", "change_gap": the worst leaf's gap of
    norms (``reference.train.leaf_gaps``), "lm_head_grad_gap": the output
    head's gap of first-gradient norms}."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad = ref_train.leaf_gaps(prog["grad_norm"], ref["grad_norm"], ref["grad_norm"])
    change = ref_train.leaf_gaps(prog["change"], ref["change"], ref["grad_norm"])
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "lm_head_grad_gap": grad[HEAD], "change_gap": max(change.values())}


def serve_numbers(a: Arch, seed: int, served: List[Tuple[List[int], List[int]]],
                  device: str) -> Dict[str, float]:
    """→ {"served_mean_gap": the mean, over the sampled requests' served
    tokens, of each token's logit gap below the reference's best at its
    place}. (The widest gap does not separate the program from the control:
    with random weights the top logits lie close, and a routing choice that
    rounding flips moves a token's logits by 1 to 3 in either precision.)"""
    strict_f32()
    if not served:
        return {"served_mean_gap": math.inf}
    return {"served_mean_gap": ref_serve.gaps(a, seed, served, device)["mean_gap"]}


def limits_for(checks: Dict[str, Any], smoke: bool = False) -> Dict[str, Any]:
    """A checks file's limits; at the configurations' smoke sizes (the CPU
    tests) with its ``smoke`` entry's limits laid over them."""
    out = dict(checks["limits"])
    if smoke:
        out.update({k: {"limit": v} for k, v in checks.get("smoke", {}).items()})
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, Any]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every limited number at or under its limit (a NaN is not). →
    (correct, {name: {"value", "limit"}})."""
    shown, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name, math.nan)
        shown[name] = {"value": v, "limit": spec["limit"]}
        ok = ok and not math.isnan(v) and v <= spec["limit"]
    return ok, shown
