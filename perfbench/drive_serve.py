"""A serving cell: ``repro_torch``'s ``ContinuousBatcher`` (admission
prefill into a slot's cache, decode rounds over every slot) fed by the
harness's loop, open (requests submitted when due) or offline (a backlog
queued at t = 0). The loop records, from the client's side, when each
request was due, left the queue and got each token, and each round's
host time and load."""
from __future__ import annotations

import gc
import time
from collections import deque
from typing import Any, Dict, List

import numpy as np
import torch

from . import probes, traffic, weights
from .arch import Arch
from .common import sub_seed
from .trace import Session, span, spans_on, traced_stretch

# after an open loop's window closes, how long the loop waits for the first
# token of requests that were due in it
DRAIN_S = 60.0


def _warm_up(batcher, mix: Dict[str, Any], vocab: int) -> None:
    """Every shape the mix reaches: an admission of the longest prompt and
    of the shortest, and decode rounds with every slot full."""
    from repro_torch.runtime.serve import Request
    rng = np.random.default_rng(0)
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    for i in range(len(batcher.slots)):
        n = hi if i < 2 else lo
        batcher.submit(Request(f"warm{i}", rng.integers(0, vocab, size=n).tolist(), 2))
    batcher.drain()


def setup(a: Arch, mix: Dict[str, Any], program_cfg: Any, seed: int, device: str):
    """→ (model, batcher): the program's model on the seed's weights and a
    batcher of the mix's slots and cache, warmed up."""
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve import ContinuousBatcher

    model = Model(program_cfg, device)
    params = weights.program_params(a, model.param_specs(), seed, device)
    # eos -1: every request decodes its max_new_tokens, so a seed's work is
    # what its traffic says
    batcher = ContinuousBatcher(model, params, mix["slots"], mix["max_len"], eos_token=-1)
    _warm_up(batcher, mix, a.vocab)
    return model, batcher


def requests(a: Arch, mix: Dict[str, Any], seed: int, seconds: float):
    return (traffic.open_loop(mix, seed, seconds, a.vocab) if mix["kind"] == "open_loop"
            else traffic.backlog(mix, seed, a.vocab))


def run(a: Arch, mix: Dict[str, Any], program_cfg: Any, seed: int, seconds: float,
        trace: bool, device: str, on_window_open) -> Dict[str, Any]:
    model, batcher = setup(a, mix, program_cfg, seed, device)
    rec, reqs = window(a, mix, model, batcher, requests(a, mix, seed, seconds), seconds, trace,
                       device, on_window_open)
    rec["served"] = _sample(reqs, mix, seed)
    del batcher, model, reqs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    if trace:
        rec["trace"] = rec.pop("session").read()
        if device == "cuda":
            rec["probes"] = probes.timed(a, mix, "serve")
    return rec


def window(a: Arch, mix: Dict[str, Any], model, batcher, specs, seconds: float, trace: bool,
           device: str, on_window_open=lambda: None):
    """The measured window over ``specs`` (``traffic.RequestSpec``): → (the
    record, the program's requests)."""
    from repro_torch.runtime.serve import Request

    open_loop = mix["kind"] == "open_loop"
    reqs = [Request(str(s.index), s.prompt, s.max_new_tokens) for s in specs]
    info = [{"due": s.due_s, "prompt_len": len(s.prompt), "left_queue": None, "tokens": []}
            for s in specs]
    index = {id(r): i for i, r in enumerate(reqs)}

    session = Session(device) if trace else None
    opens, closes = traced_stretch(seconds)
    targets = [(batcher, "_admit", "serve.admit"), (batcher, "_load_slot", "serve.prefill"),
               (model, "decode_step", "serve.decode")]
    rounds: List[Dict[str, Any]] = []
    pending = deque(range(len(reqs)))
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    on_window_open()
    t0 = time.perf_counter()
    if not open_loop:
        for i in pending:
            batcher.submit(reqs[i])
        pending.clear()
    with spans_on(session, targets):
        while True:
            now = time.perf_counter() - t0
            while pending and info[pending[0]]["due"] <= now:
                batcher.submit(reqs[pending.popleft()])
            if session and session.prof is None and now >= opens:
                session.open()
            if session and session.is_open and now >= closes:
                session.close()
            if now >= seconds:
                if not open_loop:
                    break
                waiting = [i for i, r in enumerate(info)
                           if r["due"] < seconds and not r["tokens"]]
                if not waiting or now >= seconds + DRAIN_S:
                    break
            slots_before = [r for r in batcher.slots if r is not None]
            if not slots_before and not batcher.queue:
                until = info[pending[0]]["due"] if pending else seconds
                with span(session, "serve.wait"):
                    time.sleep(min(max(0.0, until - now), 0.05))
                continue
            head = batcher.queue[:len(batcher.slots)]
            q0, prefills0 = len(batcher.queue), batcher.prefills
            s = time.perf_counter() - t0
            with span(session, "serve.round"):
                active = batcher.step()
            e = time.perf_counter() - t0
            admitted = head[:q0 - len(batcher.queue)]
            ctx = 0
            for r in slots_before + admitted:
                rec = info[index[id(r)]]
                if len(r.tokens_out) > len(rec["tokens"]):
                    rec["tokens"].append(e)
                    keys = rec["prompt_len"] + len(r.tokens_out) - 1
                    ctx += min(keys, a.window) if a.window > 0 else keys
            for r in admitted:
                info[index[id(r)]]["left_queue"] = s
            rounds.append({"start": s, "end": e, "active": active,
                           "prefill": batcher.prefills > prefills0,
                           "prefill_tokens": [len(r.prompt) - 1 for r in admitted],
                           "decode_keys": ctx})
    if session and session.is_open:
        session.close()
    window_end = rounds[-1]["end"] if (rounds and not open_loop) else seconds
    rec: Dict[str, Any] = {"kind": mix["kind"], "seconds": seconds, "window_end": window_end,
                           "requests": info, "rounds": rounds}
    if open_loop:
        due = [r for r in info if r["due"] < seconds]
        rec["attempted"] = len(due)
        rec["failed"] = sum(1 for r in due if not r["tokens"])
    else:
        rec["attempted"] = sum(1 for r in info if r["left_queue"] is not None)
        rec["failed"] = 0
    if device == "cuda":
        rec["peak_window_bytes"] = torch.cuda.max_memory_allocated()
    if session:
        rec["session"] = session
    return rec, reqs


def _sample(reqs, mix: Dict[str, Any], seed: int):
    """The finished requests the check reads: the longest, and others
    drawn from the seed, ``check_requests`` in all."""
    done = [r for r in reqs if r.done]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.prompt) + len(r.tokens_out))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(sub_seed(seed, "check_sample"))
    k = min(len(rest), mix["check_requests"] - 1)
    picked = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), size=k, replace=False))]
    return [(list(r.prompt), list(r.tokens_out)) for r in picked]
