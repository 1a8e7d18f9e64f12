"""The port's serving path: per-row decode positions, the step factories,
the continuous batcher against JAX's batcher, and the serving entry point.

JAX's ``ContinuousBatcher`` decodes every slot row at one slot's position
and feeds token 0 to the other rows, overwriting their KV entries; with one
slot that cannot happen, so JAX's batcher at ``batch_slots=1`` serving one
request at a time is the oracle for the port's batcher at two slots.

For an MoE model that oracle holds only for prompts of at most 257 tokens.
JAX's batcher feeds a prompt token by token through ``decode_step`` (one
token per MoE call: nothing is dropped), where the port's batcher admits
it by one causal prefill of ``prompt[:-1]``, which follows JAX's
``prefill``: past 256 tokens per call an expert holds only
round(T·K/E·1.25) of them and the rest are dropped. Up to 256 tokens
capacity is T, every token is kept, and the two paths compute the same.
"""
import jax
import numpy as np
import torch

from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.models import build_model as jax_build_model
from repro.runtime.serve import ContinuousBatcher as JaxBatcher
from repro.runtime.serve import Request as JaxRequest
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve_workload
from repro_torch.models import build_model
from repro_torch.runtime.serve import (
    ContinuousBatcher,
    Request,
    make_prefill_step,
    make_serve_step,
)


def _f32_model(arch):
    cfg = SMOKE_ARCHS[arch].scaled(param_dtype="float32")
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def test_decode_with_per_row_positions_equals_scalar_steps():
    """Rows at positions 3, 70 and 40 (two of them past the 64-slot local
    ring) in one batched step equal each row stepped alone at its scalar pos."""
    model, params = _f32_model("gemma3-12b")
    rng = np.random.default_rng(3)
    max_len, lens = 96, [3, 70, 40]
    solo = []
    for n in lens:
        prefix = torch.from_numpy(rng.integers(2, model.cfg.vocab, (1, n)))
        solo.append(model.prefill(params, prefix, max_len)[1])
    batched = {kind: {name: torch.cat([c[kind][name] for c in solo], dim=2)
                      for name in ("k", "v")} for kind in solo[0]}
    token = torch.from_numpy(rng.integers(2, model.cfg.vocab, (3,)))
    got, batched = model.decode_step(params, batched, token, torch.tensor(lens))
    # f32; a matmul over 3 rows may sum in another order than over 1
    tol = dict(rtol=1e-5, atol=1e-5)
    for b, n in enumerate(lens):
        want, cache_b = model.decode_step(params, solo[b], token[b:b + 1], n)
        torch.testing.assert_close(got[b:b + 1], want, **tol)
        for kind in cache_b:
            torch.testing.assert_close(batched[kind]["k"][:, :, b:b + 1],
                                       cache_b[kind]["k"], **tol)


def test_prefill_into_a_used_row_equals_a_fresh_prefill():
    """An admission prefills into one row of the batcher's cache in place:
    that row ends as a fresh prefill's cache (its old contents past the
    prompt zeroed, a 70-token prompt wrapped on the 64-slot local ring) and
    the other rows keep theirs."""
    model, params = _f32_model("gemma3-12b")
    rng = np.random.default_rng(5)
    max_len = 96
    cache = model.init_cache(3, max_len)
    for d in cache.values():
        for c in d.values():
            c.copy_(torch.from_numpy(rng.standard_normal(c.shape)))
    old = {kind: {name: c.clone() for name, c in d.items()} for kind, d in cache.items()}
    for n in (5, 70):
        tokens = torch.from_numpy(rng.integers(2, model.cfg.vocab, (1, n)))
        got = model.prefill_into(params, tokens, cache, 1)
        want, fresh = model.prefill(params, tokens, max_len)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for kind, d in cache.items():
            for name, c in d.items():
                assert torch.equal(c[:, :, 1:2], fresh[kind][name])
                assert torch.equal(c[:, :, 0::2], old[kind][name][:, :, 0::2])


def test_step_factories_are_greedy_over_model_calls():
    model, params = _f32_model("qwen1.5-0.5b")
    shape = ShapeConfig("tiny", 24, 2, "prefill")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(2, model.cfg.vocab, (2, 12)))
    nxt, cache = make_prefill_step(model, shape)[0]({"params": params, "tokens": tokens})
    logits, _ = model.prefill(params, tokens, shape.seq_len)
    assert nxt.dtype == torch.int32 and torch.equal(nxt, logits.argmax(-1).int())
    assert cache["full"]["k"].shape[3] == shape.seq_len
    nxt2, cache = make_serve_step(model, shape)[0](params, cache, nxt.long(), 12)
    assert nxt2.shape == (2,) and nxt2.dtype == torch.int32


def test_batcher_matches_jax_batcher_serving_alone():
    """5 requests (prompts of 4-7 tokens, 6 new tokens) on qwen1.5-0.5b smoke
    in f32: the port at 2 slots gives each request JAX's greedy tokens at 1."""
    jcfg = JAX_SMOKE["qwen1.5-0.5b"].scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(SMOKE_ARCHS["qwen1.5-0.5b"].scaled(param_dtype="float32"),
                     device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, jcfg.vocab, int(rng.integers(4, 8))).tolist()
               for _ in range(5)]

    ref = JaxBatcher(jm, jp, batch_slots=1, max_len=32)
    want = []
    for i, p in enumerate(prompts):
        r = JaxRequest(f"r{i}", list(p), max_new_tokens=6)
        ref.submit(r)
        ref.drain()
        want.append(r.tokens_out)

    batcher = ContinuousBatcher(tm, tp, batch_slots=2, max_len=32)
    reqs = [Request(f"r{i}", list(p), max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    batcher.drain()
    assert all(r.done for r in reqs)
    assert [r.tokens_out for r in reqs] == want
    assert batcher.all_logits_finite()


def test_moe_batcher_matches_jax_batcher_serving_alone():
    """qwen3-moe-30b-a3b smoke in f32, 4 requests, one of them with a
    257-token prompt (a 256-token admission prefill, the longest that drops
    nothing): the port at 2 slots gives each request JAX's greedy tokens at
    1 slot."""
    jcfg = JAX_SMOKE["qwen3-moe-30b-a3b"].scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(SMOKE_ARCHS["qwen3-moe-30b-a3b"].scaled(param_dtype="float32"),
                     device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, jcfg.vocab, n).tolist() for n in (5, 257, 7, 4)]
    max_len = 272

    ref = JaxBatcher(jm, jp, batch_slots=1, max_len=max_len)
    want = []
    for i, p in enumerate(prompts):
        r = JaxRequest(f"r{i}", list(p), max_new_tokens=6)
        ref.submit(r)
        ref.drain()
        want.append(r.tokens_out)

    batcher = ContinuousBatcher(tm, tp, batch_slots=2, max_len=max_len)
    reqs = [Request(f"r{i}", list(p), max_new_tokens=6) for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    batcher.drain()
    assert all(r.done for r in reqs) and batcher.prefills == len(prompts)
    assert [r.tokens_out for r in reqs] == want
    assert batcher.all_logits_finite()


def test_batcher_refuses_prompts_that_do_not_fit():
    model, params = _f32_model("qwen1.5-0.5b")
    batcher = ContinuousBatcher(model, params, batch_slots=2, max_len=8)
    for prompt in ([], list(range(2, 10))):
        try:
            batcher.submit(Request("r", prompt))
        except ValueError:
            continue
        raise AssertionError(f"prompt of {len(prompt)} tokens was accepted")


def test_serve_workload_smoke_serves_every_request():
    out = serve_workload.main(device="cpu", smoke=True)
    reqs = out["requests"]
    assert out["served"] == len(reqs) == serve_workload.BURSTS["smoke"][0]
    assert all(1 <= len(r.tokens_out) <= r.max_new_tokens for r in reqs)
    assert all(r.first_logits is not None and r.first_logits.shape == (512,)
               for r in reqs)


def test_serve_workload_smoke_serves_an_moe_model():
    """``--config qwen3-moe-30b-a3b --smoke`` serves the burst through the
    same entry point as the dense default."""
    out = serve_workload.main(device="cpu", smoke=True, config="qwen3-moe-30b-a3b")
    reqs = out["requests"]
    assert out["served"] == len(reqs) == serve_workload.BURSTS["smoke"][0]
    assert out["batcher"].model.cfg.family == "moe"
    assert all(1 <= len(r.tokens_out) <= r.max_new_tokens for r in reqs)
