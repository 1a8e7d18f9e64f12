"""The port's serving path for the SSM (mamba2-370m) and hybrid
(zamba2-2.7b) families: the continuous batcher against JAX's batcher, the
step factory and the serving entry point.

JAX's ``ContinuousBatcher`` feeds a prompt token by token through
``decode_step``, and at ``batch_slots=1`` no other slot's row is fed token 0
at a foreign position, so JAX's batcher serving one request at a time is the
oracle for the port's batcher at two slots, which admits each request by one
prefill of ``prompt[:-1]`` (the kernel's final state) and decodes both slots
in one step. Five requests through two slots reuse a slot three times: a
reused slot must keep nothing of its last request's state, and a 1-token
prompt (an empty prefix) must find its slot's state zeroed. f32; greedy
tokens must be equal.
"""
import jax
import numpy as np
import pytest
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
from repro_torch.models.layers import tree_leaves
from repro_torch.runtime.serve import ContinuousBatcher, Request, make_prefill_step

ARCHS = ["mamba2-370m", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_jax_batcher_serving_alone(arch):
    """Prompts of 6, 40 (past the smoke chunk of 32), 1, 3 and 9 tokens, 6
    new tokens each: the port at 2 slots gives each request JAX's greedy
    tokens at 1 slot."""
    jcfg = JAX_SMOKE[arch].scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(SMOKE_ARCHS[arch].scaled(param_dtype="float32"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, jcfg.vocab, n).tolist() for n in (6, 40, 1, 3, 9)]
    max_len = 56

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
    assert all(r.done for r in reqs)
    assert batcher.prefills == len(prompts) - 1          # the 1-token prompt has none
    assert [r.tokens_out for r in reqs] == want
    assert batcher.all_logits_finite()


@pytest.mark.parametrize("arch", ARCHS)
def test_empty_prefix_zeroes_the_slot_state(arch):
    """A 1-token prompt admitted into a used slot: every cache leaf's row of
    that slot is zero before its first decode, the other slot untouched."""
    model = build_model(SMOKE_ARCHS[arch].scaled(param_dtype="float32"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batcher = ContinuousBatcher(model, params, batch_slots=2, max_len=16)
    for c in tree_leaves(batcher.cache):
        c.normal_()
    old = [c.clone() for c in tree_leaves(batcher.cache)]
    batcher._load_slot(1, [])
    for c, o, d in zip(tree_leaves(batcher.cache), old, batcher._batch_dims):
        assert c.shape[d] == 2
        assert torch.count_nonzero(c.select(d, 1)) == 0
        assert torch.equal(c.select(d, 0), o.select(d, 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_returns_greedy_token_and_the_serving_state(arch):
    model = build_model(SMOKE_ARCHS[arch].scaled(param_dtype="float32"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(2, model.cfg.vocab, (2, 12)))
    shape = ShapeConfig("tiny", 24, 2, "prefill")
    nxt, cache = make_prefill_step(model, shape)[0]({"params": params, "tokens": tokens})
    logits, fresh = model.prefill(params, tokens, shape.seq_len)
    assert nxt.dtype == torch.int32 and torch.equal(nxt, logits.argmax(-1).int())
    assert sorted(cache) == sorted(model.cache_shapes(2, 24))
    for k, c in cache.items():
        assert tuple(c.shape) == model.cache_shapes(2, 24)[k] and torch.equal(c, fresh[k])
        assert bool(torch.isfinite(c).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_workload_smoke_serves_an_ssm_model(arch):
    """``--config mamba2-370m|zamba2-2.7b --smoke`` serves the burst through
    the same entry point as the dense default."""
    out = serve_workload.main(device="cpu", smoke=True, config=arch)
    reqs = out["requests"]
    assert out["served"] == len(reqs) == serve_workload.BURSTS["smoke"][0]
    assert out["batcher"].model.cfg.name == arch
    assert all(1 <= len(r.tokens_out) <= r.max_new_tokens for r in reqs)
    assert out["batcher"].all_logits_finite()
