"""The port's dense model against the JAX model: forward, prefill (logits and
cache), step-by-step decode and the loss's gradients, on the same
JAX-initialised parameters.

f32 agrees within 2e-3. bf16 is held to the relative bound of
tests/test_models.py (max |Δlogit| / max |logit| < 0.08): the two round at
different places. The port's norms are the fused kernel's function (scale
multiplied in f32, one cast) where JAX's ``layers.rmsnorm`` casts to bf16
before the scale multiply, and its attention keeps scores and probabilities
in f32 where JAX's XLA attention rounds them to bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.models import build_model as jax_build_model
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model

B = 2
SEQ = {"qwen1.5-0.5b": 24, "gemma3-12b": 80}   # gemma: past its 64-slot window
ARCHS = sorted(SEQ)
NOISY = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")


def models(arch, dtype):
    """JAX and port models of one smoke config with the same parameters:
    JAX's init, with noise on the norm scales and biases (init to ones and
    zeros) so that they matter, carried across as numpy."""
    jm = jax_build_model(JAX_SMOKE[arch].scaled(param_dtype=dtype))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if path[-1].key in NOISY:
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKE_ARCHS[arch].scaled(param_dtype=dtype), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def assert_close(got, want, dtype):
    a = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    b = np.asarray(want, np.float32)
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    else:
        rel = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)
        assert rel < 0.08, f"max rel err {rel:.4f}"


def tokens(arch, S, seed=1):
    t = np.random.default_rng(seed).integers(2, SMOKE_ARCHS[arch].vocab, (B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, dtype):
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, SEQ[arch])
    want, _ = jax.jit(lambda p, t: jm.logits(p, {"tokens": t}, remat="none"))(jp, tj)
    got, aux = tm.logits(tp, {"tokens": tt})
    assert float(aux) == 0.0
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, dtype):
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, SEQ[arch])
    max_len = 96
    want_logits, want_cache = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(jp, tj)
    got_logits, got_cache = tm.prefill(tp, tt, max_len)
    assert_close(got_logits, want_logits, dtype)
    assert sorted(got_cache) == sorted(want_cache)
    for kind in want_cache:
        for name in ("k", "v"):
            assert got_cache[kind][name].dtype == tp["final_norm"].dtype
            assert_close(got_cache[kind][name], want_cache[kind][name], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, dtype):
    """Step by step from an empty cache; gemma3 decodes 96 tokens through
    its 64-slot local ring buffers."""
    T = {"qwen1.5-0.5b": 16, "gemma3-12b": 96}[arch]
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, T)
    jstep = jax.jit(jm.decode_step)
    jcache, tcache = jm.init_cache(B, T), tm.init_cache(B, T)
    if arch == "gemma3-12b":
        assert tcache["local"]["k"].shape[3] == 64 < T
    for t in range(T):
        want, jcache = jstep(jp, jcache, tj[:, t], jnp.int32(t))
        got, tcache = tm.decode_step(tp, tcache, tt[:, t], t)
        assert_close(got, want, dtype)
    for kind in jcache:
        assert_close(tcache[kind]["k"], jcache[kind]["k"], dtype)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_pallas(arch):
    """f32: autograd of the port's ``Model.loss`` (remat "block", attention
    through the flash Function's backward) against ``jax.grad`` of
    ``Model(use_pallas=True).loss`` (Pallas backward in interpret mode), on
    every leaf; the tied embedding's gradient sums the gather's and the
    unembed's parts. gemma3's S=80 crosses its 64-slot window, with GQA."""
    _, jp, tm, tp = models(arch, "float32")
    jm = jax_build_model(JAX_SMOKE[arch].scaled(param_dtype="float32"), use_pallas=True)
    tj, tt = tokens(arch, SEQ[arch])
    lj, lt = tokens(arch, SEQ[arch], seed=2)
    (want_loss, _), want = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": tj, "labels": lj}, "block")
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    leaves = _flat(params)
    loss, _ = tm.loss(params, {"tokens": tt, "labels": lt})
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert sorted(got) == sorted(want)
    assert "/embed/table" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-3, atol=2e-3,
                                   err_msg=k)


def test_remat_recomputes_the_same_gradients_and_rejects_unknown_values():
    """remat "block" and "full" (each layer group under torch.utils.checkpoint)
    give the gradients of "none" exactly; anything else raises."""
    _, _, tm, tp = models("gemma3-12b", "float32")
    tt = tokens("gemma3-12b", 24)[1]
    batch = {"tokens": tt, "labels": tt.roll(1, dims=1)}
    grads = {}
    for remat in ("none", "block", "full"):
        params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
        loss, _ = tm.loss(params, batch, remat)
        grads[remat] = torch.autograd.grad(loss, list(_flat(params).values()))
    for remat in ("block", "full"):
        for a, b in zip(grads[remat], grads["none"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        tm.logits(tp, batch, remat="layer")
