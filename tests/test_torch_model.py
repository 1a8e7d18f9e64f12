"""The port's dense model against the JAX model: forward, prefill (logits and
cache) and step-by-step decode, on the same JAX-initialised parameters.

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
