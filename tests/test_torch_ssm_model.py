"""The port's SSM (mamba2-370m) and hybrid (zamba2-2.7b) models against the
JAX models: forward logits, the cache a prefill leaves against the cache
JAX's decode path leaves after feeding the same prompt token by token, and
step-by-step decode, on the same JAX-initialised parameters; the
parameter init and counts.

f32 agrees within 2e-3. bf16 is held to the relative bound of
tests/test_models.py (max |Δlogit| / max |logit| < 0.08): the two round at
different places (the port's norms are the fused kernel's function; its
shared-block attention keeps scores and probabilities in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.models import build_model as jax_build_model
from repro_torch.configs import SMOKE_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import layers as tl

B = 2
ARCHS = ["mamba2-370m", "zamba2-2.7b"]
# scales and biases initialised to ones or zeros, perturbed so that they matter
NOISY = ("ln", "ln1", "ln2", "final_norm", "norm", "conv_b", "d_skip")


def models(arch, dtype):
    """JAX (``use_pallas=True``: the SSD through its Pallas kernel in
    interpret mode) and port models of one smoke config with the same
    parameters, carried across as numpy."""
    jm = jax_build_model(JAX_SMOKE[arch].scaled(param_dtype=dtype), use_pallas=True)
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


def tokens(arch, S, seed=1, rows=B):
    t = np.random.default_rng(seed).integers(2, SMOKE_ARCHS[arch].vocab, (rows, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax_pallas(arch, dtype):
    """S = 40: more than the smoke chunk of 32 and no multiple of it."""
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, 40)
    want, _ = jax.jit(lambda p, t: jm.logits(p, {"tokens": t}, remat="none"))(jp, tj)
    got, aux = tm.logits(tp, {"tokens": tt})
    assert float(aux) == 0.0 and got.dtype == tp["lm_head"].dtype
    assert_close(got, want, dtype)


def _fed(jm, jp, tj, max_len):
    """JAX's serving state: the prompt fed token by token from an empty
    cache through ``decode_step`` (as JAX's batcher admits a request) → the
    last logits and the cache."""
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(tj.shape[0], max_len)
    for t in range(tj.shape[1]):
        logits, cache = step(jp, cache, tj[:, t], jnp.int32(t))
    return logits, cache


@pytest.mark.parametrize("S", [1, 2, 3, 40])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_into_leaves_the_state_of_jax_token_by_token_feed(arch, S):
    """f32. ``prefill_into`` rows 1-2 of a 3-row cache full of noise: the
    conv tail (the last 3 pre-conv rows, zero-padded on the left for S < 3),
    the SSM state from the kernel's final state and (zamba2) each shared-block
    application's K/V with the slots past the prompt zeroed, all as JAX's
    cache after feeding the prompt token by token; row 0 keeps its noise."""
    jm, jp, tm, tp = models(arch, "float32")
    tj, tt = tokens(arch, S, seed=S)
    max_len = 48
    want_logits, want_cache = _fed(jm, jp, tj, max_len)
    cache = tm.init_cache(3, max_len)
    rng = np.random.default_rng(3)
    # each leaf's batch dim: (L, B, ...) for mamba2; (g, k, B, ...) and
    # (g, B, max_len, ...) for zamba2
    bdim = {"conv": 1, "ssm": 1} if arch == "mamba2-370m" else \
        {"conv": 2, "ssm": 2, "attn_k": 1, "attn_v": 1}
    assert sorted(cache) == sorted(want_cache) == sorted(bdim)
    for c in cache.values():
        c.copy_(torch.from_numpy(rng.standard_normal(c.shape)))
    old = {k: c.clone() for k, c in cache.items()}
    got_logits = tm.prefill_into(tp, tt, cache, 1)
    assert_close(got_logits, want_logits, "float32")
    for k, d in bdim.items():
        assert cache[k].dtype == torch.float32
        assert_close(cache[k].narrow(d, 1, 2), want_cache[k], "float32")
        assert torch.equal(cache[k].narrow(d, 0, 1), old[k].narrow(d, 0, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, dtype):
    """12 steps from an empty cache, logits at each step and the caches at
    the end (the state in the cache's dtype, as JAX keeps it)."""
    T = 12
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, T)
    jstep = jax.jit(jm.decode_step)
    jcache, tcache = jm.init_cache(B, T), tm.init_cache(B, T)
    for t in range(T):
        want, jcache = jstep(jp, jcache, tj[:, t], jnp.int32(t))
        got, tcache = tm.decode_step(tp, tcache, tt[:, t], t)
        assert_close(got, want, dtype)
    for k in jcache:
        assert tcache[k].dtype == tp["final_norm"].dtype
        assert_close(tcache[k], jcache[k], dtype)


def test_init_draws_ssm_a_and_dt_bias_like_jax():
    """A_log = log U[1, 16] and dt_bias = softplus^-1 of U[1e-3, 1e-1], drawn
    in f32 from the generator and cast once: within those ranges, spread
    over them, reproducible from a seed."""
    cpu = torch.device("cpu")
    n = 4096
    a = tl._init_leaf(tl.P((n,), (None,), "ssm_a"), torch.Generator().manual_seed(0),
                      torch.float32, cpu)
    assert torch.equal(a, tl._init_leaf(tl.P((n,), (None,), "ssm_a"),
                                        torch.Generator().manual_seed(0), torch.float32, cpu))
    u = torch.exp(a)
    assert 1.0 <= float(u.min()) < 1.1 and 15.9 < float(u.max()) <= 16.0
    assert abs(float(u.mean()) - 8.5) < 0.3
    d = tl._init_leaf(tl.P((n,), (None,), "dt_bias"), torch.Generator().manual_seed(1),
                      torch.float32, cpu)
    dt = torch.nn.functional.softplus(d)
    assert 1e-3 * (1 - 1e-4) <= float(dt.min()) < 2e-3
    assert 0.099 < float(dt.max()) <= 0.1 * (1 + 1e-4)
    bf = tl._init_leaf(tl.P((8, n), ("layers", None), "dt_bias"),
                       torch.Generator().manual_seed(1), torch.bfloat16, cpu)
    assert bf.dtype == torch.bfloat16 and bf.shape == (8, n)
    with pytest.raises(ValueError, match="unknown init"):
        tl._init_leaf(tl.P((n,), (None,), "uniform"), torch.Generator(), torch.float32, cpu)


@pytest.mark.parametrize("arch,n_params,formula", [("mamba2-370m", 419_825_152, 419_713_024),
                                                   ("zamba2-2.7b", 2_422_670_240, 2_422_382_528)])
def test_full_ssm_param_counts_match_jax(arch, n_params, formula):
    """Full width and depth, on the meta device: the port's parameter tree
    holds as many parameters as JAX's, mamba2-370m 419.8 M (0.84 GB in bf16)
    and zamba2-2.7b 2.42 B (4.85 GB). The config's ``param_count`` formula
    (the same in both packages) leaves out each Mamba layer's conv bias and
    one of its three per-head vectors (a_log, dt_bias, d_skip)."""
    cfg = get_config(arch)
    n = build_model(cfg, device="cpu").n_params()
    assert n == jax_build_model(JAX_ARCHS[arch]).n_params() == n_params
    assert cfg.param_count() == JAX_ARCHS[arch].param_count() == formula
    d_in = cfg.ssm.expand * cfg.d_model
    conv_ch = d_in + 2 * cfg.ssm.n_groups * cfg.ssm.state_dim
    assert n - formula == cfg.n_layers * (conv_ch + d_in // cfg.ssm.head_dim)
