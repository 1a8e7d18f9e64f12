"""The port at the real GQA groups of chatglm3-6b (32:2, a group of 16),
qwen2-7b (28:4, 7) and mixtral-8x22b (48:8, 6), against the JAX package.

The smoke configs have 4 query and 2 KV heads whatever the config, so these
tests scale each one's heads back to the real ratio at a narrow head dim
(16; chatglm3's half-head RoPE then rotates 8 dims), 2 layers, and hold:
the forward logits, a prefill and 4 decode steps, and the loss gradients
against JAX's model on the same parameters (JAX's init carried across by
``params_from_numpy``); ``flash_attention_plain``,
``flash_decode_split_plain`` and ``flash_attention_bwd_plain`` at groups 6,
7 and 16 against ``ref.flash_attention_ref`` and its ``jax.vjp``. Then the
reckonings ``chip_smoke.py`` makes for these configs without a card: the
launches per prefill, decode round and train step, the capacity of the
long admission, and each train depth's state under its peak limit.
Tolerances are tests/test_kernels.py's: f32 2e-3, bf16 2e-2.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.kernels import ref
from repro.models import build_model as jax_build_model
from repro_torch.configs import SMOKE_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_plain, flash_attention_plain, flash_decode_split_plain)
from repro_torch.launch import profile_train
from repro_torch.models import build_model, moe

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (stdlib only at import)

# (query heads, KV heads) of each config
HEADS = {"chatglm3-6b": (32, 2), "qwen2-7b": (28, 4), "mixtral-8x22b": (48, 8)}
ARCHS = sorted(HEADS)
# mixtral's smoke window is 64: 80 positions cross it
SEQ = {"chatglm3-6b": 24, "qwen2-7b": 24, "mixtral-8x22b": 80}
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
B = 2


def scaled(cfgs, arch):
    hq, hkv = HEADS[arch]
    return cfgs[arch].scaled(n_heads=hq, n_kv_heads=hkv, head_dim=16, param_dtype="float32")


@functools.lru_cache(maxsize=None)
def models(arch):
    """JAX's and the port's model at the real head ratio, f32, with JAX's
    init (norm scales and biases perturbed, so that they matter); built once
    an arch (no test changes them)."""
    jm = jax_build_model(scaled(JAX_SMOKE, arch))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if path[-1].key in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(scaled(SMOKE_ARCHS, arch), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def tokens(arch, S, seed=1):
    t = np.random.default_rng(seed).integers(2, SMOKE_ARCHS[arch].vocab, (B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def close(got, want, dtype="float32"):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_real_gqa_forward_matches_jax(arch):
    jm, jp, tm, tp = models(arch)
    assert tm.cfg.n_heads // tm.cfg.n_kv_heads == HEADS[arch][0] // HEADS[arch][1]
    tj, tt = tokens(arch, SEQ[arch])
    want, _ = jax.jit(lambda p, t: jm.logits(p, {"tokens": t}, remat="none"))(jp, tj)
    got, _ = tm.logits(tp, {"tokens": tt})
    close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_real_gqa_prefill_and_decode_match_jax(arch):
    """A prefill of SEQ tokens, then 4 decode steps from its cache (mixtral's
    64-slot ring already past full)."""
    jm, jp, tm, tp = models(arch)
    S, steps, max_len = SEQ[arch], 4, 96
    tj, tt = tokens(arch, S + steps)
    want, jcache = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(jp, tj[:, :S])
    got, cache = tm.prefill(tp, tt[:, :S], max_len)
    close(got, want)
    jstep = jax.jit(jm.decode_step)
    for i in range(steps):
        want, jcache = jstep(jp, jcache, tj[:, S + i], jnp.int32(S + i))
        got, cache = tm.decode_step(tp, cache, tt[:, S + i], S + i)
        close(got, want)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_real_gqa_loss_gradients_match_jax(arch):
    """The gradients of one train step's loss (remat "block", attention
    through the flash Function's backward) against ``jax.grad``, every leaf."""
    jm, jp, tm, tp = models(arch)
    tj, tt = tokens(arch, SEQ[arch])
    lj, lt = tokens(arch, SEQ[arch], seed=2)
    (want_loss, _), want = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": tj, "labels": lj}, "block")
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    leaves = _flat(params)
    loss, _ = tm.loss(params, {"tokens": tt, "labels": lt})
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-3, atol=2e-3,
                                   err_msg=k)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def jax_ref(q, k, v, causal, window=0):
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def jax_ref_vjp(q, k, v, do, causal, window):
    _, vjp = jax.vjp(functools.partial(ref.flash_attention_ref, causal=causal, window=window),
                     q, k, v)
    return vjp(do)


def qkv(S, T, Hq, Hkv, dtype, seed=0, D=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, (B, n, h, D)).astype(np.float32)
                 for n, h in ((S, Hq), (T, Hkv), (T, Hkv)))


def as_torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def as_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


# (S, T, causal, window): a causal prefill, one with a window, a prompt of
# 3 rows against a longer cache
FWD_CASES = [(40, 40, True, 0), (40, 40, True, 16), (3, 70, False, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES)
@pytest.mark.parametrize("heads", sorted(HEADS.values()))
def test_flash_attention_plain_at_real_groups_matches_jax_ref(heads, case, dtype):
    S, T, causal, window = case
    q, k, v = qkv(S, T, *heads, dtype)
    got, _ = flash_attention_plain(*(as_torch(a, dtype) for a in (q, k, v)),
                                   causal=causal, window=window)
    want = jax_ref(*(as_jax(a, dtype) for a in (q, k, v)), causal=causal, window=window)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(32, 2, 1), (32, 2, 2), (28, 4, 1), (48, 8, 1)])
def test_flash_decode_split_plain_at_real_groups_matches_jax_ref(heads, dtype):
    """The split-KV decode's arithmetic in chunks of 16 keys at S = 1 (and
    at 32:2, S = 2: 32 rows a KV head, the decode kernel's most), each row
    against its own kv_len keys (one, past a chunk's edge, all 70): JAX's
    reference over those keys alone, non-causal."""
    Hq, Hkv, S = heads
    T, lens = 70, [1, 33, 70]
    q, k, v = qkv(S, T, Hq, Hkv, dtype, seed=3)
    q, k, v = (np.concatenate([a, a[:1]]) for a in (q, k, v))      # B = 3 rows
    got, _ = flash_decode_split_plain(*(as_torch(a, dtype) for a in (q, k, v)), causal=False,
                                      kv_len=torch.tensor(lens, dtype=torch.int32), chunk=16)
    for b, n in enumerate(lens):
        want = jax_ref(as_jax(q[b:b + 1], dtype), as_jax(k[b:b + 1, :n], dtype),
                       as_jax(v[b:b + 1, :n], dtype), causal=False)
        close(got[b:b + 1], want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES[:2])
@pytest.mark.parametrize("heads", sorted(HEADS.values()))
def test_flash_attention_bwd_plain_at_real_groups_matches_jax_vjp(heads, case, dtype):
    """dq, dk and dv (dk, dv summed over the group of 16, 7 or 6 heads)
    against ``jax.vjp`` of the reference in f32 on the same values."""
    S, T, causal, window = case
    q, k, v = qkv(S, T, *heads, dtype, seed=5)
    do = np.random.default_rng(6).normal(0, 1, q.shape).astype(np.float32)
    tq, tk, tv, tdo = (as_torch(a, dtype) for a in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal, window=window)
    f32 = [jnp.asarray(t.float().numpy()) for t in (tq, tk, tv, tdo)]   # the rounded values
    for g, w in zip(got, jax_ref_vjp(*f32, causal=causal, window=window)):
        close(g, w, dtype)


# ---- the chip test's reckonings, for the configs it serves and trains ----
def test_expected_launches_at_the_served_depths():
    want = {"chatglm3-6b": (28, {"flash_fwd": 28, "rmsnorm": 57}),
            "qwen2-7b": (28, {"flash_fwd": 28, "rmsnorm": 57}),
            "mixtral-8x22b": (12, {"flash_fwd": 12, "rmsnorm": 25, "moe_gmm": 36})}
    assert set(want) == set(chip_smoke.WIDE_SERVE)
    for config, (layers, each) in want.items():
        depth = chip_smoke.WIDE_SERVE[config] or get_config(config).n_layers
        assert depth == layers
        cfg = get_config(config).scaled(n_layers=depth)
        assert chip_smoke.expected_launches(cfg) == (each, each)
    ring = get_config("gemma3-12b").scaled(n_layers=chip_smoke.RING_LAYERS)
    assert chip_smoke.expected_launches(ring) == ({"flash_fwd": 12, "rmsnorm": 25},) * 2
    assert chip_smoke.RING_PROMPT > ring.local_window


def test_expected_train_launches_at_the_train_depths():
    want = {"chatglm3-6b": {"flash_fwd": 56, "flash_bwd_dq": 28, "flash_bwd_dkv": 28,
                            "rmsnorm": 114},
            "qwen2-7b": {"flash_fwd": 40, "flash_bwd_dq": 20, "flash_bwd_dkv": 20,
                         "rmsnorm": 82},
            "mixtral-8x22b": {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
                              "rmsnorm": 10, "moe_gmm": 12, "moe_gmm_dx": 6, "moe_gmm_dw": 6},
            "gemma3-12b": {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12,
                           "rmsnorm": 50}}
    for config, each in want.items():
        assert config in chip_smoke.TRAIN_CONFIGS
        cfg, _ = profile_train.train_depth(config)
        shape, tcfg = profile_train.train_shape(config), profile_train.train_config(config)
        assert shape.global_batch * shape.seq_len == 8192
        n_micro = shape.global_batch // tcfg.microbatch_per_device
        assert n_micro == 2
        assert chip_smoke.expected_train_launches(cfg, n_micro) == each
    gemma = profile_train.train_shape("gemma3-12b")
    assert gemma.seq_len > get_config("gemma3-12b").local_window


@pytest.mark.parametrize("config", ["chatglm3-6b", "qwen2-7b", "mixtral-8x22b", "gemma3-12b"])
def test_train_depth_state_fits_under_its_peak_limit(config):
    """The reckoning of ``profile_train.PEAK_LIMIT_GB``: 16 bytes a parameter
    of train state at the reckoned depth, plus five f32 temporaries of the
    largest leaf in AdamW's update, stays under the peak the card's run is
    held to, and that under the card's 80 GB."""
    cfg, r = profile_train.train_depth(config)
    limit = profile_train.PEAK_LIMIT_GB[config]
    largest = max(t.numel() for t in jax.tree.leaves(build_model(cfg, "meta").param_specs()))
    assert r["state_gb"] + 5 * 4 * largest / 1e9 < limit < 80
    assert r["params_per_layer"] * cfg.n_layers + r["params_outside_layers"] == \
        pytest.approx(r["params"])


def test_mixtral_capacities_on_the_chip_paths():
    """Tokens per expert of mixtral's gmm on each path: a 512-token and a
    1024-token admission, the 4 x 1024 prefill step and train microbatch,
    the 6,144-token long admission; decode rounds keep every token."""
    m = get_config("mixtral-8x22b").moe
    assert [moe.capacity(T, m) for T in (8, 512, 1024, 4096, chip_smoke.LONG_PROMPT)] == \
        [8, 160, 320, 1280, 1920] == [8, *chip_smoke.GMM_WIDE_C[2:]]
    assert chip_smoke.GMM_WIDE == (m.n_experts, get_config("mixtral-8x22b").d_model,
                                   m.d_ff_expert)
