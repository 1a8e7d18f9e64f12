"""The port's dense and MoE models against the JAX model: forward, prefill
(logits and cache), step-by-step decode and the loss (with the MoE aux
loss) and its gradients, on the same JAX-initialised parameters.

f32 agrees within 2e-3. bf16 is held to the relative bound of
tests/test_models.py (max |Δlogit| / max |logit| < 0.08): the two round at
different places. The port's norms are the fused kernel's function (scale
multiplied in f32, one cast) where JAX's ``layers.rmsnorm`` casts to bf16
before the scale multiply, and its attention keeps scores and probabilities
in f32 where JAX's XLA attention rounds them to bf16.

An MoE router is not continuous: where a token's K-th and (K+1)-th expert
logits lie closer than those rounding differences can move them, the two
frameworks may pick different experts for it in bf16, and that token's
output differs by a whole expert. So in bf16 an MoE model is held to the
bound position by position (each against the global max |logit|), and a
position may miss it only if the port's router was at such a near tie for
that token in some layer (``RouterTies``); at most a tenth of the positions
compared in a test may miss it.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.models import build_model as jax_build_model
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, moe

B = 2
# gemma3 and mixtral: past their 64-slot windows; chatglm3 (half-head RoPE,
# GQA kv = 2, QKV bias) and qwen2 (rope θ 1e6, QKV bias) at the dense length
SEQ = {"qwen1.5-0.5b": 24, "gemma3-12b": 80, "mixtral-8x22b": 80,
       "qwen3-moe-30b-a3b": 24, "chatglm3-6b": 24, "qwen2-7b": 24}
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


class RouterTies:
    """Records, for each call of the port's router, which tokens were near a
    tie: their K-th and (K+1)-th expert logits closer than one bf16 rounding
    on each side (2^-7 of each router input, relative, for the two
    frameworks together) can move a logit, times 2 for the two logits:
    4 · 2^-7 · max_e Σ_d |h_d|·|r_de|."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def recording(self):
        route = moe.route

        def recorded(xt, router, m):
            h, r = xt.float(), router.float()
            top = (h @ r).topk(m.top_k + 1, dim=-1).values
            reach = 4 * 2.0 ** -7 * (h.abs() @ r.abs()).max(-1).values
            self.calls.append(top[:, -2] - top[:, -1] < reach)
            return route(xt, router, m)

        moe.route = recorded
        try:
            yield self
        finally:
            moe.route = route

    def take(self, rows: int) -> torch.Tensor:
        """The calls recorded since the last take, as (rows, tokens) bool: a
        token near a tie in any of them (one call per layer)."""
        calls, self.calls = self.calls, []
        return torch.stack(calls).any(0).reshape(rows, -1)


class Misses:
    """Positions that missed the bf16 bound at a router tie, over one test."""

    def __init__(self):
        self.missed = self.compared = 0

    def check(self):
        assert self.missed <= 0.1 * self.compared, \
            f"{self.missed} of {self.compared} positions missed the bound at router ties"


def assert_close_by_position(got, want, dtype, ties, misses=None):
    """got/want (B, P, ...); ties (B, P) bool or None (dense: no router).
    bf16 MoE: each position within the bound, or near a router tie; the
    misses at ties are counted in ``misses``."""
    if dtype == "float32" or ties is None:
        return assert_close(got, want, dtype)
    a = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    b = np.asarray(want, np.float32)
    assert a.shape == b.shape and a.shape[:2] == tuple(ties.shape)
    rel = (np.abs(a - b).reshape(*a.shape[:2], -1).max(-1)
           / max(np.max(np.abs(b)), 1e-6))
    missed = (rel >= 0.08) & ~ties.numpy()
    assert not missed.any(), (f"positions {np.argwhere(missed).tolist()} off by "
                              f"{rel[missed].tolist()} with no router tie")
    misses.missed += int((rel >= 0.08).sum())
    misses.compared += rel.size


def cache_ties(ties, slots):
    """(B, positions) → (B, slots): the tie of the position each cache slot
    holds (a window ring keeps the last ``slots`` positions at ``pos % slots``;
    slots that hold nothing are held to the bound)."""
    B, S = ties.shape
    out = torch.zeros(B, slots, dtype=torch.bool)
    for p in range(max(0, S - slots), S):
        out[:, p % slots] = ties[:, p]
    return out


def cache_rows(c):
    """A cache leaf (g, cnt, B, slots, hkv, hd) as (B, slots, ...)."""
    c = c if isinstance(c, torch.Tensor) else np.asarray(c, np.float32)
    return c.permute(2, 3, 0, 1, 4, 5) if isinstance(c, torch.Tensor) \
        else c.transpose(2, 3, 0, 1, 4, 5)


def tokens(arch, S, seed=1):
    t = np.random.default_rng(seed).integers(2, SMOKE_ARCHS[arch].vocab, (B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, dtype):
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, SEQ[arch])
    want, want_aux = jax.jit(lambda p, t: jm.logits(p, {"tokens": t}, remat="none"))(jp, tj)
    with RouterTies().recording() as ties:
        got, aux = tm.logits(tp, {"tokens": tt})
    assert aux.dtype == torch.float32
    if tm.cfg.family == "moe":                 # the layers' aux losses, summed
        assert float(aux) > 0
        assert_close(aux, want_aux, dtype)
        misses = Misses()
        assert_close_by_position(got, want, dtype, ties.take(B), misses)
        misses.check()
    else:
        assert float(aux) == 0.0 and not ties.calls
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, dtype):
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, SEQ[arch])
    max_len = 96
    want_logits, want_cache = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(jp, tj)
    with RouterTies().recording() as ties:
        got_logits, got_cache = tm.prefill(tp, tt, max_len)
    tie, misses = ties.take(B) if ties.calls else None, Misses()
    assert_close_by_position(got_logits[:, None], np.asarray(want_logits)[:, None], dtype,
                             None if tie is None else tie[:, -1:], misses)
    assert sorted(got_cache) == sorted(want_cache)
    for kind in want_cache:
        for name in ("k", "v"):
            got, want = got_cache[kind][name], want_cache[kind][name]
            assert got.dtype == tp["final_norm"].dtype
            assert_close_by_position(cache_rows(got), cache_rows(want), dtype,
                                     None if tie is None else cache_ties(tie, got.shape[3]),
                                     misses)
    misses.check()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, dtype):
    """Step by step from an empty cache; gemma3 and mixtral decode 96 tokens
    through their 64-slot local and window ring buffers."""
    T = {"qwen1.5-0.5b": 16, "gemma3-12b": 96, "mixtral-8x22b": 96,
         "qwen3-moe-30b-a3b": 16, "chatglm3-6b": 16, "qwen2-7b": 16}[arch]
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, T)
    jstep = jax.jit(jm.decode_step)
    jcache, tcache = jm.init_cache(B, T), tm.init_cache(B, T)
    if arch == "gemma3-12b":
        assert tcache["local"]["k"].shape[3] == 64 < T
    if arch == "mixtral-8x22b":
        assert tcache["window"]["k"].shape[3] == 64 < T
    steps, misses = [], Misses()
    for t in range(T):
        want, jcache = jstep(jp, jcache, tj[:, t], jnp.int32(t))
        with RouterTies().recording() as ties:
            got, tcache = tm.decode_step(tp, tcache, tt[:, t], t)
        steps.append(ties.take(B) if ties.calls else None)
        assert_close_by_position(got[:, None], np.asarray(want)[:, None], dtype, steps[-1],
                                 misses)
    tie = None if steps[0] is None else torch.cat(steps, dim=1)
    for kind in jcache:
        got = tcache[kind]["k"]
        assert_close_by_position(cache_rows(got), cache_rows(jcache[kind]["k"]), dtype,
                                 None if tie is None else cache_ties(tie, got.shape[3]),
                                 misses)
    misses.check()


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


MOE = ["mixtral-8x22b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_loss_adds_the_weighted_aux_like_jax(arch, dtype):
    """``Model.loss`` of an MoE model is ce + aux_loss_weight · aux (the
    layers' Switch losses summed), as JAX's: each of the three against JAX's."""
    jm, jp, tm, tp = models(arch, dtype)
    tj, tt = tokens(arch, SEQ[arch])
    lj, lt = tokens(arch, SEQ[arch], seed=2)
    want, want_m = jax.jit(lambda p, t, lab: jm.loss(p, {"tokens": t, "labels": lab}))(
        jp, tj, lj)
    got, got_m = tm.loss(tp, {"tokens": tt, "labels": lt})
    weight = tm.cfg.moe.aux_loss_weight
    assert weight > 0 and float(got_m["aux"]) > 0
    torch.testing.assert_close(got, got_m["ce"] + weight * got_m["aux"], rtol=1e-6, atol=0)
    for g, w in ((got, want), (got_m["ce"], want_m["ce"]), (got_m["aux"], want_m["aux"])):
        if dtype == "float32":
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
        else:
            assert abs(float(g) - float(w)) < 0.02 * abs(float(w))


@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_into_past_256_tokens_matches_jax_prefill(arch):
    """f32, 2 x 150 tokens: T = 300 > 256, so capacity is round(T·K/E·1.25)
    (qwen3-moe 94, mixtral 188) and tokens past it are dropped, in JAX's
    ``prefill`` and the port's ``prefill_into`` alike. Logits and the K/V
    written into the cache rows agree within 2e-3 (mixtral's 64-slot window
    rings keep the last 64 positions)."""
    jm, jp, tm, tp = models(arch, "float32")
    tj, tt = tokens(arch, 150)
    max_len = 160
    want_logits, want_cache = jax.jit(lambda p, t: jm.prefill(p, t, max_len))(jp, tj)
    cache = tm.init_cache(3, max_len)
    got_logits = tm.prefill_into(tp, tt, cache, 1)
    assert_close(got_logits, want_logits, "float32")
    for kind in want_cache:
        for name in ("k", "v"):
            assert_close(cache[kind][name][:, :, 1:3], want_cache[kind][name], "float32")
