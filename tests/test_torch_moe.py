"""The port's MoE FFN against JAX's ``moe_ffn``, on the same numpy-seeded
inputs and weights.

Two cases per MoE smoke config: 48 tokens (T <= 256, capacity = T, no token
dropped) and 320 tokens (capacity round(T·K/E·1.25)) with the router biased
towards expert 0, so that tokens are dropped on both sides. Before the
outputs are compared, the two routers' expert choices must agree: a tie
broken differently by ``torch.topk`` and ``jax.lax.top_k`` shows as what it
is. f32 within 2e-3; bf16 within tests/test_torch_model.py's relative 0.08
(max |Δ| / max |y|): the frameworks round the silu product and the gated
sum at different places.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.configs import SMOKE_ARCHS, get_config
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import moe

ARCHS = ["mixtral-8x22b", "qwen3-moe-30b-a3b"]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
CASES = {"no_drop": (2, 24), "drops": (2, 160)}     # (B, S)


def _inputs(arch, case, name):
    """x (B, S, d) and the layer's weights as (JAX, torch) pairs. In the
    "drops" case x[..., 0] is shifted by 2 and router[0, 0] is 2, which adds
    4 ± 2 to every token's logit of expert 0."""
    cfg = SMOKE_ARCHS[arch]
    d, m = cfg.d_model, cfg.moe
    B, S = CASES[case]
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (B, S, d))
    p = {"router": rng.normal(0, d ** -0.5, (d, m.n_experts)),
         "w_gate": rng.normal(0, d ** -0.5, (m.n_experts, d, m.d_ff_expert)),
         "w_up": rng.normal(0, d ** -0.5, (m.n_experts, d, m.d_ff_expert)),
         "w_down": rng.normal(0, m.d_ff_expert ** -0.5, (m.n_experts, m.d_ff_expert, d))}
    if case == "drops":
        x[..., 0] += 2.0
        p["router"][0, 0] = 2.0

    def pair(a):
        j = jnp.asarray(a, DTYPES[name])
        return j, tensor_from_numpy(np.asarray(j), "cpu")

    xj, xt = pair(x)
    pj, pt = {}, {}
    for k, v in p.items():
        pj[k], pt[k] = pair(v)
    return cfg.moe, (xj, pj), (xt, pt)


def _jax_choices(x, router, m):
    """JAX's routing, step for step as in ``repro.models.moe.moe_ffn``:
    → (expert_idx (T, K), dropped (token, choice) pairs)."""
    T = x.shape[0] * x.shape[1]
    xt = x.reshape(T, -1).astype(jnp.float32)
    probs = jax.nn.softmax(xt @ router.astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    cap = int(max(1, round(T * m.top_k / m.n_experts * m.capacity_factor)))
    cap = T if T <= 256 else min(cap, T)
    counts = np.bincount(np.asarray(idx).reshape(-1), minlength=m.n_experts)
    return np.asarray(idx), int(np.maximum(counts - cap, 0).sum())


def _assert_close(got, want, name):
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    assert a.shape == b.shape
    if name == "float32":
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    else:
        rel = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)
        assert rel < 0.08, f"max rel err {rel:.4f}"


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, case, name):
    m, (xj, pj), (xt, pt) = _inputs(arch, case, name)
    T = xt.shape[0] * xt.shape[1]
    want_idx, want_drops = _jax_choices(xj, pj["router"], m)
    _, _, idx, _, keep, cap = moe.route(xt.reshape(T, -1), pt["router"], m)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    drops = int((~keep).sum())
    assert drops == want_drops
    if case == "drops":
        assert T > moe.NO_DROP_TOKENS and cap < T and drops > 0
    else:
        assert cap == T and drops == 0

    want_y, want_aux = jax.jit(lambda x, p: jax_moe_ffn(x, p, m))(xj, pj)
    ops.reset_launch_counts()
    y, aux = moe.moe_ffn(xt, pt, m)
    assert y.dtype == xt.dtype and aux.dtype == torch.float32
    assert sum(ops.launch_counts().values()) == 0         # the CPU takes the plain path
    _assert_close(y, want_y, name)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("T,want", [(1, 1), (8, 8), (256, 256), (257, 80), (264, 82),
                                    (300, 94), (4096, 1280)])
def test_capacity_rounds_halves_to_even_like_jax(T, want):
    """qwen3-moe smoke (E 8, top-2, factor 1.25): T·K/E·1.25 = 82.5 at T = 264
    rounds to 82, as Python's ``round`` in JAX's ``moe_ffn``; up to 256
    tokens every expert holds all of them."""
    assert moe.capacity(T, SMOKE_ARCHS["qwen3-moe-30b-a3b"].moe) == want


def test_full_qwen3_moe_capacities_of_the_serving_path():
    """128 experts, top-8: a decode round of 8 slots holds C = 8, a 511-token
    admission C = 40, a B=4 x S=1024 prefill step C = 320."""
    m = get_config("qwen3-moe-30b-a3b").moe
    assert vars(m) == vars(JAX_ARCHS["qwen3-moe-30b-a3b"].moe)
    assert [moe.capacity(T, m) for T in (1, 8, 511, 4096)] == [1, 8, 40, 320]


def _moe_ffn_by_accumulating_scatter(x, p, m):
    """``moe.moe_ffn`` as it was with ``repro``'s scatter: each dropped
    (t, k) adds a zero row at (e, 0) (``index_put_(accumulate=True)``, as
    ``.at[].add``). → (buf, y, aux)."""
    B, S, d = x.shape
    E, K = m.n_experts, m.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate, expert_idx, pos, keep, cap = moe.route(xt, p["router"], m)
    aux = E * (torch.nn.functional.one_hot(expert_idx[:, 0], E).float().mean(0)
               * probs.mean(0)).sum()
    flat_e = expert_idx.reshape(T * K)
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    contrib = torch.where(keep[:, None], xt.repeat_interleave(K, dim=0),
                          torch.zeros((), dtype=x.dtype))
    buf = torch.zeros((E, cap, d), dtype=x.dtype)
    buf.index_put_((flat_e, pos_c), contrib, accumulate=True)
    g = ops.moe_gmm(buf, p["w_gate"])
    u = ops.moe_gmm(buf, p["w_up"])
    out = ops.moe_gmm(torch.nn.functional.silu(g) * u, p["w_down"])
    w = (gate.reshape(T * K) * keep).to(x.dtype)
    y = (out[flat_e, pos_c] * w[:, None]).reshape(T, K, d).sum(dim=1)
    return buf, y.reshape(B, S, d), aux


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_by_assignment_equals_the_accumulating_scatter(arch, case, name):
    """The buffer filled by assignment (dropped rows into a discarded last
    row) equals the accumulating scatter's, and so do y and aux: kept slots
    are unique and 0 + x = x, drops included."""
    m, _, (xt, pt) = _inputs(arch, case, name)
    want_buf, want_y, want_aux = _moe_ffn_by_accumulating_scatter(xt, pt, m)
    T = xt.shape[0] * xt.shape[1]
    _, _, idx, pos, keep, cap = moe.route(xt.reshape(T, -1), pt["router"], m)
    buf = moe.dispatch(xt.reshape(T, -1), idx.reshape(-1), pos, keep, m.n_experts, cap)
    assert buf.shape == (m.n_experts, cap, xt.shape[-1]) and buf.is_contiguous()
    assert torch.equal(buf, want_buf)
    assert (case == "drops") == bool((~keep).any())
    y, aux = moe.moe_ffn(xt, pt, m)
    assert torch.equal(y, want_y)
    assert torch.equal(aux, want_aux)
