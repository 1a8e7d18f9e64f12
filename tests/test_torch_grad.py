"""The port's backward of the grouped expert GEMM and of the SSD scan
against JAX's gradients, on the same numpy-seeded inputs.

JAX's Pallas kernels for these two functions have no VJP: JAX takes their
gradients with XLA, through ``jax.vjp`` of ``ref.moe_gmm_ref`` (the expert
einsum) and of ``models.mamba2.ssd_chunked`` and ``ref.ssd_scan_ref``. The
port takes them with hand-written kernels on the card and, on the CPU, with
their plain versions ``moe_gmm_bwd_plain`` and ``ssd_scan_bwd_plain``,
which ``chip_smoke.py`` holds the kernels to. Tolerances: f32 2e-3, bf16
2e-2 (tests/test_kernels.py's), relative and of each output's largest
value where the gradient is a sum over tokens, sequence or a group's heads
(dW, dB, dC, ddt, da). Whole models: the loss gradients of the mamba2-370m
and zamba2-2.7b smoke models on every leaf, f32, against ``jax.grad`` of
``Model(use_pallas=False).loss`` (the Pallas SSD has no VJP), and of the
qwen3-moe smoke model past 256 tokens, where the capacity drops tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.kernels import ref
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as jm2
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gmm import moe_gmm_bwd_plain, moe_gmm_plain
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain
from repro_torch.models import build_model, moe

RNG = np.random.default_rng(19)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a CPU tensor of dtype ``name``."""
    j = jnp.asarray(a, JDT[name])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, name, err=""):
    """Within TOL relative and TOL of the largest |want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, err
    tol = TOL[name]
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * float(np.abs(w).max()), err_msg=err)


# ---------------------------------------------------------------------------
# grouped expert GEMM
# ---------------------------------------------------------------------------
# (E, C, D, F): ragged C (1, 17, 40 tokens per expert), D and F no multiple
# of 8, tests/test_kernels.py's first case; then the card kernel's edges:
# dX of one 64-deep K step with N one 256-column tile at C = 40, and C = 65
# (a 128-row tile holding one row past 64) with dW's N one tile
GMM_CASES = [(2, 64, 128, 96), (4, 1, 24, 16), (3, 17, 20, 12), (4, 40, 33, 24),
             (4, 40, 256, 64), (2, 65, 64, 256)]
# the cases after the first four draw from generators of their own, so
# that the first four and the later tests keep their data from RNG
GMM_OWN_SEED = {case: 100 + i for i, case in enumerate(GMM_CASES[4:])}


@pytest.mark.parametrize("E,C,D,F", GMM_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_moe_gmm_bwd_plain_matches_jax_vjp_and_autograd(E, C, D, F, name):
    """(dbuf, dw) against ``jax.vjp`` of the expert einsum and against torch
    autograd of ``moe_gmm_plain``, in the working dtype."""
    seed = GMM_OWN_SEED.get((E, C, D, F))
    rng = RNG if seed is None else np.random.default_rng(seed)
    (jb, tb), (jw, tw), (jdy, tdy) = (_pair(a, name) for a in (
        rng.normal(0, 1, (E, C, D)), rng.normal(0, D ** -0.5, (E, D, F)),
        rng.normal(0, 1, (E, C, F))))
    got = moe_gmm_bwd_plain(tb, tw, tdy)
    _, vjp = jax.vjp(ref.moe_gmm_ref, jb, jw)
    for g, w, part in zip(got, vjp(jdy), ("dbuf", "dw")):
        assert g.dtype == tb.dtype
        _close(g, w, name, part)
    leaves = [t.clone().requires_grad_() for t in (tb, tw)]
    auto = torch.autograd.grad(moe_gmm_plain(*leaves), leaves, tdy)
    for g, w in zip(got, auto):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_ops_moe_gmm_differentiates_through_the_plain_backward_on_the_cpu():
    """With grad on, ``ops.moe_gmm`` goes through its Function: the forward
    equals the plain version's and the gradients equal
    ``moe_gmm_bwd_plain``'s exactly; under no_grad no Function is built."""
    buf = torch.from_numpy(RNG.normal(0, 1, (3, 17, 20))).float().requires_grad_()
    w = torch.from_numpy(RNG.normal(0, 0.2, (3, 20, 12))).float().requires_grad_()
    dy = torch.from_numpy(RNG.normal(0, 1, (3, 17, 12))).float()
    out = ops.moe_gmm(buf, w)
    assert out.grad_fn is not None and torch.equal(out, moe_gmm_plain(buf, w))
    got = torch.autograd.grad(out, (buf, w), dy)
    want = moe_gmm_bwd_plain(buf.detach(), w.detach(), dy)
    assert all(torch.equal(g, p) for g, p in zip(got, want))
    with torch.no_grad():
        assert ops.moe_gmm(buf, w).grad_fn is None
    # only w requires grad: dbuf is not computed
    (dw,) = torch.autograd.grad(ops.moe_gmm(buf.detach(), w), (w,), dy)
    assert torch.equal(dw, want[1])


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
# tests/test_torch_ssd.py's cases (B, S, H, P, G, N, chunk): JAX's chunked
# form needs S a multiple of its chunk
SSD_CASES = [
    (1, 64, 2, 32, 1, 16, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 96, 4, 64, 1, 32, 32),
    (2, 256, 8, 64, 2, 64, 64),
]


def _ssd_inputs(B, S, H, P, G, N, name):
    """tests/test_kernels.py's distributions, as (JAX, torch) pairs, then
    the cotangents of y and of the final state."""
    ins = [_pair(a, name) for a in (
        RNG.normal(0, 1, (B, S, H, P)), RNG.uniform(1e-3, 0.1, (B, S, H)),
        -RNG.uniform(0.5, 2.0, (H,)), RNG.normal(0, 0.5, (B, S, G, N)),
        RNG.normal(0, 0.5, (B, S, G, N)))]
    dy = _pair(RNG.normal(0, 1, (B, S, H, P)), name)
    dh = RNG.normal(0, 1, (B, H, P, N)).astype(np.float32)
    return ins, dy, (jnp.asarray(dh), torch.from_numpy(dh))


def _check_ssd(got, want, name, case):
    for part, g, w in zip(("dxh", "ddt", "da", "dB", "dC"), got, want):
        _close(g, w, name, f"{part} {case}")


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ssd_scan_bwd_plain_matches_jax_vjp_of_ssd_chunked(B, S, H, P, G, N, chunk, name):
    """All five gradients, for cotangents of both outputs (dy and a non-zero
    dh_final), against ``jax.vjp`` of JAX's ``ssd_chunked`` (f32 inputs for
    f32; for bf16 the JAX reference runs in f32 on the same bf16 values,
    since its bf16 einsums round more than the port, which computes in f32
    and casts once)."""
    ins, (jdy, tdy), (jdh, tdh) = _ssd_inputs(B, S, H, P, G, N, name)
    got = ssd_scan_bwd_plain(*(t for _, t in ins), tdy, tdh)
    assert [g.dtype for g in got] == [t.dtype for _, t in ins]
    j32 = [j.astype(jnp.float32) for j, _ in ins]
    _, vjp = jax.vjp(lambda *a: jm2.ssd_chunked(*a, chunk=chunk), *j32)
    _check_ssd(got, vjp((jdy.astype(jnp.float32), jdh)), name, (B, S, H, P, G, N))


@pytest.mark.parametrize("S", [1, 37, 100, 257])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ssd_scan_bwd_plain_matches_jax_vjp_of_the_oracle_at_ragged_lengths(S, name):
    """Ragged S, G = 2 with two heads a group, a non-zero dh_final: against
    ``jax.vjp`` of the sequential oracle ``ref.ssd_scan_ref`` (f32)."""
    ins, (jdy, tdy), (jdh, tdh) = _ssd_inputs(2, S, 4, 32, 2, 16, name)
    got = ssd_scan_bwd_plain(*(t for _, t in ins), tdy, tdh)
    _, vjp = jax.vjp(ref.ssd_scan_ref, *(j.astype(jnp.float32) for j, _ in ins))
    _check_ssd(got, vjp((jdy.astype(jnp.float32), jdh)), name, S)


def test_ssd_scan_bwd_plain_is_the_same_under_any_chunk_and_without_dh_final():
    """The explicit backward is exact under any chunking, and a None
    dh_final is a zero one."""
    ins, (_, tdy), (_, tdh) = _ssd_inputs(2, 100, 4, 32, 2, 16, "float32")
    ts = [t.double() for _, t in ins]
    base = ssd_scan_bwd_plain(*ts, tdy.double(), tdh.double(), chunk=64)
    for chunk in (1, 16, 37, 128):
        for g, w in zip(ssd_scan_bwd_plain(*ts, tdy.double(), tdh.double(), chunk=chunk), base):
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9)
    zero = ssd_scan_bwd_plain(*ts, tdy.double(), torch.zeros_like(tdh).double())
    for g, w in zip(ssd_scan_bwd_plain(*ts, tdy.double(), None), zero):
        assert torch.equal(g, w)


def test_ops_ssd_scan_differentiates_through_the_plain_backward_on_the_cpu():
    """With grad on, ``ops.ssd_scan`` goes through its Function: gradients
    equal ``ssd_scan_bwd_plain``'s exactly, for both outputs' cotangents and
    for y's alone (the unused final state reaches the backward as None)."""
    ins, (_, tdy), (_, tdh) = _ssd_inputs(2, 70, 4, 32, 2, 16, "float32")
    leaves = [t.clone().requires_grad_() for _, t in ins]
    y, h = ops.ssd_scan(*leaves, chunk=32)
    got = torch.autograd.grad((y, h), leaves, (tdy, tdh))
    want = ssd_scan_bwd_plain(*(t for _, t in ins), tdy, tdh)
    assert all(torch.equal(g, p) for g, p in zip(got, want))
    y, _ = ops.ssd_scan(*leaves, chunk=32)
    got = torch.autograd.grad(y, leaves, tdy)
    want = ssd_scan_bwd_plain(*(t for _, t in ins), tdy, None)
    assert all(torch.equal(g, p) for g, p in zip(got, want))


# ---------------------------------------------------------------------------
# whole models: loss gradients
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _models(arch):
    """JAX (use_pallas=False) and port models of one smoke config in f32
    with JAX's init, every 1-D leaf (norm scales, biases, SSM dt_bias,
    a_log, d_skip) perturbed so that each matters."""
    jcfg = JAX_SMOKE[arch].scaled(param_dtype="float32")
    jm = jax_build_model(jcfg, use_pallas=False)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
                      if a.ndim == 1 else a, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKE_ARCHS[arch].scaled(param_dtype="float32"), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch,B,S", [("mamba2-370m", 2, 40), ("zamba2-2.7b", 2, 40),
                                      ("qwen3-moe-30b-a3b", 2, 160)])
def test_loss_gradients_match_jax(arch, B, S):
    """f32: autograd of the port's ``Model.loss`` (remat "block"; the SSD
    scan through its Function's backward, the expert GEMMs through theirs)
    against ``jax.grad`` of ``Model(use_pallas=False).loss``, every leaf,
    within 2e-3. S = 40 is no multiple of the SSD chunk (32); the MoE case
    has T = 320 > 256 tokens, so its capacity (100 of 320) drops tokens."""
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(3)
    toks, labels = (rng.integers(0, tm.cfg.vocab, (B, S)).astype(np.int32) for _ in range(2))
    if tm.cfg.moe is not None:
        assert moe.capacity(B * S, tm.cfg.moe) < B * S
    (want_loss, _), want = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, "block")
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    leaves = _flat(params)
    loss, _ = tm.loss(params, {"tokens": torch.from_numpy(toks).long(),
                               "labels": torch.from_numpy(labels).long()})
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-3, atol=2e-3, err_msg=k)
