"""The SSD backward's bf16 kernels' arithmetic against the plain backward
and JAX's gradients, on the same numpy-seeded inputs.

``ssd_scan_bwd_tc_plain`` is what the ``tc`` kernels of
``csrc/ssd_scan_bwd.cu`` compute, their bf16 roundings included (the card
tests hold the kernels to it). Here it is held to ``ssd_scan_bwd_plain``
(the f32 backward the CPU runs) over the kernels' edges: S at its 128-row
chunk's edges and ragged (1, 37, 127, 128, 129, 257, 300), G = 1, 2, 4
with several heads a group, a zero and a random gradient of the final
state, every state dim in ``STATE_DIMS``; and to ``jax.vjp`` of
``repro.models.mamba2.ssd_chunked`` and of the sequential oracle
``repro.kernels.ref.ssd_scan_ref`` (JAX's Pallas scan has no VJP: JAX
differentiates these). Tolerances are tests/test_kernels.py's: f32 2e-3,
bf16 2e-2, relative and of each output's largest value (dB, dC, ddt and da
are sums over heads, sequence and batch; the largest value is taken as at
least 1e-3, since at S = 1 da is 0). For bf16 inputs the JAX reference
runs in f32 on the same bf16 values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import mamba2 as jm2
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ssd_scan as port_ssd
from repro_torch.kernels.ssd_scan import (
    STATE_DIMS, ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_bwd_tc_plain)

RNG = np.random.default_rng(20)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": 2e-3, "bfloat16": 2e-2}
LENGTHS = (1, 37, 127, 128, 129, 257, 300)
PARTS = ("dxh", "ddt", "da", "dB", "dC")


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a CPU tensor of dtype ``name``."""
    j = jnp.asarray(a, JDT[name])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _inputs(B, S, H, P, G, N, name, a_range=(0.5, 2.0), dh=True):
    """tests/test_kernels.py's distributions as (JAX, torch) pairs, then the
    cotangents of y and (None for a zero one) of the final state."""
    ins = [_pair(a, name) for a in (
        RNG.normal(0, 1, (B, S, H, P)), RNG.uniform(1e-3, 0.1, (B, S, H)),
        -RNG.uniform(*a_range, (H,)), RNG.normal(0, 0.5, (B, S, G, N)),
        RNG.normal(0, 0.5, (B, S, G, N)))]
    dy = _pair(RNG.normal(0, 1, (B, S, H, P)), name)
    g = RNG.normal(0, 1, (B, H, P, N)).astype(np.float32)
    return ins, dy, (jnp.asarray(g) if dh else jnp.zeros_like(g),
                     torch.from_numpy(g) if dh else None)


def _close(got, want, name, err):
    """Within TOL relative and TOL of the largest |want| (at least 1e-3)."""
    for part, g, w in zip(PARTS, got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        w = w.float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
        assert g.shape == w.shape, f"{part} {err}"
        tol = TOL[name]
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(float(np.abs(w).max()), 1e-3),
                                   err_msg=f"{part} {err}")


def test_ssd_scan_bwd_tc_plain_keeps_one_term_rows_within_a_percent():
    """At S = 1 with a zero final-state gradient each row's dB_j (dC_j) is
    one term, C_j (B_j) times the sum over a group's heads of W_jj: the
    heads' terms can cancel, and bf16 roundings of each W_jj would then be
    most of what is left. The ``tc`` arithmetic keeps the diagonal's
    rounding residual (the kernel adds it in f32), so over 40 draws of
    chip_smoke.py's inputs (a group of 4 heads) every row of dB and dC is
    within 1e-2 of the plain backward's, relative to its norm (chip_smoke's
    per-tile bound; rounding W_jj missed it at 2 of these draws)."""
    worst = 0.0
    for seed in range(40):
        gen = torch.Generator().manual_seed(seed)
        xbc = torch.randn(2, 1, 4 * 64 + 2 * 128, generator=gen)
        xbc[..., 4 * 64:] *= 0.5
        xs, b, c = torch.split(xbc.bfloat16(), [4 * 64, 128, 128], dim=-1)
        dt = (1e-3 + 0.099 * torch.rand(2, 1, 4, generator=gen)).bfloat16()
        a = (-(0.5 + 1.5 * torch.rand(4, generator=gen))).bfloat16()
        ins = (xs.reshape(2, 1, 4, 64), dt, a, b.reshape(2, 1, 1, 128), c.reshape(2, 1, 1, 128))
        dy = torch.randn(2, 1, 4, 64, generator=gen).bfloat16()
        got = ssd_scan_bwd_tc_plain(*ins, dy, None)
        want = ssd_scan_bwd_plain(*ins, dy, None)
        for k in (3, 4):      # dB, dC: (2, 1, 1, 128)
            g, w = got[k].float(), want[k].float()
            worst = max(worst, float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max()))
    assert worst <= 1e-2, worst


@pytest.mark.parametrize("dh", [False, True], ids=["dh_zero", "dh_random"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", LENGTHS)
def test_ssd_scan_bwd_tc_plain_matches_the_plain_backward(S, G, dh):
    """bf16, strong decay (a down to -16) for every other length: all five
    gradients of ``ssd_scan_bwd_tc_plain`` within 2e-2 of
    ``ssd_scan_bwd_plain``'s, in the inputs' dtype; the state dim cycles
    through ``STATE_DIMS``."""
    i = LENGTHS.index(S)
    N = STATE_DIMS[(i + G) % len(STATE_DIMS)]
    H = 2 * G if G > 1 else 4
    ins, (_, dy), (_, g) = _inputs(2 if S <= 129 else 1, S, H, 32, G, N, "bfloat16",
                                   a_range=(1.0, 16.0) if i % 2 else (0.5, 2.0), dh=dh)
    ts = [t for _, t in ins]
    got = ssd_scan_bwd_tc_plain(*ts, dy, g)
    assert [t.dtype for t in got] == [torch.bfloat16] * 5
    _close(got, ssd_scan_bwd_plain(*ts, dy, g), "bfloat16", (S, G, N, dh))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", LENGTHS)
def test_ssd_scan_bwd_tc_plain_matches_jax_vjp_of_the_oracle(S, name):
    """Ragged S, G = 2 with two heads a group, a random dh_final: against
    ``jax.vjp`` of the sequential oracle ``ref.ssd_scan_ref`` (f32)."""
    ins, (jdy, tdy), (jdh, tdh) = _inputs(2, S, 4, 32, 2, 16, name)
    got = ssd_scan_bwd_tc_plain(*(t for _, t in ins), tdy, tdh)
    _, vjp = jax.vjp(ref.ssd_scan_ref, *(j.astype(jnp.float32) for j, _ in ins))
    _close(got, vjp((jdy.astype(jnp.float32), jdh)), name, S)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", STATE_DIMS)
def test_ssd_scan_bwd_tc_plain_matches_jax_vjp_of_ssd_chunked(N, name):
    """Every state dim, two 128-row chunks (S = 256, JAX's chunk 64),
    G = 1, 2, 4 by turns, dh_final zero or random by turns: against
    ``jax.vjp`` of JAX's ``ssd_chunked``."""
    i = STATE_DIMS.index(N)
    G = (1, 2, 4, 2)[i]
    ins, (jdy, tdy), (jdh, tdh) = _inputs(1, 256, 8, 32, G, N, name, dh=bool(i % 2))
    got = ssd_scan_bwd_tc_plain(*(t for _, t in ins), tdy, tdh)
    _, vjp = jax.vjp(lambda *a: jm2.ssd_chunked(*a, chunk=64),
                     *(j.astype(jnp.float32) for j, _ in ins))
    _close(got, vjp((jdy.astype(jnp.float32), jdh)), name, N)


@pytest.mark.parametrize("S,G,dh", [(37, 1, False), (129, 2, True), (300, 4, True)])
def test_ssd_scan_bwd_tc_plain_in_f64_is_the_plain_backward(S, G, dh):
    """Rounding nothing (f64 in, f64 compute), the kernels' formulation
    (T' only through x·(M'ᵀ·dy) and dy·y, the chunk states summed by the
    two chains) is the plain backward's function: equal to 1e-9."""
    ins, (_, dy), (_, g) = _inputs(2, S, 2 * G, 32, G, 16, "float32", dh=dh)
    ts = [t.double() for _, t in ins]
    g = None if g is None else g.double()
    for u, v in zip(ssd_scan_bwd_tc_plain(*ts, dy.double(), g),
                    ssd_scan_bwd_plain(*ts, dy.double(), g)):
        torch.testing.assert_close(u, v, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("N", STATE_DIMS)
def test_ssd_scan_bwd_variant_picker(N):
    """bf16 takes the tensor-core backward at every shape the forward takes,
    f32 the FMA kernel; another dtype, state dim or head dim raises."""
    assert port_ssd.BWD_VARIANTS == ("tc", "fma")
    for P in (32, 64, 128):
        assert port_ssd._bwd_variant(torch.bfloat16, N, P) == "tc"
        assert port_ssd._bwd_variant(torch.float32, N, P) == "fma"
        with pytest.raises(ValueError, match="dtype"):
            port_ssd._bwd_variant(torch.float16, N, P)
    with pytest.raises(ValueError, match="head dim"):
        port_ssd._bwd_variant(torch.bfloat16, N, 48)
    with pytest.raises(ValueError, match="state dim"):
        port_ssd._bwd_variant(torch.bfloat16, N + 8, 64)


@pytest.mark.parametrize("B,S,H,G,P,want", [
    (4, 1024, 32, 1, 64, 4),    # mamba2-370m's train microbatch: 256 blocks
    (4, 1024, 80, 1, 64, 4),    # zamba2-2.7b's: 640
    (1, 128, 8, 1, 64, 1),      # one chunk: one head a block
    (4, 1024, 18, 1, 64, 3),    # 4 does not divide 18: 3 heads, 192 blocks
    (2, 1024, 64, 4, 128, 4),   # 2 P tiles, 16 heads a group: 512 blocks
])
def test_ssd_bwd_heads_per_block(B, S, H, G, P, want):
    """The most heads (a divisor of H/G, at most 4) that leave the launch a
    block per SM of the H100's 132, else one."""
    assert port_ssd._bwd_heads_per_block(B, S, H, G, P, 132) == want


def test_ssd_scan_bwd_cuda_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: on the CPU it raises and
    never runs a plain version in the kernels' place."""
    ins, (_, dy), _ = _inputs(1, 16, 2, 32, 1, 16, "bfloat16")
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan_bwd_cuda(*(t for _, t in ins), dy)
