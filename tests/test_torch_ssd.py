"""The port's SSD scan and Mamba2 block against the JAX package's.

``ssd_scan_plain`` (what the CPU runs, and what ``chip_smoke.py`` holds the
CUDA kernels to on the card) and ``ssd_scan_tc_plain`` (the bf16 kernel's
arithmetic: its chunking, M and h_in rounded to bf16, the state from a
bf16 hi + lo split) against the Pallas kernel ``ssd_scan_pallas`` in
interpret mode and the sequential oracle ``ref.ssd_scan_ref``, final state
included; ``mamba_block`` against JAX's with ``use_pallas=True`` and
``mamba_decode_step`` against JAX's, on the same numpy-seeded inputs.
Tolerances are those of tests/test_kernels.py: f32 2e-3, bf16 2e-2. A bf16
block is held to 2e-2 of its largest output (``_close_block``): the port's
gated norm is the fused kernel's function (scale multiplied in f32, one
cast) where JAX's ``layers.rmsnorm`` rounds to bf16 first, and the out
projection carries that one rounding into a few elements by more than 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as jm2
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ssd_scan as port_ssd
from repro_torch.kernels.ssd_scan import ssd_scan_plain, ssd_scan_tc_plain
from repro_torch.models import mamba2 as tm2

RNG = np.random.default_rng(11)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_kernels.py's cases: (B, S, H, P, G, N, chunk)
SSD_CASES = [
    (1, 64, 2, 32, 1, 16, 16),
    (2, 128, 4, 32, 2, 16, 32),
    (1, 96, 4, 64, 1, 32, 32),
    (2, 256, 8, 64, 2, 64, 64),
]


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-3, atol=2e-3)


def _pair(a: np.ndarray, name: str):
    """The same values as a JAX array and a CPU tensor of dtype ``name``."""
    j = jnp.asarray(a, DTYPES[name][0])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_block(got, want, name):
    if name == "float32":
        return np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    a, b = _np(got), _np(want)
    rel = np.abs(a - b).max() / np.abs(b).max()
    assert a.shape == b.shape and rel < 2e-2, f"max |diff| / max |value| = {rel:.4f}"


def _ssd_inputs(B, S, H, P, G, N, name):
    """tests/test_kernels.py's distributions, as (JAX, torch) pairs."""
    return [_pair(a, name) for a in (
        RNG.normal(0, 1, (B, S, H, P)), RNG.uniform(1e-3, 0.1, (B, S, H)),
        -RNG.uniform(0.5, 2.0, (H,)), RNG.normal(0, 0.5, (B, S, G, N)),
        RNG.normal(0, 0.5, (B, S, G, N)))]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SSD_CASES)
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_reference(B, S, H, P, G, N, chunk, name):
    """y against the Pallas kernel (interpret mode) and the oracle; the
    final state, which the Pallas kernel does not emit, against the oracle's."""
    pairs = _ssd_inputs(B, S, H, P, G, N, name)
    js, ts = [j for j, _ in pairs], [t for _, t in pairs]
    y, h = ssd_scan_plain(*ts, chunk=chunk)
    assert y.shape == (B, S, H, P) and y.dtype == ts[0].dtype
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    want_pallas, none = ssd_scan_pallas(*js, chunk=chunk, interpret=True)
    assert none is None
    want_y, want_h = ref.ssd_scan_ref(*js)
    np.testing.assert_allclose(_np(y), _np(want_pallas), **_tol(name))
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol(name))
    np.testing.assert_allclose(_np(h), _np(want_h), **_tol(name))


@pytest.mark.parametrize("S", [1, 37, 100, 257])
def test_ssd_scan_plain_takes_ragged_lengths(S):
    """S no multiple of the chunk (32): the tail is padded with dt = 0, so y
    and the final state are the oracle's (f32)."""
    pairs = _ssd_inputs(2, S, 4, 32, 2, 16, "float32")
    y, h = ssd_scan_plain(*(t for _, t in pairs), chunk=32)
    want_y, want_h = ref.ssd_scan_ref(*(j for j, _ in pairs))
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol("float32"))
    np.testing.assert_allclose(_np(h), _np(want_h), **_tol("float32"))


def test_ssd_scan_plain_is_the_same_under_any_chunk():
    """The SSD is exact under any chunking (the CUDA kernels keep their own,
    128-row chunks in bf16 and 64-row tiles in f32, whatever the config's
    chunk): chunks of 1, 7, 64 and 256 agree in f64."""
    pairs = _ssd_inputs(2, 150, 4, 32, 1, 16, "float32")
    ts = [t.double() for _, t in pairs]
    y0, h0 = ssd_scan_plain(*ts, chunk=256)
    for chunk in (1, 7, 64):
        y, h = ssd_scan_plain(*ts, chunk=chunk)
        torch.testing.assert_close(y, y0, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(h, h0, rtol=1e-10, atol=1e-10)


# the tc kernel's chunk edges: S in {1, Q - 1, Q, Q + 1, 2Q + 1}
TC_LENGTHS = [1, port_ssd.TC_CHUNK - 1, port_ssd.TC_CHUNK, port_ssd.TC_CHUNK + 1,
              2 * port_ssd.TC_CHUNK + 1]


@pytest.mark.parametrize("S", TC_LENGTHS)
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ssd_scan_tc_plain_matches_plain_pallas_and_reference(S, G, name):
    """The tc kernel's decomposition (C·Bᵀ once per group, 4 heads so that
    R = 4 or 2 share it) at the chunk's edges: y against ``ssd_scan_plain``,
    the Pallas kernel (interpret mode) and the oracle, the final state
    against ``ssd_scan_plain``'s and the oracle's."""
    pairs = _ssd_inputs(2, S, 4, 32, G, 16, name)
    js, ts = [j for j, _ in pairs], [t for _, t in pairs]
    y, h = ssd_scan_tc_plain(*ts)
    assert y.shape == (2, S, 4, 32) and y.dtype == ts[0].dtype
    assert h.shape == (2, 4, 32, 16) and h.dtype == torch.float32
    py, ph = ssd_scan_plain(*ts)
    np.testing.assert_allclose(_np(y), _np(py), **_tol(name))
    np.testing.assert_allclose(_np(h), _np(ph), **_tol(name))
    want_pallas, _ = ssd_scan_pallas(*js, chunk=port_ssd.TC_CHUNK, interpret=True)
    want_y, want_h = ref.ssd_scan_ref(*js)
    np.testing.assert_allclose(_np(y), _np(want_pallas), **_tol(name))
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol(name))
    np.testing.assert_allclose(_np(h), _np(want_h), **_tol(name))


@pytest.mark.parametrize("N", port_ssd.STATE_DIMS)
def test_ssd_scan_variant_picker(N):
    """bf16 takes the tensor-core kernel at every shape the wrapper takes
    (every state dim, any head dim that is a multiple of 32), f32 the FMA
    kernel; no bf16 call is routed to ``fma``. Another shape raises."""
    for P in (32, 64, 96, 128, 160):
        assert port_ssd._variant(torch.bfloat16, N, P) == "tc"
        assert port_ssd._variant(torch.float32, N, P) == "fma"
    for P in (16, 48, 80):
        with pytest.raises(ValueError, match="head dim"):
            port_ssd._variant(torch.bfloat16, N, P)
    with pytest.raises(ValueError, match="state dim"):
        port_ssd._variant(torch.bfloat16, N + 8, 64)
    assert set(port_ssd.VARIANTS) == {"tc", "fma"}


# (B, S, H, G, P, want): the main paths' shapes at an H100's 132 SMs, then
# G > 1 and one past the tc kernel's largest block of heads
HEADS_CASES = [(4, 1024, 32, 1, 64, 2), (4, 1024, 80, 1, 64, 5), (1, 511, 32, 1, 64, 1),
               (2, 300, 16, 4, 64, 1), (8, 4096, 64, 2, 64, 8), (4, 1024, 36, 1, 64, 2)]


@pytest.mark.parametrize("B,S,H,G,P,want", HEADS_CASES)
def test_ssd_tc_heads_per_block(B, S, H, G, P, want):
    """A tc block takes heads of one group only (a divisor of H/G), at most
    TC_MAX_HEADS, and no more than keeps the launch at
    TC_MIN_BLOCKS_PER_SM blocks an SM."""
    got = port_ssd._heads_per_block(B, S, H, G, P, 132)
    assert got == want
    assert (H // G) % got == 0 and 1 <= got <= port_ssd.TC_MAX_HEADS
    chunks = -(-S // port_ssd.TC_CHUNK)
    assert got == 1 or B * chunks * (H // got) >= port_ssd.TC_MIN_BLOCKS_PER_SM * 132


def _layer(name, seed=0):
    """mamba2-370m smoke's layer 0 from JAX's init (norm scales, conv bias and
    skip perturbed off their ones and zeros), as (JAX, port) params."""
    jcfg = JAX_SMOKE["mamba2-370m"].scaled(param_dtype=name)
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
    lp = jax.tree.map(lambda a: a[0], jp["layers"])
    rng = np.random.default_rng(seed)
    for k in ("norm", "conv_b", "d_skip"):
        lp[k] = lp[k] + jnp.asarray(rng.normal(0, 0.1, lp[k].shape), lp[k].dtype)
    return jcfg, lp, params_from_numpy(jax.tree.map(np.asarray, lp), "cpu")


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_mamba_block_matches_jax_pallas(name):
    """B=2, S=40 (more than the chunk of 32, not a multiple of it)."""
    jcfg, jlp, tlp = _layer(name)
    cfg = SMOKE_ARCHS["mamba2-370m"].scaled(param_dtype=name)
    xj, xt = _pair(RNG.normal(0, 1, (2, 40, cfg.d_model)), name)
    want = jax.jit(lambda x, p: jm2.mamba_block(x, p, jcfg, use_pallas=True))(xj, jlp)
    got = tm2.mamba_block(xt, tlp, cfg)[0]
    assert got.dtype == xt.dtype
    _close_block(got, want, name)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_jax(name):
    """One recurrent step from a random (conv, ssm) cache: the output and
    both new cache entries, the state in the cache's dtype."""
    jcfg, jlp, tlp = _layer(name, seed=1)
    cfg = SMOKE_ARCHS["mamba2-370m"].scaled(param_dtype=name)
    shapes = tm2.mamba_cache_shape(cfg, 3)
    cj, ct = {}, {}
    for k, s in shapes.items():
        cj[k], ct[k] = _pair(RNG.normal(0, 0.5, s), name)
    xj, xt = _pair(RNG.normal(0, 1, (3, cfg.d_model)), name)
    want, want_cache = jax.jit(lambda x, c, p: jm2.mamba_decode_step(x, c, p, jcfg))(
        xj, cj, jlp)
    got, got_cache = tm2.mamba_decode_step(xt, ct, tlp, cfg)
    _close_block(got, want, name)
    for k in shapes:
        assert got_cache[k].dtype == ct[k].dtype and got_cache[k].shape == shapes[k]
        np.testing.assert_allclose(_np(got_cache[k]), _np(want_cache[k]), **_tol(name))
