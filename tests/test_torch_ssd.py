"""The port's SSD scan and Mamba2 block against the JAX package's.

``ssd_scan_plain`` (what the CPU runs, and what ``chip_smoke.py`` holds the
CUDA kernel to on the card) against the Pallas kernel ``ssd_scan_pallas`` in
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
from repro_torch.kernels.ssd_scan import ssd_scan_plain
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
    """The SSD is exact under any chunking (the CUDA kernel tiles by 64 rows
    whatever the config's chunk): chunks of 1, 7, 64 and 256 agree in f64."""
    pairs = _ssd_inputs(2, 150, 4, 32, 1, 16, "float32")
    ts = [t.double() for _, t in pairs]
    y0, h0 = ssd_scan_plain(*ts, chunk=256)
    for chunk in (1, 7, 64):
        y, h = ssd_scan_plain(*ts, chunk=chunk)
        torch.testing.assert_close(y, y0, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(h, h0, rtol=1e-10, atol=1e-10)


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
