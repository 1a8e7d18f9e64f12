"""The port's audio family (whisper-tiny's smoke config, ``models/encdec.py``)
against JAX's: forward logits with frames, the encoder's cross K/V,
decoding at per-row positions against JAX's scalar-position decode row by
row, the loss gradients and one train step, on the same JAX-initialised
parameters and numpy-seeded inputs.

f32 agrees within 2e-3; bf16 is held to the relative bound of
tests/test_torch_model.py (max |Δ| / max |reference| < 0.08).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.layers import sinusoidal_positions as jax_sinusoidal_positions
from repro.runtime.train import init_state as jax_init_state
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.models import build_model, encdec
from repro_torch.models.layers import sinusoidal_positions, sinusoidal_table
from repro_torch.runtime.serve import encdec_serve_cache, greedy_decode, make_prefill_step
from repro_torch.runtime.train import make_train_step

ARCH = "whisper-tiny"
B, S = 2, 12
NOISY = ("ln1", "ln2", "ln_x", "final_norm")


def models(dtype):
    """JAX and port models with the same parameters: JAX's init, noise on the
    norm scales (init to ones) so that they matter, carried across as numpy."""
    jm = jax_build_model(JAX_SMOKE[ARCH].scaled(param_dtype=dtype))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if path[-1].key in NOISY:
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKE_ARCHS[ARCH].scaled(param_dtype=dtype), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def inputs(dtype, n=S, seed=1):
    """tokens, labels and frames, as (JAX batch, port batch); the frames in
    ``dtype`` on both sides (JAX computes its encoder in the frames' dtype)."""
    cfg = SMOKE_ARCHS[ARCH]
    rng = np.random.default_rng(seed)
    tok = rng.integers(2, cfg.vocab, (B, n)).astype(np.int32)
    lab = rng.integers(2, cfg.vocab, (B, n)).astype(np.int32)
    fr = rng.normal(0, 0.1, (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
          "frames": jnp.asarray(fr, jnp.dtype(dtype))}
    tb = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long(),
          "frames": torch.from_numpy(fr).to(getattr(torch, dtype))}
    return jb, tb


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def assert_close(got, want, dtype):
    a, b = _np(got), _np(want)
    assert a.shape == b.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    else:
        rel = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)
        assert rel < 0.08, f"max rel err {rel:.4f}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_schema_and_sinusoidal_table_match_jax():
    """The parameter tree leaf by leaf; the sinusoidal table bit for bit (both
    build it in float64 and cast once); ``_sinusoidal_at`` (f32, per row)
    against the table within f32 rounding of the angle."""
    jm, _, tm, _ = models("float32")
    want = {k: tuple(v.shape) for k, v in _flat(jm.param_specs()).items()}
    assert {k: tuple(v.shape) for k, v in _flat(tm.param_specs()).items()} == want
    assert tm.n_params() == jm.n_params()
    for n, d in ((32, 64), (1500, 384)):
        np.testing.assert_array_equal(sinusoidal_positions(n, d).numpy(),
                                      np.asarray(jax_sinusoidal_positions(n, d)))
    pos = torch.tensor([0, 5, 447, 1499])
    np.testing.assert_allclose(encdec._sinusoidal_at(pos, 384)[:, 0].numpy(),
                               sinusoidal_positions(1500, 384)[pos].numpy(), atol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sinusoidal_table_is_the_table_cast_and_built_once(dtype):
    """The encoder's and decoder's cached table: ``sinusoidal_positions``
    cast to the activations' dtype, one tensor for each (n, d, device,
    dtype) however often it is asked for."""
    got = sinusoidal_table(1500, 384, torch.device("cpu"), dtype)
    assert got.dtype == dtype and got.shape == (1500, 384)
    assert torch.equal(got, sinusoidal_positions(1500, 384).to(dtype))
    assert sinusoidal_table(1500, 384, torch.device("cpu"), dtype) is got
    assert sinusoidal_table(448, 384, torch.device("cpu"), dtype).shape == (448, 384)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_with_frames_match_jax(dtype):
    jm, jp, tm, tp = models(dtype)
    jb, tb = inputs(dtype)
    want, _ = jax.jit(lambda p, b: jm.logits(p, b, remat="none"))(jp, jb)
    got, aux = tm.logits(tp, tb)
    assert got.shape == (B, S, tm.cfg.vocab) and float(aux) == 0.0
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_and_decode_at_per_row_positions_match_jax(dtype):
    """``prefill_cross_kv`` against JAX's; then the port decodes both rows in
    one step with row 0 two positions behind row 1 (row 0 feeds its first
    token at position 0 three times, which rewrites the same K/V), and each
    row's logits agree with JAX's decode of the same row at one scalar
    position per step. Every fed position of both self-attention caches
    agrees at the end."""
    jm, jp, tm, tp = models(dtype)
    jb, tb = inputs(dtype)
    T = 8
    jck, jcv = jax.jit(lambda p, f: jax_encdec.prefill_cross_kv(jm.cfg, p, f))(jp, jb["frames"])
    tcache = encdec_serve_cache(tm, tp, tb["frames"], T)
    assert_close(tcache["cross_k"], jck, dtype)
    assert_close(tcache["cross_v"], jcv, dtype)
    jcache = {**jm.init_cache(B, T), "cross_k": jck, "cross_v": jcv}
    tok = tb["tokens"][:, :T]
    jstep = jax.jit(jm.decode_step)
    want = []
    for t in range(T):
        logits, jcache = jstep(jp, jcache, jb["tokens"][:, t], jnp.int32(t))
        want.append(np.asarray(logits, np.float32))
    lag = 2
    for s in range(T + lag):
        p0, p1 = max(s - lag, 0), min(s, T - 1)
        pos = torch.tensor([p0, p1])
        got, tcache = tm.decode_step(tp, tcache, torch.stack([tok[0, p0], tok[1, p1]]), pos)
        if s >= lag:
            assert_close(got[0], want[p0][0], dtype)
        if s < T:
            assert_close(got[1], want[p1][1], dtype)
    for name in ("self_k", "self_v"):
        assert_close(tcache[name], jcache[name], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_teacher_forced_forward(dtype):
    """Decode steps from ``encdec_serve_cache`` (``greedy_decode``: the
    prompt fed, then two greedy tokens) give the forward's logits at each
    position (JAX's test_decode_matches_forward, here at per-row int
    positions)."""
    _, _, tm, tp = models(dtype)
    _, tb = inputs(dtype)
    cache = encdec_serve_cache(tm, tp, tb["frames"], S + 2)
    logits, fed = greedy_decode(tm, tp, cache, tb["tokens"], 0, S + 2)
    assert torch.equal(fed[:, :S], tb["tokens"])
    assert torch.equal(fed[:, S:], logits[S - 1:S + 1].argmax(-1).T)
    forced, _ = tm.logits(tp, {**tb, "tokens": fed}, remat="none")
    assert_close(logits.transpose(0, 1), forced, dtype)


def test_frames_are_cast_and_prefill_follows_repro():
    """f32 frames against bf16 weights give what bf16 frames give (one cast
    at the model's entry); ``Model.prefill`` raises as JAX's does, and the
    prefill step runs the forward and returns the last position's token."""
    _, _, tm, tp = models("bfloat16")
    _, tb = inputs("float32")
    got, _ = tm.logits(tp, tb)
    want, _ = tm.logits(tp, {**tb, "frames": tb["frames"].bfloat16()})
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="encdec_serve_cache"):
        tm.prefill(tp, tb["tokens"], 32)
    with pytest.raises(NotImplementedError, match="encdec_serve_cache"):
        tm.prefill_into(tp, tb["tokens"], tm.init_cache(B, 32))
    nxt, aux = make_prefill_step(tm, ShapeConfig("p", S, B, "prefill"))[0](
        {"params": tp, "tokens": tb["tokens"], "frames": tb["frames"]})
    torch.testing.assert_close(nxt, want[:, -1].argmax(-1).to(torch.int32))
    assert float(aux) == 0.0


def test_loss_gradients_match_jax():
    """f32: autograd of ``Model.loss`` with frames (remat "block": every
    decoder layer recomputed, the encoder not) against ``jax.grad`` on every
    leaf, the encoder's included."""
    jm, jp, tm, tp = models("float32")
    jb, tb = inputs("float32")
    (want_loss, _), want = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb, "block")
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    leaves = _flat(params)
    loss, _ = tm.loss(params, tb)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert sorted(got) == sorted(want) and "/encoder/blocks/attn/wq" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-3, atol=2e-3, err_msg=k)


def test_remat_recomputes_the_same_gradients():
    _, _, tm, tp = models("float32")
    _, tb = inputs("float32")
    grads = {}
    for remat in ("none", "block"):
        params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
        loss, _ = tm.loss(params, tb, remat)
        grads[remat] = torch.autograd.grad(loss, list(_flat(params).values()))
    for a, b in zip(grads["block"], grads["none"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        tm.logits(tp, tb, remat="layer")


def test_train_step_matches_jax():
    """One f32 train step (B=2 in 2 microbatches, remat "block") from JAX's
    init state on both sides, JAX's on a mesh built with ``AxisType.Auto``:
    the frames reach each microbatch's loss; loss, grad norm and the updated
    params agree."""
    kw = dict(learning_rate=5e-3, warmup_steps=2, microbatch_per_device=1,
              opt_dtype="float32")
    jm = jax_build_model(JAX_SMOKE[ARCH].scaled(param_dtype="float32"))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jstep, *_ = jax_make_train_step(jm, JTrainConfig(**kw), JShapeConfig("t", S, B, "train"),
                                    mesh)
    jstate = jax_init_state(jm, JTrainConfig(**kw), jax.random.PRNGKey(1))
    tm = build_model(SMOKE_ARCHS[ARCH].scaled(param_dtype="float32"), device="cpu")
    tstep, *_ = make_train_step(tm, TrainConfig(**kw), ShapeConfig("t", S, B, "train"))
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jb, tb = inputs("float32")
    jstate, jmet = jax.jit(jstep)(jstate, jb)
    tstate, tmet = tstep(tstate, tb)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4, err_msg=k)
    got, want = _flat(tstate["params"]), _flat(jax.tree.map(np.asarray, jstate["params"]))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=2e-3, err_msg=k)
