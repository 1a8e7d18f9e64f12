"""The port's VLM family (phi-3-vision-4.2b's smoke config) against JAX's:
forward logits with patches, the prefill cache over the patch rows and the
prompt, decoding from it, the loss gradients and one train step, on the
same JAX-initialised parameters and numpy-seeded inputs.

f32 agrees within 2e-3; bf16 is held to the relative bound of
tests/test_torch_model.py (max |Δ| / max |reference| < 0.08). JAX's own
test skips the VLM's decode; here the decode from the prefill's cache is
also held against the port's teacher-forced forward with the same patches.
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
from repro.runtime.train import init_state as jax_init_state
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.models import build_model, transformer
from repro_torch.runtime.serve import make_prefill_step
from repro_torch.runtime.train import make_train_step

ARCH = "phi-3-vision-4.2b"
B, S = 2, 12
NOISY = ("ln1", "ln2", "final_norm")


def models(dtype, use_pallas=False):
    """JAX and port models with the same parameters: JAX's init, noise on the
    norm scales (init to ones) so that they matter, carried across as numpy."""
    jm = jax_build_model(JAX_SMOKE[ARCH].scaled(param_dtype=dtype), use_pallas=use_pallas)
    rng = np.random.default_rng(0)

    def perturb(path, a):
        if path[-1].key in NOISY:
            return a + jnp.asarray(rng.normal(0, 0.1, a.shape), a.dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(SMOKE_ARCHS[ARCH].scaled(param_dtype=dtype), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def inputs(dtype, n=S, seed=1):
    """tokens, labels and patches, as (JAX batch, port batch)."""
    cfg = SMOKE_ARCHS[ARCH]
    rng = np.random.default_rng(seed)
    tok = rng.integers(2, cfg.vocab, (B, n)).astype(np.int32)
    lab = rng.integers(2, cfg.vocab, (B, n)).astype(np.int32)
    pat = rng.normal(0, 1, (B, cfg.vision.n_patches, cfg.vision.patch_dim)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
          "patches": jnp.asarray(pat, jnp.dtype(dtype))}
    tb = {"tokens": torch.from_numpy(tok).long(), "labels": torch.from_numpy(lab).long(),
          "patches": torch.from_numpy(pat).to(getattr(torch, dtype))}
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


def test_schema_has_the_vision_projection_like_jax():
    jm, _, tm, _ = models("float32")
    want = {k: tuple(v.shape) for k, v in _flat(jm.param_specs()).items()}
    got = {k: tuple(v.shape) for k, v in _flat(tm.param_specs()).items()}
    assert got == want
    v = SMOKE_ARCHS[ARCH].vision
    assert got["/vision_proj"] == (v.patch_dim, SMOKE_ARCHS[ARCH].d_model)
    assert tm.n_params() == jm.n_params() == SMOKE_ARCHS[ARCH].param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_with_patches_match_jax(dtype):
    jm, jp, tm, tp = models(dtype)
    jb, tb = inputs(dtype)
    want, _ = jax.jit(lambda p, b: jm.logits(p, b, remat="none"))(jp, jb)
    got, aux = tm.logits(tp, tb)
    assert got.shape == (B, S, tm.cfg.vocab) and float(aux) == 0.0
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_decode_from_it_match_jax(dtype):
    """The cache holds the patch rows, then the prompt, then zeros; decoding
    from it at positions n_patches + S + t agrees with JAX's decode from its
    own prefill, and with the port's teacher-forced forward over the prompt
    and the fed tokens with the same patches."""
    jm, jp, tm, tp = models(dtype)
    jb, tb = inputs(dtype)
    n_p, steps = tm.cfg.vision.n_patches, 6
    max_len = n_p + S + steps
    want_logits, jcache = jax.jit(lambda p, t, x: jm.prefill(p, t, max_len, {"patches": x}))(
        jp, jb["tokens"], jb["patches"])
    got_logits, tcache = tm.prefill(tp, tb["tokens"], max_len, {"patches": tb["patches"]})
    assert_close(got_logits, want_logits, dtype)
    for name in ("k", "v"):
        got = tcache["full"][name]
        assert got.shape == tuple(jcache["full"][name].shape) and got.shape[3] == max_len
        assert_close(got, jcache["full"][name], dtype)
        assert not got[:, :, :, n_p + S:].any()
    fed = np.random.default_rng(3).integers(2, tm.cfg.vocab, (B, steps)).astype(np.int32)
    jstep = jax.jit(jm.decode_step)
    got_steps = []
    for t in range(steps):
        want, jcache = jstep(jp, jcache, jnp.asarray(fed[:, t]), jnp.int32(n_p + S + t))
        got, tcache = tm.decode_step(tp, tcache, torch.from_numpy(fed[:, t]).long(),
                                     n_p + S + t)
        assert_close(got, want, dtype)
        got_steps.append(got)
    forced, _ = tm.logits(tp, {"tokens": torch.cat([tb["tokens"], torch.from_numpy(
        fed).long()], dim=1), "patches": tb["patches"]}, remat="none")
    assert_close(torch.stack([got_logits] + got_steps[:-1], dim=1), forced[:, S - 1:-1], dtype)


def test_patches_are_cast_to_the_parameters_dtype_at_entry():
    """f32 patches against bf16 weights give what bf16 patches give: the
    cast happens once, at the model's entry, as in JAX's ``embed_inputs``."""
    _, _, tm, tp = models("bfloat16")
    _, tb = inputs("float32")
    got, _ = tm.logits(tp, tb)
    want, _ = tm.logits(tp, {**tb, "patches": tb["patches"].bfloat16()})
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_prefill_step_caches_the_patches_beside_seq_len():
    """``make_prefill_step`` of a VLM builds a cache of ``seq_len +
    n_patches`` slots (repro's rule) and returns the prefill's next tokens."""
    _, _, tm, tp = models("float32")
    _, tb = inputs("float32")
    step, _, _ = make_prefill_step(tm, ShapeConfig("p", S + 4, B, "prefill"))
    nxt, cache = step({"params": tp, "tokens": tb["tokens"], "patches": tb["patches"]})
    logits, _ = tm.prefill(tp, tb["tokens"], S + 4 + tm.cfg.vision.n_patches,
                           {"patches": tb["patches"]})
    assert cache["full"]["k"].shape[3] == S + 4 + tm.cfg.vision.n_patches
    torch.testing.assert_close(nxt, logits.argmax(-1).to(torch.int32))
    with pytest.raises(TypeError, match="frames"):
        tm.prefill(tp, tb["tokens"], 64, {"frames": tb["patches"]})


def test_patches_to_a_model_without_vision_raise():
    """A text model given patches refuses them in ``embed_inputs``,
    ``forward`` and ``prefill``: it does not drop them silently."""
    cfg = SMOKE_ARCHS["qwen1.5-0.5b"].scaled(param_dtype="float32")
    tm = build_model(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(2, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    patches = torch.zeros(B, 4, 8)
    with pytest.raises(ValueError, match="no vision config"):
        transformer.embed_inputs(cfg, tp, tokens, patches)
    with pytest.raises(ValueError, match="no vision config"):
        transformer.forward(cfg, tp, tokens, patches, remat="none")
    with pytest.raises(ValueError, match="no vision config"):
        tm.prefill(tp, tokens, 64, {"patches": patches})


def test_loss_gradients_match_jax_pallas():
    """f32: autograd of ``Model.loss`` with patches (remat "block") against
    ``jax.grad`` of ``Model(use_pallas=True).loss`` on every leaf,
    ``vision_proj`` included."""
    jm, jp, tm, tp = models("float32", use_pallas=True)
    jb, tb = inputs("float32")
    (want_loss, _), want = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb, "block")
    params = jax.tree.map(lambda t: t.clone().requires_grad_(), tp)
    leaves = _flat(params)
    loss, _ = tm.loss(params, tb)
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    want = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert sorted(got) == sorted(want) and "/vision_proj" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-3, atol=2e-3, err_msg=k)


def test_train_step_matches_jax():
    """One f32 train step (B=2 in 2 microbatches, remat "block") from JAX's
    init state on both sides, JAX's on a mesh built with ``AxisType.Auto``:
    the patches reach each microbatch's loss; loss, grad norm and the
    updated params agree."""
    kw = dict(learning_rate=5e-3, warmup_steps=2, microbatch_per_device=1,
              opt_dtype="float32")
    jm = jax_build_model(JAX_SMOKE[ARCH].scaled(param_dtype="float32"), use_pallas=True)
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


def test_serve_workload_serves_the_vlm_text_burst():
    """``launch.serve_workload`` takes a VLM config: its burst is text only
    (a request carries no patches, as in ``repro``'s batcher), served in
    full with finite logits; an audio config is refused."""
    from repro_torch.launch import serve_workload
    out = serve_workload.main(device="cpu", smoke=True, config=ARCH)
    assert out["served"] == len(out["requests"]) and out["batcher"].all_logits_finite()
    with pytest.raises(SystemExit, match="cross K/V"):
        serve_workload.main(device="cpu", smoke=True, config="whisper-tiny")
