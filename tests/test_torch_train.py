"""The port's training slice against JAX's: AdamW, the schedule, the data
pipeline and whole train steps, on the same numpy-seeded inputs and the same
initial state.

The JAX step runs as ``tests/test_models.py`` runs it, on a mesh built with
``AxisType.Auto`` axes (the host mesh's Explicit axes make
``with_sharding_constraint`` raise) and with ``use_pallas=True``, so its
attention goes through the Pallas forward and backward kernels in interpret
mode. Trajectory bounds: losses within 1e-4 relative and parameters within
2e-3 absolute after the run, about 100x and 4x what JAX's own two attention
paths (Pallas and XLA) differ by at this size (9.7e-7 and 4.8e-4): Adam
turns tiny gradient differences into full-size updates.
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
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.runtime.train import init_state as jax_init_state
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import params_from_numpy, state_from_numpy
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamWState, global_norm, warmup_cosine
from repro_torch.runtime.train import init_state, make_train_step, n_microbatches

RNG = np.random.default_rng(7)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------
def _tree():
    return {"a": RNG.normal(0, 1, (8, 16)).astype(np.float32),
            "b": {"c": RNG.normal(0, 0.1, (16,)).astype(np.float32),
                  "d": RNG.normal(0, 2, (3, 4, 5)).astype(np.float32)}}


@pytest.mark.parametrize("mom_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_jax(mom_dtype, grad_clip):
    """Three updates from one numpy-seeded tree: params, master, moments and
    metrics agree; bf16 moments round once per step in both."""
    params, sched = _tree(), (3e-3, 2, 10)
    jopt = jax_adamw.AdamW(lr=jax_adamw.warmup_cosine(*sched), grad_clip=grad_clip,
                           mom_dtype=mom_dtype)
    topt = AdamW(lr=warmup_cosine(*sched), grad_clip=grad_clip, mom_dtype=mom_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jstate = jopt.init(jp)
    jstate = jstate._replace(m=jax.tree.map(lambda x: x.astype(jopt._mdt()), jstate.m),
                             v=jax.tree.map(lambda x: x.astype(jopt._mdt()), jstate.v))
    tstate = topt.init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda a: RNG.normal(0, 3, a.shape).astype(np.float32), params)
        jp, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        tp, tstate, tm = topt.update(params_from_numpy(grads, "cpu"), tstate, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    for name, got, want in (("params", tp, jp), ("master", tstate.master, jstate.master),
                            ("m", tstate.m, jstate.m), ("v", tstate.v, jstate.v)):
        got, want = _flat(got), _flat(want)
        for k in want:
            assert str(got[k].dtype)[6:] == str(want[k].dtype), (name, k)
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name}{k}")


def test_global_norm_and_schedule_match_jax():
    tree = _tree()
    np.testing.assert_allclose(float(global_norm(params_from_numpy(tree, "cpu"))),
                               float(jax_adamw.global_norm(tree)), rtol=1e-6)
    jlr, tlr = jax_adamw.warmup_cosine(3e-4, 10, 100), warmup_cosine(3e-4, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tlr(torch.tensor(step, dtype=torch.int32))),
                                   float(jlr(jnp.int32(step))), rtol=1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_token_pipeline_matches_jax():
    for cfg in (dict(vocab=512, seq_len=64, global_batch=4, seed=3),
                dict(vocab=151936, seq_len=1024, global_batch=2, shards=2, shard_id=1)):
        j, t = JTokenPipeline(JDataConfig(**cfg)), TokenPipeline(DataConfig(**cfg))
        for step in range(3):
            jb, tb = j.batch(step), t.batch(step)
            assert sorted(jb) == sorted(tb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.mark.parametrize("arch,S,steps", [("qwen1.5-0.5b", 64, 8), ("gemma3-12b", 80, 4)])
def test_train_trajectory_matches_jax(arch, S, steps):
    """f32, B=4, 2 microbatches, remat "block": both frameworks start from
    JAX's init state and take ``steps`` steps on the same batch."""
    B = 4
    jcfg = JAX_SMOKE[arch].scaled(param_dtype="float32")
    tcfg_kw = dict(learning_rate=5e-3, warmup_steps=2, microbatch_per_device=2,
                   opt_dtype="float32")
    jm = jax_build_model(jcfg, use_pallas=True)
    jstep, *_ = jax_make_train_step(jm, JTrainConfig(**tcfg_kw),
                                    JShapeConfig("tiny", S, B, "train"), _jax_mesh())
    jstate = jax_init_state(jm, JTrainConfig(**tcfg_kw), jax.random.PRNGKey(1))
    tm = build_model(SMOKE_ARCHS[arch].scaled(param_dtype="float32"), device="cpu")
    tshape = ShapeConfig("tiny", S, B, "train")
    tstep, state_sh, batch_sh, specs = make_train_step(tm, TrainConfig(**tcfg_kw), tshape)
    assert state_sh is None and batch_sh is None
    assert n_microbatches(tshape, None, TrainConfig(**tcfg_kw)) == 2
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    assert isinstance(tstate["opt"], AdamWState)
    assert {k: v.shape for k, v in _flat(specs["params"]).items()} == \
        {k: v.shape for k, v in _flat(tstate["params"]).items()}
    batch = JTokenPipeline(JDataConfig(jcfg.vocab, S, B)).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jit_step = jax.jit(jstep)
    jl, tl = [], []
    for _ in range(steps):
        jstate, jmet = jit_step(jstate, jb)
        tstate, tmet = tstep(tstate, tb)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        for k in ("ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert int(tstate["data_step"]) == int(jstate["data_step"]) == steps
    got, want = _flat(tstate["params"]), _flat(jax.tree.map(np.asarray, jstate["params"]))
    for k in want:
        assert not got[k].requires_grad
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0, atol=2e-3, err_msg=k)


def test_microbatch_i_takes_rows_i_mod_n():
    """The split sends row i to microbatch i mod n (as ``repro`` does), and
    the step's loss is the mean of the microbatches' losses."""
    cfg = SMOKE_ARCHS["qwen1.5-0.5b"].scaled(param_dtype="float32")
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(microbatch_per_device=2, opt_dtype="float32")
    step, *_ = make_train_step(model, tcfg, ShapeConfig("t", 8, 6, "train"))
    state = init_state(model, tcfg, torch.Generator().manual_seed(0))
    assert all(t.dtype == torch.float32 for t in _flat(state["opt"].m).values())
    batch = {k: torch.from_numpy(v) for k, v in
             TokenPipeline(DataConfig(cfg.vocab, 8, 6, seed=5)).batch(0).items()}
    seen, losses, loss_fn = [], [], model.loss

    def spy(params, mb, remat="block"):
        seen.append(mb["tokens"].clone())
        out = loss_fn(params, mb, remat)
        losses.append(float(out[0].detach()))
        return out

    model.loss = spy
    _, metrics = step(state, batch)
    assert len(seen) == 3
    for i, tokens in enumerate(seen):
        torch.testing.assert_close(tokens, batch["tokens"][[i, i + 3]], rtol=0, atol=0)
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-6)


def test_init_state_keeps_moments_in_opt_dtype():
    model = build_model(SMOKE_ARCHS["qwen1.5-0.5b"], device="cpu")
    state = init_state(model, TrainConfig(opt_dtype="bfloat16"),
                       torch.Generator().manual_seed(0))
    assert int(state["data_step"]) == 0 and int(state["opt"].step) == 0
    for name in ("m", "v"):
        assert all(t.dtype == torch.bfloat16 and not t.any()
                   for t in _flat(getattr(state["opt"], name)).values())
    for k, p in _flat(state["params"]).items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(_flat(state["opt"].master)[k], p.float())
