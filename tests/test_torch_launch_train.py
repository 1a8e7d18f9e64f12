"""The port's CWS-scheduled train launch (``repro_torch.launch.train``)
against JAX's, at smoke size on the CPU.

JAX's side is JAX's own workflow: ``build_training_workflow`` and
``LocalRuntime`` running a JAX step, as ``repro.launch.train`` builds them.
JAX's launch itself cannot run here (its host mesh has Explicit axes, which
make ``with_sharding_constraint`` raise), so the step is made on a mesh built
with ``AxisType.Auto`` and with ``use_pallas=True`` (Pallas in interpret
mode), as ``tests/test_torch_train.py`` makes it. The port's side is
``train(device="cpu", smoke=True)``. Both start from JAX's init state (its
moments cast to bf16, exactly: zeros) and take 4 steps in chunks of 2.

Bounds: in f32, ``tests/test_torch_train.py``'s (losses within 1e-4
relative, parameters within 2e-3 absolute). In bf16, the launch's own dtype,
the losses within 1e-4 relative too; the parameters within ADAM_DRIFT, twice
the sum of the steps' learning rates. The frameworks round RMSNorm at
different points (the port's norm casts once after the scale), so in bf16 a
near-zero gradient (a bias's) can take the other sign, and Adam then moves
that parameter a full step of about the learning rate the other way.
"""
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import build_model as jax_build_model
from repro.runtime.orchestrator import LocalRuntime as JLocalRuntime
from repro.runtime.orchestrator import SharedState as JSharedState
from repro.runtime.orchestrator import TrainJobSpec as JTrainJobSpec
from repro.runtime.orchestrator import build_training_workflow as jax_build_training_workflow
from repro.runtime.train import init_state as jax_init_state
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint
from repro_torch.checkpoint.ckpt import _leaves
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import state_from_numpy
from repro_torch.core.dag import TaskState
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch import train as launch
from repro_torch.models import build_model
from repro_torch.runtime.train import init_state, make_train_step

ARCH, STEPS, CHUNK, BATCH, SEQ, LR = "qwen1.5-0.5b", 4, 2, 2, 64, 3e-3
# warmup_cosine's first STEPS learning rates (warmup over 10 steps), twice
ADAM_DRIFT = 2 * sum(LR * t / 10 for t in range(1, STEPS + 1))
RUN = dict(arch=ARCH, smoke=True, steps=STEPS, chunk=CHUNK, batch=BATCH, seq=SEQ, lr=LR,
           device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_run(request):
    """JAX's CWS-scheduled run: the start state (numpy), the per-step
    losses, the state after each chunk and the final params."""
    dtype = request.param
    jcfg = JAX_SMOKE[ARCH].scaled(param_dtype=dtype)
    jm = jax_build_model(jcfg, use_pallas=True)
    tcfg = JTrainConfig(learning_rate=LR, warmup_steps=10, microbatch_per_device=BATCH)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    step, *_ = jax_make_train_step(jm, tcfg, JShapeConfig("driver", SEQ, BATCH, "train"),
                                   mesh, total_steps=STEPS)
    step = jax.jit(step)
    state = jax_init_state(jm, tcfg, jax.random.PRNGKey(0), total_steps=STEPS)
    bf16 = lambda t: jax.tree.map(lambda x: x.astype(jnp.bfloat16), t)  # noqa: E731
    state["opt"] = state["opt"]._replace(m=bf16(state["opt"].m), v=bf16(state["opt"].v))
    pipe = JTokenPipeline(JDataConfig(jcfg.vocab, SEQ, BATCH, seed=0))
    losses, after = [], {}

    def run_chunk(sh, start, stop):
        for s in range(start, stop):
            sh.state, m = step(sh.state, {k: jnp.asarray(v) for k, v in pipe.batch(s).items()})
            losses.append(float(m["loss"]))
        after[stop] = sh.state
        return {"step": stop, "loss": losses[-1]}

    start = jax.tree.map(np.asarray, state)
    shared = JSharedState(state)
    rt = JLocalRuntime(n_nodes=1)
    try:
        rt.run(jax_build_training_workflow(JTrainJobSpec("jax", STEPS, CHUNK), run_chunk,
                                           shared))
    finally:
        rt.shutdown()
    return {"dtype": dtype, "start": start, "losses": losses, "after": after,
            "params": _flat(jax.tree.map(np.asarray, shared.state["params"]))}


def _as_jax_run(monkeypatch, run):
    """Make the launch build ``run``'s config and start from its state."""
    monkeypatch.setattr(launch, "get_config", lambda arch, smoke=False:
                        get_config(arch, smoke).scaled(param_dtype=run["dtype"]))
    monkeypatch.setattr(launch, "init_state",
                        lambda *a, **k: state_from_numpy(run["start"], "cpu"))


def _assert_on_jax_trajectory(out, run, first_step):
    got = [s["loss"] for s in out["steps"]]
    assert [s["step"] for s in out["steps"]] == list(range(first_step + 1, STEPS + 1))
    np.testing.assert_allclose(got, run["losses"][first_step:], rtol=1e-4)
    params = _flat(out["state"]["params"])
    assert sorted(params) == sorted(run["params"])
    for k, want in run["params"].items():
        if run["dtype"] == "float32":
            np.testing.assert_allclose(_np(params[k]), want, rtol=0, atol=2e-3, err_msg=k)
        else:
            np.testing.assert_allclose(_np(params[k]), _np(want), rtol=0, atol=ADAM_DRIFT,
                                       err_msg=k)


def _assert_every_task_succeeded_once(out):
    dag, prov = out["workflow"], out["runtime"].cws.provenance
    traces = prov.traces_for_workflow(dag.workflow_id)
    assert sorted(t.task_id for t in traces) == sorted(dag.tasks)
    for task in dag.tasks.values():
        assert task.state == TaskState.SUCCEEDED and task.attempt == 0, task.task_id


def test_cws_training_matches_jax(monkeypatch, jax_run):
    _as_jax_run(monkeypatch, jax_run)
    out = launch.train(**RUN)
    assert out["start_step"] == 0 and out["resumed_from"] is None
    assert [c["step"] for c in out["chunks"]] == [2, 4]
    _assert_on_jax_trajectory(out, jax_run, 0)
    _assert_every_task_succeeded_once(out)
    assert out["runtime"].predictor.known("train_chunk")


def test_resume_from_a_jax_checkpoint_continues_on_jax_trajectory(monkeypatch, tmp_path,
                                                                  jax_run):
    _as_jax_run(monkeypatch, jax_run)
    jax_save_checkpoint(str(tmp_path), 2, jax_run["after"][2])
    out = launch.train(**RUN, ckpt_dir=str(tmp_path), ckpt_every=2)
    assert out["start_step"] == 2 and out["resumed_from"].endswith("step_00000002")
    _assert_on_jax_trajectory(out, jax_run, 2)
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000004")


def test_resume_after_losing_the_last_checkpoint_is_bit_identical(tmp_path):
    """Run A writes step 2 and 4; step 4 is lost, as in a crash past step 2;
    run B, the same command, resumes at step 2 and retakes steps 3 and 4
    with the same losses and parameters, bit for bit."""
    d = str(tmp_path)
    a = launch.train(**RUN, ckpt_dir=d, ckpt_every=2)
    assert sorted(a["checkpoints"]) == [2, 4]
    shutil.rmtree(os.path.join(d, "step_00000004"))
    b = launch.train(**RUN, ckpt_dir=d, ckpt_every=2)
    assert b["start_step"] == 2 and [s["step"] for s in b["steps"]] == [3, 4]
    assert [s["loss"] for s in b["steps"]] == [s["loss"] for s in a["steps"][2:]]
    got = dict(_leaves(b["state"]))
    for k, p in _leaves(a["state"]):
        assert torch.equal(got[k], p), k
    _assert_every_task_succeeded_once(b)


def test_checkpoint_task_beside_the_next_chunk_writes_its_own_step(monkeypatch, tmp_path):
    """The CWS runs each checkpoint task beside the next chunk, which
    updates the state in place. With the writer slowed past that chunk's
    end, every checkpoint still holds its own step: ``data_step`` equals its
    directory's step, and its master equals an uninterrupted run's there.
    (``data_step`` and the optimizer's step are new tensors each step, so a
    writer of the live state would still label them right: the master and
    params, updated in place, are what such a writer gets wrong.)"""
    steps, d = 8, str(tmp_path)
    real_save = launch.save_checkpoint

    def slow_save(*args, **kwargs):
        time.sleep(0.5)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(launch, "save_checkpoint", slow_save)
    out = launch.train(**{**RUN, "steps": steps}, ckpt_dir=d, ckpt_every=2)
    _assert_every_task_succeeded_once(out)
    # the race's window is real: a checkpoint task and a chunk overlapped
    traces = {t.task_id: t for t in
              out["runtime"].cws.provenance.traces_for_workflow(out["workflow"].workflow_id)}
    ckpt, nxt = traces[f"train-{ARCH}.ckpt.0000"], traces[f"train-{ARCH}.chunk.0001"]
    assert ckpt.start_time < nxt.end_time and nxt.start_time < ckpt.end_time

    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, "cpu")
    tcfg = TrainConfig(learning_rate=LR, warmup_steps=10, microbatch_per_device=BATCH)
    step, _, _, specs = make_train_step(model, tcfg, ShapeConfig("driver", SEQ, BATCH, "train"),
                                        total_steps=steps)
    state = init_state(model, tcfg, torch.Generator().manual_seed(0), total_steps=steps)
    pipe = TokenPipeline(DataConfig(cfg.vocab, SEQ, BATCH, seed=0))
    for s in range(1, steps + 1):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in pipe.batch(s - 1).items()})
        if s % 2:
            continue
        saved, manifest = restore_checkpoint(os.path.join(d, f"step_{s:08d}"), specs,
                                             device="cpu")
        assert manifest["step"] == s
        assert int(saved["data_step"]) == int(saved["opt"].step) == s
        want, params = _flat(state["opt"].master), _flat(saved["params"])
        for k, master in _flat(saved["opt"].master).items():
            assert torch.equal(master, want[k]), (s, k)
            # the step ends with params = bf16(master): one step's leaves
            assert torch.equal(params[k], master.to(params[k].dtype)), (s, k)
