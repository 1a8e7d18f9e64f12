"""Whole train steps of the port's MoE, SSM and hybrid smoke models
against JAX's, from one state on one batch.

The port trains these families through the backward of the grouped expert
GEMM and of the SSD scan (their plain versions on the CPU, the hand-written
kernels on the card); JAX through XLA autodiff of the expert einsums and
of ``ssd_chunked`` (``use_pallas=False``: JAX's Pallas SSD kernel has no
VJP). The JAX step runs on a mesh with ``AxisType.Auto`` axes, as
tests/test_torch_train.py's dense cases. Bounds as there: losses within
1e-4 relative, ce, grad norm and lr within 1e-3, parameters within 2e-3
absolute after the run.
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
from repro.runtime.train import init_state as jax_init_state
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import state_from_numpy
from repro_torch.models import build_model
from repro_torch.runtime.train import make_train_step


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-2.7b"])
def test_train_trajectory_matches_jax(arch):
    """f32, B=4, S=64, 2 microbatches, remat "block", 4 steps: both
    frameworks start from JAX's init state and train on the same batch."""
    B, S, steps = 4, 64, 4
    jcfg = JAX_SMOKE[arch].scaled(param_dtype="float32")
    tcfg_kw = dict(learning_rate=5e-3, warmup_steps=2, microbatch_per_device=2,
                   opt_dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jm = jax_build_model(jcfg, use_pallas=False)
    jstep, *_ = jax_make_train_step(jm, JTrainConfig(**tcfg_kw),
                                    JShapeConfig("tiny", S, B, "train"), mesh)
    jstate = jax_init_state(jm, JTrainConfig(**tcfg_kw), jax.random.PRNGKey(1))
    tm = build_model(SMOKE_ARCHS[arch].scaled(param_dtype="float32"), device="cpu")
    tstep, *_ = make_train_step(tm, TrainConfig(**tcfg_kw), ShapeConfig("tiny", S, B, "train"))
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
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
    got, want = _flat(tstate["params"]), _flat(jax.tree.map(np.asarray, jstate["params"]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=0, atol=2e-3, err_msg=k)
