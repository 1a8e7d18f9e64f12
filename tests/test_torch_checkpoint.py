"""The port's checkpoints (``repro_torch.checkpoint``) against ``repro``'s.

First the port's versions of ``tests/test_checkpoint_store.py``. Then the two
frameworks' files crossed both ways on a smoke train state after one JAX step
(bf16 params, f32 master, bf16 moments): each restores the other's with
identical bits in every leaf, and for one state both write identical files,
manifest and leaves byte for byte. A JAX checkpoint at step 0 (its moments
still f32) restores into the port's state (bf16 moments). The async writer
writes the state as it was at ``save``, whatever is done to it in place after.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import build_model as jax_build_model
from repro.runtime.train import init_state as jax_init_state
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_checkpoint,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint.ckpt import _leaf_key, _leaves
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import state_from_numpy
from repro_torch.models import build_model
from repro_torch.optim import AdamWState
from repro_torch.runtime.train import make_train_step

ARCH, B, S = "qwen1.5-0.5b", 2, 16


def _state():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "opt": {"mu": torch.ones(4, dtype=torch.float32)}}


def _like(w_shape=(2, 3)):
    return {"w": torch.zeros(w_shape), "opt": {"mu": torch.zeros(4)}}


# ---------------------------------------------------------------------------
# the store (the port's versions of tests/test_checkpoint_store.py)
# ---------------------------------------------------------------------------
def test_prune_keeps_exactly_n_newest(tmp_path):
    d = str(tmp_path)
    for step in (10, 20, 30, 40, 50):
        save_checkpoint(d, step, _state())
    prune_checkpoints(d, keep=3)
    left = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert left == ["step_00000030", "step_00000040", "step_00000050"]
    assert latest_checkpoint(d).endswith("step_00000050")
    prune_checkpoints(d, keep=10)
    assert len(os.listdir(d)) >= 3
    prune_checkpoints(d, keep=1)
    assert sorted(p for p in os.listdir(d)
                  if p.startswith("step_")) == ["step_00000050"]
    prune_checkpoints(d, keep=0)                 # a no-op guard, not a wipe
    assert latest_checkpoint(d).endswith("step_00000050")


def test_prune_ignores_uncommitted_directories(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _state())
    save_checkpoint(d, 2, _state())
    os.makedirs(os.path.join(d, "step_00000003"))          # a crash mid-write
    os.remove(os.path.join(save_checkpoint(d, 4, _state()), ".complete"))
    prune_checkpoints(d, keep=1)
    assert latest_checkpoint(d).endswith("step_00000002")
    assert os.path.isdir(os.path.join(d, "step_00000003"))


def test_async_writer_commits_in_order_after_wait(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(d, keep=2)
    for step in (100, 200, 300):
        ck.save(step, {"w": torch.full((3,), float(step))})
    written = ck.wait()
    assert [os.path.basename(p) for p in written] == [
        "step_00000100", "step_00000200", "step_00000300"]
    left = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert left == ["step_00000200", "step_00000300"]
    state, manifest = restore_checkpoint(latest_checkpoint(d), {"w": torch.zeros(3)})
    assert manifest["step"] == 300
    assert torch.equal(state["w"], torch.full((3,), 300.0))


def test_restore_detects_corrupted_shard(tmp_path):
    path = save_checkpoint(str(tmp_path), 7, _state())
    leaf = os.path.join(path, "w.npy")
    np.save(leaf, np.load(leaf) + 1.0)
    with pytest.raises(IOError, match="checksum mismatch"):
        restore_checkpoint(path, _like())
    state, _ = restore_checkpoint(path, _like(), verify=False)   # forensics
    assert torch.equal(state["w"], _state()["w"] + 1.0)


def test_restore_rejects_shape_mismatch_and_missing_leaf(tmp_path):
    path = save_checkpoint(str(tmp_path), 1, _state())
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, _like((3, 2)))
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(path, {"nope": torch.zeros(1)})
    with pytest.raises(NotImplementedError, match="sharding slice"):
        restore_checkpoint(path, _like(), shardings=object())


def test_manifest_records_leaf_metadata(tmp_path):
    path = save_checkpoint(str(tmp_path), 42, _state(), meta={"lr": 3e-4})
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 42
    assert manifest["meta"] == {"lr": 3e-4}
    assert manifest["leaves"]["w"]["shape"] == [2, 3]
    assert manifest["leaves"]["w"]["dtype"] == "float32"
    assert manifest["leaves"]["opt__mu"]["bytes"] == 16


# ---------------------------------------------------------------------------
# across the frameworks
# ---------------------------------------------------------------------------
def _jax_parts():
    jm = jax_build_model(JAX_SMOKE[ARCH])
    tcfg = JTrainConfig(learning_rate=3e-3, warmup_steps=2, microbatch_per_device=B)
    return jm, tcfg


@pytest.fixture(scope="module")
def jax_stepped():
    """JAX's smoke train state after one step: bf16 params, f32 master, bf16
    moments."""
    jm, tcfg = _jax_parts()
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    step, *_ = jax_make_train_step(jm, tcfg, JShapeConfig("t", S, B, "train"), mesh)
    state = jax_init_state(jm, tcfg, jax.random.PRNGKey(3))
    batch = JTokenPipeline(JDataConfig(JAX_SMOKE[ARCH].vocab, S, B, seed=1)).batch(0)
    state, _ = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    m, v = state["opt"].m, state["opt"].v
    assert {str(x.dtype) for x in jax.tree.leaves((m, v))} == {"bfloat16"}
    assert {str(x.dtype) for x in jax.tree.leaves(state["opt"].master)} == {"float32"}
    return state


def _specs():
    model = build_model(SMOKE_ARCHS[ARCH], device="cpu")
    return make_train_step(model, TrainConfig(), ShapeConfig("t", S, B, "train"))[3]


def _jax_leaves(tree):
    return {jax_ckpt._leaf_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(x):
    if isinstance(x, torch.Tensor):
        dtype = str(x.dtype).removeprefix("torch.")
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return dtype, x.numpy()
    x = np.asarray(x)
    return str(x.dtype), (x.view(np.int16) if x.dtype.name == "bfloat16" else x)


def _assert_same_bits(ours, theirs):
    ours = {_leaf_key(p): x for p, x in _leaves(ours)}
    theirs = _jax_leaves(theirs)
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        (dt_a, a), (dt_b, b) = _bits(ours[key]), _bits(theirs[key])
        assert dt_a == dt_b and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path, jax_stepped):
    path = jax_ckpt.save_checkpoint(str(tmp_path), 1, jax_stepped)
    state, manifest = restore_checkpoint(path, _specs(), device="cpu")
    assert manifest["step"] == 1 and isinstance(state["opt"], AdamWState)
    assert all(x.device.type == "cpu" for _, x in _leaves(state))
    _assert_same_bits(state, jax_stepped)


def test_port_checkpoint_restores_into_jax_bit_for_bit(tmp_path, jax_stepped):
    ours = state_from_numpy(jax.tree.map(np.asarray, jax_stepped), "cpu")
    path = save_checkpoint(str(tmp_path), 1, ours)
    restored, manifest = jax_ckpt.restore_checkpoint(path, jax_stepped)
    assert manifest["step"] == 1
    _assert_same_bits(ours, restored)


def test_both_frameworks_write_identical_files(tmp_path, jax_stepped):
    ours = state_from_numpy(jax.tree.map(np.asarray, jax_stepped), "cpu")
    a = save_checkpoint(str(tmp_path / "port"), 5, ours, {"arch": ARCH})
    b = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), 5, jax_stepped, {"arch": ARCH})
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    with open(os.path.join(a, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert len(leaves) == len(_jax_leaves(jax_stepped)) and \
        {m["dtype"] for m in leaves.values()} == {"bfloat16", "float32", "int32"}
    for name in os.listdir(b):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_jax_step0_checkpoint_restores_into_the_port_state(tmp_path):
    """JAX's ``init_state`` keeps f32 moments until the first step, the
    port's are bf16 from the start: restore casts them, exactly (zeros)."""
    jm, tcfg = _jax_parts()
    jstate = jax_init_state(jm, tcfg, jax.random.PRNGKey(0))
    assert {str(x.dtype) for x in jax.tree.leaves(jstate["opt"].m)} == {"float32"}
    path = jax_ckpt.save_checkpoint(str(tmp_path), 0, jstate)
    state, _ = restore_checkpoint(path, _specs(), device="cpu")
    for name in ("m", "v"):
        assert all(x.dtype == torch.bfloat16 and not x.any()
                   for _, x in _leaves(getattr(state["opt"], name)))
    assert int(state["opt"].step) == int(state["data_step"]) == 0
    _assert_same_bits({"params": state["params"], "master": state["opt"].master},
                      {"params": jstate["params"], "master": jstate["opt"].master})


def test_async_checkpointer_writes_the_state_as_it_was_at_save(tmp_path):
    state = {"params": {"w": torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
                        .to(torch.bfloat16)},
             "opt": AdamWState(torch.tensor(3, dtype=torch.int32),
                               {"w": torch.ones(64, 32)}, {"w": torch.zeros(64, 32)},
                               {"w": torch.zeros(64, 32)})}
    before = {k: v.clone() for k, v in
              {_leaf_key(p): x for p, x in _leaves(state)}.items()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, state)
    for _, x in _leaves(state):            # the next step, in place
        x.add_(1)
    ck.wait()
    restored, _ = restore_checkpoint(latest_checkpoint(str(tmp_path)), state)
    got = {_leaf_key(p): x for p, x in _leaves(restored)}
    assert sorted(got) == sorted(before)
    for key, x in before.items():
        assert torch.equal(got[key], x), key
