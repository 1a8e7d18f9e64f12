"""The port's steps on a device mesh (DTensor state placed by ``repro``'s
rules), on the CPU.

In this process, on a 1-rank gloo mesh: three train steps equal
``mesh=None``'s bit for bit and stay on JAX's trajectory; prefill and
decode give ``mesh=None``'s tokens and logits bit for bit (dense and MoE);
a checkpoint crosses between a mesh state and a plain one, and JAX's file
restores onto the mesh. Spawned once, 4 gloo ranks that run the cases one
after another (``tests/torch_mesh_worker.py``): a (2, 2) dense train with
ZeRO-1/2, a (1, 4) GQA train whose KV heads replicate against sharded query
heads, and expert-parallel MoE serving on (4, 1); each held against
``mesh=None`` on the full batch."""
import multiprocessing
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType
from torch.distributed.tensor import DTensor

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import SMOKE_ARCHS as JAX_SMOKE
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import build_model as jax_build_model
from repro.runtime.train import init_state as jax_init_state
from repro.runtime.train import make_train_step as jax_make_train_step
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.convert import state_from_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.runtime.serve import make_prefill_step, make_serve_step
from repro_torch.runtime.sharding import shard_tree, unshard_tree
from repro_torch.runtime.train import init_state, make_train_step, mesh_context

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_worker  # noqa: E402

B, S = 4, 32


def _leaves(tree, prefix=""):
    return torch_mesh_worker._leaves(tree, prefix)


@pytest.fixture
def mesh():
    assert not dist.is_initialized()
    yield make_host_mesh("cpu")
    dist.destroy_process_group()


def test_train_on_a_one_rank_mesh_equals_no_mesh_and_jax(mesh):
    """f32, 2 microbatches, remat "block", ZeRO-1/2: 3 steps from JAX's
    init state on the mesh and without; both bit for bit the same, and on
    JAX's trajectory (its XLA attention) at ``tests/test_torch_train.py``'s
    bounds."""
    arch, steps = "qwen1.5-0.5b", 3
    kw = dict(learning_rate=5e-3, warmup_steps=2, microbatch_per_device=2, opt_dtype="float32")
    jcfg = JAX_SMOKE[arch].scaled(param_dtype="float32")
    jm = jax_build_model(jcfg)
    jmesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jstep, *_ = jax_make_train_step(jm, JTrainConfig(**kw), JShapeConfig("t", S, B, "train"),
                                    jmesh)
    jstate = jax_init_state(jm, JTrainConfig(**kw), jax.random.PRNGKey(1))
    tm = build_model(SMOKE_ARCHS[arch].scaled(param_dtype="float32"), device="cpu")
    shape = ShapeConfig("t", S, B, "train")
    ref_step, *_ = make_train_step(tm, TrainConfig(**kw), shape)
    step, state_sh, batch_sh, _ = make_train_step(tm, TrainConfig(**kw), shape, mesh)
    start = jax.tree.map(np.asarray, jstate)
    ref = state_from_numpy(start, "cpu")
    state = shard_tree(state_from_numpy(start, "cpu"), state_sh)
    assert all(isinstance(t, DTensor) for t in _leaves(state).values())
    batch = JTokenPipeline(JDataConfig(jcfg.vocab, S, B)).batch(0)
    jit_step = jax.jit(jstep)
    for _ in range(steps):
        jstate, jm_ = jit_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        ref, mr = ref_step(ref, tb)
        state, m = step(state, shard_tree(tb, batch_sh))
        assert float(m["loss"]) == float(mr["loss"])
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]), rtol=1e-4)
    got, want = _leaves(unshard_tree(state)), _leaves(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    jparams = _leaves(state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")["params"],
                      "/params")
    for k, w in jparams.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2e-3, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b"])
def test_prefill_and_decode_on_a_one_rank_mesh_equal_no_mesh(mesh, arch):
    cfg = SMOKE_ARCHS[arch]
    model = build_model(cfg, device="cpu")
    steps = 8
    pshape, dshape = ShapeConfig("p", 24, 2, "prefill"), ShapeConfig("d", 24, 2, "decode")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
    prefill, psh, _ = make_prefill_step(model, pshape, mesh)
    serve, ssh, specs = make_serve_step(model, dshape, mesh)
    assert sorted(ssh) == sorted(specs) == ["cache", "params", "pos", "token"]
    ref_prefill, none_sh, _ = make_prefill_step(model, pshape)
    assert none_sh is None
    nxt_r, cache_r = ref_prefill({"params": params, "tokens": tokens})
    nxt, cache = prefill({"params": shard_tree(params, psh["params"]),
                          "tokens": shard_tree(tokens, psh["tokens"])})
    assert torch.equal(nxt.full_tensor(), nxt_r)
    for k, c in _leaves(unshard_tree(cache)).items():
        assert torch.equal(c, _leaves(cache_r)[k]), k
    dparams, cache = shard_tree(params, ssh["params"]), shard_tree(cache, ssh["cache"])
    tok_r, tok = nxt_r.long(), shard_tree(nxt_r.long(), ssh["token"])
    for i in range(steps):
        lr, cache_r = model.decode_step(params, cache_r, tok_r, 12 + i)
        with mesh_context(mesh):
            lg, cache = model.decode_step(dparams, cache, tok, 12 + i)
        assert torch.equal(lg.full_tensor(), lr), i
        tok_r = lr.argmax(-1)
        tok = shard_tree(tok_r, ssh["token"])
    nxt, _ = serve(dparams, cache, tok, 12 + steps)
    assert torch.equal(nxt.full_tensor(), make_serve_step(model, dshape)[0](
        params, cache_r, tok_r, 12 + steps)[0])


def test_checkpoints_cross_between_mesh_and_plain_state(mesh, tmp_path):
    """A plain state restores onto the mesh's shardings and a mesh state's
    checkpoint restores plain, leaf for leaf; JAX's file restores onto the
    mesh (the elastic path: the saving side had no mesh)."""
    model = build_model(SMOKE_ARCHS["qwen1.5-0.5b"], device="cpu")
    tcfg = TrainConfig()
    _, state_sh, _, specs = make_train_step(model, tcfg, ShapeConfig("t", 8, 2, "train"), mesh)
    plain = init_state(model, tcfg, torch.Generator().manual_seed(0))
    onto_mesh, _ = restore_checkpoint(save_checkpoint(str(tmp_path / "a"), 1, plain),
                                      specs, state_sh)
    placed = shard_tree(init_state(model, tcfg, torch.Generator().manual_seed(0)), state_sh)
    back, _ = restore_checkpoint(save_checkpoint(str(tmp_path / "b"), 1, placed), specs,
                                 device="cpu")
    want = _leaves(plain)
    for tree in (onto_mesh, back):
        got = _leaves(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            g = got[k]
            if tree is onto_mesh:
                assert isinstance(g, DTensor) and g.placements == _leaves(placed)[k].placements
                g = g.full_tensor()
            assert torch.equal(g, want[k]), k
    jm = jax_build_model(JAX_SMOKE["qwen1.5-0.5b"])
    jstate = jax_init_state(jm, JTrainConfig(), jax.random.PRNGKey(2))
    jstate["opt"] = jstate["opt"]._replace(
        m=jax.tree.map(lambda x: x.astype(jnp.bfloat16), jstate["opt"].m),
        v=jax.tree.map(lambda x: x.astype(jnp.bfloat16), jstate["opt"].v))
    jpath = jax_save_checkpoint(str(tmp_path / "jax"), 5, jstate)
    from_jax, manifest = restore_checkpoint(jpath, specs, state_sh)
    assert manifest["step"] == 5
    jwant = _leaves(state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu"))
    for k, g in _leaves(from_jax).items():
        assert torch.equal(g.full_tensor(), jwant[k]), k


CASE_TIMEOUT_S = 59.0


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """4 gloo ranks, spawned once, run ``torch_mesh_worker.CASES`` in order;
    → case → None when every rank finished it, else what went wrong. Each
    case gets ``CASE_TIMEOUT_S`` from the end of the one before; after a
    failure or a timeout the ranks are stopped and the later cases are not
    reached."""
    out = tmp_path_factory.mktemp("spmd")
    world = 4
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_mesh_worker.run,
                         args=(r, world, str(out / "store"), torch_mesh_worker.CASES, str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    outcome, failed = {}, None
    for case in torch_mesh_worker.CASES:
        if failed:
            outcome[case] = f"not reached: {failed} failed"
            continue
        deadline = time.monotonic() + CASE_TIMEOUT_S
        while True:
            done = all((out / f"{case}.rank{r}.done").exists() for r in range(world))
            if done or not any(p.is_alive() for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if done:
            outcome[case] = None
            continue
        errors = [e.read_text() for e in sorted(out.glob(f"{case}.rank*.err"))]
        outcome[case] = "\n".join(errors) or f"not done by every rank in {CASE_TIMEOUT_S} s"
        failed = case
    for p in procs:
        p.join(5.0 if not failed else 0.0)
        if p.is_alive():
            p.kill()
            p.join()
    yield outcome


@pytest.mark.parametrize("case", torch_mesh_worker.CASES)
def test_spmd_on_four_ranks_matches_no_mesh(case, four_ranks):
    assert four_ranks[case] is None, four_ranks[case]
