"""Rank processes for ``tests/test_torch_mesh.py``: the port's SPMD path on
more than one CPU rank (gloo), each case held against the same model run
with ``mesh=None`` on the full batch in the same process. Not a test module:
``run`` is the target that the test spawns, one process per rank; the ranks
run the cases one after another and mark each one done or failed.

The train cases hold, for each of 3 steps, the loss, ce and gradient norm
within ``REL`` relative (step 3's loss is the first that reads moments the
mesh stored); for the first step, from the same parameters on both sides,
every leaf of the accumulated f32 gradient (what the mesh reduces) within
``REL`` of the leaf's largest value. After the 3 steps the AdamW moments
are held within ``MOMENT_REL`` of each leaf's largest value: the sharded
sums add in another order (measured: gradients within 1.2e-6 of each
leaf's largest), and from the second step on the gradients are taken at
parameters that differ by that much. The parameters and their f32 master
are held within ``PARAM_ATOL`` absolute: Adam scales each element's
gradient to about ±lr, so an element whose gradient is near f32 rounding
noise moves by a visible part of a step either way; a bound relative to
the leaf's largest value does not hold for them."""
import os
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import MoEConfig, ShapeConfig, TrainConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.runtime.serve import make_prefill_step, make_serve_step
from repro_torch.runtime.sharding import shard_tree, unshard_tree
from repro_torch.runtime.train import init_state, make_train_step

# the train cases: (arch, mesh shape); f32, STEPS steps of B = 8, S = 32
TRAIN_CASES = {"dense_2x2": ("qwen1.5-0.5b", (2, 2)),
               "gqa_1x4": ("chatglm3-6b", (1, 4))}
CASES = (*TRAIN_CASES, "ep_serve_4x1")
STEPS = 3
REL = 2e-5
LR = 5e-3
MOMENT_REL = 2e-4                 # measured up to 3.6e-5 (v: 1.8e-5)
PARAM_ATOL = 1.5e-3               # measured up to 5.7e-4 (1, 4), 9.2e-5 (2, 2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in sorted(tree) for k2, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, tuple):
        return {k2: v for i, t in enumerate(tree) for k2, v in _leaves(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def train_case(arch, shape):
    """The mesh step on every rank; the reference and the checks on rank 0."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    lead = dist.get_rank() == 0
    cfg = SMOKE_ARCHS[arch].scaled(param_dtype="float32")
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(microbatch_per_device=2, opt_dtype="float32", learning_rate=LR,
                       warmup_steps=1, zero1=True, zero2=True)
    seen = []
    update = AdamW.update

    def recording_update(self, grads, state, params):
        seen.append(_leaves(unshard_tree(grads)))
        return update(self, grads, state, params)

    AdamW.update = recording_update
    tshape = ShapeConfig("t", 32, 8, "train")
    ref_step, *_ = make_train_step(model, tcfg, tshape)
    step, state_sh, batch_sh, _ = make_train_step(model, tcfg, tshape, mesh)
    ref = init_state(model, tcfg, torch.Generator().manual_seed(0))
    state = shard_tree(init_state(model, tcfg, torch.Generator().manual_seed(0)), state_sh)
    pipe = TokenPipeline(DataConfig(cfg.vocab, 32, 8, seed=3))
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
        state, m = step(state, shard_tree(batch, batch_sh))
        if not lead:
            seen.clear()
            continue
        ref, mr = ref_step(ref, batch)
        for k in ("loss", "ce", "grad_norm"):
            a, b = float(m[k]), float(mr[k])
            assert abs(a - b) <= REL * abs(b), (i, k, a, b)
        (got_g, want_g), seen[:] = seen, []
        assert sorted(got_g) == sorted(want_g)
        if i == 0:
            _assert_close(got_g, want_g, lambda w: REL * float(w.abs().max()), "grads")
    got = unshard_tree(state)
    if lead:
        assert sorted(_leaves(got)) == sorted(_leaves(ref))
        for part in ("m", "v"):
            _assert_close(_leaves(getattr(got["opt"], part)), _leaves(getattr(ref["opt"], part)),
                          lambda w: MOMENT_REL * float(w.abs().max()), part)
        for what, g, w in (("params", got["params"], ref["params"]),
                           ("master", got["opt"].master, ref["opt"].master)):
            _assert_close(_leaves(g), _leaves(w), lambda w: PARAM_ATOL, what)
        assert int(got["opt"].step) == int(ref["opt"].step) == STEPS


def _assert_close(got, want, tol_of, what):
    bad = []
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        err = float((g.float() - w.float()).abs().max())
        if err > tol_of(w.float()):
            bad.append((k, err, tol_of(w.float())))
    assert not bad, (what, bad)


def ep_serve_case():
    """Prefill and decode steps in EP mode on every rank; the reference and
    the checks on rank 0."""
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    lead = dist.get_rank() == 0
    base = SMOKE_ARCHS["qwen3-moe-30b-a3b"]
    cfg = base.scaled(param_dtype="float32",
                      moe=MoEConfig(n_experts=64, top_k=base.moe.top_k,
                                    d_ff_expert=base.moe.d_ff_expert))
    model = build_model(cfg, device="cpu")
    B, S, steps = 4, 12, 6
    pshape = ShapeConfig("p", S + steps, B, "prefill")
    dshape = ShapeConfig("d", S + steps, B, "decode")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    prefill, psh, _ = make_prefill_step(model, pshape, mesh)
    serve, ssh, _ = make_serve_step(model, dshape, mesh)
    nxt, cache = prefill({"params": shard_tree(params, psh["params"]),
                          "tokens": shard_tree(tokens, psh["tokens"])})
    dparams = shard_tree(params, ssh["params"])
    cache = shard_tree(cache, ssh["cache"])
    out = [nxt.full_tensor()]
    for i in range(steps):
        nxt, cache = serve(dparams, cache, shard_tree(out[-1].long(), ssh["token"]), S + i)
        out.append(nxt.full_tensor())
    if lead:
        ref_serve = make_serve_step(model, dshape)[0]
        nxt_r, cache_r = make_prefill_step(model, pshape)[0]({"params": params,
                                                              "tokens": tokens})
        want = [nxt_r]
        for i in range(steps):
            nxt_r, cache_r = ref_serve(params, cache_r, want[-1].long(), S + i)
            want.append(nxt_r)
        assert torch.equal(torch.stack(out), torch.stack(want))


def run(rank, world, init_file, cases, out_dir):
    """Run ``cases`` in order on this rank; each ends in ``<case>.rank<r>.done``
    or, with its traceback, ``<case>.rank<r>.err`` (and no later case runs)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        for case in cases:
            try:
                if case in TRAIN_CASES:
                    train_case(*TRAIN_CASES[case])
                else:
                    ep_serve_case()
            except BaseException:
                with open(os.path.join(out_dir, f"{case}.rank{rank}.err"), "w") as f:
                    f.write(traceback.format_exc())
                raise
            open(os.path.join(out_dir, f"{case}.rank{rank}.done"), "w").close()
    finally:
        dist.destroy_process_group()
