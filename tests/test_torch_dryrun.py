"""The port's dry run (``repro_torch.launch.dryrun``) on one small cell, in
this process: the qwen1.5-0.5b smoke config's train step at B = 8, S = 64
on an 8-rank fake mesh (2 × 2 × 2, "pod", "data", "model"), traced under
``FakeTensorMode``. The cell must come out ``ok``; the traced FLOPs of a
device times the ranks must lie within FLOPS_TOL of the analytic model's
global count; the state's bytes per device must be the sum its placements
give; collectives must have been recorded, the pod hop among them."""
import math

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.runtime.sharding import map_tree
from repro_torch.runtime.train import make_train_step

# traced / analytic FLOPs: the trace counts what torch.utils.flop_counter
# has formulas for (the products, the plain attention's over every (query,
# key) pair where the analytic model takes the causal mean), the analytic
# model also the optimizer's 20 FLOPs a parameter; measured 0.9649 here
FLOPS_TOL = (0.9, 1.1)


@pytest.fixture
def fake_world():
    assert not dist.is_initialized()
    dryrun.start_fake_world(8)
    yield make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    dist.destroy_process_group()


def test_one_cell_on_an_eight_rank_fake_mesh(fake_world):
    mesh = fake_world
    cfg = SMOKE_ARCHS["qwen1.5-0.5b"]
    shape = ShapeConfig("train_64", 64, 8, "train")
    rec = dryrun.dry_run_cell(cfg, shape, mesh, True, shape_name="train_64",
                              mesh_name="2x2x2", pod_ranks=4)
    assert rec["status"] == "ok" and rec["chips"] == 8
    ratio = rec["hlo_flops_per_device"] * 8 / rec["analytic_flops_global"]
    assert FLOPS_TOL[0] <= ratio <= FLOPS_TOL[1], ratio
    # the state's bytes per device from the placements: each leaf's global
    # bytes over the extents of the mesh dims that shard it
    model = build_model(cfg, device="cpu")
    _, state_sh, batch_sh, specs = make_train_step(model, TrainConfig(), shape, mesh, True)
    want = []

    def per_device(spec, sh):
        split = math.prod(mesh.shape[i] for i, p in enumerate(sh.placements) if p.is_shard())
        assert spec.numel() % split == 0
        want.append(spec.numel() * spec.element_size() // split)

    map_tree(per_device, specs, state_sh)
    map_tree(per_device, model.input_specs(shape), batch_sh)
    assert rec["memory_analysis"]["state_bytes_per_device"] == sum(want)
    assert rec["per_device_hbm_bytes"] > sum(want) and rec["fits_hbm"]
    assert rec["n_collectives"] > 0 and rec["collective_bytes_dcn"] > 0
    assert rec["collectives_by_kind"].get("all-reduce", 0) > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert 0 < rec["roofline_frac"] and rec["model_flops"] > 0


@pytest.mark.parametrize("hq, hkv, ok", [(12, 6, True), (16, 2, True), (12, 3, False)])
def test_gqa_heads_split_against_replicated_kv(fake_world, hq, hkv, ok):
    """Query heads split on "model" (extent 2) against every KV head: rank 0
    slices the KV heads its query heads use, and refuses a range of query
    heads that does not map onto whole KV heads (12 on 3: heads 0..5 would
    read KV heads 0 and 1 as groups of 3, where 0..3 use 0)."""
    mesh = fake_world
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, h, 16, generator=g) for h in (hq, hkv, hkv))
    split = (Replicate(), Replicate(), Shard(2))
    dq = DTensor.from_local(q[:, :, :hq // 2], mesh, split, run_check=False)
    dk, dv = (DTensor.from_local(t, mesh, (Replicate(),) * 3, run_check=False) for t in (k, v))
    if not ok:
        with pytest.raises(ValueError, match="whole KV heads"):
            ops.flash_attention(dq, dk, dv, causal=True)
        return
    want = ops.flash_attention(q, k, v, causal=True)[:, :, :hq // 2]
    assert torch.equal(ops.flash_attention(dq, dk, dv, causal=True).to_local(), want)
