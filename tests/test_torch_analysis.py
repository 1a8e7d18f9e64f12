"""The port's analytic FLOP and byte model against ``repro``'s: for every
config and every entry of ``SHAPES`` the floats are equal (the same
arithmetic in the same order, compared with ``==``); only the hardware
constants differ, and they are the H100's."""
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import analysis as jan
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import analysis as tan
from repro_torch.models import build_model


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_analytic_model_equals_jax_exactly(arch):
    jcfg, tcfg = JAX_ARCHS[arch], ARCHS[arch]
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    for name, jshape in JAX_SHAPES.items():
        tshape = SHAPES[name]
        B, S = jshape.global_batch, jshape.seq_len
        assert tan.forward_flops(tcfg, B, S) == jan.forward_flops(jcfg, B, S)
        assert tan.decode_flops(tcfg, B, S) == jan.decode_flops(jcfg, B, S)
        assert tan.model_flops_for_cell(tcfg, tshape, tm) == \
            jan.model_flops_for_cell(jcfg, jshape, jm)
        for kw in (dict(chips=256, n_micro=16), dict(chips=512, n_micro=8, remat=False),
                   dict(chips=1, n_micro=2, param_bytes=123456, cache_bytes=789,
                        attention_impl="flash")):
            t, j = tan.analytic_cell(tcfg, tshape, **kw), jan.analytic_cell(jcfg, jshape, **kw)
            assert (t.flops_global, t.bytes_global, t.flops_per_device,
                    t.bytes_per_device, t.assumptions) == \
                (j.flops_global, j.bytes_global, j.flops_per_device,
                 j.bytes_per_device, j.assumptions)


def test_h100_constants_and_ring_costs():
    assert (tan.PEAK_FLOPS, tan.HBM_BW, tan.HBM_BYTES) == (989.4e12, 3.35e12, 80 * 10**9)
    assert (tan.NVLINK_BW, tan.IB_BW, tan.NODE_SIZE) == (450e9, 50e9, 8)
    assert tan.ring_cost("all-reduce", 1000, 4) == 2.0 * 1000 * 3 / 4
    assert tan.ring_cost("all-gather", 1000, 4) == 1000 * 3 / 4
    assert tan.ring_cost("reduce-scatter", 1000, 4) == 1000 * 3
    assert tan.ring_cost("all-reduce", 1000, 1) == 0.0
    assert not tan.collective_op("all-reduce", 8, range(8)).crosses_pods
    assert tan.collective_op("all-reduce", 8, range(0, 16, 2)).crosses_pods
    assert tan.collective_op("all-reduce", 8, [0, 1], over_pod=True).crosses_pods
    ana = tan.analytic_cell(ARCHS["qwen1.5-0.5b"], SHAPES["train_4k"], chips=256, n_micro=16)
    rep = tan.roofline_from_trace([tan.collective_op("all-gather", 1 << 20, range(16))],
                                  arch="a", shape="s", mesh_desc="16x16", chips=256,
                                  model_flops=1e15, analytic=ana, min_bytes=1e9,
                                  per_device_bytes=81 * 10**9)
    assert rep.compute_s == ana.flops_per_device / tan.PEAK_FLOPS
    assert rep.collective_s == (1 << 20) * 15 / 16 / tan.IB_BW
    assert not rep.fits_hbm and rep.n_collectives == 1
