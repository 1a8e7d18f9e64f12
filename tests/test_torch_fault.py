"""The port's ``runtime/fault.py`` (``repro_torch.runtime.fault``): the
port's versions of ``tests/test_runtime_fault.py`` (``StepWatchdog``,
``ElasticPlan``, ``resume_or_init`` without a checkpoint), then
``resume_or_init`` restoring the newest committed checkpoint and ignoring an
uncommitted one.
"""
import os

import pytest
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.optim import AdamWState
from repro_torch.runtime import fault as fault_mod
from repro_torch.runtime.fault import ElasticPlan, StepWatchdog, _median, \
    resume_or_init


class _Clock:
    """Deterministic stand-in for time.monotonic."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture()
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(fault_mod.time, "monotonic", c)
    return c


def _step(wd, clock, dt):
    wd.start()
    clock.now += dt
    return wd.stop()


def test_median_odd_and_even():
    assert _median([3.0, 1.0, 2.0]) == 2.0
    assert _median([4.0, 1.0, 2.0, 3.0]) == 2.5


def test_watchdog_needs_min_samples_before_flagging(clock):
    wd = StepWatchdog(factor=2.0, min_samples=5)
    # the first min_samples steps are calibration: nothing flags, even
    # a wild outlier
    for dt in (1.0, 1.0, 1.0, 1.0, 50.0):
        assert _step(wd, clock, dt) is False
    assert wd.flagged == []


def test_watchdog_flags_stragglers_and_keeps_estimate_clean(clock):
    seen = []
    wd = StepWatchdog(factor=2.0, min_samples=5,
                      on_straggler=lambda s, dt, med: seen.append((s, dt, med)))
    for _ in range(6):
        assert _step(wd, clock, 1.0) is False
    assert _step(wd, clock, 10.0) is True          # >> 2*median + 3*MAD
    assert wd.flagged == [7]
    assert len(seen) == 1
    step, dt, med = seen[0]
    assert step == 7 and dt == pytest.approx(10.0) and med == pytest.approx(1.0)
    # the straggler must not pollute the running estimate
    assert max(wd.times) == pytest.approx(1.0)
    assert wd.stats() == {"median_s": pytest.approx(1.0), "stragglers": 1}


def test_watchdog_tolerates_normal_jitter(clock):
    wd = StepWatchdog(factor=2.0, min_samples=5)
    for i in range(20):
        dt = 1.0 + 0.05 * (i % 3)                  # mild jitter
        assert _step(wd, clock, dt) is False
    assert wd.flagged == []


def test_watchdog_window_is_bounded(clock):
    wd = StepWatchdog(min_samples=5)
    for _ in range(120):
        _step(wd, clock, 1.0)
    assert len(wd.times) == 100


def test_watchdog_stop_requires_start(clock):
    wd = StepWatchdog()
    with pytest.raises(AssertionError):
        wd.stop()


def test_watchdog_empty_stats():
    assert StepWatchdog().stats() == {"median_s": 0.0, "stragglers": 0}


# ---------------------------------------------------------------------------
# ElasticPlan
# ---------------------------------------------------------------------------

def test_elastic_plan_scale_and_mesh_shape():
    plan = ElasticPlan(old_devices=16, new_devices=8)
    assert plan.scale == 0.5
    # model parallelism is topology-bound; data parallelism flexes
    assert plan.new_mesh_shape(model_parallel=4) == (2, 4)
    with pytest.raises(AssertionError):
        plan.new_mesh_shape(model_parallel=3)


def test_elastic_plan_keeps_global_batch_by_growing_per_device():
    plan = ElasticPlan(old_devices=16, new_devices=8,
                       keep_global_batch=True)
    new_global, per_dev = plan.adjust_batch(global_batch=256,
                                            dp_old=16, dp_new=8)
    assert (new_global, per_dev) == (256, 32)      # trajectory preserved
    with pytest.raises(AssertionError):
        plan.adjust_batch(global_batch=255, dp_old=16, dp_new=8)


def test_elastic_plan_keeps_throughput_by_shrinking_global_batch():
    plan = ElasticPlan(old_devices=16, new_devices=8,
                       keep_global_batch=False)
    new_global, per_dev = plan.adjust_batch(global_batch=256,
                                            dp_old=16, dp_new=8)
    assert (new_global, per_dev) == (128, 16)      # per-device preserved


# ---------------------------------------------------------------------------
# resume_or_init
# ---------------------------------------------------------------------------

def test_resume_or_init_without_checkpoint_initialises_fresh(tmp_path):
    init = {"w": 1.0}
    state, step = resume_or_init(None, lambda: init)
    assert state is init and step == 0
    # an empty checkpoint dir is the same as no dir
    state, step = resume_or_init(str(tmp_path), lambda: init)
    assert state is init and step == 0


def _train_state(step):
    return {"params": {"w": torch.full((4, 3), float(step), dtype=torch.bfloat16)},
            "opt": AdamWState(torch.tensor(step, dtype=torch.int32),
                              {"w": torch.full((4, 3), float(step))},
                              {"w": torch.zeros(4, 3, dtype=torch.bfloat16)},
                              {"w": torch.zeros(4, 3, dtype=torch.bfloat16)}),
            "data_step": torch.tensor(step, dtype=torch.int32)}


def test_resume_or_init_restores_the_newest_committed_checkpoint(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 2, _train_state(2))
    save_checkpoint(d, 4, _train_state(4))
    # a crash while step 6 was written: no .complete marker
    os.remove(os.path.join(save_checkpoint(d, 6, _train_state(6)), ".complete"))
    calls = []

    def init():
        calls.append(1)
        return _train_state(0)

    state, step = resume_or_init(d, init)
    assert step == 4 and len(calls) == 1            # init gave the template
    assert int(state["data_step"]) == 4 and int(state["opt"].step) == 4
    assert torch.equal(state["opt"].master["w"], torch.full((4, 3), 4.0))
    assert state["params"]["w"].dtype == torch.bfloat16

    # a template on ``meta`` restores onto ``device`` without an init
    like = _train_state(0)
    meta = {"params": {"w": like["params"]["w"].to("meta")},
            "opt": AdamWState(*(t.to("meta") if isinstance(t, torch.Tensor)
                                else {"w": t["w"].to("meta")} for t in like["opt"])),
            "data_step": like["data_step"].to("meta")}
    state, step = resume_or_init(d, init, like=meta, device="cpu")
    assert step == 4 and len(calls) == 1
    assert state["opt"].m["w"].device.type == "cpu"
    assert torch.equal(state["params"]["w"], _train_state(4)["params"]["w"])
