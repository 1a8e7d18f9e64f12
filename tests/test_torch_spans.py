"""The program's spans (``repro_torch.spans``): nothing recorded and no
``record_function`` opened while no profiler records; under a CPU
``torch.profiler`` session, the serving round's, the train step's and a
Mamba block's spans with their names, parents, keys, waits and
attributes; each span's interval enclosing the profiler's event of the
same range (one clock); device-time sums that leave the ranges out; the
list kept bounded and consistent across ``clear()``."""
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import SMOKE_ARCHS
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import profile_train
from repro_torch.launch.kernel_times import kernel_events, split_kernels
from repro_torch.models import build_model
from repro_torch.runtime.serve import ContinuousBatcher, Request
from repro_torch.runtime.train import init_state, make_train_step

MOE = "qwen3-moe-30b-a3b"
MOE_SPANS = ("moe.route", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


def _model(arch=MOE):
    model = build_model(SMOKE_ARCHS[arch], device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _batcher(prompt_lens=(9, 5)):
    model, params = _model()
    b = ContinuousBatcher(model, params, 2, 64, eos_token=-1)
    for i, n in enumerate(prompt_lens):
        b.submit(Request(f"r{i}", list(range(2, 2 + n)), 3))
    return b


def _train(steps=1):
    model, _ = _model()
    tcfg = TrainConfig(microbatch_per_device=1, warmup_steps=1)
    step, *_ = make_train_step(model, tcfg, ShapeConfig("tiny", 16, 2, "train"))
    state = init_state(model, tcfg, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(2, model.cfg.vocab, (2, 16), generator=g)
             for k in ("tokens", "labels")}
    for _ in range(steps):
        state, _ = step(state, batch)
    return model


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, spans.records()


def _by_name(recs, name):
    return [i for i, r in enumerate(recs) if r.name == name]


def test_without_a_profiler_nothing_is_recorded_and_no_range_opened(monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler recording")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    null = spans.span("a", key=1, wait=True, device="cpu", n=2)
    assert spans.span("b") is null and not null.recording
    with null as s:
        s.set(active=3)
    b = _batcher()
    assert b.step() == 2
    _train()
    assert spans.records() == []


def test_a_serving_round_records_admissions_uploads_decode_and_readback():
    b = _batcher()
    _, recs = _profiled(b.step)
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in recs)
    (rnd,) = _by_name(recs, "batcher.round")
    assert recs[rnd].parent is None and recs[rnd].key == 0
    assert recs[rnd].attrs == {"active": 2, "admitted": 2}
    admits = _by_name(recs, "batcher.admit")
    assert [recs[i].key for i in admits] == ["r0", "r1"]
    assert [recs[i].attrs["prompt_len"] for i in admits] == [9, 5]
    assert all(recs[i].parent == rnd and recs[i].attrs["queue_wait_us"] >= 0 for i in admits)
    prefills = _by_name(recs, "model.prefill_into")
    assert [recs[i].parent for i in prefills] == admits
    assert [recs[i].key for i in prefills] == ["r0", "r1"]
    assert all(recs[i].device_ms == recs[i].host_ms for i in prefills)      # a CPU device
    uploads = _by_name(recs, "batcher.upload")
    assert [recs[i].parent for i in uploads] == admits + [rnd]
    (dec,) = _by_name(recs, "model.decode_step")
    assert recs[dec].parent == rnd and recs[dec].key == 0 and recs[dec].device_ms > 0
    (pos,) = _by_name(recs, "model.upload")
    assert recs[pos].parent == dec
    (back,) = _by_name(recs, "batcher.readback")
    assert recs[back].parent == rnd
    waits = {recs[i].name for i, r in enumerate(recs) if r.wait}
    assert waits == {"batcher.upload", "model.upload", "batcher.readback"}
    # one set of MoE spans a layer call of each prefill; none in the decode
    # step (S = 1), whose rounds they would slow more than tracing may
    layers = SMOKE_ARCHS[MOE].n_layers
    for name in MOE_SPANS:
        parents = [recs[recs[i].parent].name for i in _by_name(recs, name)]
        assert parents == ["model.prefill_into"] * (2 * layers)
        assert all(recs[i].device_ms is None for i in _by_name(recs, name))
    assert [recs[i].name for i in range(len(recs)) if recs[i].attrs.get("active")] == \
        ["batcher.round"]


def test_a_train_step_records_its_phases_per_microbatch_with_device_times():
    _, recs = _profiled(lambda: _train(steps=2))
    steps = _by_name(recs, "train_step")
    assert [recs[i].key for i in steps] == [0, 1]
    assert all(recs[i].parent is None and recs[i].device_ms > 0 for i in steps)
    for s in steps:
        kids = [i for i, r in enumerate(recs) if r.parent == s]
        names = [recs[i].name for i in kids]
        assert names == ["train_step.forward", "train_step.backward", "train_step.accumulate"] * 2 \
            + ["train_step.optimizer"]
        assert all(recs[i].key == recs[s].key and not recs[i].wait for i in kids)
        assert [recs[i].attrs.get("microbatch") for i in kids] == [0, 0, 0, 1, 1, 1, None]
        assert all(recs[i].device_ms == recs[i].host_ms for i in kids)
        assert sum(recs[i].host_ms for i in kids) <= recs[s].host_ms
    # the MoE layers' spans, in the forward and again in the backward's
    # recomputation (remat "block")
    layers = SMOKE_ARCHS[MOE].n_layers
    for name in MOE_SPANS:
        parents = [recs[recs[i].parent].name for i in _by_name(recs, name)]
        assert parents.count("train_step.forward") == 2 * 2 * layers
        assert parents.count("train_step.backward") == 2 * 2 * layers


def test_a_span_encloses_the_profiler_event_of_its_range():
    b = _batcher()
    prof, recs = _profiled(lambda: (b.step(), _train()))
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    checked = 0
    for name in ("batcher.round", "batcher.admit", "model.decode_step", "batcher.readback",
                 "train_step", "train_step.optimizer", "moe.experts"):
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) > 0, name
        for (s, e), (ks, ke) in zip(mine, theirs):
            assert s <= ks and ke <= e, (name, ks - s, e - ke)
            checked += 1
    assert checked >= 7


def test_a_mamba_block_records_its_stages():
    model, params = _model("mamba2-370m")
    tokens = torch.randint(2, model.cfg.vocab, (1, 12), generator=torch.Generator().manual_seed(4))
    _, recs = _profiled(lambda: model.prefill(params, tokens, 16))
    blocks = _by_name(recs, "mamba_block")
    assert len(blocks) == SMOKE_ARCHS["mamba2-370m"].n_layers
    for blk in blocks:
        assert [r.name for r in recs if r.parent == blk] == [
            "mamba_block.causal_conv", "mamba_block.dt_and_a", "mamba_block.ssd_scan"]


def test_submit_stamps_the_queue_time_on_the_span_clock():
    model, params = _model()
    b = ContinuousBatcher(model, params, 1, 64, eos_token=-1)
    before = time.time()
    fresh, stamped = Request("a", [3, 4, 5], 2), Request("b", [3, 4], 2, submitted_at=12.5)
    b.submit(fresh)
    b.submit(stamped)
    assert before <= fresh.submitted_at <= time.time()
    assert stamped.submitted_at == 12.5


def test_spans_of_another_thread_nest_under_the_span_its_caller_waits_in():
    """As autograd's device thread runs the backward while the caller waits
    in ``train_step.backward``."""
    def worker():
        with spans.span("inner", key="w"):
            pass

    def outer():
        with spans.span("outer", key=7) as s:
            s.set(n=1)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        with spans.span("after"):
            pass

    _, recs = _profiled(outer)
    assert [(r.name, r.parent, r.key) for r in recs] == [
        ("outer", None, 7), ("inner", 0, "w"), ("after", None, None)]
    assert recs[0].attrs == {"n": 1}
    spans.clear()
    assert spans.records() == []


def test_spans_opened_by_many_threads_at_once_are_all_recorded():
    """More threads than cores, switching often: no record is lost, every
    one closes, and no span is left open for the next to take as parent."""
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 50

    def worker(t):
        for i in range(per_thread):
            with spans.span("w", key=(t, i)):
                pass

    def run():
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, recs = _profiled(run)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(r.key for r in recs) == [(t, i) for t in range(n_threads)
                                           for i in range(per_thread)]
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns for r in recs)

    def after():
        with spans.span("after"):
            pass

    _, recs = _profiled(after)
    assert recs[-1].name == "after" and recs[-1].parent is None


def test_device_time_sums_leave_out_the_ranges_of_the_spans():
    """A range shows in a trace as a user annotation on each device it
    spans; ``profile_train``'s, ``profile_serve``'s and ``chip_smoke.py``'s
    sums of device time read ``kernel_events``, which leaves them out (read
    here on the CPU, where the ranges are the CPU's annotations)."""
    prof, recs = _profiled(_train)
    names = {r.name for r in recs}
    assert {"train_step", "train_step.optimizer", "moe.experts"} <= names
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in prof.events() if e.device_type == cpu and e.is_user_annotation]
    assert names <= {e.name for e in ranges}
    busy_us, by_family, by_kernel, n = split_kernels(prof, profile_train.family, cpu)
    assert not names & set(by_kernel)
    assert n == sum(e.device_type == cpu for e in prof.events()) - len(ranges) > 0
    assert busy_us == pytest.approx(sum(by_family.values())) and busy_us > 0
    assert kernel_events(prof) == []            # no CUDA event on the CPU

    class Event:
        def __init__(self, name, annotation):
            self.name, self.is_user_annotation = name, annotation
            self.device_type = torch.autograd.DeviceType.CUDA

    class Trace:
        def events(self):
            return [Event("train_step", True), Event("moe_gmm_tc_kernel", False),
                    Event("Memcpy HtoD", False), Event("model.decode_step", True)]

    assert [e.name for e in kernel_events(Trace())] == ["moe_gmm_tc_kernel", "Memcpy HtoD"]


def test_clear_keeps_the_open_spans_as_parents_of_what_opens_in_them():
    def run():
        with spans.span("outer", key=1):
            with spans.span("before"):
                pass
            spans.clear()
            with spans.span("child"):
                pass
        with spans.span("next"):
            pass

    _, recs = _profiled(run)
    assert [(r.name, r.parent) for r in recs] == [("outer", None), ("child", 0), ("next", None)]
    assert all(r.end_ns is not None for r in recs)


def test_the_list_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 3)

    def run():
        for i in range(5):
            with spans.span("s", key=i, device="cpu"):
                pass

    _, recs = _profiled(run)
    assert [r.key for r in recs] == [0, 1, 2] and spans.dropped == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped == 0
