"""The tracers' fallback when ``torch.profiler`` records no device event.

On the card a profiler session sometimes records no device event at all.
``profile_serve`` and ``profile_train`` then time the burst or the step
once more between CUDA events (``kernel_times.profiled_or_events``) and
say so, instead of exiting; the idle shares and the breakdowns by
kernel family are then null, as the span holds the host's gaps. Here, on
the CPU, the session is a stub with no device event and ``event_ms``
(which needs a card) a stub that runs the call and returns a fixed span.
"""
import pytest
import torch

from repro_torch.launch import kernel_times, profile_serve


class _EmptySession:
    """What ``torch.profiler.profile`` gives where it recorded nothing on
    the device: host events only."""

    class _HostEvent:
        device_type = torch.autograd.DeviceType.CPU
        is_user_annotation = False
        name = "aten::mm"

    def events(self):
        return [self._HostEvent()]


@pytest.fixture
def event_stub(monkeypatch):
    calls = []

    def event_ms(fn, iters=1, before=None):
        calls.append(fn())
        return 12.5
    monkeypatch.setattr(kernel_times, "event_ms", event_ms)
    return calls


def test_empty_profiler_session_falls_back_to_cuda_events(event_stub, capsys):
    """The span between CUDA events holds the host's gaps: the idle shares
    that the reports derive from it are null, not a number."""
    busy_us, by_family, by_kernel, n = profile_serve._split(_EmptySession())
    assert (busy_us, dict(by_family), dict(by_kernel), n) == (0.0, {}, {}, 0)
    got = kernel_times.profiled_or_events(busy_us, lambda: "ran", "the burst",
                                          device_idle_share=0.5,
                                          unprofiled_device_idle_share=0.4)
    assert got == (12500.0, "CUDA events",
                   {"device_idle_share": None, "unprofiled_device_idle_share": None})
    assert event_stub == ["ran"]
    assert "the burst: torch.profiler recorded no device event" in capsys.readouterr().out


def test_profiled_time_is_kept_when_the_session_recorded_the_device(event_stub, capsys):
    busy_us, timed_with, idle = kernel_times.profiled_or_events(
        830.0, lambda: "ran", "the train step", device_idle_share=0.002)
    assert (busy_us, timed_with) == (830.0, "torch.profiler")
    assert idle == {"device_idle_share": pytest.approx(1 - 0.00083 / 0.002)}
    assert event_stub == [] and capsys.readouterr().out == ""
