"""The per-layer metrics read from the program's own spans
(``perfbench/program_spans.py``): a traced smoke run of the batch cell and
of the train cell reports its two, finite and positive; an untraced run,
which records no span, reports none of them."""
from __future__ import annotations

import math

import pytest

from perfbench import drive_serve, drive_train
from perfbench.run import run_workload
from repro_torch import spans

SEED = 2**33 + 29
CELLS = {"serve.mixtral-8x22b.batch": ("decode_host_ms_p50.offline", "host_wait_ms_p50.offline"),
         "train.qwen3-moe-30b-a3b.4k": ("accumulate_ms.train", "optimizer_ms.train")}
SECONDS = 1.0


@pytest.fixture(autouse=True)
def _stretch_from_the_start(monkeypatch):
    """The traced stretch opens with the window (on the card at 30 % of
    it): a loaded CPU may take the whole of a short window for a step."""
    for mod in (drive_serve, drive_train):
        monkeypatch.setattr(mod, "traced_stretch", lambda seconds: (0.0, 0.4 * seconds))


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_run_reports_the_span_metrics(cell):
    got = run_workload(cell, SEED, SECONDS, True, device="cpu", smoke=True)["metrics"]
    for name in CELLS[cell]:
        assert name in got, (name, sorted(got))
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0, got[name]
        assert got[name]["unit"] == "ms"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_untraced_run_records_no_span_and_reports_none(cell):
    got = run_workload(cell, SEED, SECONDS, False, device="cpu", smoke=True)["metrics"]
    assert not set(CELLS[cell]) & set(got)
    assert spans.records() == []
