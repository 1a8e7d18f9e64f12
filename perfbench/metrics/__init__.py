"""Metric readers: ``<metric name>.py`` holds ``read(run)``, which takes the
metric from what a run recorded (``run``: the record ``drive_train`` or ``drive_serve`` made, with
``arch``, ``mix`` and ``setup_s``) and returns its value, or None where
it finds nothing to read (the harness then leaves the metric out)."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Callable

HERE = Path(__file__).resolve().parent


def reader(name: str) -> Callable[[Any], Any]:
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
