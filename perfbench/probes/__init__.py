"""Kernels a traced run times alone at its cell's shapes, by family:
``<family>.py`` holds ``train(a, mix)`` and ``serve(a, mix)``, each → {name:
{"measured_s", "least_s"}} (``trace.kernel_times``). A family with no
file, or no function for the cell's kind, times nothing, and the readers
of those kernels' rooflines find nothing to read."""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any, Dict, Optional

HERE = Path(__file__).resolve().parent


def timed(a: Any, mix: Dict[str, Any], kind: str) -> Optional[Dict[str, Dict[str, float]]]:
    if not (HERE / f"{a.family}.py").is_file():
        return None
    probe = getattr(importlib.import_module(f"{__name__}.{a.family}"), kind, None)
    return probe(a, mix) if probe else None
