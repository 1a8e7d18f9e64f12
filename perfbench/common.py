"""Paths, seeds and the small statistics every part of the harness shares."""
from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"

# the top-level module names that no process of the benchmark may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def sub_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one use of ``seed`` (a weight leaf, a batch, a
    permutation), so that every use draws its own stream whatever the
    order of the calls."""
    digest = hashlib.sha256(f"{int(seed)}/{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Dict[str, Any]:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic_file(name: str) -> Dict[str, Any]:
    return load_json(HERE / "traffic" / f"{name}.json")


def checks_file(workload_name: str) -> Dict[str, Any]:
    return load_json(HERE / "checks" / f"{workload_name}.json")


def loaded_forbidden(modules: Sequence[str]) -> List[str]:
    """The names among ``modules`` whose top-level package (the part before
    the first dot, compared whole) is one the benchmark may not load:
    ``repro_torch`` is not ``repro``."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of every value:
    the smallest value with at least q % of the values at or below it."""
    if not values:
        return None
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]
