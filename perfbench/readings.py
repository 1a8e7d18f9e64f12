"""What several metric readers take from a run's record."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from .common import percentile


def p95_ms(seconds: List[float]) -> Optional[float]:
    v = percentile(seconds, 95)
    return None if v is None else v * 1e3


def _due(run: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [r for r in run["requests"] if r["due"] < run["seconds"]]


def _stopped(run: Dict[str, Any]) -> float:
    """When the loop stopped stepping, seconds into the window."""
    return max([run["seconds"]] + [r["end"] for r in run["rounds"]])


def ttfts(run: Dict[str, Any]) -> List[float]:
    stop = _stopped(run)
    return [(r["tokens"][0] if r["tokens"] else stop) - r["due"] for r in _due(run)]


def token_gaps(run: Dict[str, Any]) -> List[float]:
    end = run["seconds"]
    out = []
    for r in _due(run):
        t = [x for x in r["tokens"] if x <= end]
        out.extend(b - a for a, b in zip(t, t[1:]))
    return out


def queue_waits(run: Dict[str, Any]) -> List[float]:
    stop = _stopped(run)
    return [(r["left_queue"] if r["left_queue"] is not None else stop) - r["due"]
            for r in _due(run)]


def idle_share(run: Dict[str, Any]) -> Optional[float]:
    tr = run.get("trace")
    if not tr or not tr.get("recorded"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def gmm_roofline(run: Dict[str, Any], counters: Dict[str, Optional[str]]) -> Optional[float]:
    """Σ launches · least time / Σ launches · measured time, in %, over the
    products ``run["probes"]`` timed (``<kind>_up``, ``<kind>_down``); a kind's
    launches a step are its counter's (``launches_per_step``), gate/up two
    thirds and down one third; a kind with no counter weighs 1."""
    gmm = run.get("probes")
    if not gmm:
        return None
    per = run.get("launches_per_step", {})
    least = measured = 0.0
    for kind, counter in counters.items():
        n = per.get(counter, 0.0) if counter else 1.0
        for part, share in (("up", 2.0 / 3.0), ("down", 1.0 / 3.0)):
            g = gmm[f"{kind}_{part}"]
            least += n * share * g["least_s"]
            measured += n * share * g["measured_s"]
    return 100.0 * least / measured if measured > 0 else None
