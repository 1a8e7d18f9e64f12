"""Task runtime prediction (paper §5): the Lotaru predictor.

The port's own copy of ``repro.core.predict``'s ``BayesianLinReg``,
``_features``, ``NodeProfile`` and ``LotaruPredictor``; the serving entry point
orders requests shortest-predicted-first with it. Training from the
provenance store (``train_from_provenance``) waits for the slice that ports
the store.

``LotaruPredictor`` is online task-runtime prediction without historical
traces (Bader et al., FGCS 2024): per-task-type Bayesian linear regression
of runtime on input size, trained from quick downscaled "local" profiling
runs and online feedback, combined with per-node speed factors obtained
from microbenchmarks.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Bayesian linear regression  y = w0 + w1 * x  with conjugate updates.
# --------------------------------------------------------------------------
class BayesianLinReg:
    """Online Bayesian linear regression (normal likelihood, Gaussian prior).

    Uses the standard conjugate update of the weight posterior
    ``N(mean, cov)`` with fixed noise precision ``beta``; ``predict`` returns
    (mean, std) of the predictive distribution. Features are ``[1, x]`` with x
    log-scaled, matching Lotaru's observation that runtime grows roughly
    linearly in input size across decades of sizes.
    """

    def __init__(self, n_features: int = 2, alpha: float = 1e-3, beta: float = 4.0):
        self.n = n_features
        self.alpha = alpha
        self.beta = beta
        self.cov_inv = alpha * np.eye(n_features)
        self.cov_inv_mean = np.zeros(n_features)
        self.count = 0

    def update(self, x: np.ndarray, y: float) -> None:
        self.cov_inv = self.cov_inv + self.beta * np.outer(x, x)
        self.cov_inv_mean = self.cov_inv_mean + self.beta * x * y
        self.count += 1

    def _posterior(self) -> Tuple[np.ndarray, np.ndarray]:
        cov = np.linalg.inv(self.cov_inv)
        mean = cov @ self.cov_inv_mean
        return mean, cov

    def predict(self, x: np.ndarray) -> Tuple[float, float]:
        mean, cov = self._posterior()
        mu = float(mean @ x)
        var = 1.0 / self.beta + float(x @ cov @ x)
        return mu, math.sqrt(max(var, 1e-12))


def _features(input_size: int) -> np.ndarray:
    # log1p keeps decades of input sizes numerically tame.
    return np.array([1.0, math.log1p(float(input_size))])


@dataclass
class NodeProfile:
    """Per-node microbenchmark results (Lotaru uses CPU/mem/IO scores)."""

    node: str
    speed_factor: float = 1.0      # >1 = faster than reference
    bench_scores: Dict[str, float] = field(default_factory=dict)


class LotaruPredictor:
    """Online runtime prediction without historical traces.

    Workflow (matching the Lotaru paper):
      1. ``register_node_bench`` stores microbenchmark-derived speed factors.
      2. ``observe_local_profiling`` feeds the quick downscaled workflow run
         executed on one "local" node — these seed the per-task-type model.
      3. ``observe`` adds online feedback from real task executions
         (runtimes are first normalised to the reference speed).
      4. ``predict(name, input_size, node)`` returns predicted seconds on
         that node (+ uncertainty), de-normalising by its speed factor.
    """

    def __init__(self) -> None:
        self.models: Dict[str, BayesianLinReg] = defaultdict(BayesianLinReg)
        self.nodes: Dict[str, NodeProfile] = {}
        self._fallback_mean: Dict[str, float] = {}
        # bumped whenever predictions may change — memo key for callers
        # caching predictor-derived quantities
        self.version: int = 0

    # -- infrastructure knowledge (CWSI stores machine characteristics) --
    def register_node_bench(self, profile: NodeProfile) -> None:
        self.nodes[profile.node] = profile
        self.version += 1

    def speed(self, node: Optional[str]) -> float:
        if node is None or node not in self.nodes:
            return 1.0
        return max(self.nodes[node].speed_factor, 1e-6)

    # -- training --
    def observe_local_profiling(self, name: str, input_size: int, runtime_s: float,
                                node: Optional[str] = None) -> None:
        self.observe(name, input_size, runtime_s, node)

    def observe(self, name: str, input_size: int, runtime_s: float,
                node: Optional[str] = None) -> None:
        norm = runtime_s * self.speed(node)          # → reference-node seconds
        if norm <= 0:
            return
        # Regress log-runtime: multiplicative noise, strictly positive preds.
        self.models[name].update(_features(input_size), math.log(norm))
        m = self._fallback_mean.get(name)
        self._fallback_mean[name] = norm if m is None else 0.7 * m + 0.3 * norm
        self.version += 1

    # -- inference --
    def predict(self, name: str, input_size: int,
                node: Optional[str] = None) -> Tuple[float, float]:
        """Returns (runtime_seconds_on_node, std_seconds)."""
        model = self.models.get(name)
        if model is None or model.count == 0:
            mu = self._fallback_mean.get(name, 60.0)
            return mu / self.speed(node), mu  # huge std: unknown task type
        log_mu, log_std = model.predict(_features(input_size))
        mu = math.exp(min(log_mu, 50.0))
        std = mu * (math.exp(min(log_std, 10.0)) - 1.0)
        return mu / self.speed(node), std / self.speed(node)

    def known(self, name: str) -> bool:
        m = self.models.get(name)
        return m is not None and m.count > 0
