"""Task runtime & resource prediction plugins (paper §5).

Implements the prediction approaches the paper plans to integrate:

* ``LotaruPredictor`` — online task-*runtime* prediction without historical
  traces (Bader et al., FGCS 2024): per-task-type Bayesian linear regression
  of runtime on input size, trained from (a) quick downscaled "local" profiling
  runs and (b) online feedback, combined with per-node speed factors obtained
  from microbenchmarks.
* ``FeedbackMemoryPredictor`` — task peak-*memory* prediction in the style of
  Witt et al. (HPCS'19) / Tovar et al.: linear model of peak memory vs input
  size with a safety margin; on under-provisioning (OOM) the scheduler retries
  with a doubled allocation. Predicts low wastage without failures.
* ``RooflinePrior`` — TPU adaptation (DESIGN.md §2): for gang-scheduled JAX
  step tasks the dry-run's roofline terms (compute/memory/collective seconds)
  give an *analytic* prior runtime, which seeds the Bayesian regression where
  Lotaru would use microbenchmarks. This connects the scheduler to the
  compiled-artifact analysis in ``launch/dryrun.py``.

All predictors read ONLY from the provenance store / explicit observations —
never from scheduler internals — mirroring how CWSI plugins are wired.
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .provenance import ProvenanceStore


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
    """Per-node microbenchmark results (Lotaru uses CPU/mem/IO scores;
    the TPU adaptation uses chip generation peak specs)."""

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
        # bumped whenever predictions may change — memo key for strategies
        # caching predictor-derived quantities (HEFT weighted ranks)
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

    def train_from_provenance(self, store: ProvenanceStore) -> int:
        n = 0
        for t in store.task_traces:
            if t.state == "SUCCEEDED" and t.runtime_s > 0:
                self.observe(t.name, t.input_size, t.runtime_s, t.node)
                n += 1
        return n

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


# --------------------------------------------------------------------------
# Peak-memory prediction with under-provisioning retries (paper §5).
# --------------------------------------------------------------------------
def _mem_model() -> BayesianLinReg:
    return BayesianLinReg(beta=50.0)


class FeedbackMemoryPredictor:
    """Linear peak-mem-vs-input-size model with safety margin.

    ``allocate`` returns the bytes to request for an attempt:
      attempt 0 → model prediction + k·std (or the user request if no data);
      attempt n → doubled allocation after each OOM (the paper's retry rule).
    ``observe`` feeds measured peak memory back (online learning).
    """

    def __init__(self, sigma_margin: float = 2.0, floor_bytes: int = 64 << 20):
        # tighter noise prior than the runtime model: peak memory is far
        # less dispersed than runtime (beta = 1/sigma^2, sigma ≈ 0.14 log).
        # Module-level factory, not a lambda: journal snapshots pickle the
        # engine, predictors included.
        self.models: Dict[str, BayesianLinReg] = defaultdict(_mem_model)
        self.sigma_margin = sigma_margin
        self.floor = floor_bytes
        # empirical log-residuals per task type: high-variance tools (e.g.
        # assemblers) need wider margins than the model's noise prior
        self._resid: Dict[str, List[float]] = defaultdict(list)

    def observe(self, name: str, input_size: int, peak_mem_bytes: int) -> None:
        if peak_mem_bytes <= 0:
            return
        x = _features(input_size)
        y = math.log(float(peak_mem_bytes))
        m = self.models[name]
        if m.count >= 2:
            pred, _ = m.predict(x)
            self._resid[name].append(y - pred)
        m.update(x, y)

    def train_from_provenance(self, store: ProvenanceStore) -> int:
        n = 0
        for t in store.task_traces:
            if t.state == "SUCCEEDED" and t.peak_mem_bytes > 0:
                self.observe(t.name, t.input_size, t.peak_mem_bytes)
                n += 1
        return n

    def predict(self, name: str, input_size: int) -> Optional[int]:
        model = self.models.get(name)
        if model is None or model.count < 2:
            return None
        log_mu, log_std = model.predict(_features(input_size))
        res = self._resid.get(name, ())
        if len(res) >= 3:
            emp = (sum(r * r for r in res) / len(res)) ** 0.5
            log_std = max(log_std, emp)
        return int(math.exp(min(log_mu + self.sigma_margin * log_std, 60.0)))

    def allocate(self, name: str, input_size: int, user_request: int,
                 attempt: int) -> int:
        base = self.predict(name, input_size)
        if base is None:
            base = user_request
        base = max(base, self.floor)
        return int(base * (2 ** attempt))


# --------------------------------------------------------------------------
# Roofline prior for gang-scheduled JAX step tasks (TPU adaptation).
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class RooflineTerms:
    """The three §Roofline terms for one compiled step (seconds)."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_s(self) -> float:
        # max(compute, memory) assumes perfect overlap of HBM traffic with
        # MXU work; collectives overlap partially (0.5 exposure default).
        return max(self.compute_s, self.memory_s) + 0.5 * self.collective_s

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.__getitem__)


class RooflinePrior:
    """Analytic runtime prior for step-programs, seeded from dry-run JSON.

    ``register(name, terms, steps_per_task)`` installs the prior;
    ``seed(lotaru)`` injects it into a LotaruPredictor as synthetic
    observations so the Bayesian model starts at the analytic estimate and
    refines online — exactly the cold-start role microbenchmarks play in
    Lotaru.
    """

    def __init__(self) -> None:
        self.terms: Dict[str, Tuple[RooflineTerms, int]] = {}

    def register(self, name: str, terms: RooflineTerms, steps_per_task: int = 1) -> None:
        self.terms[name] = (terms, steps_per_task)

    def predict(self, name: str) -> Optional[float]:
        entry = self.terms.get(name)
        if entry is None:
            return None
        t, steps = entry
        return t.step_s * steps

    def seed(self, lotaru: LotaruPredictor, pseudo_obs: int = 3,
             nominal_input: int = 1 << 30) -> None:
        for name, (t, steps) in self.terms.items():
            for _ in range(pseudo_obs):
                lotaru.observe(name, nominal_input, t.step_s * steps)
