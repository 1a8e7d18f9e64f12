# Scheduler-side plugins the serving path needs (the port's own copies).
from .predict import BayesianLinReg, LotaruPredictor, NodeProfile  # noqa: F401
