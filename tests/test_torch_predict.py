"""The port's copy of the Lotaru predictor gives repro's predictions."""
import numpy as np
import pytest

from repro.core.predict import LotaruPredictor as JaxLotaru
from repro.core.predict import NodeProfile as JaxNodeProfile
from repro_torch.core.predict import LotaruPredictor, NodeProfile


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lotaru_predictions_equal_repro(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = LotaruPredictor(), JaxLotaru()
    for p in (ours, theirs):
        cls = NodeProfile if p is ours else JaxNodeProfile
        p.register_node_bench(cls("fast", speed_factor=2.0))
        p.register_node_bench(cls("slow", speed_factor=0.5))
    for _ in range(40):
        name = f"task{int(rng.integers(0, 4))}"
        size = int(rng.integers(1, 1 << 30))
        runtime = float(rng.lognormal(2.0, 0.5))
        node = [None, "fast", "slow"][int(rng.integers(0, 3))]
        ours.observe(name, size, runtime, node)
        theirs.observe_local_profiling(name, size, runtime, node)
    assert ours.version == theirs.version
    for name in ("task0", "task1", "task2", "task3", "unseen"):
        assert ours.known(name) == theirs.known(name)
        for size in (1, 1000, 1 << 20, 1 << 34):
            for node in (None, "fast", "slow", "unknown"):
                assert ours.predict(name, size, node) == theirs.predict(name, size, node)


def test_serving_order_is_shortest_predicted_first():
    from repro_torch.launch.serve_workload import shortest_predicted_first
    from repro_torch.runtime.serve import Request
    reqs = [Request(f"r{i}", [2, 3], max_new_tokens=n)
            for i, n in enumerate([32, 8, 16, 8, 32])]
    order = shortest_predicted_first(reqs, (8, 16, 32))
    assert [r.max_new_tokens for r in order] == [8, 8, 16, 32, 32]
    assert [r.req_id for r in order] == ["r1", "r3", "r2", "r0", "r4"]
