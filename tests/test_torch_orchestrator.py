"""The port's orchestrator (``repro_torch.runtime.orchestrator``, a copy of
``repro``'s): the port's versions of ``tests/test_orchestrator.py``.

``chips`` is a PER-NODE request and ``nodes`` the gang width, so a 4-node ×
4-chip job reaches the engine as ``Resources(chips=4, nodes=4)``. Elastic
widths are vetted at build time against ``ElasticPlan.new_mesh_shape``, which
the orchestrator's lazy import takes from the port's ``runtime/fault.py``.
"""
import pytest

from repro_torch.runtime.orchestrator import (
    SharedState,
    TrainJobSpec,
    build_training_workflow,
)


def _chunk(shared, start, stop):
    return {"start": float(start), "stop": float(stop)}


def _build(**kwargs):
    spec = TrainJobSpec(job_id=kwargs.pop("job_id", "job"),
                        n_steps=kwargs.pop("n_steps", 30), **kwargs)
    return spec, build_training_workflow(spec, _chunk, SharedState(None))


def test_chunk_chain_structure():
    spec, dag = _build(n_steps=25, chunk=10)
    chunks = sorted(t for t in dag.tasks if ".chunk." in t)
    assert len(chunks) == 3                      # ceil(25 / 10)
    for a, b in zip(chunks, chunks[1:]):
        assert a in dag.parents[b]


def test_gang_resources_map_nodes_and_per_node_chips():
    spec, dag = _build(chips=4, nodes=4)
    res = dag.tasks[f"{spec.job_id}.chunk.0000"].spec.resources
    assert res.nodes == 4
    assert res.chips == 4                        # per NODE, not per gang
    assert res.gang is True


def test_single_node_job_stays_gang_free():
    spec, dag = _build(chips=0, nodes=1)
    res = dag.tasks[f"{spec.job_id}.chunk.0000"].spec.resources
    assert res.nodes == 1 and res.gang is False
    assert "ckpt" not in dag.tasks[f"{spec.job_id}.chunk.0000"].spec.params
    with pytest.raises(ValueError):
        _build(nodes=0)


def test_ckpt_cadence_reaches_engine_params():
    spec, dag = _build(chips=2, nodes=2, ckpt_interval_s=45.0)
    for tid, t in dag.tasks.items():
        if ".chunk." in tid:
            assert t.spec.params["ckpt"] == {"interval_s": 45.0}


def test_eval_and_ckpt_tasks_stay_single_node():
    spec, dag = _build(n_steps=20, chunk=10, chips=4, nodes=4,
                       eval_every=10, ckpt_every=10)
    spec2 = TrainJobSpec(job_id="j2", n_steps=20, chunk=10, chips=4,
                         nodes=4, eval_every=10, ckpt_every=10)
    dag = build_training_workflow(spec2, _chunk, SharedState(None),
                                  run_eval=lambda s, step: {},
                                  run_ckpt=lambda s, step: None)
    kinds = {t.name for t in dag.tasks.values()}
    assert {"train_chunk", "eval", "checkpoint"} <= kinds
    for t in dag.tasks.values():
        if t.name in ("eval", "checkpoint"):
            assert t.spec.resources.nodes == 1
            assert t.spec.resources.gang is False


def test_elastic_widths_validated_against_mesh():
    # 4 nodes × 2 chips, model axis 2: width 2 → 4 devices (ok),
    # width 3 → 6 devices (ok), width 1 → 2 devices (ok)
    spec, dag = _build(chips=2, nodes=4, model_parallel=2,
                       elastic=(1, 3, 2))
    params = dag.tasks[f"{spec.job_id}.chunk.0000"].spec.params
    assert params["elastic"] == {"allowed": [3, 2, 1]}   # widest first

    # model axis 4 with 2 chips/node: odd widths give indivisible meshes
    with pytest.raises(ValueError, match="model_parallel"):
        _build(chips=2, nodes=4, model_parallel=4, elastic=(1,))
    # widths outside [1, nodes-1] are configuration bugs
    with pytest.raises(ValueError, match="invalid"):
        _build(chips=2, nodes=4, elastic=(4,))
    with pytest.raises(ValueError, match="invalid"):
        _build(chips=2, nodes=4, elastic=(0,))
    with pytest.raises(ValueError, match="invalid"):
        _build(chips=2, nodes=4, elastic=(True,))
    # elastic without a gang is meaningless
    with pytest.raises(ValueError, match="multi-node"):
        _build(chips=2, nodes=1, elastic=(1,))


def test_wire_roundtrip_preserves_gang_shape():
    from repro_torch.core.dag import TaskSpec

    spec, dag = _build(chips=4, nodes=4, ckpt_interval_s=30.0,
                       elastic=(2,))
    t = dag.tasks[f"{spec.job_id}.chunk.0000"].spec
    back = TaskSpec.from_json(t.to_json())
    assert back.resources.nodes == 4
    assert back.resources.chips == 4
    assert back.params["ckpt"] == {"interval_s": 30.0}
    assert back.params["elastic"] == {"allowed": [2]}
