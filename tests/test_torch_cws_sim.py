"""The port's copy of the CWS's evaluation path runs as ``repro``'s does.

The discrete-event simulator over nf-core traces, driven through
``repro_torch.cluster`` and ``repro_torch.core``, makes the scheduling
decisions pinned in ``tests/golden/`` (read only here) for every strategy
and every arbiter, as ``tests/test_golden_traces.py`` holds ``repro``'s;
the port's journal recovers an engine that decides the same; and a CWSI
call crosses a real socket (``CWSIHTTPServer``) from a ``ReliableCWSIClient``
retrying through a lossy ``FaultyTransport``.
"""
import json
from pathlib import Path

import pytest

from repro_torch.cluster import (
    ClusterSimulator,
    FaultyTransport,
    SimConfig,
    build_workflow,
    heterogeneous_cluster,
)
from repro_torch.core import (
    CWSIHTTPServer,
    CWSIServer,
    CommonWorkflowScheduler,
    Journal,
    LotaruPredictor,
    ReliableCWSIClient,
    Resources,
    TaskSpec,
    http_transport,
    recover,
)
from repro_torch.core.strategies import STRATEGIES

GOLDEN_DIR = Path(__file__).parent / "golden"
GiB = 1 << 30


def _trace(cws, wids=None):
    out = [[tr.task_id, tr.node, round(tr.start_time, 6)]
           for tr in cws.provenance.task_traces
           if tr.state == "SUCCEEDED" and (wids is None or tr.workflow_id in wids)]
    out.sort(key=lambda e: (e[2], e[0]))
    return out


def _run_scenario(strategy, arbiter, shares, workflows, seed, n_nodes=4, journal=None):
    """``tests/test_golden_traces.py``'s scenario, on the port's modules."""
    sim = ClusterSimulator(heterogeneous_cluster(n_nodes), SimConfig(seed=seed))
    cws = CommonWorkflowScheduler(adapter=sim, strategy=strategy,
                                  predictor=LotaruPredictor(), arbiter=arbiter)
    if journal:
        Journal(journal).attach(cws)
    for wid, share in shares.items():
        cws.set_workflow_share(wid, share)
    sim.attach(cws)
    dags = [build_workflow(wf, seed=wf_seed, workflow_id=wid, n_samples=n)
            for wf, wf_seed, wid, n in workflows]
    for dag in dags:
        sim.submit_workflow_at(0.0, dag)
    sim.run()
    assert all(d.succeeded() for d in dags)
    return cws, _trace(cws, {d.workflow_id for d in dags})


def _golden(name):
    return json.loads((GOLDEN_DIR / f"{name}.json").read_text())["trace"]


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_strategy_traces_are_repros_golden(strategy):
    _, trace = _run_scenario(strategy, "first_appearance", {},
                             [("chipseq", 3, "wf-golden", 2)], seed=42)
    assert trace and trace == _golden(f"strategy_{strategy}")


TENANTS = dict(shares={"tenant-a": 1.0, "tenant-b": 3.0},
               workflows=[("chipseq", 5, "tenant-a", 3), ("viralrecon", 6, "tenant-b", 3)],
               seed=42, n_nodes=2)


@pytest.mark.parametrize("arbiter", ["first_appearance", "fair_share", "strict_priority"])
def test_arbiter_traces_are_repros_golden(arbiter):
    _, trace = _run_scenario("rank_min_rr", arbiter, **TENANTS)
    assert trace and trace == _golden(f"arbiter_{arbiter}")


def test_journal_recovers_an_engine_that_decided_the_same(tmp_path):
    """The fair-share scenario journaled: ``recover`` replays the log into an
    engine with the same trace and operation counts, itself unjournaled."""
    jp = str(tmp_path / "wal.jsonl")
    live, trace = _run_scenario("rank_min_rr", "fair_share", **TENANTS, journal=jp)
    assert trace == _golden("arbiter_fair_share")
    rec = recover(jp, journal=False)
    assert _trace(rec) == _trace(live) and rec.op_counts() == live.op_counts()
    assert type(rec).__module__ == "repro_torch.core.scheduler"
    assert live.stats()["journaled"] and not rec.stats()["journaled"]


class _NullAdapter:
    def launch(self, task, node, mem_alloc):
        pass

    def kill(self, task_id):
        pass


def test_reliable_client_over_http_through_a_faulty_transport():
    """Registrations and submits over ``http_transport`` to a localhost
    ``CWSIHTTPServer``, through a ``FaultyTransport`` that drops requests and
    responses and duplicates some: the client retries, the server dedups,
    and every task is there exactly once."""
    cws = CommonWorkflowScheduler(adapter=_NullAdapter())
    with CWSIHTTPServer(CWSIServer(cws)) as httpd:
        faulty = FaultyTransport(http_transport(httpd.url), drop_request_prob=0.2,
                                 drop_response_prob=0.2, duplicate_prob=0.2, seed=5)
        client = ReliableCWSIClient(transport=faulty, sleep=None, max_attempts=10)
        client.register_workflow("w0")
        for i in range(12):
            client.submit_task("w0", TaskSpec(
                task_id=f"w0.t{i}", name="proc",
                resources=Resources(cpus=1.0, mem_bytes=GiB),
                params={"sim": {"runtime": 3.0}}))
        faulty.flush()
        state = client.workflow_state("w0")
    assert client.gave_up == 0 and client.retries > 0
    assert faulty.dropped_requests + faulty.dropped_responses > 0
    assert len(cws.dags["w0"]) == 12 and len(state["tasks"]) == 12
