"""Node/slice profiles for the cluster substrate.

Two kinds of resources appear in the framework:
  * CPU cluster nodes — the paper's own evaluation environment (commodity
    Kubernetes nodes running containerised workflow tasks);
  * TPU slices — the TPU adaptation: a "node" registered with the CWS is a
    gang-schedulable slice (sub-pod or pod) with chips + HBM, living inside
    an ICI domain; cross-slice traffic rides DCN.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core.scheduler import NodeInfo

GiB = 1 << 30

# TPU v5e hardware constants (single source of truth; §Roofline uses these).
TPU_V5E = {
    "peak_bf16_flops": 197e12,     # FLOP/s per chip
    "hbm_bandwidth": 819e9,        # bytes/s per chip
    "hbm_bytes": 16 * GiB,         # per chip
    "ici_bandwidth": 50e9,         # bytes/s per link (~50 GB/s/link)
    "dcn_bandwidth": 25e9,         # bytes/s per host across pods
}


def cpu_node(name: str, cpus: float = 8.0, mem_gib: int = 32,
             speed_factor: float = 1.0,
             labels: Optional[Dict[str, str]] = None) -> NodeInfo:
    return NodeInfo(name=name, cpus=cpus, mem_bytes=mem_gib * GiB,
                    chips=0, speed_factor=speed_factor, labels=labels or {})


def tpu_slice(name: str, chips: int = 256, speed_factor: float = 1.0,
              generation: str = "v5e",
              labels: Optional[Dict[str, str]] = None) -> NodeInfo:
    lab = {"accelerator": f"tpu-{generation}", **(labels or {})}
    return NodeInfo(
        name=name,
        cpus=chips / 4,                      # host cores per chip group
        mem_bytes=chips * TPU_V5E["hbm_bytes"],
        chips=chips,
        hbm_bytes_per_chip=int(TPU_V5E["hbm_bytes"]),
        speed_factor=speed_factor,
        labels=lab,
    )


def uniform_cluster(n_nodes: int, cpus: float = 4.0, mem_gib: int = 32,
                    prefix: str = "s") -> List[NodeInfo]:
    """A homogeneous N-node cluster (zero-padded names so the round-robin
    ring's name sort equals the registration order). Used by the
    node-scale placement sweep and the index oracle tests, where N runs
    to thousands."""
    width = max(len(str(max(n_nodes - 1, 0))), 2)
    return [cpu_node(f"{prefix}{i:0{width}d}", cpus, mem_gib)
            for i in range(n_nodes)]


def domain_cluster(n_domains: int, nodes_per_domain: int,
                   cpus: float = 4.0, mem_gib: int = 32,
                   key: str = "rack", prefix: str = "d") -> List[NodeInfo]:
    """A homogeneous cluster partitioned into failure domains.

    Node ``{prefix}{d}n{i}`` carries label ``{key: "{prefix}{d}"}``, so a
    ``faults.DomainOutage`` on domain ``"{prefix}{d}"`` takes out all of
    its ``nodes_per_domain`` members at one instant (the correlated-
    failure case a per-node fault schedule cannot express)."""
    return [
        cpu_node(f"{prefix}{d}n{i:02d}", cpus, mem_gib,
                 labels={key: f"{prefix}{d}"})
        for d in range(n_domains) for i in range(nodes_per_domain)
    ]


def heterogeneous_cluster(n_nodes: int = 6, cpus: float = 8.0,
                          mem_gib: int = 32,
                          speed_spread: float = 0.3) -> List[NodeInfo]:
    """A commodity cluster in the style of the paper's evaluation setup:
    ``n_nodes`` nodes whose speeds span ``1 ± speed_spread`` (deterministic
    spacing so experiments are reproducible)."""
    nodes = []
    for i in range(n_nodes):
        frac = i / max(n_nodes - 1, 1)
        speed = (1.0 - speed_spread) + 2 * speed_spread * frac
        nodes.append(cpu_node(f"node-{i:02d}", cpus, mem_gib, round(speed, 3)))
    return nodes


def tpu_fleet(n_pods: int = 2, chips_per_pod: int = 256,
              generations: Optional[List[str]] = None) -> List[NodeInfo]:
    """A fleet of pod-level slices; heterogeneous generations get speed
    factors proportional to their peak FLOP/s (v5p ≈ 2.3x v5e bf16)."""
    gen_speed = {"v5e": 1.0, "v5p": 2.33, "v4": 1.40}
    gens = generations or ["v5e"] * n_pods
    return [
        tpu_slice(f"pod-{i:02d}", chips_per_pod, gen_speed.get(g, 1.0), g)
        for i, g in enumerate(gens)
    ]
