# Resource-manager substrate: node/slice profiles, the discrete-event
# cluster simulator (paper-methodology evaluation), nf-core-shaped traces,
# and a real thread-pool executor driven by the same CWS engine.
from .executor import LocalExecutor  # noqa: F401
from .faults import (  # noqa: F401
    DomainOutage,
    FaultInjector,
    FaultPlan,
    FaultyTransport,
    LaunchVerdict,
    NodeFlap,
)
from .nodes import (  # noqa: F401
    GiB,
    TPU_V5E,
    cpu_node,
    domain_cluster,
    heterogeneous_cluster,
    tpu_fleet,
    tpu_slice,
    uniform_cluster,
)
from .simulator import (  # noqa: F401
    ClusterSimulator,
    SimConfig,
    run_workflow,
    run_workflows,
)
from .traces import (  # noqa: F401
    Arrival,
    NF_CORE_TEMPLATES,
    NF_CORE_WORKFLOWS,
    TraceReplayer,
    build_workflow,
    burst_arrivals,
    poisson_arrivals,
    recorded_arrivals,
    template_task_count,
    trace_task_count,
    workflow_summary,
)
