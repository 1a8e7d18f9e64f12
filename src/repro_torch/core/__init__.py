# The paper's primary contribution: the Common Workflow Scheduler (CWS)
# and its interface (CWSI) — workflow-aware scheduling inside the resource
# manager, with prediction plugins and central provenance. The port's own
# copy; the journal and the CWSI's HTTP transport and client are not in it.
from .dag import (  # noqa: F401
    DataRef,
    Resources,
    Task,
    TaskSpec,
    TaskState,
    WorkflowDAG,
    fresh_task_id,
)
from .arbiter import (  # noqa: F401
    ARBITERS,
    Arbiter,
    ArbiterContext,
    FirstAppearanceArbiter,
    PreemptionCandidate,
    StrictPriorityArbiter,
    WeightedFairShareArbiter,
    WorkflowQuota,
    deficits,
    dominant_cost,
    make_arbiter,
)
from . import commands  # noqa: F401
from .cwsi import CWSI_VERSION, CWSIClient, CWSIError, CWSIServer  # noqa: F401
from .node_index import NodeCapacityIndex, NodeCaps  # noqa: F401
from .predict import (  # noqa: F401
    FeedbackMemoryPredictor,
    LotaruPredictor,
    NodeProfile,
    RooflinePrior,
    RooflineTerms,
)
from .provenance import NodeEvent, ProvenanceStore, TaskTrace  # noqa: F401
from .scheduler import (  # noqa: F401
    ClusterAdapter,
    CommonWorkflowScheduler,
    NodeInfo,
    QuotaExceededError,
    RetiredWorkflow,
    TaskResult,
)
from .strategies import (  # noqa: F401
    STRATEGIES,
    NodeView,
    PlacementKey,
    SchedulingContext,
    Strategy,
    make_strategy,
)
