# The paper's primary contribution: the Common Workflow Scheduler (CWS)
# and its interface (CWSI) — workflow-aware scheduling inside the resource
# manager, with prediction plugins and central provenance.
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
from .cwsi_client import (  # noqa: F401
    RETRYABLE_STATUSES,
    ReliableCWSIClient,
    TransportError,
)
from .cwsi_http import CWSIHTTPServer, http_transport  # noqa: F401
from .journal import Journal, engine_config, read_commands, recover  # noqa: F401
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
