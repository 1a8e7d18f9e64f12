# Resource-manager substrate of the port: node profiles and the real
# thread-pool executor driven by the CWS engine. The discrete-event
# simulator, its fault plans and the nf-core traces are not in the port.
from .executor import LocalExecutor  # noqa: F401
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
