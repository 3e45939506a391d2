"""Global scheduling: layer allocation across a swarm + request routing
(port of ``parallax_tpu/scheduling``).

Capability parity: reference ``src/scheduling`` (SURVEY.md section 2.1) —
a lightweight central scheduler assigns contiguous layer ranges of one
model to heterogeneous nodes (phase 1, ``layer_allocation``), registers
end-to-end pipelines, and routes each request along a node path (phase 2,
``request_routing``), reacting to joins/leaves/heartbeats with rebalancing
(``scheduler``). Pure host-side Python — nothing here touches a device.
"""

from parallax_tpu_torch.scheduling.node import (
    CacheIndex,
    Node,
    RooflinePerformanceModel,
)
from parallax_tpu_torch.scheduling.node_management import (
    NodeManager,
    NodeState,
    Pipeline,
)
from parallax_tpu_torch.scheduling.request_routing import (
    CacheAwareRouting,
    RequestMeta,
    make_router,
)
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

__all__ = [
    "CacheAwareRouting",
    "CacheIndex",
    "Node",
    "RequestMeta",
    "RooflinePerformanceModel",
    "NodeManager",
    "NodeState",
    "Pipeline",
    "GlobalScheduler",
    "make_router",
]
