"""Node registry + pipeline lifecycle (port of
``parallax_tpu/scheduling/node_management.py``).

Capability parity: reference ``src/scheduling/node_management.py:25-520``
(NodeManager with ACTIVE/STANDBY states; Pipeline dataclass validating
contiguous no-gap/no-overlap stage chains; fixed-pipeline registry for RR
routing; capacity reporting) and the HA restore path
(``adopt_pipelines``).
"""

from __future__ import annotations

import dataclasses
import enum

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.scheduling.node import Node


class NodeState(enum.Enum):
    STANDBY = "standby"   # joined, no layer allocation
    ACTIVE = "active"     # serving a layer range


@dataclasses.dataclass
class Pipeline:
    """An ordered chain of nodes covering layers [0, num_layers) exactly."""

    nodes: list[Node]
    pipeline_id: int = 0

    def validate(self, num_layers: int) -> None:
        if not self.nodes:
            raise ValueError("empty pipeline")
        if self.nodes[0].start_layer != 0:
            raise ValueError("pipeline must start at layer 0")
        for prev, nxt in zip(self.nodes, self.nodes[1:]):
            if prev.end_layer != nxt.start_layer:
                raise ValueError(
                    f"gap/overlap between {prev.node_id}[{prev.start_layer},"
                    f"{prev.end_layer}) and {nxt.node_id}[{nxt.start_layer},"
                    f"{nxt.end_layer})"
                )
        if self.nodes[-1].end_layer != num_layers:
            raise ValueError(
                f"pipeline ends at {self.nodes[-1].end_layer}, "
                f"model has {num_layers} layers"
            )

    @property
    def node_ids(self) -> list[str]:
        return [n.node_id for n in self.nodes]

    @property
    def role(self) -> str:
        """Phase pool this pipeline belongs to: the members' shared role,
        or "mixed" when they disagree."""
        roles = {n.role for n in self.nodes}
        return roles.pop() if len(roles) == 1 else "mixed"

    def latency_ms(self, batch_size: int = 8) -> float:
        total = sum(n.stage_latency_ms(batch_size) for n in self.nodes)
        for a, b in zip(self.nodes, self.nodes[1:]):
            total += a.rtt_to(b.node_id) * 1e3
        return total

    def min_refit_version(self) -> int:
        return min(n.refit_version for n in self.nodes)

    def is_ready(self) -> bool:
        return all(n.is_ready for n in self.nodes)


class NodeManager:
    """Thread-safe membership + pipeline registry."""

    def __init__(self, num_layers: int):
        self.num_layers = num_layers
        self._lock = make_lock("scheduling.node_management", reentrant=True)
        self._nodes: dict[str, Node] = {}
        self._state: dict[str, NodeState] = {}
        self._pipelines: list[Pipeline] = []
        self._next_pipeline_id = 0

    # -- membership -------------------------------------------------------

    def add(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.node_id] = node
            self._state[node.node_id] = (
                NodeState.ACTIVE if node.has_allocation else NodeState.STANDBY
            )

    def remove(self, node_id: str) -> list[Node]:
        """Drop a node; detach any pipeline containing it, putting the other
        members back to STANDBY (reference node_management.py:161-181).
        Returns the displaced members."""
        with self._lock:
            node = self._nodes.pop(node_id, None)
            self._state.pop(node_id, None)
            displaced: list[Node] = []
            if node is None:
                return displaced
            kept: list[Pipeline] = []
            for p in self._pipelines:
                if node_id in p.node_ids:
                    for member in p.nodes:
                        if member.node_id != node_id:
                            member.clear_layers()
                            if member.node_id in self._state:
                                self._state[member.node_id] = NodeState.STANDBY
                            displaced.append(member)
                else:
                    kept.append(p)
            self._pipelines = kept
            return displaced

    def get(self, node_id: str) -> Node | None:
        with self._lock:
            return self._nodes.get(node_id)

    def nodes(self, state: NodeState | None = None) -> list[Node]:
        with self._lock:
            if state is None:
                return list(self._nodes.values())
            return [
                n for nid, n in self._nodes.items()
                if self._state[nid] == state
            ]

    def state_of(self, node_id: str) -> NodeState | None:
        with self._lock:
            return self._state.get(node_id)

    def set_active(self, node_id: str) -> None:
        with self._lock:
            if node_id in self._state:
                self._state[node_id] = NodeState.ACTIVE

    def standby_all(self) -> None:
        with self._lock:
            for nid, n in self._nodes.items():
                n.clear_layers()
                self._state[nid] = NodeState.STANDBY
            self._pipelines = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    # -- pipelines --------------------------------------------------------

    def register_pipelines(self, pipelines: list[Pipeline]) -> None:
        with self._lock:
            for p in pipelines:
                p.validate(self.num_layers)
                p.pipeline_id = self._next_pipeline_id
                self._next_pipeline_id += 1
                for n in p.nodes:
                    self._state[n.node_id] = NodeState.ACTIVE
            self._pipelines.extend(pipelines)

    def adopt_pipelines(self, pipelines: list[Pipeline],
                        next_pipeline_id: int) -> None:
        """HA restore path (``ha/``): REPLACE the pipeline table with one
        replicated from a primary, keeping the primary's pipeline ids
        (register_pipelines would renumber them, and worker-visible ids
        must survive a promotion). Members go ACTIVE; every other known
        node drops to STANDBY."""
        with self._lock:
            members = {n.node_id for p in pipelines for n in p.nodes}
            for nid in self._state:
                self._state[nid] = (
                    NodeState.ACTIVE if nid in members else NodeState.STANDBY
                )
            self._pipelines = list(pipelines)
            self._next_pipeline_id = max(
                next_pipeline_id,
                max((p.pipeline_id + 1 for p in pipelines), default=0),
            )

    @property
    def next_pipeline_id(self) -> int:
        with self._lock:
            return self._next_pipeline_id

    @property
    def pipelines(self) -> list[Pipeline]:
        with self._lock:
            return list(self._pipelines)

    def capacity_report(self) -> dict:
        with self._lock:
            return {
                "num_nodes": len(self._nodes),
                "num_active": sum(
                    1 for s in self._state.values() if s == NodeState.ACTIVE
                ),
                "num_pipelines": len(self._pipelines),
                "total_layer_capacity": sum(
                    n.layer_capacity() for n in self._nodes.values()
                ),
                "max_concurrent_requests": sum(
                    min(n.max_concurrent_requests() for n in p.nodes)
                    for p in self._pipelines
                ) if self._pipelines else 0,
            }
