"""Phase-2 scheduling: route each request along a node path (port of
``parallax_tpu/scheduling/request_routing.py``).

Capability parity: reference ``src/scheduling/request_routing.py:180-853``
— round-robin over fixed registered pipelines (with readiness and
refit-version skipping), shortest-latency dynamic-programming routing over
whatever layer ranges the active nodes currently announce, the randomized
router and the prefix-cache-aware router.

The decision and per-pipeline dispatch counters go to ``cluster_status``
and to the metrics registry (``parallax_routing_decisions_total``,
``parallax_routing_dispatch_total``). Dropped with its plane: the
conformance sanitizer's route charges (ROADMAP queue 1 item 14). The
cache-aware router's per-tenant fairness term (``gamma`` > 0) is the JAX
router's. Refused by name: the LoRA digest namespaces (item 11).
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

from parallax_tpu_torch.obs import names as mnames
from parallax_tpu_torch.runtime.radix_cache import block_hash_chain
from parallax_tpu_torch.scheduling.node import Node
from parallax_tpu_torch.scheduling.node_management import NodeManager, Pipeline
from parallax_tpu_torch.utils import unported


@dataclasses.dataclass
class RequestMeta:
    """Per-request routing context, built once at dispatch.

    Carries the tokenized prompt so cache-aware routing can hash its
    block chain exactly once (memoized per block size — workers may run
    different page sizes) and compare it against the digests each head
    node's radix tree published through heartbeats. ``lora_id``,
    ``tenant_id`` and ``qos_class`` ride the JAX RPC payloads; a LoRA
    chain waits for the adapter namespaces (item 11).
    """

    request_id: str
    prompt_ids: list[int] | None = None
    lora_id: str | None = None
    tenant_id: str | None = None
    qos_class: str | None = None
    # Filled by the router at dispatch; compared against the actual hit
    # the head engine reports on request_complete.
    predicted_cached_tokens: int = 0
    _chains: dict = dataclasses.field(default_factory=dict)

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_ids or ())

    def chain(self, block_size: int) -> list[int]:
        """Rolling block-hash chain of the prompt at ``block_size``."""
        if self.prompt_ids is None:
            return []
        if self.lora_id is not None:
            raise unported("LoRA digest namespaces (RequestMeta.lora_id)",
                           11)
        got = self._chains.get(block_size)
        if got is None:
            got = self._chains[block_size] = block_hash_chain(
                self.prompt_ids, block_size
            )
        return got


class RoutingStrategy:
    # Whether this router can use partial-range replica nodes that are
    # not members of a registered pipeline (the scheduler's dynamic-join
    # gate reads this instead of matching router names).
    supports_partial_replicas = False
    # Whether workers should publish prefix digests through heartbeats
    # (only CacheAwareRouting reads them).
    wants_digests = False

    def __init__(self, manager: NodeManager):
        self.manager = manager
        # Routing-decision counters ({chosen_by_cache, chosen_by_load,
        # fallback_imbalance, ...}) and per-pipeline dispatch counts —
        # surfaced in /cluster/status.
        self.decision_counters: dict[str, int] = {}
        self.pipeline_dispatches: dict[int, int] = {}

    def find_path(self, meta: RequestMeta | None = None) -> list[Node] | None:
        raise NotImplementedError

    def on_dispatch(self, path: list[Node]) -> None:
        for n in path:
            n.load += 1

    def on_complete(self, path_ids: list[str]) -> None:
        for nid in path_ids:
            n = self.manager.get(nid)
            if n is not None:
                n.load = max(0, n.load - 1)

    # -- decision telemetry ------------------------------------------------

    def _count_decision(self, reason: str) -> None:
        self.decision_counters[reason] = (
            self.decision_counters.get(reason, 0) + 1
        )
        try:
            from parallax_tpu_torch.obs.registry import get_registry

            get_registry().counter(
                mnames.ROUTING_DECISIONS_TOTAL,
                "Routing decisions per strategy reason",
                labelnames=("reason",),
            ).labels(reason=reason).inc()
        except Exception:  # pragma: no cover - metrics never break routing
            pass

    def _count_pipeline(self, pipeline_id: int) -> None:
        self.pipeline_dispatches[pipeline_id] = (
            self.pipeline_dispatches.get(pipeline_id, 0) + 1
        )
        try:
            from parallax_tpu_torch.obs.registry import get_registry

            get_registry().counter(
                mnames.ROUTING_DISPATCH_TOTAL,
                "Requests dispatched per registered pipeline",
                labelnames=("pipeline",),
            ).labels(pipeline=str(pipeline_id)).inc()
        except Exception:  # pragma: no cover - metrics never break routing
            pass


# Pipeline roles each request phase may dispatch to. The prompt phase
# avoids decode specialists so a prompt never lands in the middle of deep
# continuous batches; the decode phase (KV-handoff targets) avoids prefill
# specialists so a handed-off request never bounces back to a prompt pool.
_PHASE_ROLES = {
    "prompt": ("prefill", "mixed"),
    "decode": ("decode", "mixed"),
}


def eligible_pipelines(
    manager: NodeManager, phase: str | None = None
) -> list[Pipeline]:
    """Registered pipelines a request can be dispatched to right now:
    every stage ready, weights at the latest refit version, admission
    capacity available (the shared gate of RR and cache-aware routing).
    ``phase`` restricts the set to the matching phase pool. The prompt
    phase FALLS BACK to every eligible pipeline when its pool is empty
    (availability over specialization: the swarm keeps serving when the
    last prefill node dies); the decode phase does not (the prefill head
    then keeps the request local)."""
    pipelines = manager.pipelines
    if not pipelines:
        return []
    latest_refit = max(p.min_refit_version() for p in pipelines)
    ok = [
        p for p in pipelines
        if p.is_ready()
        and p.min_refit_version() >= latest_refit
        and not any(n.load >= n.max_concurrent_requests() for n in p.nodes)
    ]
    roles = _PHASE_ROLES.get(phase or "")
    if roles is None:
        return ok
    pool = [p for p in ok if p.role in roles]
    if not pool and phase == "prompt":
        return ok
    return pool


class RoundRobinRouting(RoutingStrategy):
    """RR cursor over registered node-disjoint pipelines (reference
    request_routing.py:589-680,797-852)."""

    def __init__(self, manager: NodeManager):
        super().__init__(manager)
        self._cursor = 0

    def find_path(self, meta: RequestMeta | None = None) -> list[Node] | None:
        pipelines = self.manager.pipelines
        if not pipelines:
            return None
        ok = {
            p.pipeline_id
            for p in eligible_pipelines(self.manager, phase="prompt")
        }
        for off in range(len(pipelines)):
            p = pipelines[(self._cursor + off) % len(pipelines)]
            if p.pipeline_id not in ok:
                continue
            self._cursor = (self._cursor + off + 1) % len(pipelines)
            self._count_pipeline(p.pipeline_id)
            return p.nodes
        return None


class CacheAwareRouting(RoutingStrategy):
    """Prefix-cache-aware pipeline choice (SGLang cache-aware router /
    Mooncake KV-centric scheduling): score every eligible pipeline by

        ``alpha * predicted_uncached_tokens + beta * head_load``

    where the prediction walks the request's block-hash chain against the
    head node's heartbeat-fed :class:`CacheIndex`. An imbalance guard
    falls back to least-loaded dispatch when the in-flight spread across
    eligible pipelines exceeds ``imbalance_threshold``. Requests without
    routing metadata (no prompt, digests not yet flowing) degrade to
    least-loaded.
    """

    wants_digests = True

    def __init__(self, manager: NodeManager, alpha: float = 1.0,
                 beta: float = 256.0, imbalance_threshold: int = 8,
                 gamma: float = 0.0, fairness_halflife_s: float = 30.0):
        super().__init__(manager)
        # alpha is per uncached prompt token, beta per in-flight request:
        # the defaults price one queued request like 256 uncached tokens
        # (roughly one prefill chunk).
        self.alpha = alpha
        self.beta = beta
        self.imbalance_threshold = imbalance_threshold
        # Per-tenant fairness: gamma prices one unit of a tenant's own
        # recent-dispatch share on a pipeline like gamma uncached tokens,
        # so a chatty tenant's requests spread across replicas. 0.0 (the
        # default) disables the term.
        self.gamma = gamma
        self.fairness_halflife_s = fairness_halflife_s
        # (pipeline_id, tenant) -> [decayed dispatch share, last stamp].
        self._tenant_share: dict[tuple[int, str], list] = {}
        self._cursor = 0   # tie-break rotation so equal scores spread

    def find_path(self, meta: RequestMeta | None = None) -> list[Node] | None:
        candidates = eligible_pipelines(self.manager, phase="prompt")
        if not candidates:
            return None
        self._cursor += 1
        loads = [p.nodes[0].load for p in candidates]
        if max(loads) - min(loads) > self.imbalance_threshold:
            chosen = candidates[loads.index(min(loads))]
            self._count_decision("fallback_imbalance")
            return self._dispatch(chosen, 0, meta)

        best, best_score, best_hit = None, None, 0
        for i, p in enumerate(candidates):
            head = p.nodes[0]
            hit = 0
            if meta is not None and meta.prompt_ids:
                index = head.cache_index
                if index.block > 0:
                    hit = index.predict_cached_tokens(
                        meta.chain(index.block), index.block,
                        meta.num_prompt_tokens,
                    )
            uncached = (meta.num_prompt_tokens if meta else 0) - hit
            cost = self.alpha * uncached + self.beta * head.load
            if self.gamma > 0.0 and meta is not None and meta.tenant_id:
                cost += self.gamma * self._tenant_recent(
                    p.pipeline_id, meta.tenant_id)
            score = (
                cost,
                # Rotating tie-break: equal scores (cold cluster, no
                # meta) must spread like round-robin.
                (i + self._cursor) % len(candidates),
            )
            if best_score is None or score < best_score:
                best, best_score, best_hit = p, score, hit
        self._count_decision(
            "chosen_by_cache" if best_hit > 0 else "chosen_by_load"
        )
        return self._dispatch(best, best_hit, meta)

    def _tenant_recent(self, pipeline_id: int, tenant: str,
                       charge: float = 0.0) -> float:
        """Exponentially decayed recent-dispatch share of ``tenant`` on
        ``pipeline_id`` (half-life ``fairness_halflife_s``); ``charge``
        adds to it at dispatch. Decay is applied lazily on access."""
        now = time.monotonic()
        ent = self._tenant_share.get((pipeline_id, tenant))
        if ent is None:
            ent = self._tenant_share[(pipeline_id, tenant)] = [0.0, now]
        value, stamp = ent
        value *= math.exp(
            -(now - stamp) * math.log(2.0)
            / max(1e-6, self.fairness_halflife_s)
        )
        value += charge
        ent[0], ent[1] = value, now
        if len(self._tenant_share) > 65536:
            # Bounded: drop the stalest entries (decayed to noise).
            for key, _e in sorted(
                self._tenant_share.items(), key=lambda kv: kv[1][1]
            )[: len(self._tenant_share) // 2]:
                del self._tenant_share[key]
        return value

    def _dispatch(self, pipeline: Pipeline, predicted_hit: int,
                  meta: RequestMeta | None) -> list[Node]:
        if meta is not None:
            meta.predicted_cached_tokens = predicted_hit
            if self.gamma > 0.0 and meta.tenant_id:
                self._tenant_recent(pipeline.pipeline_id, meta.tenant_id,
                                    charge=1.0)
        self._count_pipeline(pipeline.pipeline_id)
        return pipeline.nodes


class DPRouting(RoutingStrategy):
    """Shortest-latency path over announced layer ranges (reference
    request_routing.py:286-426): dp over layer boundaries, cost = stage
    latency + inter-hop RTT + load compensation."""

    supports_partial_replicas = True

    def find_path(self, meta: RequestMeta | None = None) -> list[Node] | None:
        nodes = [n for n in self.manager.nodes() if n.has_allocation and n.is_ready]
        if not nodes:
            return None
        num_layers = self.manager.num_layers
        by_start: dict[int, list[Node]] = {}
        for n in nodes:
            by_start.setdefault(n.start_layer, []).append(n)

        INF = float("inf")
        memo: dict[tuple[int, str | None], tuple[float, list[Node]]] = {}

        def best(boundary: int, prev: Node | None) -> tuple[float, list[Node]]:
            if boundary == num_layers:
                return 0.0, []
            key = (boundary, prev.node_id if prev else None)
            if key in memo:
                return memo[key]
            result = (INF, [])
            for cand in by_start.get(boundary, []):
                if cand.load >= cand.max_concurrent_requests():
                    continue
                cost = cand.stage_latency_ms()
                if prev is not None:
                    cost += prev.rtt_to(cand.node_id) * 1e3
                tail_cost, tail = best(cand.end_layer, cand)
                if cost + tail_cost < result[0]:
                    result = (cost + tail_cost, [cand] + tail)
            memo[key] = result
            return result

        cost, path = best(0, None)
        return path if cost < INF else None


class RandomizedRouting(RoutingStrategy):
    """Randomized choice over ALL complete dynamic pipelines (reference
    ``RandomizedOverDynamicPipelinesRouting``, request_routing.py:443-500):
    DFS-enumerate every complete path over the announced layer ranges,
    drop overloaded ones, and pick randomly weighted by inverse estimated
    latency. A seeded ``random.Random``, as in the JAX router, so seeded
    picks match."""

    supports_partial_replicas = True

    # DFS ceiling: enumeration is exponential in replica fan-out; beyond
    # this many complete paths the sample is already diverse.
    MAX_PATHS = 128

    def __init__(self, manager: NodeManager, seed: int | None = None):
        super().__init__(manager)
        self._rng = random.Random(seed)

    def _discover(self) -> list[list[Node]]:
        nodes = [
            n for n in self.manager.nodes()
            if n.has_allocation and n.is_ready
        ]
        num_layers = self.manager.num_layers
        by_start: dict[int, list[Node]] = {}
        for n in nodes:
            by_start.setdefault(n.start_layer, []).append(n)
        # Shuffle each candidate list per call: the MAX_PATHS cutoff then
        # truncates a DIFFERENT suffix every request.
        for cands in by_start.values():
            self._rng.shuffle(cands)
        paths: list[list[Node]] = []

        def dfs(boundary: int, acc: list[Node]) -> None:
            if len(paths) >= self.MAX_PATHS:
                return
            if boundary == num_layers:
                paths.append(list(acc))
                return
            for cand in by_start.get(boundary, []):
                if cand.load >= cand.max_concurrent_requests():
                    continue
                acc.append(cand)
                dfs(cand.end_layer, acc)
                acc.pop()

        dfs(0, [])
        return paths

    def find_path(self, meta: RequestMeta | None = None) -> list[Node] | None:
        paths = self._discover()
        if not paths:
            return None
        weights = []
        for p in paths:
            ms = sum(n.stage_latency_ms() for n in p)
            for prev, nxt in zip(p, p[1:]):
                ms += prev.rtt_to(nxt.node_id) * 1e3
            weights.append(1.0 / max(ms, 1e-6))
        return self._rng.choices(paths, weights=weights, k=1)[0]


def find_turning_points(
    nodes: list[Node], num_layers: int
) -> list[tuple[str, int, str]]:
    """Layer-level DP over overlapping shards: where should the optimal
    route switch nodes, and which hosted layers does that strand?

    Capability parity: reference ``request_routing.py:86-177``. State is
    (layer, hosting node); node cost is the per-layer latency proxy, edge
    cost the RTT between distinct nodes. Backtracking the cheapest path
    yields truncation advice for the allocator:

    - ``(node, l, "tail")`` — the route leaves ``node`` at layer ``l``
      even though it still hosts ``l``: the shard suffix ``[l, end)`` is
      dead weight there.
    - ``(node, l, "head")`` — the route first uses ``node`` at layer
      ``l`` past its hosted start: the prefix ``[start, l)`` is dead.

    Returns [] when some layer has no host (no complete route exists).
    """
    if num_layers <= 0 or not nodes:
        return []
    hosts: list[list[int]] = []
    for layer in range(num_layers):
        h = [
            i for i, n in enumerate(nodes)
            if n.has_allocation and n.start_layer <= layer < n.end_layer
        ]
        if not h:
            return []
        hosts.append(h)

    INF = float("inf")
    cost = {i: nodes[i].layer_latency_ms() for i in hosts[0]}
    back: list[dict[int, int | None]] = [{i: None for i in hosts[0]}]
    for layer in range(1, num_layers):
        nxt: dict[int, float] = {}
        bk: dict[int, int | None] = {}
        for i in hosts[layer]:
            lat = nodes[i].layer_latency_ms()
            best, best_j = INF, None
            for j, c in cost.items():
                hop = 0.0 if j == i else (
                    nodes[j].rtt_to(nodes[i].node_id) * 1e3
                )
                if c + hop + lat < best:
                    best, best_j = c + hop + lat, j
            nxt[i] = best
            bk[i] = best_j
        back.append(bk)
        cost = nxt

    end_i = min(cost, key=lambda k: cost[k])
    path = [end_i]
    for layer in range(num_layers - 1, 0, -1):
        prev = back[layer][path[-1]]
        if prev is None:
            break
        path.append(prev)
    path.reverse()

    # Tail advice anchors at each node's LAST use, not each departure: a
    # route may leave a node and re-enter it later, and trimming at the
    # first departure would delete shards the route itself depends on.
    turning: list[tuple[str, int, str]] = []
    first_used: dict[int, int] = {}
    last_used: dict[int, int] = {}
    for layer, idx in enumerate(path):
        first_used.setdefault(idx, layer)
        last_used[idx] = layer
    for idx, ll in last_used.items():
        if nodes[idx].end_layer > ll + 1:
            turning.append((nodes[idx].node_id, ll + 1, "tail"))
    for idx, l0 in first_used.items():
        if l0 > nodes[idx].start_layer:
            turning.append((nodes[idx].node_id, l0, "head"))
    return turning


def make_router(name: str, manager: NodeManager, **kwargs) -> RoutingStrategy:
    if name in ("rr", "round_robin"):
        return RoundRobinRouting(manager)
    if name in ("dp", "dynamic"):
        return DPRouting(manager)
    if name in ("random", "randomized"):
        return RandomizedRouting(manager)
    if name in ("cache_aware", "cache-aware", "prefix"):
        return CacheAwareRouting(manager, **kwargs)
    raise ValueError(f"unknown routing strategy {name!r}")
