"""The global scheduler orchestrator (port of
``parallax_tpu/scheduling/scheduler.py``).

Capability parity: reference ``src/scheduling/scheduler.py:29-649`` — event
queues for join/leave/update, bootstrap gating on a minimum node count,
heartbeat timeout sweeping, request dispatch, and serialized global
rebalance on topology changes.

Threading model as in the JAX package: one event thread owns all topology
mutations; a dispatch thread assigns routing tables; callers only enqueue.
Nothing here touches a device.

Scheduler HA is the JAX scheduler's (``ha/``, docs/ha.md): the
``epoch`` rides every reply; a ``passive`` scheduler is a warm-standby
mirror whose threads stay parked until ``StandbyScheduler.promote``; a
``fenced`` one saw a worker echo a higher epoch and mutates nothing; an
installed ``journal`` records every replicated mutation (join, leave,
peer_down, the heartbeat replay window, the pipeline table's diffs and
migration_done) and weight refits (:meth:`begin_refit` writes the
``refit`` record a promoted standby replays). Phase roles (role-homogeneous
pipelines, phase-filtered routing pools), the KV handoff's decode-pool
targets (``pool="decode"``) and their ``disagg`` counters, live
migration's target choice, ``where_is`` table and drain counters are the
JAX scheduler's.

The observability plane is the JAX scheduler's too: heartbeats carry each
node's histogram snapshots, goodput, device plane, watchdog health and a
sequence-numbered flight-event batch; the cluster timeline
(``obs/timeline.py``) ingests the batches beside the scheduler's own
decisions (peer_down, node_leave, node_health, migration_done,
ha_fenced); ``slo=`` (an ``obs/slo.py`` ``SLOConfig``) evaluates SLO
attainment and burn rates over the merged histograms; and
``cluster_status`` carries the merged ``metrics``, ``goodput``,
``device``, ``health``, ``slo`` and ``timeline`` sections.

So is the QoS control plane (``qos=``, a ``qos/classes.QoSConfig``): a
cluster-scope admission controller reads the merged per-class TTFT
histograms off the heartbeats and relays its shed verdict in heartbeat
replies (``qos_shed``); with ``autoscale`` the pool autoscaler re-roles
whole pipelines between the prefill and decode pools; ``cluster_status``
then carries a ``qos`` section.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.config import ModelConfig
from parallax_tpu_torch.scheduling.layer_allocation import (
    BaseLayerAllocator,
    DPLayerAllocator,
    GreedyLayerAllocator,
    assign_to_lightest_layers,
)
from parallax_tpu_torch.scheduling.node import Node
from parallax_tpu_torch.scheduling.node_management import (
    NodeManager,
    NodeState,
)
from parallax_tpu_torch.scheduling.request_routing import (
    RequestMeta,
    RoutingStrategy,
    find_turning_points,
    make_router,
)
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.utils.hw import HardwareInfo

logger = get_logger(__name__)


@dataclasses.dataclass
class PendingRequest:
    request_id: str
    # Routing context (tokenized prompt for prefix-digest matching).
    meta: "RequestMeta | None" = None
    # Read at call time (a virtual clock patched over ``time`` reaches it).
    enqueue_time: float = dataclasses.field(
        default_factory=lambda: time.monotonic())
    # The dispatcher retries routing until this deadline before giving up
    # (reference RequestHandler retry ladder, request_handler.py:100-245).
    deadline: float = dataclasses.field(
        default_factory=lambda: time.monotonic() + 10.0
    )
    # Filled by the dispatcher.
    path_ids: list[str] | None = None
    event: threading.Event = dataclasses.field(default_factory=threading.Event)
    # Set by a caller that gave up waiting; the dispatcher then drops the
    # request instead of charging load for a path nobody will use.
    cancelled: bool = False


class GlobalScheduler:
    """Assigns layers to nodes and node paths to requests."""

    # Heartbeat-sweep probation: a node whose last beat reported an
    # in-progress engine reload gets this multiple of the base timeout
    # before _handle_leave fires ...
    BUSY_GRACE_FACTOR = 5.0
    # ... while a node a peer's async sender reported unreachable gets
    # this FRACTION of it (floored at 1.5 s).
    PEER_DOWN_GRACE_FACTOR = 0.25

    def __init__(
        self,
        model: ModelConfig,
        min_nodes_bootstrapping: int = 1,
        allocator: str = "greedy",
        routing: str = "rr",
        heartbeat_timeout_s: float = 30.0,
        routing_kwargs: dict | None = None,
        slo=None,
        qos=None,
        passive: bool = False,
    ):
        self.model = model
        # Scheduler HA (ha/, docs/ha.md): ``epoch`` rides heartbeat
        # replies and fences a revived old primary; a ``passive``
        # scheduler is a warm-standby mirror — its event / dispatch
        # threads stay parked and the service refuses mutating RPCs until
        # StandbyScheduler.promote() flips it active; a ``fenced``
        # scheduler saw proof (a worker echoing a higher epoch) that a
        # standby promoted past it and refuses to mutate.
        self.epoch = 1
        self.passive = passive
        self.fenced = False
        # Installed by ha.journal.install_journal; None = HA off (every
        # _journal() hook is a no-op).
        self.journal = None
        self._journaled_pipelines = None
        self.min_nodes = min_nodes_bootstrapping
        self.manager = NodeManager(model.num_hidden_layers)
        alloc_cls: type[BaseLayerAllocator] = (
            GreedyLayerAllocator if allocator == "greedy" else DPLayerAllocator
        )
        self.allocator = alloc_cls(model.num_hidden_layers)
        self.routing_name = routing
        self.routing_kwargs = dict(routing_kwargs or {})
        self.router: RoutingStrategy = make_router(
            routing, self.manager, **self.routing_kwargs
        )
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.bootstrapped = threading.Event()
        # rid -> (predicted cached tokens, prompt tokens): dispatch-time
        # predictions awaiting the head's request_complete actuals
        # (bounded — an abandoned request must not leak an entry).
        self._predictions: OrderedDict[str, tuple[int, int]] = OrderedDict()
        self._predictions_cap = 4096
        # Aggregate predicted-vs-actual hit telemetry (cluster_status
        # "routing" section).
        self.routing_accuracy = {
            "requests": 0, "predicted_tokens": 0, "actual_tokens": 0,
            "abs_error_tokens": 0,
        }
        self._events: queue.Queue = queue.Queue()
        self._requests: queue.Queue[PendingRequest] = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = make_lock("scheduling.scheduler", reentrant=True)
        self.refit_version = 0
        self.refit_index: dict[str, str] = {}
        # Live migration: rid -> the head now serving it (reported by
        # targets via ``migration_done``); pollers that lost their head ask
        # ``where_is`` here. Bounded — finished requests age out.
        self._migrations: OrderedDict[str, str] = OrderedDict()
        self.migration_stats = {"drains": 0, "targets_chosen": 0,
                                "recorded": 0}
        # KV handoff telemetry: decode-pool target queries from prefill
        # heads, targets chosen, and queries that found no serviceable
        # decode / mixed pipeline (the head then keeps the request local).
        self.disagg_stats = {"target_queries": 0, "targets_chosen": 0,
                             "no_target": 0}
        # Cluster event timeline: workers ship sequence-numbered
        # flight-event batches in heartbeats; the ring merges them with
        # the scheduler's own decisions into one causally ordered story
        # (/debug/timeline).
        from parallax_tpu_torch.obs.timeline import ClusterTimeline

        self.timeline = ClusterTimeline()
        # SLO objectives over the cluster-merged histograms, one sample
        # each time cluster_status() runs. None = none declared.
        self.slo_tracker = None
        if slo is not None:
            from parallax_tpu_torch.obs.slo import SLOTracker

            self.slo_tracker = SLOTracker(slo)
        # Multi-tenant QoS: the cluster-scope admission controller and the
        # pool autoscaler, both ticked on the event thread. None = QoS off
        # (no work, no reply fields).
        self.qos_config = qos
        self.qos_controller = None
        self.autoscaler = None
        if qos is not None:
            from parallax_tpu_torch.qos import (
                AdmissionController,
                PoolAutoscaler,
            )

            self.qos_controller = AdmissionController(qos, scope="cluster")
            if qos.autoscale:
                self.autoscaler = PoolAutoscaler(
                    self.manager, qos, timeline=self.timeline)

    # -- public API (thread-safe enqueues) --------------------------------

    def enqueue_join(
        self, node_id: str, hardware: HardwareInfo,
        wire_formats: list | None = None, role: str | None = None,
    ) -> None:
        self._events.put(("join", node_id, hardware, wire_formats, role))

    def enqueue_leave(self, node_id: str) -> None:
        self._events.put(("leave", node_id))

    def enqueue_update(
        self,
        node_id: str,
        layer_latency_ms: float | None = None,
        load: int | None = None,
        rtt_s: dict | None = None,
        is_ready: bool | None = None,
        refit_version: int | None = None,
        lora_adapters: list | None = None,
        step_timing: dict | None = None,
        cache_stats: dict | None = None,
        transport: dict | None = None,
        metrics: dict | None = None,
        cache_digests: dict | None = None,
        busy: bool | None = None,
        goodput: dict | None = None,
        health: dict | None = None,
        events: dict | None = None,
        kernel: dict | None = None,
        spec: dict | None = None,
        constrained: dict | None = None,
        device: dict | None = None,
    ) -> None:
        """A heartbeat: the node's soft state and its status planes, kept
        as the node's fields for ``cluster_status``; ``events`` (a
        flight-event batch) goes into the cluster timeline."""
        self._events.put((
            "update", node_id, dict(
                lat=layer_latency_ms, load=load, rtt=rtt_s, ready=is_ready,
                refit=refit_version, adapters=lora_adapters,
                step_timing=step_timing, cache_stats=cache_stats,
                transport=transport, metrics=metrics,
                cache_digests=cache_digests, busy=busy,
                goodput=goodput, health=health, events=events,
                kernel=kernel, spec=spec, constrained=constrained,
                device=device,
            ),
        ))

    def enqueue_peer_down(self, reporter: str, peer: str,
                          reason: str = "") -> None:
        """A worker's async sender declared ``peer`` unreachable: mark
        its CacheIndex stale NOW (the cache-aware router must stop
        scoring a dead replica's prefixes) and put it under the
        accelerated heartbeat sweep."""
        self._events.put(("peer_down", reporter, peer, reason))

    def receive_request(
        self, request_id: str, meta: RequestMeta | None = None,
        arrival_time: float | None = None,
    ) -> PendingRequest:
        """``arrival_time`` (monotonic) preserves the ORIGINAL arrival
        when a request is re-enqueued after its dispatched path died."""
        pr = PendingRequest(request_id, meta=meta)
        if arrival_time is not None:
            pr.enqueue_time = arrival_time
        self._requests.put(pr)
        return pr

    def get_node_allocation(self, node_id: str) -> dict | None:
        """The worker's view of its assignment (heartbeat reply payload)."""
        node = self.manager.get(node_id)
        if node is None or not node.has_allocation:
            return None
        alloc = {
            "start_layer": node.start_layer,
            "end_layer": node.end_layer,
            "model_name": self.model.model_name,
            "refit_version": self.refit_version,
        }
        if self.router.wants_digests:
            # Cache-aware routing: workers build their engine with digest
            # tracking on and publish delta payloads on heartbeats.
            alloc["want_digests"] = True
        # Normally the worker's own join-time role echoed back; the QoS
        # autoscaler may have re-roled its pipeline (adopted in place).
        alloc["role"] = node.role
        if self.qos_controller is not None:
            # Cluster shed verdict, OR'd by workers with their local one.
            alloc["qos_shed"] = self.qos_controller.shedding
        return alloc

    def drain_requested(self, node_id: str) -> list[str]:
        """Consume a head node's pending drain directives (dead peers
        whose in-flight requests it must give up); relayed on the
        heartbeat reply."""
        node = self.manager.get(node_id)
        if node is None or not node.pending_drain:
            return []
        # The heartbeat handler thread consumes while the event thread
        # may add: consume-and-clear under the lock.
        with self._lock:
            dead = sorted(node.pending_drain)
            node.pending_drain.clear()
        return dead

    def digests_resync_requested(self, node_id: str) -> bool:
        """Consume a node's pending digest-resync flag (set when a delta
        arrived out of sequence); the heartbeat reply relays it so the
        worker's next beat carries a full snapshot."""
        node = self.manager.get(node_id)
        if node is None or not node.digests_need_resync:
            return False
        node.digests_need_resync = False
        return True

    # -- live migration ------------------------------------------------------

    def choose_migration_targets(
        self, requests: list[dict], exclude: "set[str] | None" = None,
        pool: str | None = None,
    ) -> dict:
        """Pick a surviving pipeline per parked request, scored the
        cache-aware way: ``predicted_uncached + 256 * head_load`` against
        each head's heartbeat-fed CacheIndex mirror (``requests`` carry the
        restored prompt's block-hash chains), so a migrating request lands
        where its prefix is already cached and the restore re-prefills only
        the uncovered suffix. Charges router load per chosen path
        (released by the target head's eventual request_complete).

        ``pool="decode"`` restricts the candidates to the decode phase pool
        (the KV handoff's targets): decode or mixed pipelines, never
        prefill specialists, with no fallback. It counts
        ``disagg_stats``' target_queries, targets_chosen and no_target; an
        empty result tells the prefill head to keep the request local."""
        from parallax_tpu_torch.scheduling.request_routing import (
            eligible_pipelines,
        )

        excl = set(exclude or ())
        out: dict = {}
        candidates = [
            p for p in eligible_pipelines(self.manager, phase=pool)
            if not (set(p.node_ids) & excl)
        ]
        if pool == "decode":
            with self._lock:
                self.disagg_stats["target_queries"] += len(requests)
                if not candidates:
                    self.disagg_stats["no_target"] += len(requests)
        if not candidates:
            return out
        for r in requests:
            rid = r.get("rid")
            if not isinstance(rid, str):
                continue
            lora = r.get("lora_id")
            prompt_tokens = int(r.get("prompt_tokens") or 0)
            chains = r.get("chains") or {}
            best = best_score = None
            best_hit = 0
            for i, p in enumerate(candidates):
                if lora and not all(
                    lora in n.lora_adapters for n in p.nodes
                ):
                    continue
                head = p.nodes[0]
                hit = 0
                idx = head.cache_index
                chain = chains.get(idx.block) or chains.get(str(idx.block))
                if idx.block > 0 and chain:
                    try:
                        hit = idx.predict_cached_tokens(
                            [int(c) for c in chain], idx.block,
                            prompt_tokens,
                        )
                    except (TypeError, ValueError):
                        hit = 0
                score = (
                    max(0, prompt_tokens - hit) + 256.0 * head.load,
                    (i + self.migration_stats["targets_chosen"])
                    % len(candidates),
                )
                if best_score is None or score < best_score:
                    best, best_score, best_hit = p, score, hit
            if best is None:
                continue
            self.router.on_dispatch(best.nodes)
            # migrate_target / disagg_target land on the service thread
            # while the sweep and heartbeat threads read these stats for
            # cluster_status.
            with self._lock:
                if pool == "decode":
                    self.disagg_stats["targets_chosen"] += 1
                else:
                    self.migration_stats["targets_chosen"] += 1
            out[rid] = {
                "path": list(best.node_ids),
                "head_layers": [
                    best.nodes[0].start_layer, best.nodes[0].end_layer,
                ],
                "predicted_cached_tokens": best_hit,
            }
        return out

    def record_migration(self, request_id: str, head: str) -> None:
        """A target head restored ``request_id``: pollers that lost the
        old head find the new one via ``migrated_head``."""
        with self._lock:
            self._migrations[request_id] = head
            self._migrations.move_to_end(request_id)
            while len(self._migrations) > 4096:
                self._migrations.popitem(last=False)
            self.migration_stats["recorded"] += 1
        self.timeline.record(
            "migration_done", node=head, request_id=request_id,
        )
        self._journal("migration_done", {"rid": request_id, "head": head})

    def migrated_head(self, request_id: str) -> str | None:
        with self._lock:
            return self._migrations.get(request_id)

    # -- scheduler HA (ha/, docs/ha.md) ----------------------------------

    def fence(self, epoch: int) -> None:
        """A worker echoed a scheduler epoch higher than ours: a standby
        promoted while we were partitioned / paused. Stop mutating — the
        promoted scheduler owns the swarm now (split-brain guard)."""
        if self.fenced:
            return
        self.fenced = True
        logger.warning(
            "scheduler fenced: worker echoed epoch %d > our %d — a "
            "standby promoted past us; refusing further mutations",
            epoch, self.epoch,
        )
        self.timeline.record("ha_fenced", epoch=epoch, our_epoch=self.epoch)

    def _journal(self, kind: str, data: dict) -> None:
        """Replicate one state mutation (no-op while HA is off)."""
        if self.journal is None:
            return
        try:
            self.journal.record(kind, data)
        except Exception:  # HA must never break serving
            logger.exception("journal record %r failed", kind)

    def _journal_pipelines(self) -> None:
        """Journal the pipeline / allocation table when it changed since
        the last call. Allocation is DERIVED state (the allocator is
        deterministic only given identical arrival order), so the
        primary's actual decision is replicated rather than recomputed by
        the standby — covering bootstrap, extend, dynamic-join replicas,
        turning-point trims and rebalances through one diff point."""
        if self.journal is None:
            return
        members: set[str] = set()
        pipelines = []
        for p in self.manager.pipelines:
            pipelines.append({
                "id": p.pipeline_id,
                "nodes": [
                    [n.node_id, n.start_layer, n.end_layer, n.role]
                    for n in p.nodes
                ],
            })
            members.update(p.node_ids)
        replicas = [
            [n.node_id, n.start_layer, n.end_layer]
            for n in self.manager.nodes(NodeState.ACTIVE)
            if n.node_id not in members and n.has_allocation
        ]
        cur = {
            "bootstrapped": self.bootstrapped.is_set(),
            "next_id": self.manager.next_pipeline_id,
            "pipelines": pipelines,
            "replicas": replicas,
        }
        if cur != self._journaled_pipelines:
            self._journaled_pipelines = cur
            self._journal("pipelines", cur)

    # -- weight refit ------------------------------------------------------

    def begin_refit(self, index_map: dict[str, str]) -> int:
        """Register a new weight version (weight name -> uri or {"uri",
        "sha256"}); workers pick it up from heartbeat replies and routers
        skip pipelines whose version lags (``p2p/refit.py``)."""
        with self._lock:
            self.refit_version += 1
            self.refit_index = dict(index_map)
            version = self.refit_version
        self._journal("refit", {"version": version,
                                "index": dict(index_map)})
        return version

    # -- synchronous twins of the loops -------------------------------------

    def apply_event(self, ev: tuple) -> None:
        """Apply one topology event synchronously."""
        self._handle_event(ev)

    def drain_events(self) -> int:
        """Drain and handle every queued event now (synchronous twin of
        one _event_loop pass). Returns the number handled."""
        n = 0
        while True:
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                return n
            try:
                self._handle_event(ev)
            except Exception:
                logger.exception("event %r failed", ev[0])
            n += 1

    def sweep_once(self) -> None:
        """One heartbeat-sweep + QoS-tick + journal-diff pass (synchronous
        twin of the _event_loop's 1 Hz housekeeping)."""
        self._sweep_heartbeats()
        self._qos_tick(time.monotonic())
        self._journal_pipelines()

    def dispatch_once(self) -> bool:
        """Route one queued request now (synchronous twin of one
        _dispatch_loop pass). Returns False when the queue was empty."""
        try:
            pr = self._requests.get_nowait()
        except queue.Empty:
            return False
        self._dispatch_one(pr)
        return True

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        for fn in (self._event_loop, self._dispatch_loop):
            t = threading.Thread(target=fn, daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)

    # -- event loop (single thread owns topology) -------------------------

    def _event_loop(self) -> None:
        last_sweep = time.monotonic()
        while not self._stop.is_set():
            try:
                ev = self._events.get(timeout=0.05)
            except queue.Empty:
                ev = None
            if ev is not None:
                try:
                    self._handle_event(ev)
                except Exception:
                    # The topology thread must survive malformed
                    # network-fed payloads.
                    logger.exception("event %r failed", ev[0])
            now = time.monotonic()
            if now - last_sweep > 1.0:
                self._sweep_heartbeats()
                self._qos_tick(now)
                # Autoscaler re-roles and sweep-driven churn change the
                # allocation table off the join / leave paths; the 1 Hz
                # diff catches them for the HA journal.
                self._journal_pipelines()
                last_sweep = now

    def _qos_tick(self, now: float) -> None:
        """QoS control-plane pass (event thread, ~1 Hz): feed the cluster
        admission controller the merged protected-class TTFT counts, run
        its hysteresis and tick the pool autoscaler. The verdict reaches
        workers in their next heartbeat reply (``qos_shed``)."""
        ctl = self.qos_controller
        if ctl is None:
            return
        under, total = self._qos_cluster_counts()
        if total:
            ctl.observe_cumulative(under, total, now)
        if ctl.tick(now):
            self.timeline.record(
                "qos_shed" if ctl.shedding else "qos_release",
                burn=round(ctl.last_burn, 3),
            )
        if self.autoscaler is not None:
            self.autoscaler.tick(now)

    def _qos_cluster_counts(self) -> tuple[float, int]:
        """Cluster-cumulative (under-budget, total) counts of the
        protected class's TTFT, summed over every pipeline member's
        heartbeat-shipped ``parallax_qos_ttft_ms`` children."""
        from parallax_tpu_torch.obs import names as mnames
        from parallax_tpu_torch.obs.slo import fraction_below

        ctl = self.qos_controller
        budget = ctl.protected.deadline_ms
        under, total = 0.0, 0
        for p in self.manager.pipelines:
            for n in p.nodes:
                children = (n.metrics or {}).get(mnames.QOS_TTFT_MS)
                if not isinstance(children, dict):
                    continue
                for label, snap in children.items():
                    if ctl.protected.name not in str(label):
                        continue
                    u, t = fraction_below(snap, budget)
                    under += u
                    total += t
        return under, total

    def _handle_event(self, ev: tuple) -> None:
        kind = ev[0]
        if self.fenced:
            # A promoted standby owns the swarm; a fenced old primary
            # mutating its registry would fork the control plane.
            return
        if kind == "join":
            _, node_id, hardware, *rest = ev
            node = Node(node_id=node_id, hardware=hardware, model=self.model)
            if rest and rest[0]:
                node.wire_formats = tuple(rest[0])
            if len(rest) > 1 and rest[1]:
                # Unknown strings degrade to mixed, as in the JAX
                # scheduler: a newer worker build must still serve.
                role = str(rest[1]).lower()
                node.role = (
                    role if role in ("prefill", "decode", "mixed")
                    else "mixed"
                )
            self.manager.add(node)
            logger.info("node %s joined (%s x%d, role=%s)", node_id,
                        hardware.device_kind, hardware.num_chips,
                        node.role)
            self._journal("join", {
                "node_id": node_id,
                "hardware": hardware.to_dict(),
                "wire_formats": list(node.wire_formats),
                "role": node.role,
            })
            self._try_bootstrap_or_extend()
            self._journal_pipelines()
        elif kind == "leave":
            self._handle_leave(ev[1])
        elif kind == "peer_down":
            _, reporter, peer, reason = ev
            node = self.manager.get(peer)
            if node is None:
                return
            stale = len(node.cache_index)
            node.cache_index.clear()
            if node.peer_down_at is None:
                node.peer_down_at = time.monotonic()
                logger.warning(
                    "peer_down: %s reported %s unreachable (%s); "
                    "%d cache-index digests dropped, sweep accelerated",
                    reporter, peer, reason or "?", stale,
                )
                self.timeline.record(
                    "peer_down", node=peer, reporter=reporter,
                    reason=reason or "?",
                )
                self._journal("peer_down", {
                    "reporter": reporter, "peer": peer,
                    "reason": reason or "",
                })
        elif kind == "update":
            self._handle_update(ev[1], ev[2])

    def _handle_update(self, node_id: str, u: dict) -> None:
        if u["events"] is not None:
            # Merge the node's flight-event batch even for an unknown node:
            # a churn victim's last beats are exactly the interesting ones.
            self.timeline.ingest(node_id, u["events"])
        node = self.manager.get(node_id)
        if node is None:
            return
        node.touch()
        # A live beat disproves any dead-peer report or probation.
        node.peer_down_at = None
        node.suspect = False
        if u["busy"] is not None:
            node.reported_busy = bool(u["busy"])
        if u["lat"] is not None:
            node.measured_layer_latency_ms = u["lat"]
        if u["load"] is not None:
            node.load = u["load"]
        if u["rtt"]:
            node.rtt_s.update(u["rtt"])
        if u["ready"] is not None:
            node.is_ready = u["ready"]
        if u["refit"] is not None:
            node.refit_version = u["refit"]
        if u["adapters"] is not None:
            node.lora_adapters = tuple(u["adapters"])
        for field in ("step_timing", "cache_stats", "kernel", "spec",
                      "constrained", "transport", "metrics", "goodput",
                      "device"):
            if u[field] is not None:
                setattr(node, field, u[field])
        health = u["health"]
        if health is not None:
            prev = (node.health or {}).get("status")
            node.health = health
            status = health.get("status")
            if status != prev and status in ("degraded", "stalled"):
                # Sick but alive: the node still beats (the sweep leaves
                # it alone) while its watchdog says a component stopped
                # making progress.
                logger.warning(
                    "node %s reports health %s: %s", node_id, status,
                    "; ".join(health.get("causes") or ()) or "?",
                )
                self.timeline.record(
                    "node_health", node=node_id, status=status,
                    causes=list(health.get("causes") or ()),
                )
        if u["cache_digests"] is not None:
            if node.cache_index.apply(u["cache_digests"]):
                node.digests_need_resync = True
        # Bounded heartbeat-replay window: a promoted standby re-derives
        # soft state (load charges, readiness, digest continuity) from
        # these instead of trusting a snapshot of someone else's clocks.
        self._journal("hb", {
            "node_id": node_id,
            "load": u["load"],
            "ready": u["ready"],
            "busy": u["busy"],
            "latency_ms": u["lat"],
            "refit_version": u["refit"],
            "digests": u["cache_digests"],
        })

    def _try_bootstrap_or_extend(self) -> None:
        standby = self.manager.nodes(NodeState.STANDBY)
        if not self.bootstrapped.is_set():
            if len(self.manager) < self.min_nodes:
                return
            pipelines = self.allocator.allocate_role_aware(standby)
            if not pipelines:
                return
            self.manager.register_pipelines(pipelines)
            self.bootstrapped.set()
            self._log_allocation("bootstrap")
        else:
            # Serving already: extend with new pipelines when standby
            # nodes suffice (reference RR extend path).
            pipelines = self.allocator.allocate_role_aware(standby)
            if pipelines:
                self.manager.register_pipelines(pipelines)
                self._log_allocation("extend")
        # Leftover standby nodes that cannot complete a pipeline still
        # help under dynamic routing: replicate an existing stage range
        # (reference dynamic_join, layer_allocation.py:193-214).
        if self.router.supports_partial_replicas and self.bootstrapped.is_set():
            active = self.manager.nodes(NodeState.ACTIVE)
            for node in self.manager.nodes(NodeState.STANDBY):
                if active and assign_to_lightest_layers(
                    node, active, self.model.num_hidden_layers
                ):
                    self.manager.set_active(node.node_id)
                    active.append(node)
                    self._log_allocation("dynamic-join")
            self._apply_turning_point_trims()

    def _apply_turning_point_trims(self) -> None:
        """Trim replica shard segments the optimal route never uses
        (reference find_turning_points warm-up trimming,
        request_routing.py:86-177). Registered pipeline members are never
        trimmed; a replica is trimmed only once it reported a measured
        layer latency and is idle (a trim reloads its engine)."""
        active = self.manager.nodes(NodeState.ACTIVE)
        members = {
            n.node_id for p in self.manager.pipelines for n in p.nodes
        }
        for node_id, layer, kind in find_turning_points(
            active, self.model.num_hidden_layers
        ):
            node = self.manager.get(node_id)
            if node is None or node_id in members:
                continue
            if node.measured_layer_latency_ms is None or node.load > 0:
                continue
            if kind == "tail" and node.start_layer < layer < node.end_layer:
                logger.info(
                    "turning-point trim: %s tail [%d, %d) -> [%d, %d)",
                    node_id, node.start_layer, node.end_layer,
                    node.start_layer, layer,
                )
                node.set_layers(node.start_layer, layer)
            elif kind == "head" and node.start_layer < layer < node.end_layer:
                logger.info(
                    "turning-point trim: %s head [%d, %d) -> [%d, %d)",
                    node_id, node.start_layer, node.end_layer,
                    layer, node.end_layer,
                )
                node.set_layers(layer, node.end_layer)

    def _handle_leave(self, node_id: str) -> None:
        # Every pipeline through the dying node has a head that owns full
        # request state: flag it (consumed by its next heartbeat reply),
        # and the head checkpoints the affected requests away. When the
        # head IS the dying node, the client's resume ladder recovers.
        for p in self.manager.pipelines:
            if node_id not in p.node_ids:
                continue
            head = p.nodes[0]
            if head.node_id != node_id:
                with self._lock:
                    head.pending_drain.add(node_id)
                    self.migration_stats["drains"] += 1
        displaced = self.manager.remove(node_id)
        logger.info("node %s left; %d displaced", node_id, len(displaced))
        self.timeline.record(
            "node_leave", node=node_id, displaced=len(displaced),
        )
        self._journal("leave", {"node_id": node_id})
        active = list(self.manager.nodes(NodeState.ACTIVE))
        if not self.manager.pipelines or self.allocator.should_global_rebalance(
            active
        ):
            self._global_rebalance()
        else:
            self._try_bootstrap_or_extend()
        self._journal_pipelines()

    def _global_rebalance(self) -> None:
        """Tear everything down and re-allocate from scratch (reference
        scheduler.py:581-636). Workers detect new ranges via heartbeat
        replies and reload."""
        logger.info("global rebalance")
        self.manager.standby_all()
        self.bootstrapped.clear()
        self._try_bootstrap_or_extend()

    def _sweep_heartbeats(self) -> None:
        for node in self.manager.nodes():
            # Standby nodes may legitimately sit in a long blocking join;
            # give them a much longer leash before eviction.
            factor = 1.0 if node.has_allocation else 10.0
            timeout = self.heartbeat_timeout_s * factor
            # A dead-peer report overrides busy probation.
            if node.reported_busy and node.peer_down_at is None:
                # Probation, not eviction: an engine reload can outlast
                # the base timeout; the node said so in its last beat.
                extended = timeout * self.BUSY_GRACE_FACTOR
                if node.is_stale(timeout) and not node.is_stale(extended):
                    if not node.suspect:
                        node.suspect = True
                        logger.warning(
                            "heartbeat overdue but %s reported a reload "
                            "in progress: suspect, grace extended x%.0f",
                            node.node_id, self.BUSY_GRACE_FACTOR,
                        )
                    continue
                timeout = extended
            if node.peer_down_at is not None:
                # A peer already reported it dead; a missing heartbeat on
                # top of the report is confirmation.
                timeout = min(
                    timeout,
                    max(1.5, timeout * self.PEER_DOWN_GRACE_FACTOR),
                )
            if node.is_stale(timeout):
                logger.warning("heartbeat timeout: %s", node.node_id)
                self._handle_leave(node.node_id)

    # -- dispatch loop ----------------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                pr = self._requests.get(timeout=0.05)
            except queue.Empty:
                continue
            if not self._dispatch_one(pr):
                time.sleep(0.02)

    def _dispatch_one(self, pr: PendingRequest) -> bool:
        """Route one pending request (shared by the dispatch thread and
        :meth:`dispatch_once`). Returns False when the request was
        re-queued for a later retry."""
        if pr.cancelled:
            pr.event.set()
            return True
        try:
            path = self.router.find_path(pr.meta)
        except Exception:
            # A router bug must not kill the dispatch thread: treat as
            # "no path now" and let the retry ladder run.
            logger.exception("find_path failed for %s", pr.request_id)
            path = None
        if path is not None:
            self.router.on_dispatch(path)
            pr.path_ids = [n.node_id for n in path]
            if pr.meta is not None and pr.meta.prompt_ids:
                self._record_prediction(
                    pr.request_id,
                    pr.meta.predicted_cached_tokens,
                    pr.meta.num_prompt_tokens,
                )
            pr.event.set()
            return True
        if time.monotonic() < pr.deadline:
            # No serviceable pipeline right now (bootstrap in flight, all
            # busy): retry until the deadline.
            self._requests.put(pr)
            return False
        pr.event.set()
        return True

    def _record_prediction(self, request_id: str, predicted: int,
                           prompt_tokens: int) -> None:
        with self._lock:
            self._predictions[request_id] = (predicted, prompt_tokens)
            while len(self._predictions) > self._predictions_cap:
                self._predictions.popitem(last=False)

    def complete_request(self, path_ids: list[str],
                         request_id: str | None = None,
                         cached_tokens: int | None = None) -> None:
        self.router.on_complete(path_ids)
        if request_id is None:
            return
        # Predicted-vs-actual prefix-hit telemetry: the head engine
        # reports its real admission-time hit on request_complete.
        with self._lock:
            pred = self._predictions.pop(request_id, None)
            if pred is None or cached_tokens is None:
                return
            predicted, _prompt_tokens = pred
            acc = self.routing_accuracy
            acc["requests"] += 1
            acc["predicted_tokens"] += predicted
            acc["actual_tokens"] += int(cached_tokens)
            acc["abs_error_tokens"] += abs(predicted - int(cached_tokens))

    # -- introspection ----------------------------------------------------

    def cluster_status(self) -> dict:
        """The JAX ``cluster_status``: capacity, bootstrap, the merged
        histograms (``metrics``), ``goodput``, ``device``, the ``health``
        rollup, ``slo``, the ``timeline`` counters, the routing section
        with its per-phase pools, the ``disagg`` rollup and the pipelines
        with their nodes."""
        from parallax_tpu_torch.obs.device import merge_device
        from parallax_tpu_torch.obs.goodput import merge_goodput
        from parallax_tpu_torch.obs.registry import (
            merge_histogram_snapshots,
            summarize_snapshots,
        )
        from parallax_tpu_torch.obs.watchdog import worst_status

        report = self.manager.capacity_report()
        report["bootstrapped"] = self.bootstrapped.is_set()
        # Cluster-wide latency percentiles from every node's heartbeat
        # histogram snapshots.
        node_snaps = [
            n.metrics for p in self.manager.pipelines for n in p.nodes
            if n.metrics
        ]
        merged_snaps = None
        if node_snaps:
            merged_snaps = merge_histogram_snapshots(node_snaps)
            report["metrics"] = summarize_snapshots(merged_snaps)
        all_nodes = [n for p in self.manager.pipelines for n in p.nodes]
        cluster_goodput = merge_goodput(
            [n.goodput for n in all_nodes if n.goodput]
        )
        if cluster_goodput is not None:
            report["goodput"] = cluster_goodput
        # Device plane: classes and families unioned, bytes summed, the
        # invariant ANDed; a node without a payload is a counted skip.
        cluster_device = merge_device([n.device for n in all_nodes])
        if cluster_device is not None:
            report["device"] = cluster_device
        health_reports = {
            n.node_id: n.health for n in all_nodes if n.health
        }
        if health_reports:
            report["health"] = {
                "status": worst_status(
                    h.get("status") for h in health_reports.values()
                ),
                "sick_nodes": sorted(
                    nid for nid, h in health_reports.items()
                    if h.get("status") in ("degraded", "stalled")
                ),
            }
        if self.slo_tracker is not None:
            req_counts = (cluster_goodput or {}).get("requests") or {}
            report["slo"] = self.slo_tracker.observe_and_evaluate({
                "hists": merged_snaps or {},
                "finished": req_counts.get("finished") or 0,
                "aborted": req_counts.get("aborted") or 0,
            })
        # Timeline counters (the events live at /debug/timeline).
        report["timeline"] = {
            "ingested": self.timeline.ingested,
            "gaps": self.timeline.gaps,
            "resets": self.timeline.resets,
        }
        with self._lock:
            accuracy = dict(self.routing_accuracy)
            disagg = dict(self.disagg_stats)
        from parallax_tpu_torch.qos.autoscaler import pool_report

        pipelines = self.manager.pipelines
        # Shared with the QoS autoscaler: the numbers read here are those
        # the re-roling loop acts on.
        pools = pool_report(pipelines)
        report["routing"] = {
            "strategy": self.routing_name,
            "decisions": dict(self.router.decision_counters),
            "pipeline_dispatches": {
                str(pid): n
                for pid, n in self.router.pipeline_dispatches.items()
            },
            "predicted_vs_actual": accuracy,
            "pools": pools,
            "queued_unrouted": self._requests.qsize(),
        }
        # Disaggregated serving: active when a prefill pool and a
        # decode-capable pool are both registered.
        report["disagg"] = {
            "active": "prefill" in pools
            and any(r in pools for r in ("decode", "mixed")),
            **disagg,
        }
        # The QoS control plane: cluster shed state and burn, the class
        # table and the autoscaler's re-role ledger. Absent when QoS is off.
        if self.qos_controller is not None:
            report["qos"] = {
                "enabled": True,
                "classes": [
                    {"name": c.name, "priority": c.priority,
                     "deadline_ms": c.deadline_ms,
                     "sheddable": c.sheddable}
                    for c in self.qos_config.classes
                ],
                "admission": self.qos_controller.payload(),
                "autoscaler": (
                    self.autoscaler.payload()
                    if self.autoscaler is not None
                    else {"enabled": False}
                ),
            }
        report["pipelines"] = [
            {
                "id": p.pipeline_id,
                "role": p.role,
                "nodes": [
                    {
                        "node_id": n.node_id,
                        "layers": [n.start_layer, n.end_layer],
                        "load": n.load,
                        "ready": n.is_ready,
                        "role": n.role,
                        "suspect": n.suspect,
                        "health": n.health,
                        "goodput": n.goodput,
                        "device": n.device,
                        "step_timing": n.step_timing,
                        "cache_stats": n.cache_stats,
                        "kernel": n.kernel,
                        "spec": n.spec,
                        "constrained": n.constrained,
                        "transport": n.transport,
                        "wire_formats": list(n.wire_formats),
                        "cache_index": {
                            "digests": len(n.cache_index),
                            "block": n.cache_index.block,
                        } if len(n.cache_index) else None,
                    }
                    for n in p.nodes
                ],
            }
            for p in pipelines
        ]
        # Node-churn robustness: drain directives issued, migration
        # targets chosen, restores reported back by target heads.
        with self._lock:
            report["migrations"] = dict(self.migration_stats)
            # Weight refit (port only): the version registered and the one
            # each node's heartbeats report; routing skips the laggards.
            report["refit"] = {
                "version": self.refit_version,
                "nodes": {n.node_id: n.refit_version
                          for n in self.manager.nodes()},
            }
        return report

    def _log_allocation(self, event: str) -> None:
        for p in self.manager.pipelines:
            logger.info(
                "%s: pipeline %d = %s",
                event,
                p.pipeline_id,
                " -> ".join(
                    f"{n.node_id}[{n.start_layer},{n.end_layer})"
                    for n in p.nodes
                ),
            )
