"""Control-plane RPC service: nodes <-> GlobalScheduler (port of
``parallax_tpu/backend/scheduler_service.py``).

Capability parity: reference ``src/backend/server/rpc_connection_handler.py``
(node_join blocking until allocation <=300 s, node_update heartbeat with
reallocation piggyback + auto-rejoin, node_leave) and the
``SchedulerManage`` glue (scheduler_manage.py:185-200).

The replies keep the JAX service's keys (``start_layer`` / ``end_layer``,
``standby``, ``rejoin``, ``want_digests``, ``digests_resync``, ``drain``,
``model_name``, ``epoch``, ``standbys``, ``role``). ``node_join`` takes the
worker's phase role (prefill, decode or mixed). Live migration's RPCs are
served: ``migrate_target`` (CacheIndex-scored destinations for a head's
parked requests), ``migration_done`` (a target restored one) and
``where_is`` (where a migrated request lives now), and so is the KV
handoff's ``disagg_target`` (decode-pool destinations for a prefill head's
finished prompts).

Scheduler HA (docs/ha.md), as in the JAX service: every MUTATING handler
is guarded by :meth:`SchedulerService._ha_blocked` — a passive
(warm-standby mirror) or fenced (superseded old primary) scheduler
answers ``{"not_primary": True, "epoch": N}`` and the workers' failover
wrapper rotates to the promoted peer. Read-only lookups (``where_is``)
stay open on a mirror. Heartbeats carry the worker's highest-seen epoch;
a primary hearing a higher epoch than its own fences itself before
touching state. ``ha_sync`` serves a standby's journal pull.
"""

from __future__ import annotations

import time

from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.p2p.transport import Transport
from parallax_tpu_torch.scheduling.request_routing import RequestMeta
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.utils.hw import HardwareInfo

logger = get_logger(__name__)


def _dict_or_none(payload: dict, key: str) -> dict | None:
    value = payload.get(key)
    return value if isinstance(value, dict) else None


class SchedulerService:
    """Exposes a GlobalScheduler over the transport RPC surface."""

    def __init__(
        self,
        scheduler: GlobalScheduler,
        transport: Transport,
        join_timeout_s: float = 300.0,
        standby_addrs: list[str] | None = None,
    ):
        self.scheduler = scheduler
        self.transport = transport
        self.join_timeout_s = join_timeout_s
        # Standby address list advertised on allocations / heartbeat
        # replies so every worker learns the failover targets from the
        # primary itself (--scheduler-standby).
        self.standby_addrs = list(standby_addrs or [])
        transport.register(proto.NODE_JOIN, self._on_join)
        transport.register(proto.NODE_UPDATE, self._on_update)
        transport.register(proto.NODE_LEAVE, self._on_leave)
        transport.register(proto.REQUEST_COMPLETE, self._on_request_complete)
        transport.register(proto.PEER_DOWN, self._on_peer_down)
        transport.register(proto.ROUTE_REQUEST, self._on_route_request)
        transport.register(proto.MIGRATE_TARGET, self._on_migrate_target)
        transport.register(proto.DISAGG_TARGET, self._on_disagg_target)
        transport.register(proto.MIGRATION_DONE, self._on_migration_done)
        transport.register(proto.WHERE_IS, self._on_where_is)
        # Scheduler HA: the standby's journal pull.
        transport.register(proto.HA_SYNC, self._on_ha_sync)
        transport.register("__ping__", lambda *_: "pong")

    def start(self) -> None:
        self.transport.start()
        if not self.scheduler.passive:
            # A standby's scheduler threads start at promotion, not here
            # — the mirror must not sweep heartbeats it never receives.
            self.scheduler.start()

    def stop(self) -> None:
        self.scheduler.stop()
        self.transport.stop()

    # -- HA guards ----------------------------------------------------------

    def _ha_blocked(self) -> bool:
        """True when this scheduler must refuse mutations: a passive
        standby mirror, or an old primary fenced off by a promotion."""
        return self.scheduler.passive or self.scheduler.fenced

    def _not_primary(self) -> dict:
        return {"not_primary": True, "epoch": self.scheduler.epoch}

    # -- handlers (run on transport worker threads) -------------------------

    def _on_join(self, _peer: str, payload: dict) -> dict:
        """Blocks until the node has an allocation, or returns a STANDBY
        acknowledgement: once the swarm is bootstrapped, an unneeded
        joiner goes to standby and receives layers via heartbeat replies
        when the topology changes."""
        if self._ha_blocked():
            return self._not_primary()
        node_id = payload["node_id"]
        hw = HardwareInfo.from_dict(payload["hardware"])
        self.scheduler.enqueue_join(
            node_id, hw,
            wire_formats=(
                [str(f) for f in payload["wire_formats"]]
                if isinstance(payload.get("wire_formats"), (list, tuple))
                else None
            ),
            # Phase role: prefill / decode / mixed; absent on older
            # builds -> mixed.
            role=(
                str(payload["role"])
                if isinstance(payload.get("role"), str) else None
            ),
        )
        deadline = time.monotonic() + self.join_timeout_s
        while time.monotonic() < deadline:
            alloc = self.scheduler.get_node_allocation(node_id)
            if alloc is not None:
                return self._with_model(alloc)
            if self.scheduler.bootstrapped.is_set():
                grace = time.monotonic() + 2.0
                while time.monotonic() < grace:
                    alloc = self.scheduler.get_node_allocation(node_id)
                    if alloc is not None:
                        return self._with_model(alloc)
                    time.sleep(0.05)
                return self._with_epoch({"standby": True})
            time.sleep(0.05)
        return {"error": "no allocation within timeout"}

    def _with_model(self, alloc: dict) -> dict:
        """Allocations carry the serving model's name."""
        alloc = dict(alloc)
        alloc["model_name"] = self.scheduler.model.model_name
        return self._with_epoch(alloc)

    def _with_epoch(self, reply: dict) -> dict:
        """Every scheduler reply carries the epoch (fencing signal for
        workers' failover wrappers) and the standby address list."""
        reply["epoch"] = self.scheduler.epoch
        if self.standby_addrs:
            reply["standbys"] = list(self.standby_addrs)
        return reply

    def _on_update(self, _peer: str, payload: dict) -> dict:
        # Fencing check BEFORE the guard: a worker echoing an epoch higher
        # than ours is proof a standby promoted past us — we must fence
        # even (especially) if we still think we are primary.
        echoed = payload.get("epoch")
        if (
            isinstance(echoed, int)
            and echoed > self.scheduler.epoch
            and not self.scheduler.passive
        ):
            self.scheduler.fence(echoed)
        if self._ha_blocked():
            return self._not_primary()
        node_id = payload["node_id"]
        if self.scheduler.manager.get(node_id) is None:
            # Auto-rejoin after scheduler restart/eviction (reference
            # rpc_connection_handler.py:71-113).
            if "hardware" in payload:
                self.scheduler.enqueue_join(
                    node_id, HardwareInfo.from_dict(payload["hardware"])
                )
            return self._with_epoch({"rejoin": True})
        self.scheduler.enqueue_update(
            node_id,
            layer_latency_ms=payload.get("layer_latency_ms"),
            load=payload.get("load"),
            rtt_s=payload.get("rtt_s"),
            is_ready=payload.get("is_ready"),
            refit_version=payload.get("refit_version"),
            lora_adapters=(
                [str(a) for a in payload["lora_adapters"]]
                if isinstance(payload.get("lora_adapters"), (list, tuple))
                else None
            ),
            step_timing=_dict_or_none(payload, "step_timing"),
            cache_stats=_dict_or_none(payload, "cache_stats"),
            kernel=_dict_or_none(payload, "kernel"),
            spec=_dict_or_none(payload, "spec"),
            constrained=_dict_or_none(payload, "constrained"),
            transport=_dict_or_none(payload, "transport"),
            # Histogram snapshots (merged into cluster percentiles) and
            # the flight-event batch (the cluster timeline).
            metrics=_dict_or_none(payload, "metrics"),
            events=_dict_or_none(payload, "events"),
            # Prefix-digest delta/snapshot (cache-aware routing): folded
            # into the node's scheduler-side CacheIndex.
            cache_digests=_dict_or_none(payload, "cache_digests"),
            # Engine reload in progress: the sweep extends this node's
            # grace instead of declaring a loading worker dead.
            busy=bool(payload["busy"]) if "busy" in payload else None,
            goodput=_dict_or_none(payload, "goodput"),
            device=_dict_or_none(payload, "device"),
            health=_dict_or_none(payload, "health"),
        )
        alloc = self._with_model(
            self.scheduler.get_node_allocation(node_id) or {})
        alloc["refit_version"] = self.scheduler.refit_version
        alloc["refit_index"] = (
            self.scheduler.refit_index
            if (payload.get("refit_version") or 0)
            < self.scheduler.refit_version
            else None
        )
        if self.scheduler.digests_resync_requested(node_id):
            # A delta arrived out of sequence: the worker's next beat
            # must carry a full digest snapshot.
            alloc["digests_resync"] = True
        drain = self.scheduler.drain_requested(node_id)
        if drain:
            # A pipeline through these dead peers is dissolving.
            alloc["drain"] = drain
        return alloc

    def _on_leave(self, _peer: str, payload: dict):
        if self._ha_blocked():
            return self._not_primary()
        self.scheduler.enqueue_leave(payload["node_id"])
        return "ok"

    def _on_request_complete(self, _peer: str, payload: dict):
        if self._ha_blocked():
            return self._not_primary()
        self.scheduler.complete_request(
            payload.get("path") or [],
            request_id=payload.get("rid"),
            cached_tokens=payload.get("cached_tokens"),
        )
        return "ok"

    def _on_peer_down(self, _peer: str, payload: dict):
        """A worker's async sender declared a next-hop peer dead: mark
        its CacheIndex stale immediately and accelerate its sweep."""
        if self._ha_blocked():
            return self._not_primary()
        self.scheduler.enqueue_peer_down(
            str(payload.get("reporter") or _peer or "?"),
            str(payload["peer"]),
            str(payload.get("reason") or ""),
        )
        return "ok"

    def _on_migrate_target(self, _peer: str, payload: dict) -> dict:
        """Destinations for a head's parked requests, scored against each
        surviving head's CacheIndex mirror."""
        if self._ha_blocked():
            return self._not_primary()
        reqs = payload.get("requests")
        if not isinstance(reqs, list):
            return {"targets": {}}
        exclude = {str(x) for x in (payload.get("exclude") or ())}
        return {
            "targets": self.scheduler.choose_migration_targets(
                [r for r in reqs if isinstance(r, dict)], exclude
            )
        }

    def _on_disagg_target(self, _peer: str, payload: dict) -> dict:
        """Decode-pool destinations for a prefill head's finished prompts
        (the KV handoff): migrate_target's CacheIndex scoring, restricted
        to decode / mixed pipelines. An empty map tells the head to keep
        the request local."""
        if self._ha_blocked():
            return self._not_primary()
        reqs = payload.get("requests")
        if not isinstance(reqs, list):
            return {"targets": {}}
        exclude = {str(x) for x in (payload.get("exclude") or ())}
        return {
            "targets": self.scheduler.choose_migration_targets(
                [r for r in reqs if isinstance(r, dict)], exclude,
                pool="decode",
            )
        }

    def _on_migration_done(self, _peer: str, payload: dict):
        """A target head restored a migrated request: record where it lives
        now so pollers that lost the old head can follow."""
        if self._ha_blocked():
            return self._not_primary()
        rid, head = payload.get("rid"), payload.get("head")
        if isinstance(rid, str) and isinstance(head, str):
            self.scheduler.record_migration(rid, head)
        return "ok"

    def _on_where_is(self, _peer: str, payload: dict) -> dict:
        # Deliberately NOT guarded: the migration table is read-only here,
        # and a standby's mirror answering pollers during the promotion
        # window shortens the stream gap.
        head = self.scheduler.migrated_head(str(payload.get("rid") or ""))
        return {"head": head} if head else {}

    # -- scheduler HA (docs/ha.md) -------------------------------------------

    def _on_ha_sync(self, _peer: str, payload: dict) -> dict:
        """Standby journal pull (doubles as the lease probe): reply with
        the journal records past the standby's applied seq, or a full
        snapshot when the ring already evicted that window; register the
        caller for push replication either way."""
        if self._ha_blocked():
            return self._not_primary()
        journal = self.scheduler.journal
        if journal is None:
            return {"error": "journal not enabled on this scheduler"}
        try:
            from_seq = int(payload.get("from_seq") or 0)
        except (TypeError, ValueError):
            from_seq = 0
        standby_id = str(payload.get("node_id") or _peer or "standby")
        journal.attach(standby_id)
        records, contiguous = journal.records_since(from_seq)
        if not contiguous:
            from parallax_tpu_torch.ha.journal import snapshot_state

            return self._with_epoch(
                {"snapshot": snapshot_state(self.scheduler)}
            )
        return self._with_epoch({"seq": journal.seq, "records": records})

    def _on_route_request(self, _peer: str, payload: dict) -> dict:
        """RPC twin of :meth:`route_request` for clients whose in-process
        scheduler handle is passive, fenced or absent (the SwarmClient
        after a standby promotion)."""
        if self._ha_blocked():
            return self._not_primary()
        rid = payload.get("rid")
        if not isinstance(rid, str):
            return {}
        try:
            age_ms = float(payload.get("arrival_age_ms") or 0.0)
        except (TypeError, ValueError):
            age_ms = 0.0
        try:
            timeout_s = float(payload.get("timeout_s") or 10.0)
        except (TypeError, ValueError):
            timeout_s = 10.0
        prompt_ids = payload.get("prompt_ids")
        path = self.route_request(
            rid,
            timeout_s=min(timeout_s, self.join_timeout_s),
            prompt_ids=(
                [int(t) for t in prompt_ids]
                if isinstance(prompt_ids, (list, tuple)) else None
            ),
            lora_id=(
                str(payload["lora_id"])
                if isinstance(payload.get("lora_id"), str) else None
            ),
            arrival_time=time.monotonic() - age_ms / 1e3,
            tenant_id=(
                str(payload["tenant_id"])
                if isinstance(payload.get("tenant_id"), str) else None
            ),
            qos_class=(
                str(payload["qos_class"])
                if isinstance(payload.get("qos_class"), str) else None
            ),
        )
        if path is None:
            return self._with_epoch({})
        return self._with_epoch({"path": path})

    # -- routing for the HTTP plane -----------------------------------------

    def route_request(self, request_id: str, timeout_s: float = 5.0,
                      prompt_ids: list[int] | None = None,
                      lora_id: str | None = None,
                      arrival_time: float | None = None,
                      tenant_id: str | None = None,
                      qos_class: str | None = None) -> list[str] | None:
        """Block until the dispatcher assigns a node path (reference
        scheduler_manage.get_routing_table, scheduler_manage.py:287-313).
        ``prompt_ids`` (already tokenized by the HTTP frontend) feed the
        cache-aware router."""
        if self._ha_blocked():
            # A mirror's dispatch thread isn't running; blocking here
            # would burn the caller's whole timeout for nothing.
            return None
        meta = RequestMeta(
            request_id, prompt_ids=prompt_ids, lora_id=lora_id,
            tenant_id=tenant_id, qos_class=qos_class,
        ) if prompt_ids else None
        pr = self.scheduler.receive_request(
            request_id, meta=meta, arrival_time=arrival_time,
        )
        if not pr.event.wait(timeout_s):
            # Caller gives up: mark cancelled so a late dispatch does not
            # charge node load for a path nobody will use.
            pr.cancelled = True
            return None
        return pr.path_ids
