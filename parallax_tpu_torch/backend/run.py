"""Swarm serving: the global scheduler, its RPC service and the OpenAI
HTTP frontend (``run``), and the chat host (``chat-host``) — port of
``parallax_tpu/backend/run.py``.

    python -m parallax_tpu_torch run --model-name DIR --min-nodes 2 \\
        --port 3001 [--routing cache_aware]
    python -m parallax_tpu_torch chat-host --head 10.0.0.1:7000 --port 8000

``run`` serves the HTTP API on ``--port`` and the scheduler's RPC on
``--port + 1`` (``join --scheduler-addr HOST:PORT+1``): each request is
routed to a pipeline, handed to its head worker over RPC, and its tokens
are polled back for the frontend. A chat host fronts a scheduler-less
swarm's head worker instead, with an empty routing table (the head routes
it from its gossip). Neither touches the card.

Scheduler HA, as in the JAX ``run`` (docs/ha.md): ``--scheduler-standby
S1,S2`` journals the scheduler's state, advertises the standbys to every
worker and routes the frontend through them once this scheduler is
fenced; ``--standby-of P`` runs a passive mirror plus a
``StandbyScheduler`` tailing P, which promotes itself after
``--ha-lease-s`` of silence. Until then the mirror's frontend answers 503
(no route), and ``/cluster/status_json`` the mirror's state.

The scheduler's transport is the swarm's relay: a ``join --relay`` worker
registers its reverse route there, and ``--relay-token`` is the secret
every registration must present. ``POST /scheduler/init`` switches the
served model live (:func:`make_scheduler_init_fn`): a fresh
``GlobalScheduler`` for the new model replaces the running one, the
workers rejoin and reload, and the frontend's tokenizer and
``/v1/models`` follow. The web UI is served at ``/ui``. The frontend
serves the JAX ``run``'s observability hooks: ``--slo`` objectives in
``/cluster/status``, the cluster ``/debug/timeline``, a deep ``/healthz``
over the workers' watchdogs, ``/debug/device`` as the cluster merge plus
each node's payload, and ``/profile/start|stop`` with a ``pipeline`` body
fanned out to every stage over the ``PROFILE`` RPC. ``--qos`` runs the
cluster QoS plane (the admission controller's ``qos_shed`` verdict, the
pool autoscaler with ``autoscale=1``, the class headers at the frontend,
class, tenant and remaining deadline through the route RPC and the head
submit), and ``--routing-gamma`` the cache-aware router's per-tenant
fairness term. The poll loop
follows a live migration (``{"migrated": head}`` from the old head, or the
scheduler's ``where_is``) and resumes a request whose path died after it
streamed tokens by resubmitting those tokens as ``replay_ids``, as the JAX
client does.
"""

from __future__ import annotations

import os
import signal
import threading
import time

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.backend.http_server import (
    OpenAIFrontend,
    load_tokenizer,
)
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.ha.backoff import Backoff, BackoffPolicy
from parallax_tpu_torch.ha.failover import SchedulerFailover
from parallax_tpu_torch.ha.journal import StateJournal, install_journal
from parallax_tpu_torch.ha.standby import StandbyScheduler
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.p2p.transport import TcpTransport, Transport
from parallax_tpu_torch.runtime.request import Request, RequestStatus
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from parallax_tpu_torch.utils import get_logger, unported

logger = get_logger(__name__)

# The poll loop's retry between failed polls of a head (full jitter from
# 0.25 s, capped at 2 s, as the JAX client's).
POLL_RETRY = BackoffPolicy(base_s=0.25, cap_s=2.0)


class SwarmClient:
    """Submits requests to head nodes over the transport and mirrors token
    progress back into the local Request (the HTTP frontend streams from
    it). Capability parity: reference RequestHandler forwarding + SSE relay
    (request_handler.py:100-245).

    Routing goes through ``service`` (an in-process scheduler) while it
    is primary, or over the ``route_request`` RPC against
    ``scheduler_peers`` through the failover rotation (the primary and its
    standbys: a dead scheduler or a ``not_primary`` answer rotates to the
    next), or — with neither — to ``default_head`` with an empty routing
    table (a chat host in front of a scheduler-less swarm)."""

    def __init__(self, transport: Transport,
                 service: SchedulerService | None = None,
                 poll_interval_s: float = 0.02,
                 default_head: str | None = None,
                 scheduler_peers: list[str] | None = None):
        self.transport = transport
        self.service = service
        self.poll_interval_s = poll_interval_s
        self.default_head = default_head
        # Scheduler HA (docs/ha.md): when the in-process scheduler goes
        # passive / fenced (a standby elsewhere promoted), route / release
        # / where_is fall back to RPC against this failover rotation, so
        # the HTTP frontend keeps admitting through the promoted peer.
        self.sched_transport: SchedulerFailover | None = None
        if scheduler_peers:
            self.sched_transport = SchedulerFailover(transport,
                                                     scheduler_peers)
        # rid -> head node id, for stop-string early finish.
        self._heads: dict[str, str] = {}
        # rid -> monotonic arrival at routing time: a path that dies
        # before the first token is re-routed, and the re-enqueue carries
        # the ORIGINAL arrival.
        self._arrivals: dict[str, float] = {}

    def _local_primary(self) -> bool:
        """True while the in-process scheduler may route / mutate: not a
        passive standby mirror, not fenced off by a promotion."""
        svc = self.service
        return svc is not None and not (
            svc.scheduler.passive or svc.scheduler.fenced
        )

    def route(self, request_id: str,
              prompt_ids: list[int] | None = None,
              lora_id: str | None = None,
              tenant_id: str | None = None,
              qos_class: str | None = None) -> list[str] | None:
        """The request's node path; None when no pipeline is serviceable
        (the frontend's retryable 503)."""
        if self.service is None and self.sched_transport is None:
            # Chat-host mode: probe the head's readiness so a still-loading
            # or route-less swarm maps to the frontend's 503.
            if self.default_head is None:
                return None
            try:
                r = self.transport.call(
                    self.default_head, proto.CHAT_READY, None, timeout=5.0
                )
            except Exception:
                return None
            return [] if isinstance(r, dict) and r.get("ready") else None
        if lora_id is not None:
            raise unported("LoRA requests (lora_id)", 11)
        self._arrivals[request_id] = time.monotonic()
        path = self._route_any(request_id, prompt_ids=prompt_ids,
                               tenant_id=tenant_id, qos_class=qos_class)
        if not path:
            # No submit will follow to retire the entry via _poll_loop.
            self._arrivals.pop(request_id, None)
        return path

    def _route_any(self, request_id: str,
                   prompt_ids: list[int] | None = None,
                   arrival_time: float | None = None,
                   tenant_id: str | None = None,
                   qos_class: str | None = None) -> list[str] | None:
        """Route in-process while the local scheduler is primary, over RPC
        against the failover rotation otherwise (docs/ha.md)."""
        if self._local_primary():
            return self.service.route_request(
                request_id, timeout_s=10.0, prompt_ids=prompt_ids,
                arrival_time=arrival_time, tenant_id=tenant_id,
                qos_class=qos_class,
            )
        if self.sched_transport is None:
            return None
        age_ms = 0.0
        if arrival_time is not None:
            age_ms = max(0.0, (time.monotonic() - arrival_time) * 1e3)
        try:
            reply = self.sched_transport.call(
                self.sched_transport.active_peer, proto.ROUTE_REQUEST,
                {
                    "rid": request_id,
                    "prompt_ids": prompt_ids,
                    "lora_id": None,
                    "tenant_id": tenant_id,
                    "qos_class": qos_class,
                    # Monotonic clocks do not survive the process hop:
                    # ship the AGE so the scheduler re-anchors arrival.
                    "arrival_age_ms": age_ms,
                    "timeout_s": 10.0,
                },
                timeout=15.0,
            )
        except Exception as e:
            logger.warning("route_request RPC failed: %s", e)
            return None
        path = (reply or {}).get("path")
        return [str(x) for x in path] if path else None

    def _release_path(self, path: list[str] | None) -> None:
        """Release a routed path's load charge: in-process while the local
        scheduler is primary, over RPC otherwise (the charge lives on
        whichever scheduler routed or inherited the request; a promoted
        standby rebuilt it from the journal)."""
        if not path:
            return
        if self._local_primary():
            try:
                self.service.scheduler.complete_request(list(path))
            except Exception:
                logger.exception("releasing path %s", path)
            return
        if self.sched_transport is None:
            return
        try:
            self.sched_transport.call(
                self.sched_transport.active_peer, proto.REQUEST_COMPLETE,
                {"path": list(path)}, timeout=5.0,
            )
        except Exception as e:
            logger.warning("request_complete RPC failed: %s", e)

    @staticmethod
    def _submit_payload(request: Request, path: list[str]) -> dict:
        return {
            "rid": request.request_id,
            "prompt_ids": request.prompt_ids,
            "sampling_params": request.sampling_params.to_dict(),
            "routing_table": list(path),
            "eos_token_ids": list(request.eos_token_ids),
            "lora_id": request.lora_id,
            **SwarmClient._qos_payload(request),
        }

    @staticmethod
    def _qos_payload(request: Request) -> dict:
        """QoS context for a head submit: class and tenant verbatim, the
        deadline as a REMAINING budget (absolute monotonic values do not
        survive the process hop). Empty for untagged requests."""
        out: dict = {}
        if request.qos_class is not None:
            out["qos_class"] = request.qos_class
        if request.deadline is not None:
            out["deadline_ms"] = max(
                0.0, (request.deadline - time.monotonic()) * 1e3)
        if request.tenant_id is not None:
            out["tenant"] = request.tenant_id
        return out

    def submit(self, request: Request) -> threading.Event:
        if request.routing_table:
            head = request.routing_table[0]
        elif self.default_head is not None:
            head = self.default_head
        else:
            raise RuntimeError("request has no routing table")
        try:
            self.transport.call(
                head, proto.CHAT_SUBMIT,
                self._submit_payload(request, request.routing_table),
                timeout=30.0)
        except Exception:
            # The workers never saw this request; release the load the
            # dispatcher charged for the path.
            self._release_path(list(request.routing_table))
            raise RuntimeError(f"head node {head} unreachable")
        ev = threading.Event()
        self._heads[request.request_id] = head
        t = threading.Thread(
            target=self._poll_loop, args=(request, head, ev), daemon=True
        )
        t.start()
        return ev

    def stop(self, request_id: str) -> None:
        """Ask the head node to finish a request early (stop-string match);
        best-effort."""
        head = self._heads.get(request_id)
        if head is None:
            return
        try:
            self.transport.call(
                head, proto.CHAT_STOP, {"rid": request_id}, timeout=10.0
            )
        except Exception as e:
            logger.warning("chat_stop failed for %s: %s", request_id, e)

    def _poll_loop(self, request: Request, head: str, ev: threading.Event):
        try:
            self._poll_until_done(request, head, ev)
        finally:
            self._heads.pop(request.request_id, None)
            self._arrivals.pop(request.request_id, None)

    def _migrated_head(self, request_id: str) -> str | None:
        """The scheduler's where_is table: targets report restored
        requests there, so a poller whose OLD head died after shipping
        still finds the new one. A local PASSIVE mirror may answer too
        (migration_done records replicate through the journal); falls back
        to the ``where_is`` RPC against the failover rotation."""
        if self.service is not None:
            moved = self.service.scheduler.migrated_head(request_id)
            if moved:
                return moved
        if self.sched_transport is None or self._local_primary():
            return None
        try:
            reply = self.sched_transport.call(
                self.sched_transport.active_peer, proto.WHERE_IS,
                {"rid": request_id}, timeout=5.0,
            )
        except Exception:
            return None
        head = (reply or {}).get("head")
        return str(head) if head else None

    def _reroute(self, request: Request) -> str | None:
        """Post-dispatch rung of the retry ladder: the routed path died, so
        release its load charge, re-enqueue with the ORIGINAL arrival time
        and resubmit to the new head. A request that already streamed
        tokens resubmits them as ``replay_ids``: teacher-forced through
        decode steps on the new head, so the continuation is bit-identical
        and no token is re-sampled. Returns the new head, or None when no
        pipeline is serviceable (the caller then aborts)."""
        rid = request.request_id
        self._release_path(list(request.routing_table))
        try:
            path = self._route_any(rid, prompt_ids=list(request.prompt_ids),
                                   arrival_time=self._arrivals.get(rid),
                                   tenant_id=request.tenant_id,
                                   qos_class=request.qos_class)
        except Exception:
            logger.exception("re-route for %s failed", rid)
            path = None
        if not path:
            # Charge already released above; clear the table so the
            # caller's abort does not release it again.
            request.routing_table[:] = []
            return None
        request.routing_table[:] = path
        head = path[0]
        payload = self._submit_payload(request, path)
        streamed = list(request.output_ids)
        if streamed:
            payload["replay_ids"] = streamed
            if len(request.output_logprobs) == len(streamed):
                payload["replay_logprobs"] = list(request.output_logprobs)
        try:
            self.transport.call(head, proto.CHAT_SUBMIT, payload,
                                timeout=30.0)
        except Exception as e:
            logger.warning("re-routed submit of %s to %s failed: %s",
                           rid, head, e)
            self._release_path(list(path))
            request.routing_table[:] = []
            return None
        logger.info(
            "re-routed %s onto %s (%s)", rid, head,
            f"replaying {len(streamed)} streamed tokens" if streamed
            else "path death before first token",
        )
        return head

    def _poll_until_done(self, request: Request, head: str,
                         ev: threading.Event):
        rid = request.request_id
        failures = 0
        reroutes = 0
        retry = None   # a Backoff, reset to None on a good poll

        def follow_migration(new_head: str) -> str:
            """Switch polling to the head that owns the request now. The
            OLD path's load charge was released by the source head at
            migrate-out and the NEW path's is owned by the target, so the
            stale table must not feed a later abort-time release."""
            request.routing_table[:] = []
            self._heads[rid] = new_head
            return new_head

        def try_recover() -> str | None:
            """Head unreachable or amnesiac: follow a recorded migration
            first; failing that, re-route (bounded attempts). A request
            that already streamed tokens resubmits them as
            ``replay_ids``. Mid-stream re-routing also requires the
            SCHEDULER to have lost the head: a client-side partition to a
            head the scheduler still trusts must not fork the request onto
            a second pipeline while the first keeps decoding it."""
            nonlocal reroutes
            moved = self._migrated_head(rid)
            if moved and moved != head:
                return follow_migration(moved)
            if (self.service is None and self.sched_transport is None) \
                    or reroutes >= 2:
                return None
            if request.output_ids and self.service is not None \
                    and self.service.scheduler.manager.get(head) is not None:
                return None
            reroutes += 1
            return self._reroute(request)

        while True:
            try:
                r = self.transport.call(
                    head, proto.CHAT_POLL, {"rid": rid}, timeout=10.0
                )
                failures = 0
                retry = None
            except Exception as e:
                failures += 1
                if failures % 4 == 0:
                    # The old head may have shipped the request away before
                    # dying: ask the scheduler's where_is table while the
                    # unreachable count accumulates.
                    moved = self._migrated_head(rid)
                    if moved and moved != head:
                        head = follow_migration(moved)
                        failures = 0
                        continue
                if failures > 10:
                    recovered = try_recover()
                    if recovered:
                        head = recovered
                        self._heads[rid] = head
                        failures = 0
                        continue
                    request.abort(f"head node unreachable: {e}")
                    # The worker cannot report completion anymore; release
                    # the path's load charge here (empty after a migration
                    # follow — the target owns that charge).
                    self._release_path(list(request.routing_table))
                    ev.set()
                    return
                # Jittered exponential backoff between failed polls: a head
                # blip with many concurrent pollers must not herd its
                # recovery (docs/ha.md).
                if retry is None:
                    retry = Backoff(POLL_RETRY)
                retry.wait()
                continue
            if r.get("migrated"):
                # Live migration: the request now runs on another head;
                # keep streaming from there.
                head = follow_migration(str(r["migrated"]))
                continue
            if "error" in r:
                recovered = try_recover()
                if recovered:
                    head = recovered
                    self._heads[rid] = head
                    failures = 0
                    continue
                request.abort(r["error"])
                ev.set()
                return
            ids = r["output_ids"]
            if len(ids) > len(request.output_ids):
                request.output_ids[:] = ids
                lps = r.get("output_logprobs")
                if lps:
                    request.output_logprobs[:] = lps
            if r["finished"]:
                request.set_status(RequestStatus(r["status"]),
                                   "client-finish")
                ev.set()
                return
            time.sleep(self.poll_interval_s)


def build_swarm_frontend(
    scheduler: GlobalScheduler,
    transport: TcpTransport,
    tokenizer,
    model_name: str,
    standby_addrs: list[str] | None = None,
    resolve_model=None,
    tokenizer_fn=None,
    device_memory_bytes: int | None = None,
    qos_config=None,
) -> tuple[OpenAIFrontend, SchedulerService, SwarmClient]:
    """The scheduler host's frontend: the RPC service over ``transport``
    and the OpenAI API routing through it, with ``/cluster/status_json``
    and ``/cluster/status`` serving the scheduler's core
    ``cluster_status()``. With ``standby_addrs`` the service advertises
    them and the client gets the failover rotation over them: once this
    scheduler is fenced (a standby promoted past it), routing goes over
    RPC to the promoted peer instead of 503ing the frontend. With
    ``resolve_model(name) -> ModelConfig`` the frontend serves
    ``/scheduler/init`` (:func:`make_scheduler_init_fn`), its tokenizer
    following ``tokenizer_fn(name)``. ``qos_config`` makes the frontend
    parse the QoS headers and body fields."""
    service = SchedulerService(scheduler, transport,
                               standby_addrs=standby_addrs)
    client = SwarmClient(transport, service,
                         scheduler_peers=list(standby_addrs or []) or None)

    def timeline(fmt: str, limit: int):
        tl = service.scheduler.timeline
        if fmt == "chrome":
            return tl.export_chrome()
        return tl.snapshot(limit=limit)

    def healthz():
        # Deep cluster health: ``stalled`` (503) only when every pipeline
        # is blocked by a stalled member, so a liveness probe never
        # restarts a healthy scheduler frontend over one sick worker among
        # replicas; a sick worker shows as ``degraded`` with the per-node
        # detail.
        from parallax_tpu_torch.obs.watchdog import worst_status

        sched = service.scheduler
        pipelines = sched.manager.pipelines
        nodes = {
            n.node_id: n.health
            for p in pipelines for n in p.nodes
            if n.health
        }
        cluster = worst_status(h.get("status") for h in nodes.values())
        pipe_status = [
            worst_status((n.health or {}).get("status") for n in p.nodes)
            for p in pipelines
        ]
        if pipe_status and all(s == "stalled" for s in pipe_status):
            status = "stalled"
        elif cluster != "ok":
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "cluster_status": cluster,
            "bootstrapped": sched.bootstrapped.is_set(),
            "components": {
                nid: h.get("components") or {} for nid, h in nodes.items()
            },
            "causes": [
                f"{nid}: {c}"
                for nid, h in nodes.items()
                for c in (h.get("causes") or ())
            ],
        }

    def device():
        # The cluster merge plus each node's raw heartbeat payload.
        from parallax_tpu_torch.obs.device import merge_device

        sched = service.scheduler
        nodes = [n for p in sched.manager.pipelines for n in p.nodes]
        return {
            "cluster": merge_device([n.device for n in nodes]),
            "nodes": {n.node_id: n.device for n in nodes if n.device},
        }

    def profile_cluster(action: str, pipeline, out_dir, max_seconds):
        # Every stage of the chosen pipeline(s) starts / stops its trace
        # over RPC, so the whole serving path profiles one wall-clock
        # window. A node's failure lands in the manifest instead of
        # aborting the fan-out: a half-started profile stays stoppable.
        sched = service.scheduler
        pipelines = sched.manager.pipelines
        if pipeline in ("all", "*"):
            chosen = list(pipelines)
        else:
            chosen = [p for p in pipelines
                      if str(p.pipeline_id) == str(pipeline)]
            if not chosen:
                raise ValueError(
                    f"unknown pipeline {pipeline!r} (have: "
                    f"{[str(p.pipeline_id) for p in pipelines]} or "
                    f"\"all\")"
                )
        targets, seen = [], set()
        for p in chosen:
            for n in p.nodes:
                if n.node_id not in seen:
                    seen.add(n.node_id)
                    targets.append(n)
        if not targets:
            raise ValueError("no pipeline stages to profile")
        manifest = []
        for n in targets:
            payload = {"action": action}
            if action == "start":
                payload["dir"] = out_dir
                payload["max_seconds"] = max_seconds
            try:
                r = transport.call(n.node_id, proto.PROFILE, payload,
                                   timeout=60.0)
            except Exception as e:
                r = {"node_id": n.node_id, "error": str(e)}
            if not isinstance(r, dict):
                r = {"node_id": n.node_id, "error": f"bad reply {r!r}"}
            manifest.append(r)
        return manifest

    frontend = OpenAIFrontend(
        tokenizer,
        submit_fn=client.submit,
        route_fn=client.route,
        status_fn=lambda: service.scheduler.cluster_status(),
        model_name=model_name,
        stop_fn=client.stop,
        device_memory_bytes=device_memory_bytes,
        healthz_fn=healthz,
        timeline_fn=timeline,
        device_fn=device,
        profile_cluster_fn=profile_cluster,
        qos_config=qos_config,
    )
    if resolve_model is not None:
        frontend.scheduler_init_fn = make_scheduler_init_fn(
            service, resolve_model, frontend=frontend,
            tokenizer_fn=tokenizer_fn)
    return frontend, service, client


def make_scheduler_init_fn(service: SchedulerService, resolve_model,
                           frontend: OpenAIFrontend | None = None,
                           tokenizer_fn=None):
    """The model-switch hook of ``/scheduler/init``: a fresh
    ``GlobalScheduler`` for the new model replaces the running service's,
    under a lock (one stop per swap), with the routing strategy and its
    tuning kept. The workers are unknown to it, so their next heartbeat
    gets a rejoin; they resolve the new model (the join reply names it)
    and reload their stage. The frontend's tokenizer follows through
    ``tokenizer_fn``. An unknown model raises ValueError (400)."""
    lock = make_lock("backend.run_frontend")

    def init(model_name: str, init_nodes_num: int) -> dict:
        try:
            model = resolve_model(model_name)
        except KeyError as e:
            raise ValueError(str(e)) from None
        new_tokenizer = tokenizer_fn(model_name) if tokenizer_fn else None
        with lock:
            old = service.scheduler
            new_sched = GlobalScheduler(
                model, min_nodes_bootstrapping=init_nodes_num,
                routing=old.routing_name,
                routing_kwargs=old.routing_kwargs,
                # The QoS classes and autoscaler are service policy too.
                qos=old.qos_config,
            )
            # The SLO objectives and their burn-rate history belong to the
            # service, not the model: they survive a switch.
            new_sched.slo_tracker = old.slo_tracker
            new_sched.start()
            service.scheduler = new_sched
            if frontend is not None and new_tokenizer is not None:
                frontend.tokenizer = new_tokenizer
            try:
                old.stop()
            except Exception:
                logger.exception("stopping the previous scheduler")
        logger.info("scheduler switched to %s (min_nodes=%d)", model_name,
                    init_nodes_num)
        return {"num_layers": model.num_hidden_layers}

    return init


def build_chat_host_frontend(
    head_addr: str,
    tokenizer,
    model_name: str,
    transport: TcpTransport | None = None,
) -> tuple[OpenAIFrontend, SwarmClient]:
    """Standalone chat host on a non-worker machine (reference
    ``node_chat_http_server.py`` + ``launch_chat.py``): the OpenAI API
    proxying to one scheduler-less head worker, which fills in its own
    gossip routing table for the empty table this host submits."""
    if transport is None:
        transport = TcpTransport("", "127.0.0.1")
        transport.start()
        transport.peer_id = transport.address
    client = SwarmClient(transport, default_head=head_addr)
    frontend = OpenAIFrontend(
        tokenizer,
        submit_fn=client.submit,
        route_fn=client.route,
        model_name=model_name,
        stop_fn=client.stop,
    )
    return frontend, client


def _serve_until_signalled(frontend: OpenAIFrontend, host: str, port: int,
                           started) -> None:
    """Run ``frontend`` until SIGINT / SIGTERM (handlers are installed on
    the main thread only) or :meth:`OpenAIFrontend.shutdown`."""
    if threading.current_thread() is threading.main_thread():
        # shutdown() blocks until serve_forever returns: call it off the
        # serving thread.
        def shutdown(*_):
            threading.Thread(target=frontend.shutdown, daemon=True).start()

        signal.signal(signal.SIGINT, shutdown)
        signal.signal(signal.SIGTERM, shutdown)
    frontend.run(host=host, port=port, on_start=started)


def chat_host_main(args, on_start=None) -> int:
    """CLI ``chat-host``: serve the OpenAI API, proxying to a swarm head
    worker, until the frontend shuts down (SIGINT / SIGTERM).
    ``on_start(frontend)`` runs once the socket is bound."""
    tokenizer = load_tokenizer(args.model_path)
    frontend, client = build_chat_host_frontend(
        args.head, tokenizer, args.model_name or "parallax-tpu",
    )

    def started(fe: OpenAIFrontend) -> None:
        logger.info("chat host on :%d -> head %s", fe.port, args.head)
        if on_start is not None:
            on_start(fe)

    try:
        _serve_until_signalled(frontend, args.host, args.port, started)
    finally:
        client.transport.stop()
    return 0


def resolve_model(name: str):
    """``run --model-name``: a checkpoint directory's config, or a preset
    (``models/presets.py``)."""
    from parallax_tpu_torch.config import load_config
    from parallax_tpu_torch.models.presets import get_preset

    if os.path.isdir(name):
        return load_config(name)
    try:
        return get_preset(name)
    except KeyError:
        raise ValueError(f"unknown model {name}")


def run_main(args, on_start=None) -> int:
    """``run`` entry: the scheduler, its RPC service on ``--port + 1`` and
    the HTTP frontend on ``--port``, until SIGINT / SIGTERM. ``--port 0``
    binds both to free ports, logged once the HTTP socket is bound. With
    ``--scheduler-standby`` the scheduler journals to its standbys; with
    ``--standby-of`` it is a passive mirror tailing the primary, whose
    lease arms at start (start the primary first).
    ``on_start(frontend, service)`` runs once the HTTP socket is bound.
    Nothing here touches a device."""
    try:
        model = resolve_model(args.model_name)
    except ValueError as e:
        raise SystemExit(str(e))
    tokenizer = load_tokenizer(
        args.model_name if os.path.isdir(args.model_name) else None
    )
    routing_kwargs = None
    if args.routing in ("cache_aware", "cache-aware"):
        routing_kwargs = {
            "alpha": args.routing_alpha,
            "beta": args.routing_beta,
            "imbalance_threshold": args.routing_imbalance,
            "gamma": args.routing_gamma or 0.0,
        }
    # Scheduler HA (docs/ha.md): --scheduler-standby names the warm
    # standbys this primary replicates to (and advertises to workers);
    # --standby-of flips this process INTO a standby mirror tailing the
    # named primary, promoting itself when the lease expires.
    standby_addrs = [
        p.strip() for p in (args.scheduler_standby or "").split(",")
        if p.strip()
    ]
    standby_of = args.standby_of or None
    slo_config = None
    if args.slo:
        from parallax_tpu_torch.obs.slo import parse_slo_spec

        # Fails fast on a malformed spec: a mistyped objective must not
        # silently track nothing.
        slo_config = parse_slo_spec(args.slo, window_s=args.slo_window_s)
    qos_config = None
    if args.qos:
        from parallax_tpu_torch.qos import parse_qos_spec

        # Fails fast on a malformed spec, like --slo.
        qos_config = parse_qos_spec(args.qos)
    scheduler = GlobalScheduler(
        model, min_nodes_bootstrapping=args.min_nodes,
        routing=args.routing, routing_kwargs=routing_kwargs,
        slo=slo_config,
        qos=qos_config,
        passive=bool(standby_of),
    )
    # The scheduler's transport is the swarm's relay for NAT'd workers.
    transport = TcpTransport("scheduler", args.host,
                             args.port + 1 if args.port else 0,
                             relay_token=args.relay_token)
    frontend, service, _client = build_swarm_frontend(
        scheduler, transport, tokenizer, args.model_name,
        standby_addrs=standby_addrs or None,
        resolve_model=resolve_model,
        tokenizer_fn=lambda name: load_tokenizer(
            name if os.path.isdir(name) else None),
        qos_config=qos_config,
    )
    standby_ctl = None
    if standby_addrs and not standby_of:
        journal = StateJournal(epoch=scheduler.epoch)
        journal.bind(transport)
        install_journal(scheduler, journal)
    elif not standby_of:
        # Without standbys the scheduler remains the swarm's single point
        # of failure: a crash aborts nothing in flight on the workers, but
        # no new requests route until it restarts and the workers rejoin.
        logger.info(
            "scheduler HA standby disabled: no --scheduler-standby "
            "addresses configured — a scheduler crash stalls routing "
            "until restart (docs/ha.md)"
        )
    service.start()
    if standby_of:
        # Built once the RPC plane listens, under the address the primary
        # pushes journal records to (the JAX ``run`` leaves the id at
        # "standby", so its pushes fail and the pulls alone carry the
        # journal).
        standby_ctl = StandbyScheduler(
            scheduler, transport=transport, primary=standby_of,
            lease_s=args.ha_lease_s or 6.0, node_id=transport.address,
        )
        standby_ctl.start()

    def started(fe: OpenAIFrontend) -> None:
        if standby_ctl is not None:
            logger.info(
                "warm standby of %s: mirroring journal, HTTP on :%d "
                "(promotes on lease expiry)", standby_of, fe.port,
            )
        logger.info("scheduler RPC on :%d, HTTP on :%d (min_nodes=%d)",
                    transport.port, fe.port, args.min_nodes)
        if on_start is not None:
            on_start(fe, service)

    try:
        _serve_until_signalled(frontend, args.host, args.port, started)
    finally:
        if standby_ctl is not None:
            standby_ctl.stop()
        # The primary's journal, or the one a promotion installed.
        if scheduler.journal is not None:
            scheduler.journal.stop()
        service.stop()
    return 0
