"""WorkerNode: the per-host serving daemon (port of
``parallax_tpu/p2p/node.py``).

Two modes, as in the JAX package:

- **Scheduler mode** (``scheduler_peer`` set): the worker joins the global
  scheduler (``node_join`` with its ``detect_hardware()`` summary, its wire
  formats and its phase role), builds the layer range the scheduler
  assigns, heartbeats (``node_update``), reloads when a reply moves its
  range, rejoins when asked, reports each finished request
  (``request_complete``) and each peer its sender found dead
  (``peer_down``), and says ``node_leave`` on :meth:`stop`. The head
  serves the routing table the scheduler chose. Every scheduler RPC goes
  through ``ha/failover.SchedulerFailover`` over the primary and its
  warm standbys (``scheduler_standby``, extended by the ``standbys`` the
  primary advertises): a dead primary or a ``not_primary`` answer rotates
  to the next, and heartbeats echo the highest epoch seen, which fences a
  revived old primary (docs/ha.md).
- **Scheduler-less mode** (``scheduler_peer=None``): the worker
  self-assigns its layer range, gossips block announcements over its
  static peers, and — when it hosts layer 0 — computes its own fewest-hops
  routing table from the announcements (reference DHT announce + dijkstra
  routing, ``p2p/server.py:569-626``).

One step thread owns the engine; an inbox queue decouples the transport's
handler threads from it. Worker node ids are their transport addresses
(``host:port``).

Only the step thread touches CUDA: the engine is built there, and its
``host_hidden`` mode hands each step's forwarded hidden rows over as CPU
tensors (one pinned D2H copy a step, waited on there). The sender's
workers, the gossip pool and the transport's threads serialize and
deserialize CPU tensors only; ``_drain_inbox`` moves inbound rows to the
device through ``submit_intermediate``. (One CUDA call from another
thread breaks a global-mode graph capture.) Every engine, the first
allocation's too, is built on the step thread, and a reload drops the old
engine's KV and weights before the new ones load. The heartbeat thread
reads host state only.

Live migration, as in the JAX worker: on a scheduled HEAD, a ``drain``
directive or a dead next hop FLAGS the affected requests (``migrating``:
the local scheduler stops scheduling them); once out of every in-flight
step and window they are PARKED on the step thread — KV preempted to the
host tier and harvested into a checkpoint image where possible, the
request extracted, the old path's mirrors released — then a ship thread
asks the scheduler for a target pipeline (``migrate_target``) and sends
each checkpoint head to head (``rpc_checkpoint``). The target restores it
on its step thread, by KV-image adoption or by re-prefill and
teacher-forced replay, and reports ``migration_done``; pollers follow via
``chat_poll``'s ``{"migrated": head}`` or the scheduler's ``where_is``. A
request nobody takes within ``MIGRATION_PARK_TIMEOUT_S`` aborts with
"migration: no serviceable pipeline". Mirrors and scheduler-less swarms
abort instead (nobody picks a target). ``chat_submit`` with ``replay_ids``
teacher-forces a client's already-streamed tokens. The heartbeat sends
speculation's ledger and None for the planes not ported yet (step timing,
metrics, goodput, device, health, events, constrained decoding). Pipeline
speculation rides FORWARD packets (``spec_len`` on the way down, the last
stage's ``spec_accepted`` back to the head).

Disaggregated prefill / decode, as in the JAX worker: a scheduled worker
joins with ``role`` prefill, decode or mixed (the default, which serves
both phases and hands nothing off). On a prefill-role HEAD each request
that crosses the prefill / decode boundary (prompt KV computed, first
token committed) is FLAGGED; once out of every in-flight step and window
it is PARKED on the step thread like a migration (KV preempted to the host
tier and harvested into an image, the grammar fields read, the request
extracted). A ship thread asks the scheduler for a decode-pool target
(``disagg_target``) and streams the image over a second ``AsyncSender``
(the KV lane, which keeps page bulk off the data plane's queues) as
layer-chunked ``rpc_kv_transfer`` frames (``runtime/kv_handoff.py``). The
decode head assembles them on its transport thread (CPU tensors only),
admits the checkpoint and adopts the pages on its step thread, and answers
``kv_handoff_result``. The fallback ladder: a prefix-warm target or a
missing image ships the checkpoint alone (re-prefill and replay there); a
nack re-ships checkpoint-only; a timeout or a lane failure re-ships
checkpoint-only to the SAME target, so a late ack resolves in place; no
decode pool restores the request locally, and a park deadline restores it
locally after ``where_is`` says nobody else owns it. ``handoff_stats``
counts it all.

Relay mode, the model switch and reference-protocol frames, as in the
JAX worker: a worker whose ``peer_id`` is ``relay:<id>@<relay>`` (behind a
NAT, dialed by no one) registers its reverse route at the relay on every
heartbeat. An allocation naming another model than the one served is a
live model switch (``/scheduler/init``): ``resolve_model`` gives the new
config and weights, the old engine's KV and weights are dropped, the new
stage loads, and the grammar vocabulary follows the new tokenizer; a
failed resolve keeps the old name, so the next allocation retries.
FORWARD and ABORT take raw protobuf bytes from a reference-protocol peer
(``p2p/interop.py``), counted in the inbound stats.

The observability plane is the JAX worker's: heartbeats carry the step
timing, the histogram snapshots (``metrics``), goodput, the device plane,
the watchdog's ``health``, a sequence-numbered flight-event batch
(``events``) and the ``constrained`` ledger; traced FORWARD packets join
the head's trace; ``PROFILE`` starts and stops ``torch.profiler`` on the
step thread (the frontend's fan-out target, with an auto-stop deadline);
and ``watchdog=True`` runs the stall watchdog over the step loop, the
senders, migration, the KV shipper, admission and the compile
observatory. The heartbeat thread reads host state and the engine's
snapshots only; what must touch the device runs on the step thread,
posted through its inbox (``_call_on_step``).

QoS rides the worker as in the JAX package: QoS-tagged FORWARD packets
carry the head's class onto mirrors, ``chat_submit`` takes a class, a
remaining deadline and a tenant, and a heartbeat reply's ``role`` (the
pool autoscaler's re-role: adopted in place, no reload; a decode ->
prefill move drains through the handoff on later step-loop passes) and
``qos_shed`` (the cluster verdict, OR'd into the local controller) set
host state only.

Per-request LoRA: the worker registers its ``lora_adapters`` on every
(re)allocation against the stage's new layer range, before the engine is
published; its heartbeats advertise the names; ``lora_id`` rides FORWARD
packets (and the reference protocol's ``lora_path``); a parked request's
chain descriptor hashes in its adapter's namespace.

Weight refit (``p2p/refit.py``): heartbeats carry the worker's
``refit_version``; a reply naming a newer one posts ``("refit", version,
index)``; the step thread starts one ``refit-fetch`` thread, which fetches
and checks this stage's tensors on the host (no CUDA call), saves them to
the ``refit_cache_dir`` store when one is set and posts them back; the
step thread copies them into the weights in place and the engine drops
its prefix cache. A freshly built engine serves the checkpoint's weights
(version 0) until the newest cached version for its model and layer range
is restored, or the scheduler's index is fetched again.

Not ported yet, refused by name with its ROADMAP queue 1 item: tensor
parallelism (item 10).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _fwait

import torch

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.config import (
    ModelConfig,
    resolve_role,
    resolve_wire_dtype,
)
from parallax_tpu_torch.constrained import grammar_vocab_from_tokenizer
from parallax_tpu_torch.ha.backoff import BackoffPolicy
from parallax_tpu_torch.ha.failover import SchedulerFailover
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.models.base import StageModel
from parallax_tpu_torch.obs import names as mnames
from parallax_tpu_torch.p2p import interop, proto
from parallax_tpu_torch.p2p.transport import (
    NO_HANDLER_MARK,
    AsyncSender,
    Transport,
    make_ping_handler,
)
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime import kv_handoff
from parallax_tpu_torch.runtime.checkpoint import (
    CheckpointError,
    build_resumed_request,
    checkpoint_from_request,
    checkpoint_from_wire,
    checkpoint_to_wire,
)
from parallax_tpu_torch.runtime.cache_manager import derive_ns_salt
from parallax_tpu_torch.runtime.radix_cache import block_hash_chain
from parallax_tpu_torch.runtime.request import (
    IntermediateRequest,
    Request,
    RequestStatus,
    SamplingParams,
)
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.utils.hw import detect_hardware
from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer, load_tokenizer

logger = get_logger(__name__)

# The retry shape of the worker's scheduler RPCs (the join's redial, the
# heartbeat's rotation to a promoted standby): full jitter from 0.25 s,
# doubling, capped at 2 s.
SCHEDULER_RETRY = BackoffPolicy(base_s=0.25, cap_s=2.0)


class WorkerNode:
    """Serves its layer range (assigned by the scheduler, or self-assigned
    in a scheduler-less swarm), forwards activations to the next hop and,
    at the head, answers chat RPCs."""

    # Live migration: a request parked for checkpoint shipping that finds
    # no target pipeline within this long is aborted (the client resume
    # ladder is the rung below).
    MIGRATION_PARK_TIMEOUT_S = 20.0
    # Backoff between target-query attempts while no pipeline is
    # serviceable (bootstrap/rebalance in flight).
    MIGRATION_RETRY_S = 1.0
    # Disaggregation handoff: a prefill head's parked request that has not
    # landed on a decode replica within this long restores LOCALLY
    # (mixed-mode decode) — never aborts.
    HANDOFF_PARK_TIMEOUT_S = 20.0
    # Backoff between ship attempts after a retryable failure.
    HANDOFF_RETRY_S = 0.5
    # A KV transfer whose decode-side result has not arrived within this
    # long is presumed lost (target death, lane failure): fall back to a
    # checkpoint-only re-ship. The target acks duplicates without a second
    # submit, so a merely-lost result cannot double-decode.
    HANDOFF_RESULT_TIMEOUT_S = 15.0
    # Ship-thread backpressure on the kv lane: stop enqueueing while the
    # peer's queue holds this many frames (well under the lane's max_queue
    # of 64) and give a wedged lane this long before falling back.
    KV_LANE_HIGH_WATER = 32
    KV_LANE_DRAIN_TIMEOUT_S = 60.0

    def __init__(
        self,
        transport: Transport,
        scheduler_peer: str | None,
        model_config: ModelConfig,
        engine_config: EngineConfig | None = None,
        load_params=None,          # callable (StageModel) -> params
        heartbeat_interval_s: float = 2.0,
        static_peers: list[str] | None = None,
        layers: tuple[int, int] | None = None,
        device=None,
        tokenizer_path: str | None = None,
        role: str | None = None,
        kv_transfer_chunk_bytes: int | None = None,
        scheduler_standby: list[str] | None = None,
        resolve_model=None,
        watchdog: bool = False,
        watchdog_degraded_s: float = 5.0,
        watchdog_stalled_s: float = 15.0,
        lora_adapters: dict | None = None,  # name -> PEFT dir or tree
        refit_cache_dir: str | None = None,
    ):
        """``scheduler_peer`` is the scheduler's RPC address; None enters
        SCHEDULER-LESS mode, where the worker self-assigns ``layers``.
        ``scheduler_standby`` seeds the failover rotation with warm-standby
        scheduler addresses (the primary's replies extend it).
        ``device`` is the engine's (None = ``cuda:0``, ``"cpu"`` for the
        plain path). ``tokenizer_path`` (the checkpoint directory) gives a
        last-stage worker the grammar vocabulary for json_schema rows.
        ``role`` is the phase specialization (prefill, decode or mixed, the
        default); ``kv_transfer_chunk_bytes`` the payload target of one
        layer-chunked KV_TRANSFER frame (default 4 MiB).
        ``resolve_model(name) -> (ModelConfig, load_params | None)`` serves
        a live model switch (None refuses one; load_params None draws
        seeded random weights). ``watchdog`` runs the stall watchdog
        (degraded / stalled after ``watchdog_degraded_s`` /
        ``watchdog_stalled_s`` without progress). ``lora_adapters`` (name
        -> PEFT directory or adapter tree) are registered on every engine
        the worker builds; one that fails to load is logged and left out,
        so its requests abort with the reason. ``refit_cache_dir`` keeps
        the newest three fetched refit versions on disk
        (``RefitVersionStore``), restored after every (re)load. The JAX
        worker's mesh argument waits for its item."""
        self.scheduler_peer = scheduler_peer
        self.standalone = scheduler_peer is None
        # Scheduler HA (docs/ha.md): every scheduler RPC routes through a
        # failover wrapper that retries with jittered exponential backoff
        # under the caller's deadline and rotates to a promoted standby on
        # connection failure or a not_primary redirect. The wrapper also
        # tracks the highest scheduler epoch seen; heartbeats echo it so a
        # superseded old primary fences itself.
        self.sched_transport: SchedulerFailover | None = None
        if not self.standalone:
            self.sched_transport = SchedulerFailover(
                transport, [scheduler_peer, *(scheduler_standby or [])],
                policy=SCHEDULER_RETRY,
            )
        if self.standalone and layers is None:
            raise ValueError(
                "scheduler-less mode requires explicit layers=(start, end)"
            )
        # Phase specialization: "prefill" heads hand finished prompts to
        # the decode pool over the KV lane; "decode" nodes are handoff
        # targets; "mixed" serves both phases with no handoffs.
        self.role = resolve_role(role)
        if self.standalone and self.role != "mixed":
            logger.warning(
                "--role %s ignored in scheduler-less mode: no scheduler to "
                "assign decode-pool targets; this worker serves both "
                "phases", self.role,
            )
            self.role = "mixed"
        self.transport = transport
        self.model_config = model_config
        # Own copy: callers may share one EngineConfig across workers.
        self.engine_config = dataclasses.replace(
            engine_config or EngineConfig())
        self.load_params = load_params or self._random_params
        self.heartbeat_interval_s = heartbeat_interval_s
        self.static_peers = list(static_peers or [])
        self.device = device
        self.resolve_model = resolve_model
        self._self_layers = layers
        self.tokenizer_path = tokenizer_path
        self.lora_adapters = dict(lora_adapters or {})
        # Weight refit: the version of the weights served (0: the
        # checkpoint's), one fetch thread at a time, the on-disk store of
        # fetched versions, and each applied refit's figures.
        self.refit_version = 0
        self._refit_fetching = False
        self.refit_store = None
        if refit_cache_dir:
            from parallax_tpu_torch.p2p.refit import RefitVersionStore

            self.refit_store = RefitVersionStore(refit_cache_dir)
        self.refit_log: list[dict] = []
        # (vocab bytes, eos id) for grammar-constrained decoding, built
        # once from the tokenizer files on the first last-stage engine.
        self._grammar_vocab: tuple | None = None
        # Boot epoch: travels in gossip announcements so peers can tell a
        # restarted process (possibly a different build — different wire
        # caps) from a continuing one.
        self._epoch = uuid.uuid4().hex[:12]
        # Gossip registry: node_id -> block announcement.
        self._peer_blocks: dict[str, dict] = {}
        self._peer_lock = make_lock("node.peers")
        self._gossip_pool: ThreadPoolExecutor | None = None
        self.peer_ttl_s = max(10.0, 5 * heartbeat_interval_s)

        self.node_id = transport.peer_id
        self.engine: StageEngine | None = None
        self.start_layer = -1
        self.end_layer = -1
        # The step loop's in-flight ticket and its engine (a reload drops
        # both before the new engine loads).
        self._pending = None
        self._pending_engine: StageEngine | None = None
        # Prefix-digest publishing (cache-aware routing): a per-payload
        # sequence number and the full-snapshot flag. A lost heartbeat
        # leaves a seq gap the scheduler answers with digests_resync.
        self._digests_seq = 0
        self._digests_full_next = True
        # Engine reload in progress: rides heartbeats so the scheduler's
        # sweep extends this node's grace while it loads.
        self._busy_reloading = False
        # The model name the allocations name (another one is a live
        # model switch).
        self._served_model_name: str | None = None
        # detect_hardware()'s summary, read by the first join.
        self._hardware: dict | None = None
        self._inbox: queue.Queue = queue.Queue()
        # Set by every _post(): the step thread parks on it when idle.
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # Head-node bookkeeping: finished requests awaiting pickup.
        self._finished: queue.Queue[Request] = queue.Queue()
        self._request_events: dict[str, threading.Event] = {}
        # Live migration. Step-thread state except _migrated_to, which
        # pollers read from transport threads (write-once strings).
        # rid -> dead peer: flagged for parking, still draining out of the
        # engine (in-flight steps must resolve first).
        self._migration_pending: dict[str, str] = {}
        # rid -> park entry (request, optional KV image, grammar fields,
        # timestamps).
        self._migration_parked: dict[str, dict] = {}
        # rid -> target head: chat_poll redirects followers there after
        # the request shipped away (bounded; see _record_migrated).
        self._migrated_to: OrderedDict[str, str] = OrderedDict()
        # Async sender pipeline: serialization + socket latency leave the
        # step thread (per-peer bounded in-order queues); overflow or send
        # failure feeds the abort path.
        self.sender = AsyncSender(transport, on_failure=self._on_send_failure)
        # The KV handoff's transfer lane is a SECOND AsyncSender: page bulk
        # rides its own per-peer FIFOs, so a multi-megabyte handoff never
        # head-of-line blocks FORWARD / RELEASE traffic (or the reverse).
        self.kv_transfer_chunk_bytes = int(
            kv_transfer_chunk_bytes or kv_handoff.DEFAULT_CHUNK_BYTES)
        self.kv_sender = AsyncSender(
            transport, max_queue=64, on_failure=self._on_kv_send_failure,
            name="kv",
        )
        # Handoff counters (also the registry's parallax_kv_* series) and
        # the inbound reassembly (this node as a decode target), swept
        # from the heartbeat thread.
        self.handoff_stats = kv_handoff.HandoffStats()
        # Watchdog progress counters: migration ship rounds and timeouts,
        # handoff ship rounds, results and local restores.
        self._migration_progress = 0
        self._handoff_progress = 0
        self._kv_assembler = kv_handoff.HandoffAssembler(
            stats=self.handoff_stats)
        # Source-side ledger (this node as a prefill head), step-thread
        # state mirroring the migration maps: rid -> flag time for rows
        # draining out of the in-flight window, rid -> park entry for
        # checkpointed requests moving through the ship ladder.
        self._handoff_pending: dict[str, float] = {}
        self._handoff_parked: dict[str, dict] = {}
        self._handoff_warned = False
        # Fail fast on a bad wire dtype.
        resolve_wire_dtype(self.engine_config.wire_dtype, model_config.dtype)
        # Negotiated wire dtype per link: peer -> (dtype | None,
        # expires_at); None ships native frames. Writes that follow a slow
        # probe go through _wire_lock plus the per-peer forget generation,
        # so an invalidated decision is never resurrected by a probe.
        self._wire_dtypes: dict[str, tuple[str | None, float]] = {}
        self._wire_lock = make_lock("node.wire_caps")
        self._wire_forget_gen: dict[str, int] = {}
        self._wire_warned_native: set[str] = set()
        # Per-source receive counters, bumped from transport threads.
        self._rx_stats: dict[str, dict] = {}
        self._rx_lock = make_lock("node.rx_stats")

        transport.register(proto.FORWARD, self._on_forward)
        transport.register(proto.ABORT, self._on_abort)
        transport.register(proto.RELEASE, self._on_release)
        transport.register("__announce__", self._on_announce)
        transport.register(proto.CHAT_READY, self._on_chat_ready)
        transport.register(proto.CHAT_SUBMIT, self._on_chat_submit)
        transport.register(proto.CHAT_POLL, self._on_chat_poll)
        transport.register(proto.CHAT_STOP, self._on_chat_stop)
        transport.register(proto.WIRE_CAPS, self._on_wire_caps)
        transport.register(proto.CHECKPOINT, self._on_checkpoint)
        transport.register(proto.KV_TRANSFER, self._on_kv_transfer)
        transport.register(proto.KV_RESULT, self._on_kv_result)
        transport.register("__ping__", make_ping_handler())
        transport.register(proto.PROFILE, self._on_profile)
        # Cluster-scope profiling: one trace at a time, with an auto-stop
        # deadline (a frontend that dies mid-profile must not leave this
        # worker tracing forever).
        self._profiling = False
        self._profile_dir: str | None = None
        self._profile_timer: threading.Timer | None = None
        self._profile_lock = make_lock("node.profile")
        # The stall watchdog (started with the node) and the flight-event
        # shipping state: the ring cursor acked by the scheduler, this
        # node's own contiguous sequence and the ring -> shipped
        # assignments not acked yet.
        self._watchdog = None
        self._watchdog_cfg = (
            (watchdog_degraded_s, watchdog_stalled_s) if watchdog else None)
        self._events_cursor = 0
        self._events_seq = 0
        self._events_assigned: dict[int, int] = {}
        # Head-node chat requests by id (polled by the chat host).
        self._chat_requests: dict[str, Request] = {}
        # rid -> (route, park-to-restore seconds on the wall clock) of each
        # checkpoint this worker restored (also counted in the registry).
        self.restores: OrderedDict[str, tuple[str, float]] = OrderedDict()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Join (scheduler mode), then serve. The join RPC only fetches the
        allocation: every engine is built on the step thread, so
        heartbeats and announcements flow from the first moment. The join
        blocks until the scheduler bootstraps (up to its join timeout)."""
        self.transport.start()
        if self.standalone:
            s, e = self._self_layers
            alloc = {"start_layer": s, "end_layer": e}
            logger.info("%s: scheduler-less, self-assigned layers [%d, %d)",
                        self.node_id, s, e)
        else:
            alloc = self._join()
        if self._watchdog_cfg is not None:
            self._start_watchdog(*self._watchdog_cfg)
        for fn in (self._announcer_loop, self._step_loop):
            t = threading.Thread(target=fn, daemon=True, name=fn.__name__)
            t.start()
            self._threads.append(t)
        if "start_layer" in alloc:
            self._post(("reload", alloc))
        else:
            logger.info("%s: joined as standby", self.node_id)

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        for t in self._threads:
            t.join(timeout=3.0)
        if self._watchdog is not None:
            self._watchdog.stop()
        self.sender.close()
        self.kv_sender.close()
        if self._gossip_pool is not None:
            self._gossip_pool.shutdown(wait=False, cancel_futures=True)
        if not self.standalone:
            try:
                self.sched_transport.call(
                    self.scheduler_peer, proto.NODE_LEAVE,
                    {"node_id": self.node_id}, timeout=5.0,
                )
            except Exception:
                pass
        self.transport.stop()

    # -- join + allocation ----------------------------------------------------

    def _sched_peer(self) -> str:
        """Current scheduler address for fire-and-forget sender traffic
        (PEER_DOWN / REQUEST_COMPLETE / MIGRATION_DONE ride the async
        sender, which has no retry-rotate loop of its own — so they at
        least target whichever peer the failover wrapper last proved
        alive; a frame lost across the promotion window is best_effort by
        contract)."""
        return self.sched_transport.active_peer

    def _is_scheduler(self, peer: str) -> bool:
        """True for the primary OR any standby: scheduler addresses are
        exempt from peer_down reporting (the failover wrapper handles
        scheduler death)."""
        return peer in self.sched_transport.peers

    def _join(self, timeout_s: float = 300.0) -> dict:
        """``node_join``: blocks until the scheduler allocates (or parks
        this node as standby). The failover wrapper dials the primary and
        the standbys in turn, with jittered backoff, until ``timeout_s``,
        so a scheduler that does not accept connections yet is dialed
        again. The hardware summary is read once, by the first join (on
        the thread that calls :meth:`start`): a rejoin runs on the
        heartbeat thread, which makes no CUDA call."""
        if self._hardware is None:
            self._hardware = detect_hardware(self.device).to_dict()
        payload = {
            "node_id": self.node_id,
            "hardware": self._hardware,
            # The dtype names this build decodes on activation frames.
            "wire_formats": list(proto.WIRE_DTYPES),
            # Phase specialization: the scheduler keeps pipelines
            # role-homogeneous and phase-filters routing pools.
            "role": self.role,
        }
        reply = self.sched_transport.call(
            self.scheduler_peer, proto.NODE_JOIN, payload, timeout=timeout_s,
        )
        if not reply or ("start_layer" not in reply
                         and "standby" not in reply):
            raise RuntimeError(f"join rejected: {reply}")
        return reply

    def _apply_allocation(self, alloc: dict) -> None:
        if "start_layer" not in alloc:
            return
        self._busy_reloading = True
        try:
            self._apply_allocation_inner(alloc)
        finally:
            self._busy_reloading = False

    def _apply_allocation_inner(self, alloc: dict) -> None:
        """(Re)build the engine for ``alloc``'s range, on the step thread.
        A ``want_digests`` flip forces a rebuild as a moved range does;
        the old engine's requests abort ("node reallocated") and its KV
        and weights are dropped before the new stage loads, so two
        workers on one card never hold both."""
        model_switched = self._maybe_switch_model(alloc.get("model_name"))
        want_digests = bool(alloc.get("want_digests"))
        digests_switched = want_digests != self.engine_config.cache_digests
        if digests_switched:
            self.engine_config.cache_digests = want_digests
        start, end = alloc["start_layer"], alloc["end_layer"]
        if not digests_switched and not model_switched and (start, end) == (
            self.start_layer, self.end_layer
        ):
            return
        logger.info("%s: (re)loading layers [%d, %d)", self.node_id,
                    start, end)
        self._abort_in_flight("node reallocated")
        self._drop_engine()
        self.start_layer, self.end_layer = start, end
        t0 = time.monotonic()
        model = create_stage_model(self.model_config, start, end)
        params = self.load_params(model)
        engine = StageEngine(
            model, params, self.engine_config, device=self.device,
            host_hidden=True,
        )
        for name, source in self.lora_adapters.items():
            # Each (re)allocation re-registers every adapter against the
            # stage's new layer range, BEFORE the engine is published: a
            # heartbeat firing mid-registration would otherwise report an
            # empty adapter list and drop every advertised variant.
            try:
                engine.load_adapter(name, source)
            except (ValueError, OSError) as e:
                logger.warning("adapter %r failed to load: %s", name, e)
        self.engine = engine
        if (
            self.role == "prefill"
            and self.engine.host_tier is None
            and not self._handoff_warned
        ):
            # Page shipping needs the host tier on the source to harvest
            # images.
            self._handoff_warned = True
            logger.warning(
                "%s: kv-image handoff disabled: no host KV tier on this "
                "prefill-role worker — handoffs ship checkpoints only and "
                "the decode pool re-prefills (set --host-cache-bytes to "
                "enable page shipping)", self.node_id,
            )
        # Fresh engine = empty radix tree: the scheduler's digest mirror
        # for this node is stale; the next heartbeat ships a snapshot.
        self._digests_full_next = True
        # The new engine holds the checkpoint's weights: version 0 until a
        # cached version is restored or the scheduler's index is fetched
        # again (its heartbeat reply carries the index while this node
        # lags).
        self.refit_version = 0
        self._restore_refit_cache()
        if model.is_last:
            self._wire_grammar()
        logger.info("%s: layers [%d, %d) ready on %s (%.2f s to load and "
                    "build)", self.node_id, start, end, self.engine.device,
                    time.monotonic() - t0)

    def _maybe_switch_model(self, model_name: str | None) -> bool:
        """A live model switch (``/scheduler/init``): the allocation names
        another model than the one served, so its config and weights come
        from ``resolve_model``; True when they did. The first allocation's
        name is recorded, not compared: scheduler and worker may spell the
        same model differently (a preset key, a checkpoint path)."""
        if not model_name:
            return False
        if self._served_model_name is None or (
            model_name == self._served_model_name
        ):
            self._served_model_name = model_name
            return False
        if self.resolve_model is None:
            raise RuntimeError(
                f"scheduler switched to {model_name!r} but this worker has "
                f"only {self.model_config.model_name!r} locally (no "
                "resolver); restart the worker with the new --model-path")
        config, load_params = self.resolve_model(model_name)
        # The new name is recorded only after the resolve succeeded: a
        # failed switch retries on a later allocation instead of serving
        # the old model under the new name.
        self._served_model_name = model_name
        logger.warning("%s: switching model %s -> %s", self.node_id,
                       self.model_config.model_name, model_name)
        self.model_config = config
        self.load_params = load_params or self._random_params
        # The new model's tokenizer differs: the grammar vocabulary is
        # built again from the new checkpoint (a preset has none).
        self._grammar_vocab = None
        self.tokenizer_path = model_name if os.path.isdir(model_name) else None
        return True

    def _wire_grammar(self) -> None:
        """Enable json_schema enforcement on a last-stage worker: build the
        tokenizer's byte vocabulary once and hand it to the engine. Without
        real tokenizer files, constrained requests abort with a clear
        reason instead of being silently unenforced: the byte tokenizer's
        ids are not a real model's vocabulary."""
        if self._grammar_vocab is None:
            if not self.tokenizer_path:
                logger.warning(
                    "%s: no tokenizer path; json_schema requests will be "
                    "rejected", self.node_id)
                return
            try:
                tok = load_tokenizer(self.tokenizer_path)
                if isinstance(tok, SimpleTokenizer):
                    raise ValueError(
                        f"no tokenizer files at {self.tokenizer_path}")
                self._grammar_vocab = grammar_vocab_from_tokenizer(tok)
            except Exception as e:
                logger.warning("%s: grammar vocab unavailable (%s); "
                               "json_schema requests will be rejected",
                               self.node_id, e)
                return
        self.engine.set_grammar_vocab(*self._grammar_vocab)

    def _drop_engine(self) -> None:
        """Release the engine, its in-flight ticket and (on a card) the
        cached blocks its KV and weights held."""
        eng = self.engine
        if eng is None:
            return
        self.engine = None
        if self._pending is not None and self._pending_engine is eng:
            try:
                eng.discard(self._pending)
            except Exception:
                logger.exception("discarding the in-flight step")
        self._pending = self._pending_engine = None
        device = eng.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        del eng
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    def _abort_in_flight(self, reason: str) -> None:
        eng = self.engine
        if eng is None:
            return
        sched = eng.scheduler
        reqs = list(sched.running.values()) + list(sched.wait_queue.values())
        aborted = 0
        for req in reqs:
            if (
                not req.status.is_finished
                and req.request_id in self._migration_pending
            ):
                # Flagged for migration and the engine is going away: park
                # the token-level state NOW (force: the engine and its KV
                # are discarded wholesale, so no image and no in-flight
                # hazard).
                dead = self._migration_pending.pop(req.request_id)
                self._park_request(eng, req, dead, force=True)
                continue
            if not req.status.is_finished:
                req.abort(reason)
            sched.release_request(req)
            self._finish(req)
            aborted += 1
        if aborted:
            logger.warning("%s: aborted %d in-flight requests (%s)",
                           self.node_id, aborted, reason)

    def _random_params(self, model: StageModel):
        """Seeded random weights, deterministic per layer range (the JAX
        package draws them from ``jax.random.key`` with the same seed)."""
        dtype = (torch.bfloat16 if self.engine_config.kv_dtype == "bfloat16"
                 else torch.float32)
        device = torch.device(self.device or "cuda:0")
        gen = torch.Generator(device=device)
        gen.manual_seed(model.start_layer * 1000 + model.end_layer)
        return model.init_params(gen, dtype, device)

    # -- announcer: scheduler-less gossip -------------------------------------

    def _announcer_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.standalone:
                    self._gossip_beat()
                else:
                    # Inbound KV transfers whose source died mid-flight
                    # are discarded here (the request recovers through the
                    # source's result timeout or the client resume ladder).
                    self._kv_assembler.sweep()
                    if self.node_id.startswith("relay:") and hasattr(
                        self.transport, "register_at_relay"
                    ):
                        # Refresh the reverse route every beat: idempotent,
                        # and it restores the route after a dropped relay
                        # connection with no liveness logic of its own.
                        self.transport.register_at_relay(
                            self.node_id.rsplit("@", 1)[1])
                    self._heartbeat()
                self._reap_rx_stats()
            except Exception as e:
                logger.warning("%s failed: %s", "gossip beat"
                               if self.standalone else "heartbeat", e)
            self._stop.wait(self.heartbeat_interval_s)

    # -- announcer: scheduler heartbeats ----------------------------------------

    def _heartbeat(self) -> None:
        """One ``node_update`` and its reply. Host state only: the engine's
        counters, dispatch summary, latency EWMA and digest log are Python
        values, so this thread makes no CUDA call."""
        eng = self.engine
        ev_batch, ev_cursor = self._event_batch()
        reply = self.sched_transport.call(
            self.scheduler_peer,
            proto.NODE_UPDATE,
            {
                "node_id": self.node_id,
                # Highest scheduler epoch this worker has seen: the fencing
                # signal — a primary hearing a higher epoch than its own
                # knows a standby promoted past it (docs/ha.md).
                "epoch": self.sched_transport.epoch,
                "cache_digests": self._digest_heartbeat(eng),
                "is_ready": eng is not None,
                "load": eng.scheduler.num_requests() if eng else 0,
                "layer_latency_ms": (
                    eng.layer_latency_ms_ewma if eng else None
                ),
                "cache_stats": eng.cache_stats() if eng else None,
                "kernel": eng.kernel_dispatch_summary() if eng else None,
                "transport": self.transport_stats(),
                "refit_version": self.refit_version,
                "lora_adapters": eng.adapter_names() if eng else [],
                "busy": self._busy_reloading,
                # Speculation's ledger (None while it is off) and the
                # constrained-decoding ledger (None until a feature row
                # ran).
                "spec": eng.spec_summary() if eng else None,
                "constrained": eng.constrained_summary() if eng else None,
                "step_timing": eng.step_timing.summary() if eng else None,
                # Histogram snapshots the scheduler merges into cluster
                # percentiles, the goodput ledger, the device plane, the
                # watchdog's state and a flight-event batch for the
                # cluster timeline.
                "metrics": self._metrics_snapshot(),
                "goodput": self._goodput_heartbeat(),
                "device": self._device_heartbeat(),
                "health": (self._watchdog.summary()
                           if self._watchdog is not None else None),
                "events": ev_batch,
            },
            timeout=10.0,
        )
        # The reply landed, so the scheduler ingested the batch: adopt
        # the cursor and prune the acked assignments. A failed beat
        # re-ships from the old cursor under the same numbers (the
        # timeline dedupes them).
        self._events_cursor = ev_cursor
        if self._events_assigned:
            self._events_assigned = {
                rs: s for rs, s in self._events_assigned.items()
                if rs > ev_cursor
            }
        if not isinstance(reply, dict):
            return
        if reply.get("drain"):
            # Pipelines through these dead peers are dissolving: posted
            # before any reload below, so the step thread aborts them
            # while their state still exists.
            self._post(("drain", [str(x) for x in reply["drain"]]))
        if reply.get("digests_resync"):
            # The scheduler saw a sequence gap: a full snapshot next beat.
            self._digests_full_next = True
        self._adopt_qos_reply(reply)
        if reply.get("rejoin"):
            # The scheduler lost us (restart or heartbeat eviction).
            logger.warning("%s: scheduler asked for rejoin", self.node_id)
            rejoin_alloc = self._join()
            if "start_layer" in rejoin_alloc:
                self._post(("reload", rejoin_alloc))
        elif reply.get("start_layer") is not None:
            want_digests = bool(reply.get("want_digests"))
            served = self._served_model_name
            if (reply["start_layer"], reply["end_layer"]) != (
                self.start_layer, self.end_layer
            ) or want_digests != self.engine_config.cache_digests or (
                # A model switch whose resolve failed: try it again.
                served is not None
                and reply.get("model_name") not in (None, served)
            ):
                # The scheduler moved us: reload on the step thread.
                self._post(("reload", reply))
            else:
                self._adopt_refit_reply(reply)

    def _adopt_refit_reply(self, reply: dict) -> None:
        """A heartbeat reply naming a newer weight version than the one
        served posts it to the step thread (host state only)."""
        version = reply.get("refit_version") or 0
        if reply.get("refit_index") and version > self.refit_version:
            self._post(("refit", version, reply["refit_index"]))

    def _adopt_qos_reply(self, reply: dict) -> None:
        """The QoS plane of a heartbeat reply, on host state only (this
        runs on the heartbeat thread, which makes no CUDA call).

        ``role``: the pool autoscaler's re-role. The new phase is adopted
        in place (same layers, no reload); a decode -> prefill move drains
        its in-flight decodes through the handoff machinery on the step
        loop's later passes, which read ``self.role``. ``qos_shed``: the
        cluster's shed verdict, OR'd with the engine's local controller."""
        role = reply.get("role")
        if (
            isinstance(role, str) and role in ("prefill", "decode", "mixed")
            and role != self.role and not self.standalone
        ):
            old_role = self.role
            self.role = role
            logger.warning("%s: re-roled %s -> %s by the scheduler",
                           self.node_id, old_role, role)
            from parallax_tpu_torch.obs.flight import get_flight

            get_flight().event("qos_rerole", node=self.node_id, role=role,
                               prev=old_role)
        if "qos_shed" in reply:
            eng = self.engine
            if eng is not None and eng.scheduler.qos is not None:
                eng.scheduler.qos.set_remote_shed(bool(reply["qos_shed"]))

    def _event_batch(self) -> tuple[dict | None, int]:
        """The next bounded flight-event batch for the cluster timeline
        and the ring cursor to adopt once the scheduler's reply confirms
        it landed, tagged with this process's boot epoch (a restart resets
        the scheduler's gap accounting instead of counting a false gap).

        Shipped events are renumbered into this node's own contiguous
        sequence (an in-process swarm shares one ring whose global
        sequence interleaves siblings); the ring -> shipped assignment is
        stable across retries, so a resend reuses its numbers and the
        timeline dedupes it. Events the ring evicted before they shipped
        surface as ``lost``."""
        try:
            from parallax_tpu_torch.obs.flight import get_flight

            fl = get_flight()
            events, cursor = fl.events_since(
                self._events_cursor, limit=256, node=self.node_id)
            lost = 0
            oldest = fl.oldest_seq()
            if self._events_cursor and oldest > self._events_cursor + 1:
                lost = oldest - self._events_cursor - 1
            cursor = max(cursor, oldest - 1 if oldest else 0)
        except Exception:  # pragma: no cover - obs never breaks beats
            return None, self._events_cursor
        if not events and not lost:
            return None, cursor
        batch = []
        for e in events:
            ring_seq = int(e.get("seq") or 0)
            seq = self._events_assigned.get(ring_seq)
            if seq is None:
                self._events_seq += 1
                seq = self._events_seq
                self._events_assigned[ring_seq] = seq
            batch.append(dict(e, seq=seq))
        payload = {"epoch": self._epoch, "batch": batch}
        if lost:
            payload["lost"] = lost
        return payload, cursor

    @staticmethod
    def _count_migration_in(mode: str, park_s: float | None) -> None:
        """``parallax_migrations_total{mode}``, the park -> resume latency
        histogram and the goodput ledger's ``migrate`` time (never
        raises)."""
        try:
            from parallax_tpu_torch.obs.goodput import get_goodput
            from parallax_tpu_torch.obs.registry import get_registry

            reg = get_registry()
            reg.counter(
                mnames.MIGRATIONS_TOTAL,
                "Requests restored on this head after a live migration "
                "or client resume",
                labelnames=("mode",),
            ).labels(mode=mode).inc()
            if park_s is not None:
                reg.histogram(
                    mnames.MIGRATION_MS,
                    "Park -> resume latency of migrated requests, ms",
                ).observe(park_s * 1e3)
                # Park -> resume is churn overhead, not serving time.
                get_goodput().add_time("migrate", park_s)
        except Exception:  # pragma: no cover - metrics never break serving
            pass

    @staticmethod
    def _metrics_snapshot() -> dict | None:
        """Histogram snapshots for the heartbeat (the scheduler merges them
        into cluster percentiles), empty children stripped; None when
        nothing was observed yet."""
        try:
            from parallax_tpu_torch.obs.registry import get_registry

            out = {}
            for name, children in (
                    get_registry().histogram_snapshots().items()):
                kept = {
                    lbl: c for lbl, c in children.items() if c.get("count")
                }
                if kept:
                    out[name] = kept
            return out or None
        except Exception:  # pragma: no cover - metrics never break serving
            return None

    @staticmethod
    def _goodput_heartbeat() -> dict | None:
        """This process's goodput payload (one card a worker; never
        raises)."""
        try:
            from parallax_tpu_torch.obs.goodput import get_goodput

            return get_goodput().payload(chips=1)
        except Exception:  # pragma: no cover - obs never breaks beats
            return None

    @staticmethod
    def _device_heartbeat() -> dict | None:
        """This process's device-plane payload (never raises)."""
        try:
            from parallax_tpu_torch.obs.device import get_device_plane

            return get_device_plane().payload()
        except Exception:  # pragma: no cover - obs never breaks beats
            return None

    # -- stall watchdog and profiling ----------------------------------------

    def _start_watchdog(self, degraded_s: float, stalled_s: float) -> None:
        """Build and start the stall watchdog: each component registers a
        (pending, progress) probe; pending work whose progress stops
        moving walks ok -> degraded -> stalled, emits flight events (so
        the stall lands in the cluster timeline) and flips the deep
        ``/healthz``. The probes run on the monitor thread and read host
        counters only."""
        from parallax_tpu_torch.obs.device import get_device_plane
        from parallax_tpu_torch.obs.watchdog import StallWatchdog

        wd = StallWatchdog(
            node_id=self.node_id,
            degraded_after_s=degraded_s,
            stalled_after_s=stalled_s,
        )

        def _step_pending() -> float:
            eng = self.engine
            if eng is None:
                return 0.0
            return float(eng.scheduler.num_requests())

        wd.register_beat("step_loop", _step_pending)

        def _sender_probe():
            # Both lanes: a wedged kv lane stalls handoffs as a wedged
            # FORWARD link stalls decode. Frames leaving the queue either
            # way are progress.
            stats = dict(self.sender.stats())
            for p, s in self.kv_sender.stats().items():
                stats[f"kv:{p}"] = s
            pending = sum(
                s.get("queue_depth", 0) or 0 for s in stats.values())
            progress = sum(
                (s.get("frames_out", 0) or 0) + (s.get("drops", 0) or 0)
                + (s.get("errors", 0) or 0)
                for s in stats.values()
            )
            worst = max(
                (s.get("queue_depth", 0) or 0 for s in stats.values()),
                default=0,
            )
            return float(pending), float(progress), f"deepest queue {worst}"

        wd.register("sender", _sender_probe)

        def _migration_probe():
            pending = len(self._migration_pending) + len(
                self._migration_parked)
            return (
                float(pending), float(self._migration_progress),
                f"{len(self._migration_parked)} parked",
            )

        wd.register("migration", _migration_probe)

        def _kv_shipper_probe():
            # Flagged and parked handoffs on this prefill head plus inbound
            # transfers assembling on this decode head; frames moving
            # either way count as progress (a large image spends seconds
            # in flight).
            pending = (
                len(self._handoff_pending) + len(self._handoff_parked)
                + self._kv_assembler.partial_count()
            )
            frames_out = sum(
                (s.get("frames_out", 0) or 0)
                for s in self.kv_sender.stats().values()
            )
            progress = (self._handoff_progress
                        + self._kv_assembler.frames_total + frames_out)
            return (
                float(pending), float(progress),
                f"{len(self._handoff_parked)} parked, "
                f"{self._kv_assembler.partial_count()} assembling",
            )

        wd.register("kv_shipper", _kv_shipper_probe)

        def _admission_probe():
            eng = self.engine
            if eng is None:
                return 0.0, 0.0, ""
            sched = eng.scheduler
            return (
                float(len(sched.wait_queue)),
                float(sched.admitted_total),
                f"{len(sched.running)} running",
            )

        wd.register("admission", _admission_probe)
        # Capture storms freeze the compile observatory's progress.
        wd.register("compile", get_device_plane().compile.probe)
        wd.start()
        self._watchdog = wd

    def health_summary(self) -> dict:
        """The watchdog's component state machine (a shallow ok when the
        watchdog is off)."""
        wd = self._watchdog
        if wd is None:
            return {"status": "ok", "components": {}, "causes": []}
        return wd.summary()

    def _call_on_step(self, fn, timeout: float = 60.0):
        """Run ``fn()`` on the step thread (posted through the inbox) and
        return its result, re-raising its exception."""
        box: queue.Queue = queue.Queue(maxsize=1)
        self._post(("call", fn, box))
        try:
            ok, value = box.get(timeout=timeout)
        except queue.Empty as e:
            raise TimeoutError("the step thread did not answer") from e
        if not ok:
            raise value
        return value

    def _on_profile(self, _peer: str, payload: dict):
        """The cluster profile fan-out's target: start / stop a
        ``torch.profiler`` trace on this stage, on the step thread. The
        reply feeds the frontend's per-node manifest; ``max_seconds`` arms
        an auto-stop timer here too."""
        from parallax_tpu_torch.obs import profiler

        payload = payload or {}
        action = str(payload.get("action") or "")
        with self._profile_lock:
            if action == "start":
                if self._profiling:
                    return {
                        "node_id": self.node_id,
                        "error": "profiler already running",
                        "dir": self._profile_dir,
                    }
                out_dir = str(payload.get("dir") or profiler.DEFAULT_DIR)
                try:
                    max_seconds = float(payload.get("max_seconds") or 120.0)
                except (TypeError, ValueError):
                    max_seconds = 120.0
                try:
                    self._call_on_step(lambda: profiler.start_trace(out_dir))
                except Exception as e:
                    return {"node_id": self.node_id, "error": str(e)}
                self._profiling = True
                self._profile_dir = out_dir
                self._profile_timer = threading.Timer(
                    max(1.0, max_seconds), self._profile_autostop)
                self._profile_timer.daemon = True
                self._profile_timer.start()
                return {"node_id": self.node_id, "profiling": True,
                        "dir": out_dir}
            if action == "stop":
                if not self._profiling:
                    return {"node_id": self.node_id,
                            "error": "profiler not running"}
                if self._profile_timer is not None:
                    self._profile_timer.cancel()
                    self._profile_timer = None
                try:
                    path = self._call_on_step(profiler.stop_trace)
                except Exception as e:
                    return {"node_id": self.node_id, "error": str(e)}
                finally:
                    self._profiling = False
                return {"node_id": self.node_id, "profiling": False,
                        "dir": self._profile_dir, "trace": path}
        return {"node_id": self.node_id,
                "error": f"unknown action {action!r}"}

    def _profile_autostop(self) -> None:
        """The max_seconds deadline fired without an explicit stop."""
        from parallax_tpu_torch.obs import profiler

        with self._profile_lock:
            if not self._profiling:
                return
            self._profiling = False
            self._profile_timer = None
            logger.warning("%s: profiler auto-stop: max_seconds deadline "
                           "reached", self.node_id)
            try:
                self._call_on_step(profiler.stop_trace)
            except Exception:
                logger.exception("%s: profiler auto-stop failed",
                                 self.node_id)

    def _digest_heartbeat(self, eng) -> dict | None:
        """Prefix-digest payload for one heartbeat: a delta normally, a
        full snapshot after a (re)build or a resync request.
        Sequence-numbered per payload. None unless the allocation asked
        for digests."""
        if eng is None or not self.engine_config.cache_digests:
            return None
        try:
            payload = eng.cache_digest_payload(full=self._digests_full_next)
        except Exception:
            logger.exception("digest payload failed")
            return None
        if payload is None:
            return None
        self._digests_full_next = False
        self._digests_seq += 1
        payload["seq"] = self._digests_seq
        return payload

    def _fresh_peer_ids(self, now: float) -> set[str]:
        """Peers whose announcements are within the TTL (THE liveness
        definition — routes, gossip fan-out and the sweep agree on it)."""
        with self._peer_lock:
            return {
                nid for nid, b in self._peer_blocks.items()
                if now - b["t"] <= self.peer_ttl_s
            }

    def _known_blocks(self) -> list[dict]:
        """Fresh announcements incl. our own, with ages so receivers can
        order third-party info correctly."""
        now = time.monotonic()
        out = []
        if self.start_layer >= 0:
            out.append({
                "node_id": self.node_id, "start": self.start_layer,
                "end": self.end_layer, "ready": self.engine is not None,
                "age_s": 0.0, "epoch": self._epoch,
            })
        with self._peer_lock:
            for nid, b in self._peer_blocks.items():
                age = now - b["t"]
                if age <= self.peer_ttl_s:
                    out.append({
                        "node_id": nid, "start": b["start"], "end": b["end"],
                        "ready": b["ready"], "age_s": age,
                        "epoch": b.get("epoch"),
                    })
        return out

    def _merge_blocks(self, blocks: list[dict],
                      from_peer: str | None = None) -> None:
        now = time.monotonic()
        with self._peer_lock:
            for b in blocks or []:
                nid = b.get("node_id")
                if not nid or nid == self.node_id:
                    continue
                t = now - float(b.get("age_s", 0.0))
                prev = self._peer_blocks.get(nid)
                if prev is None or t > prev["t"]:
                    new_ep = b.get("epoch")
                    prev_ep = prev.get("epoch") if prev else None
                    # A peer's OWN announcement is authoritative for its
                    # boot epoch (an absent one too); a third party's
                    # missing epoch keeps the known one.
                    direct = nid == from_peer
                    epoch = new_ep if direct else (new_ep or prev_ep)
                    changed = (
                        epoch != prev_ep if direct
                        else bool(new_ep) and new_ep != prev_ep
                    )
                    # A restarted peer may be another build: its
                    # negotiated wire dtype is stale.
                    if prev is not None and changed:
                        self._forget_wire_dtype(nid)
                    self._peer_blocks[nid] = {
                        "start": int(b["start"]), "end": int(b["end"]),
                        "ready": bool(b.get("ready")), "t": t,
                        "epoch": epoch,
                    }

    def _gossip_beat(self) -> None:
        """Announce our block to every static peer and every FRESH known
        peer; merge what they know back (transitive discovery). Expired
        entries are pruned, so dead peers are not re-dialed forever."""
        blocks = self._known_blocks()
        now = time.monotonic()
        with self._peer_lock:
            for nid, b in list(self._peer_blocks.items()):
                if now - b["t"] > 3 * self.peer_ttl_s:
                    del self._peer_blocks[nid]
                    self._forget_wire_dtype(nid)
        known = self._fresh_peer_ids(now)
        timeout = min(5.0, max(1.0, self.heartbeat_interval_s))

        def announce(peer: str) -> None:
            try:
                reply = self.transport.call(
                    peer, "__announce__", {"blocks": blocks},
                    timeout=timeout,
                )
            except Exception as e:
                logger.debug("announce to %s failed: %s", peer, e)
                return
            if isinstance(reply, dict):
                self._merge_blocks(reply.get("blocks"), from_peer=peer)

        # Concurrent dials off a persistent pool: dead static peers must
        # not serialize connect timeouts past the TTL.
        if self._gossip_pool is None:
            self._gossip_pool = ThreadPoolExecutor(
                max_workers=min(16, 4 + len(self.static_peers)),
                thread_name_prefix="gossip",
            )
        futures = [
            self._gossip_pool.submit(announce, p)
            for p in set(self.static_peers) | known if p != self.node_id
        ]
        _fwait(futures, timeout=timeout + 1.0)

        # The gossip TTL doubles as the liveness sweep: requests routed
        # through an expired peer are aborted on the step thread.
        if self.engine is not None:
            fresh = self._fresh_peer_ids(time.monotonic())
            fresh.add(self.node_id)
            self._post(("liveness", fresh))

    def _on_announce(self, peer: str, payload: dict):
        self._merge_blocks((payload or {}).get("blocks"), from_peer=peer)
        return {"blocks": self._known_blocks()}

    def _on_chat_ready(self, _peer: str, _payload):
        """Readiness probe for chat hosts: can this head serve a request
        submitted with an EMPTY routing table right now? (In scheduler
        mode the scheduler routes: ready once the engine is built.)"""
        if self.engine is None:
            return {"ready": False}
        if not self.standalone:
            return {"ready": True}
        return {"ready": self.local_route() is not None}

    def local_route(self) -> list[str] | None:
        """Head-side routing table: fewest-hops chain of announced READY
        blocks from our end layer to num_layers (dijkstra over layer
        boundaries with unit edge cost)."""
        if self.start_layer != 0 or self.engine is None:
            return None
        num_layers = self.model_config.num_hidden_layers
        fresh = self._fresh_peer_ids(time.monotonic())
        by_start: dict[int, list[tuple[str, int]]] = {}
        with self._peer_lock:
            for nid, b in self._peer_blocks.items():
                if nid not in fresh or not b["ready"]:
                    continue
                by_start.setdefault(b["start"], []).append((nid, b["end"]))

        best: dict[int, list[str] | None] = {num_layers: []}

        def chain(boundary: int) -> list[str] | None:
            if boundary in best:
                return best[boundary]
            best[boundary] = None          # cycle guard
            result = None
            for nid, end in by_start.get(boundary, []):
                if end <= boundary:
                    continue
                tail = chain(end)
                if tail is not None and (
                    result is None or 1 + len(tail) < len(result)
                ):
                    result = [nid] + tail
            best[boundary] = result
            return result

        tail = chain(self.end_layer)
        if tail is None:
            # The common operator error: every layer hosted, but block
            # boundaries that do not meet exactly.
            covered = set(range(self.start_layer, self.end_layer))
            for start, blocks in by_start.items():
                for _nid, end in blocks:
                    covered.update(range(start, end))
            if covered >= set(range(num_layers)):
                logger.warning(
                    "no route: every layer is hosted but block boundaries "
                    "do not meet exactly (blocks chain only when one "
                    "worker's --end-layer equals the next's --start-layer)"
                )
            return None
        return [self.node_id] + tail

    # -- wire-format negotiation + transport telemetry -----------------------

    # A cached link decision is re-confirmed after this long; a transient
    # probe failure is retried after WIRE_PROBE_RETRY_S (frames ship
    # native meanwhile).
    WIRE_DTYPE_REFRESH_S = 300.0
    WIRE_PROBE_RETRY_S = 30.0

    def _on_wire_caps(self, _peer: str, _payload):
        """The tensor dtypes this build decodes."""
        return {"formats": list(proto.WIRE_DTYPES)}

    def _wire_dtype_for(self, peer: str) -> str | None:
        """Negotiated wire dtype for one link (cached). Runs on the sender
        worker, never the step thread."""
        want = resolve_wire_dtype(
            self.engine_config.wire_dtype, self.model_config.dtype
        )
        if want is None:
            return None
        now = time.monotonic()
        entry = self._wire_dtypes.get(peer)
        if entry is not None and now < entry[1]:
            return entry[0]
        if entry is not None:
            # Expired: serve the stale decision and revalidate off this
            # worker (a blocking probe would stall the queue behind it).
            with self._wire_lock:
                entry = self._wire_dtypes.get(peer)
                if entry is None:
                    stale = None     # forgotten: ship native, re-probe
                else:
                    stale = entry[0]
                    self._wire_dtypes[peer] = (
                        stale, now + self.WIRE_PROBE_RETRY_S
                    )
            if entry is not None:
                threading.Thread(
                    target=self._negotiate_wire_dtype,
                    args=(peer, want, 10.0),
                    daemon=True, name=f"wirecaps-{peer}",
                ).start()
                return stale
        # First contact, or a forget raced in: a short blocking probe only
        # in front of a near-empty queue.
        if self.sender.queue_depth(peer) <= 8:
            self._negotiate_wire_dtype(peer, want, timeout=1.0)
            entry = self._wire_dtypes.get(peer)
            return entry[0] if entry is not None else None
        now = time.monotonic()
        with self._wire_lock:
            if self._wire_dtypes.get(peer) is None:
                self._wire_dtypes[peer] = (None, now + self.WIRE_PROBE_RETRY_S)
        threading.Thread(
            target=self._negotiate_wire_dtype, args=(peer, want, 10.0),
            daemon=True, name=f"wirecaps-{peer}",
        ).start()
        return None

    def _negotiate_wire_dtype(self, peer: str, want: str,
                              timeout: float) -> None:
        """Blocking capability probe + cache update; the answer is dropped
        if the peer was invalidated while the probe was in flight."""
        gen = self._wire_forget_gen.get(peer, 0)

        def log_native(msg, *args):
            if peer not in self._wire_warned_native:
                self._wire_warned_native.add(peer)
                logger.warning(msg, *args)
            else:
                logger.debug(msg, *args)

        try:
            caps = self.transport.call(
                peer, proto.WIRE_CAPS, None, timeout=timeout
            )
        except Exception as e:
            if NO_HANDLER_MARK in str(e):
                # Definitive: a build without WIRE_CAPS will not grow one.
                log_native(
                    "%s: peer %s has no wire_caps handler (older build?); "
                    "sending native frames on this link", self.node_id, peer,
                )
                self._cache_wire_dtype(
                    peer, None, self.WIRE_DTYPE_REFRESH_S, gen)
                return
            log_native(
                "%s: wire_caps probe to %s failed (%s); sending native "
                "frames, retrying in %ds",
                self.node_id, peer, e, int(self.WIRE_PROBE_RETRY_S),
            )
            self._cache_wire_dtype(peer, None, self.WIRE_PROBE_RETRY_S, gen)
            return
        got = None
        formats = set((caps or {}).get("formats") or ())
        if want in formats:
            got = want
            self._wire_warned_native.discard(peer)
        else:
            log_native(
                "%s: peer %s cannot decode wire dtype %s; sending native "
                "frames on this link", self.node_id, peer, want,
            )
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "wire_dtype", node=self.node_id, peer=peer, want=want,
            negotiated=got,
        )
        self._cache_wire_dtype(peer, got, self.WIRE_DTYPE_REFRESH_S, gen)

    def _cache_wire_dtype(self, peer: str, dtype: str | None, ttl: float,
                          gen: int) -> None:
        with self._wire_lock:
            if self._wire_forget_gen.get(peer, 0) == gen:
                self._wire_dtypes[peer] = (dtype, time.monotonic() + ttl)

    def _forget_wire_dtype(self, peer: str) -> None:
        """Drop a link's negotiated wire dtype (the peer failed, restarted
        or departed); the next frame re-probes."""
        with self._wire_lock:
            self._wire_forget_gen[peer] = (
                self._wire_forget_gen.get(peer, 0) + 1
            )
            self._wire_dtypes.pop(peer, None)

    def _on_send_failure(self, peer: str, reason: str) -> None:
        """Sender failure (queue overflow or dead peer): abort the
        requests routed through the peer, on the step thread."""
        logger.error("%s: async send to %s failed: %s",
                     self.node_id, peer, reason)
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "abort_path", node=self.node_id, peer=peer, reason=reason,
        )
        self._forget_wire_dtype(peer)
        if not self.standalone and not self._is_scheduler(peer):
            # Tell the scheduler now: it drops the peer's CacheIndex and
            # accelerates its heartbeat sweep.
            self.sender.send(
                self._sched_peer(), proto.PEER_DOWN,
                {"reporter": self.node_id, "peer": peer, "reason": reason},
                best_effort=True,
            )
        self._post(("abort_path", peer))

    def _count_rx(self, peer: str, wire_req: dict) -> None:
        self._count_rx_bytes(
            peer, proto.tensor_nbytes(wire_req.get("hidden_states")))

    def _count_rx_bytes(self, peer: str, nbytes: int) -> None:
        with self._rx_lock:
            rx = self._rx_stats.setdefault(
                peer or "?", {"frames_in": 0, "bytes_in": 0}
            )
            rx["frames_in"] += 1
            rx["bytes_in"] += nbytes
            rx["t"] = time.monotonic()

    def _reap_rx_stats(self, idle_s: float | None = None) -> None:
        """Drop inbound counters of peers that stopped sending (the
        sender's idle horizon, so tx and rx rows retire together)."""
        if idle_s is None:
            idle_s = self.sender.idle_reap_s
        now = time.monotonic()
        with self._rx_lock:
            for peer in [
                p for p, rx in self._rx_stats.items()
                if now - rx.get("t", now) > idle_s
            ]:
                del self._rx_stats[peer]

    def transport_stats(self) -> dict | None:
        """Per-link telemetry: the sender's outbound counters merged with
        inbound frame/byte counts per source peer."""
        links = self.sender.stats()
        with self._rx_lock:
            rx_snapshot = {p: dict(rx) for p, rx in self._rx_stats.items()}
        for peer, rx in rx_snapshot.items():
            rx.pop("t", None)
            links.setdefault(peer, {}).update(rx)
        return links or None

    # -- transport handlers (any thread) -------------------------------------

    def _on_forward(self, peer: str, payload):
        if isinstance(payload, (bytes, bytearray)):
            # A reference-protocol peer: a raw protobuf ForwardRequest,
            # counted whole-frame.
            ireqs = interop.forward_bytes_to_ireqs(payload)
            self._count_rx_bytes(peer, len(payload))
            for ireq in ireqs:
                self._post(("forward", ireq))
            return "ok"
        for wire_req in payload["reqs"]:
            self._count_rx(peer, wire_req)
            self._post(("forward", proto.ireq_from_wire(wire_req)))
        return "ok"

    def _on_abort(self, _peer: str, payload):
        rids = (interop.abort_bytes_to_rids(payload)
                if isinstance(payload, (bytes, bytearray))
                else payload["rids"])
        for rid in rids:
            self._post(("release", rid, True))
        return "ok"

    def _on_release(self, _peer: str, payload: dict):
        for rid in payload["rids"]:
            self._post(("release", rid, payload.get("abort", False)))
        return "ok"

    def _on_chat_submit(self, _peer: str, payload: dict):
        req = Request(
            request_id=payload["rid"],
            prompt_ids=list(payload["prompt_ids"]),
            sampling_params=SamplingParams.from_dict(
                payload.get("sampling_params") or {}
            ),
            routing_table=list(payload.get("routing_table") or []),
            eos_token_ids=tuple(payload.get("eos_token_ids") or ()),
            lora_id=payload.get("lora_id"),
            # QoS context: the deadline ships as a REMAINING budget and
            # re-anchors on this process's monotonic clock.
            qos_class=payload.get("qos_class"),
            deadline=(
                time.monotonic() + float(payload["deadline_ms"]) / 1e3
                if payload.get("deadline_ms") is not None else None
            ),
            tenant_id=payload.get("tenant"),
        )
        replay = payload.get("replay_ids")
        if replay:
            # Client resume rung: the submitting frontend mirrors tokens it
            # already streamed from a head that died. Teacher-forcing them
            # through ordinary decode steps makes the continuation
            # bit-identical and no token is re-sampled — the replay
            # machinery checkpoint restores use.
            req.replay_ids = [int(x) for x in replay]
            lps = payload.get("replay_logprobs") or []
            req.replay_logprobs = (
                [float(x) for x in lps]
                if len(lps) == len(req.replay_ids) else []
            )
        self._chat_requests[req.request_id] = req
        self.submit(req)
        return "ok"

    def _on_chat_stop(self, _peer: str, payload: dict):
        """Stop-string early finish (FINISHED_STOP; the text stands)."""
        self._post(("stop", payload["rid"]))
        return "ok"

    def _on_chat_poll(self, _peer: str, payload: dict):
        req = self._chat_requests.get(payload["rid"])
        if req is None:
            # Shipped away in a live migration: redirect the poller to the
            # head that owns the request now.
            head = self._migrated_to.get(payload["rid"])
            if head:
                return {"migrated": head}
            return {"error": "unknown request"}
        out = {
            "output_ids": list(req.full_output_ids),
            "output_logprobs": list(req.full_output_logprobs),
            "status": req.status.value,
            "finished": req.status.is_finished,
        }
        if req.status.is_finished:
            self._chat_requests.pop(payload["rid"], None)
        return out

    def submit(self, request: Request) -> threading.Event:
        """Head-node API: enqueue a user request; the returned event fires
        when it finishes."""
        ev = threading.Event()
        self._request_events[request.request_id] = ev
        self._post(("submit", request))
        return ev

    def pop_finished(self) -> list[Request]:
        out = []
        while True:
            try:
                out.append(self._finished.get_nowait())
            except queue.Empty:
                return out

    # -- step loop (owns the engine) -----------------------------------------

    def _post(self, item: tuple) -> None:
        """Enqueue work for the step thread and wake it."""
        self._inbox.put(item)
        self._wake.set()

    def _step_loop(self) -> None:
        # The overlapped two-phase loop keeps exactly ONE step in flight:
        # drive_step dispatches step N+1 before resolving step N. The
        # ticket lives on the node so a reload can drop it with its
        # engine.
        while not self._stop.is_set():
            try:
                wd = self._watchdog
                if wd is not None:
                    # One dict increment a pass: a drive_step that hangs
                    # stops the beats.
                    wd.beat("step_loop")
                worked = self._drain_inbox()
                eng = self.engine
                if eng is not None:
                    # The engine's obs refresh (snapshot, HBM ledger,
                    # device-time harvest) at its own cadence.
                    eng.obs_tick()
                if self._pending is not None and self._pending_engine is not eng:
                    self._pending = None
                if self._migration_pending or self._migration_parked:
                    # Park drained requests as checkpoints and ship the
                    # parked ones to their target pipelines.
                    self._migration_tick(eng)
                if self.role == "prefill" and not self.standalone:
                    # Disaggregation: move finished prompts to the decode
                    # pool (flag -> park -> ship -> result).
                    self._handoff_tick(eng)
                if eng is None:
                    self._wake.wait(0.01)
                    self._wake.clear()
                    continue
                outs, self._pending = drive_step(eng, self._pending)
                self._pending_engine = eng
                for out in outs:
                    self._route_outputs(out)
                    worked = worked or out.num_tokens > 0
                if not worked and self._pending is None:
                    # Event-driven idle wait; the timeout only bounds
                    # housekeeping (request-timeout sweeps).
                    if self._inbox.empty():
                        self._wake.wait(0.05)
                    self._wake.clear()
            except Exception:
                # The step thread must survive: a dead step loop with a
                # live announcer would look healthy forever.
                logger.exception("step loop error")
                pending, eng = self._pending, self._pending_engine
                if pending is not None and eng is not None:
                    # Retry only a ticket that is still unresolved; one
                    # whose own resolve failed was abandoned already.
                    try:
                        if eng.is_inflight(pending):
                            self._route_outputs(eng.resolve(pending))
                    except Exception:
                        logger.exception("in-flight step resolution failed")
                self._pending = None
                time.sleep(0.1)

    def _drain_inbox(self) -> bool:
        worked = False
        while True:
            try:
                item = self._inbox.get_nowait()
            except queue.Empty:
                return worked
            worked = True
            kind = item[0]
            if kind == "forward":
                ireq: IntermediateRequest = item[1]
                if ireq.next_token_id is not None:
                    self.engine.commit_token(
                        ireq.request_id, ireq.next_token_id,
                        ireq.token_logprob,
                    )
                elif ireq.spec_accepted is not None:
                    self.engine.commit_spec_result(
                        ireq.request_id, ireq.spec_accepted)
                else:
                    self.engine.submit_intermediate(ireq)
            elif kind == "submit":
                req: Request = item[1]
                try:
                    if self.standalone and not req.routing_table:
                        route = self.local_route()
                        if route is None:
                            raise RuntimeError(
                                "no route to the last layer from gossip "
                                "announcements"
                            )
                        req.routing_table = route
                    self.engine.submit(req)
                except Exception as e:
                    req.abort(str(e))
                    self._finish(req)
            elif kind == "release":
                rid, aborted = item[1], item[2]
                eng = self.engine
                req = None
                if eng is not None:
                    req = eng.scheduler.running.get(rid) or (
                        eng.scheduler.wait_queue.get(rid)
                    )
                    eng.release(rid, abort=aborted)
                # A release can end a request this HEAD still tracks for a
                # client: complete it for the waiters.
                if req is not None:
                    ev = self._request_events.pop(rid, None)
                    if ev is not None:
                        self._finished.put(req)
                        ev.set()
            elif kind == "stop":
                self.engine.stop_request(item[1])
            elif kind == "abort_path":
                # A next-hop peer is unreachable. A scheduled head
                # checkpoints its requests through it away (migration);
                # mirrors own no restartable state and a scheduler-less
                # swarm has nobody to pick a target: they abort.
                if self.engine is None:
                    continue
                peer = item[1]
                self._forget_wire_dtype(peer)
                migratable = (
                    not self.standalone and self.engine.model.is_first
                )
                sched = self.engine.scheduler
                for req in (
                    list(sched.running.values())
                    + list(sched.wait_queue.values())
                ):
                    if peer not in req.routing_table or req.status.is_finished:
                        continue
                    if migratable and not getattr(req, "is_mirror", False):
                        self._flag_for_migration(req, peer)
                    else:
                        req.abort(f"peer {peer} unreachable")
            elif kind == "drain":
                # Scheduler directive (heartbeat reply): these peers are
                # dead and the pipelines through them are dissolving —
                # checkpoint every affected head request away.
                if self.engine is None or not self.engine.model.is_first:
                    continue
                dead_peers = set(item[1])
                sched = self.engine.scheduler
                for req in (
                    list(sched.running.values())
                    + list(sched.wait_queue.values())
                ):
                    if req.status.is_finished or getattr(
                        req, "is_mirror", False
                    ):
                        continue
                    hit = dead_peers & set(req.routing_table)
                    if hit:
                        self._flag_for_migration(req, sorted(hit)[0])
            elif kind == "restore":
                self._restore_checkpoint(item[1], item[2])
            elif kind == "call":
                fn, box = item[1], item[2]
                try:
                    box.put((True, fn()))
                except Exception as e:
                    box.put((False, e))
            elif kind == "migration_shipped":
                self._on_migration_shipped(item[1])
            elif kind == "handoff_shipped":
                self._on_handoff_shipped(item[1])
            elif kind == "handoff_result":
                self._on_handoff_result(item[1])
            elif kind == "handoff_confirmed":
                # The park deadline's ownership check came back (the entry
                # is already out of the parked map).
                rid, e, owner = item[1], item[2], item[3]
                if isinstance(owner, str) and owner != self.node_id:
                    # The transfer DID land there: the target's finish
                    # releases the retained path charge; ours releases the
                    # old path through _finish_handoff.
                    e.pop("pinned_charged", None)
                    self._finish_handoff(rid, e, owner, with_kv=True)
                else:
                    self._handoff_restore_local(e, "park deadline")
            elif kind == "kv_lane_down":
                # The transfer lane to a decode head died: transfers
                # awaiting its result cannot complete — fall back to a
                # checkpoint-only re-ship now instead of waiting out the
                # result timeout.
                peer = item[1]
                now = time.monotonic()
                for rid, e in self._handoff_parked.items():
                    if (
                        e.get("awaiting_since") is not None
                        and e.get("target") == peer
                    ):
                        self._handoff_transfer_failed(
                            rid, e, "transfer_failed", now)
            elif kind == "liveness":
                # Abort requests routed through peers whose announcements
                # expired — one scan per beat.
                fresh = item[1]
                sched = self.engine.scheduler
                for req in (
                    list(sched.running.values())
                    + list(sched.wait_queue.values())
                ):
                    dead = [p for p in req.routing_table if p not in fresh]
                    if dead and not req.status.is_finished:
                        req.abort(f"peer {dead[0]} unreachable")
            elif kind == "reload":
                self._apply_allocation(item[1])
            elif kind == "refit":
                version, index = item[1], item[2]
                eng = self.engine
                if (
                    version <= self.refit_version
                    or eng is None
                    or self._refit_fetching
                ):
                    continue
                # Fetch and checksum off the step thread: decoding must
                # not stall on network IO. The fetch thread makes no CUDA
                # call: its tensors stay on the host until the apply.
                self._refit_fetching = True
                threading.Thread(
                    target=self._fetch_refit, args=(version, index, eng),
                    daemon=True, name="refit-fetch",
                ).start()
            elif kind == "refit_apply":
                self._apply_refit(*item[1:])

    # -- weight refit ---------------------------------------------------------

    def _fetch_refit(self, version: int, index: dict, eng) -> None:
        """The refit-fetch thread: this stage's tensors as CPU tensors,
        saved to the store when one is set, then posted back to the step
        thread with the engine they were fetched for."""
        from parallax_tpu_torch.p2p.refit import fetch_refit_tensors

        try:
            stats: dict = {}
            tensors = fetch_refit_tensors(eng, index, stats=stats)
            if self.refit_store is not None:
                model = eng.model
                try:
                    t0 = time.perf_counter()
                    self.refit_store.save(version, tensors, meta={
                        "model_name": self.model_config.model_name,
                        "start_layer": model.start_layer,
                        "end_layer": model.end_layer,
                    })
                    stats["store_s"] = time.perf_counter() - t0
                except Exception:
                    logger.exception("refit v%d disk cache failed", version)
            self._post(("refit_apply", version, tensors, eng, stats))
        except Exception:
            logger.exception("refit v%d fetch failed", version)
        finally:
            self._refit_fetching = False

    def _apply_refit(self, version: int, tensors: dict, eng,
                     stats: dict) -> None:
        """On the step thread: swap fetched tensors into the weights in
        place (``apply_prefetched``). A fetch made for an engine that has
        since been rebuilt is dropped: the new engine reports its own
        version and the scheduler's index comes again."""
        from parallax_tpu_torch.p2p.refit import apply_prefetched

        if eng is not self.engine or version <= self.refit_version:
            return
        try:
            t0 = time.perf_counter()
            n = apply_prefetched(eng, tensors, version)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            apply_ms = (time.perf_counter() - t0) * 1e3
        except Exception:
            logger.exception("refit v%d apply failed", version)
            return
        self.refit_version = version
        # The prefix cache was dropped: the scheduler's digest mirror
        # needs a full snapshot.
        self._digests_full_next = True
        entry = {"version": version, "tensors": n,
                 "bytes": int(stats.get("bytes", 0)),
                 "fetch_s": stats.get("fetch_s", 0.0),
                 "sha256_s": stats.get("sha256_s", 0.0),
                 "decode_s": stats.get("decode_s", 0.0),
                 "store_s": stats.get("store_s"),
                 "apply_ms": apply_ms,
                 "pages_invalidated": eng.cache.stats.pages_invalidated}
        self.refit_log.append(entry)
        logger.info("refit: %s", json.dumps(entry))

    def _restore_refit_cache(self) -> None:
        """Reload the newest cached refit version for this model and layer
        range after a (re)load, so a restarted worker serves the pushed
        weights without fetching them again. Newest first, falling back
        through older intact versions (a crash mid-save could leave the
        newest unreadable); a version cached for another model or layer
        range is skipped: its stage-local keys would shape-check but hold
        other layers' weights."""
        if self.refit_store is None or self.engine is None:
            return
        from parallax_tpu_torch.p2p.refit import apply_prefetched

        for version in reversed(self.refit_store.versions()):
            if version <= self.refit_version:
                return
            meta = self.refit_store.load_meta(version)
            if meta is None or (
                meta.get("model_name") != self.model_config.model_name
                or meta.get("start_layer") != self.start_layer
                or meta.get("end_layer") != self.end_layer
            ):
                logger.info(
                    "refit cache v%d skipped (cached for %s [%s, %s))",
                    version, (meta or {}).get("model_name"),
                    (meta or {}).get("start_layer"),
                    (meta or {}).get("end_layer"),
                )
                continue
            try:
                apply_prefetched(self.engine, self.refit_store.load(version),
                                 version)
                self.refit_version = version
                logger.info("refit cache v%d restored", version)
                return
            except Exception:
                logger.exception("refit cache restore v%d failed", version)

    # -- live migration -------------------------------------------------------

    def _flag_for_migration(self, req: Request, dead_peer: str) -> None:
        rid = req.request_id
        if rid in self._migration_pending or rid in self._migration_parked:
            return
        if rid in self._handoff_pending or rid in self._handoff_parked:
            # Already leaving through the handoff: its own ladder
            # (re-ship, local restore) recovers it.
            return
        req.migrating = True
        self._migration_pending[rid] = dead_peer
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "migrate_flag", node=self.node_id, request_id=rid,
            dead_peer=dead_peer,
        )

    def _migration_tick(self, eng) -> None:
        """One step-loop pass of the migration state machine: park flagged
        requests that left every in-flight step and window, ship parked
        ones, abort the ones nobody could take before the deadline."""
        now = time.monotonic()
        if self._migration_pending and eng is not None:
            inflight = eng.inflight_rids()
            for rid, dead in list(self._migration_pending.items()):
                sched = eng.scheduler
                req = sched.running.get(rid) or sched.wait_queue.get(rid)
                if req is None or req.status.is_finished:
                    self._migration_pending.pop(rid, None)
                    continue
                if rid in inflight:
                    continue    # its pages are being written; next pass
                self._migration_pending.pop(rid)
                self._park_request(eng, req, dead)
        ready = [
            rid for rid, e in self._migration_parked.items()
            if not e["shipping"] and now >= e["next_attempt"]
        ]
        if ready:
            for rid in ready:
                self._migration_parked[rid]["shipping"] = True
            entries = {rid: self._migration_parked[rid] for rid in ready}
            threading.Thread(
                target=self._ship_checkpoints, args=(entries,),
                daemon=True, name="migrate-ship",
            ).start()
        for rid, e in list(self._migration_parked.items()):
            if not e["shipping"] and now > e["deadline"]:
                self._migration_parked.pop(rid)
                self._migration_progress += 1
                req = e["req"]
                req.abort("migration: no serviceable pipeline")
                self._finish(req)

    @staticmethod
    def _harvestable(req: Request) -> bool:
        """Whether a park can carry this request's KV as a checkpoint
        image: a decode row past prefill, or a MID-PREFILL row with
        computed tokens of its own (the target resumes the chunked prefill
        at the computed mark). PREEMPTED rows already live in the host
        tier and restore via replay."""
        return (
            req.status is RequestStatus.DECODING and req.is_prefill_done
        ) or (
            req.status is RequestStatus.PREFILLING
            and req.num_computed_tokens > 0
        )

    def _park_request(
        self, eng, req: Request, dead_peer: str, force: bool = False
    ) -> None:
        """Checkpoint one request out of the engine, on the step thread.
        The KV image and the grammar fields are harvested here, before
        ``extract`` drops the engine's per-request state; the ship thread
        reads only what this parks (CPU tensors and host values)."""
        rid = req.request_id
        image = None
        grammar = None
        if not force:
            grammar = eng.grammar_checkpoint_fields(rid)
        if not force and eng.host_tier is not None and self._harvestable(req):
            # The committed KV image parks in the host tier exactly like a
            # preemption; the checkpoint serializes it so a
            # layout-compatible target swaps it in instead of recomputing.
            # A mid-prefill park first trims the owned pages to the
            # computed span. A failed preemption (tier full) means
            # re-prefill at the target; a failed transfer raises.
            if req.status is RequestStatus.PREFILLING:
                eng.cache.trim_uncomputed_pages(req)
            if eng.cache.preempt_to_host(req):
                image = eng.harvest_kv_image(req)
        extracted = eng.extract(rid, force=force)
        if extracted is None:
            # Raced back into flight; re-flag and retry next pass.
            self._migration_pending[rid] = dead_peer
            return
        old_table = list(req.routing_table)
        eng.cache.release(req)
        # Old-path survivors drop their mirrors now, not at timeout.
        for peer in old_table:
            if peer != self.node_id and peer != dead_peer:
                self.sender.send(
                    peer, proto.RELEASE,
                    {"rids": [rid], "abort": True}, best_effort=True,
                )
        now = time.monotonic()
        self._migration_parked[rid] = {
            "req": req,
            "image": image,
            "grammar": grammar,
            "old_table": old_table,
            "dead": dead_peer,
            "parked_wall": time.time(),
            "deadline": now + self.MIGRATION_PARK_TIMEOUT_S,
            "next_attempt": now,
            "shipping": False,
        }
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "migrate_park", node=self.node_id, request_id=rid,
            kv_pages=(len(image.layers[0]) if image is not None else 0),
            tokens=len(req.full_output_ids),
        )

    def _ship_checkpoints(self, entries: dict[str, dict]) -> None:
        """Ship thread: ask the scheduler for CacheIndex-scored targets,
        ship each checkpoint over an acknowledged RPC, report the outcomes
        back to the step thread. Reads only parked (frozen) request state.
        Every entry ALWAYS gets a result posted — an unexpected error maps
        to "retry", never to a permanently ``shipping`` entry that the
        park-timeout abort could no longer reach."""
        results: dict[str, tuple] = {}
        try:
            self._ship_checkpoints_inner(entries, results)
        except Exception:
            logger.exception("%s: checkpoint ship failed", self.node_id)
        finally:
            for rid in entries:
                results.setdefault(rid, ("retry", "ship error"))
            self._post(("migration_shipped", results))

    @staticmethod
    def _target_descriptor(req: Request, page: int) -> dict:
        """CacheIndex-scoring descriptor for one parked request: the FULL
        token history (a resumed request's prompt already folds prior
        outputs in, and outputs awaiting teacher-forced replay count too),
        so the scheduler's chain prediction sees the tokens the restore
        will re-prefill."""
        history = list(req.all_token_ids) + list(req.replay_ids)
        d = {
            "rid": req.request_id,
            "prompt_tokens": len(history),
            "lora_id": req.lora_id,
        }
        if req.lora_id is not None:
            # Adapter requests hash in the adapter's own digest namespace:
            # deterministic per adapter id, so the scheduler's CacheIndex
            # mirrors (fed from equally salted radix trees on every
            # replica) score them too.
            salt = derive_ns_salt(req.lora_id)
            history = [t ^ salt for t in history]
        d["chains"] = {str(page): block_hash_chain(history, page)}
        return d

    def _ship_checkpoints_inner(
        self, entries: dict[str, dict], results: dict[str, tuple]
    ) -> None:
        page = self.engine_config.page_size
        descriptors = [
            self._target_descriptor(e["req"], page) for e in entries.values()
        ]
        try:
            reply = self.sched_transport.call(
                self.scheduler_peer, proto.MIGRATE_TARGET,
                {
                    "requests": descriptors,
                    "exclude": sorted({e["dead"] for e in entries.values()}),
                },
                timeout=15.0,
            )
            targets = (reply or {}).get("targets") or {}
        except Exception as exc:
            logger.warning("%s: migrate_target query failed: %s",
                           self.node_id, exc)
            targets = {}
        by_head: dict[str, list] = {}
        for rid, e in entries.items():
            t = targets.get(rid)
            if not isinstance(t, dict) or not t.get("path"):
                results[rid] = ("retry", "no serviceable pipeline")
                continue
            path = [str(x) for x in t["path"]]
            image = e["image"]
            # Raw-KV adoption only makes sense when the target head runs
            # the exact same stage: a single-stage pipeline over our layer
            # range. Anything else re-prefills (which also feeds downstream
            # stages their chunks).
            kv_ok = (
                image is not None
                and len(path) == 1
                and list(t.get("head_layers") or [])
                == [image.start_layer, image.end_layer]
            )
            ckpt = checkpoint_from_request(
                e["req"], routing_table=path,
                kv=image if kv_ok else None,
                grammar=e["grammar"],
            )
            ckpt.parked_wall = e["parked_wall"]
            by_head.setdefault(path[0], []).append(
                (rid, path, checkpoint_to_wire(ckpt))
            )
        for head, batch in by_head.items():
            try:
                reply = self.transport.call(
                    head, proto.CHECKPOINT,
                    {"checkpoints": [w for _r, _p, w in batch]},
                    timeout=30.0,
                )
            except Exception as exc:
                # The chosen target died between choice and ship: the load
                # charge must not leak, and the request retries against
                # whatever pipeline the next query finds.
                for rid, path, _w in batch:
                    results[rid] = ("retry", f"target {head} unreachable")
                    self.sender.send(
                        self._sched_peer(), proto.REQUEST_COMPLETE,
                        {"path": path}, best_effort=True,
                    )
                logger.warning("%s: checkpoint ship to %s failed: %s",
                               self.node_id, head, exc)
                continue
            accepted = set((reply or {}).get("accepted") or ())
            rejected = (reply or {}).get("rejected") or {}
            for rid, path, _w in batch:
                if rid in accepted:
                    results[rid] = ("ok", head)
                else:
                    results[rid] = (
                        "failed",
                        str(rejected.get(rid) or "target rejected"),
                    )
                    self.sender.send(
                        self._sched_peer(), proto.REQUEST_COMPLETE,
                        {"path": path}, best_effort=True,
                    )

    def _on_migration_shipped(self, results: dict[str, tuple]) -> None:
        self._migration_progress += 1
        for rid, (status, info) in results.items():
            e = self._migration_parked.get(rid)
            if e is None:
                continue
            if status == "ok":
                self._migration_parked.pop(rid)
                self._record_migrated(rid, info)
                # The request lives on the target now: pollers get the
                # {"migrated": head} redirect, and a direct submitter's
                # done-event is retired unfired (chat_poll is the follow
                # channel).
                self._chat_requests.pop(rid, None)
                self._request_events.pop(rid, None)
                # Release the OLD path's load charge; the target's own
                # request_complete covers the new path when it finishes.
                self.sender.send(
                    self._sched_peer(), proto.REQUEST_COMPLETE,
                    {"path": e["old_table"] or [self.node_id]},
                    best_effort=True,
                )
                logger.info("%s: migrated %s to %s (%s)", self.node_id,
                            rid, info, "KV image" if e["image"] is not None
                            else "replay")
                from parallax_tpu_torch.obs.flight import get_flight

                get_flight().event(
                    "migrate_out", node=self.node_id, request_id=rid,
                    target=info, with_kv=e["image"] is not None,
                )
            else:
                # "retry" (target unreachable / no pipeline) and "failed"
                # (target rejected) re-enter the park loop: the next query
                # may pick another pipeline, and the park deadline bounds
                # how long we keep trying before the abort.
                if status == "failed":
                    logger.warning(
                        "%s: migration of %s rejected (%s); retrying until "
                        "the park deadline", self.node_id, rid, info,
                    )
                e["shipping"] = False
                e["next_attempt"] = time.monotonic() + self.MIGRATION_RETRY_S

    def _record_migrated(self, rid: str, head: str) -> None:
        self._migrated_to[rid] = head
        while len(self._migrated_to) > 4096:
            self._migrated_to.popitem(last=False)

    # -- disaggregated prefill / decode: the KV handoff -------------------
    #
    # Prefill-role head flow, one step-loop pass at a time: a request
    # crosses the prefill / decode boundary (prompt KV computed, first
    # token committed) -> FLAGGED (``migrating`` stops the local scheduler
    # from planning it into further steps and windows) -> once out of the
    # in-flight window it is PARKED exactly like a migration (KV preempted
    # to the host tier and harvested into an image, the grammar fields
    # read, the request extracted, pages released) -> the scheduler picks
    # a CacheIndex-scored DECODE-POOL target -> the image streams over the
    # KV lane as layer-chunked KV_TRANSFER frames -> the decode head
    # assembles, validates through the strict checkpoint decoder, admits
    # the request like a preempted resume and answers KV_RESULT. Fallback
    # ladder on any miss: checkpoint-only re-ship (re-prefill from the
    # target's radix + teacher-forced replay), then local restore
    # (mixed-mode decode here), then — only if the engine itself is gone —
    # abort.

    def _handoff_tick(self, eng) -> None:
        """One step-loop pass of the handoff state machine: flag, park,
        ship, resolve result timeouts and the park deadline."""
        now = time.monotonic()
        if eng is not None and eng.model.is_first:
            for rid in eng.handoff_ready_rids():
                if (
                    rid in self._handoff_pending
                    or rid in self._handoff_parked
                    or rid in self._migration_pending
                ):
                    continue
                req = eng.scheduler.running.get(rid)
                if req is None or req.status.is_finished:
                    continue
                if req.handoff_local:
                    continue
                req.migrating = True
                self._handoff_pending[rid] = now
                from parallax_tpu_torch.obs.flight import get_flight

                get_flight().event(
                    "handoff_flag", node=self.node_id, request_id=rid,
                )
        if self._handoff_pending and eng is not None:
            inflight = eng.inflight_rids()
            for rid in list(self._handoff_pending):
                sched = eng.scheduler
                req = sched.running.get(rid) or sched.wait_queue.get(rid)
                if req is None or req.status.is_finished:
                    self._handoff_pending.pop(rid, None)
                    continue
                if rid in inflight:
                    continue    # pages still being written; next pass
                flagged = self._handoff_pending.pop(rid)
                self._park_for_handoff(eng, req, flagged)
        ready = [
            rid for rid, e in self._handoff_parked.items()
            if not e["shipping"] and e["awaiting_since"] is None
            and now >= e["next_attempt"]
        ]
        if ready:
            for rid in ready:
                self._handoff_parked[rid]["shipping"] = True
            entries = {rid: self._handoff_parked[rid] for rid in ready}
            threading.Thread(
                target=self._ship_handoffs, args=(entries,),
                daemon=True, name="kv-handoff-ship",
            ).start()
        for rid, e in list(self._handoff_parked.items()):
            if (
                e["awaiting_since"] is not None
                and now - e["awaiting_since"] > self.HANDOFF_RESULT_TIMEOUT_S
            ):
                self._handoff_transfer_failed(rid, e, "result_timeout", now)
            elif (
                not e["shipping"]
                and e["awaiting_since"] is None
                and now > e["deadline"]
            ):
                # Park deadline: nobody (provably) took it — decode it
                # HERE, the mixed-mode rung, never an abort. An entry that
                # ever had a pinned target first confirms ownership with
                # the scheduler's where_is table: under an asymmetric
                # partition the target may own the request while every
                # result and re-ship back to us was lost, and a local
                # restore would then fork it onto two heads.
                self._handoff_parked.pop(rid)
                self._handoff_progress += 1
                if e.get("pinned_target"):
                    threading.Thread(
                        target=self._confirm_then_restore_local,
                        args=(rid, e), daemon=True,
                        name="kv-handoff-confirm",
                    ).start()
                else:
                    self._handoff_restore_local(e, "park deadline")

    def _confirm_then_restore_local(self, rid: str, e: dict) -> None:
        """Background thread (the where_is RPC must not block the step
        thread): if the scheduler records another head owning ``rid``, the
        earlier transfer landed — finish the handoff instead of forking a
        local copy. An unknown or unreachable answer restores locally
        (availability first)."""
        owner = None
        try:
            reply = self.sched_transport.call(
                self.scheduler_peer, proto.WHERE_IS, {"rid": rid},
                timeout=5.0,
            )
            owner = (reply or {}).get("head")
        except Exception:
            owner = None
        self._post(("handoff_confirmed", rid, e, owner))

    def _handoff_transfer_failed(
        self, rid: str, e: dict, reason: str, now: float, pin: bool = True,
    ) -> None:
        """A KV transfer died (nack, lane failure, result timeout): release
        the charged target path and drop to the checkpoint-only rung on the
        next ship attempt.

        ``pin`` (timeouts and lane failures — wherever the target's verdict
        is UNKNOWN) routes that re-ship back to the SAME target: if the
        slow transfer succeeded there, the duplicate ack resolves it in
        place, whereas a fresh target would leave two heads decoding the
        same request. An explicit nack from the target (it does NOT own
        the request) re-ships pin-free."""
        self.handoff_stats.record_fallback(reason)
        path = e.get("target_path")
        if pin and e.get("target"):
            # Verdict unknown: the target MAY own (and later finish) the
            # request, and its finish releases the path charge — releasing
            # here too would double-decrement the decode head's load.
            # Keep the charge with the pin; it is released only once the
            # pinned re-ship proves the target does NOT own the request
            # (reject / unreachable) or the park deadline restores it
            # locally.
            e["pinned_target"] = e["target"]
            e["pinned_path"] = list(path or [e["target"]])
            e["pinned_charged"] = bool(path)
        elif path:
            # Explicit nack (or no known target): the target never took
            # ownership, so nothing else releases the router charge the
            # scheduler made when it chose this path.
            self.sender.send(
                self._sched_peer(), proto.REQUEST_COMPLETE,
                {"path": list(path)}, best_effort=True,
            )
        e["awaiting_since"] = None
        e["target"] = None
        e["target_path"] = None
        e["kv_failed"] = True
        e["next_attempt"] = now

    def _release_pinned_charge(self, e: dict) -> None:
        """Release the router charge kept across a pinned re-ship — once,
        when the pinned target is proven NOT to own the request or the
        request restores locally."""
        if e.pop("pinned_charged", False) and e.get("pinned_path"):
            self.sender.send(
                self._sched_peer(), proto.REQUEST_COMPLETE,
                {"path": list(e["pinned_path"])}, best_effort=True,
            )

    def _park_for_handoff(self, eng, req: Request, flagged: float) -> None:
        """Checkpoint one finished prompt out of the prefill engine, on the
        step thread (cache bookkeeping and every CUDA call live there).
        The mechanics of a migration park: the grammar fields first, then
        a host-tier preempt and image harvest where possible, extract,
        release. The ship thread reads only what this parks (CPU tensors
        and host values)."""
        rid = req.request_id
        t_park = time.monotonic()
        image = None
        # Read before ``extract``, which drops the engine's DFA state. The
        # JAX park reads none, and its decode head recomputes the state
        # from the stream.
        grammar = eng.grammar_checkpoint_fields(rid)
        if eng.host_tier is not None and self._harvestable(req):
            try:
                if req.status is RequestStatus.PREFILLING:
                    eng.cache.trim_uncomputed_pages(req)
                if eng.cache.preempt_to_host(req):
                    image = eng.harvest_kv_image(req)
            except Exception:
                logger.exception(
                    "%s: KV harvest for the handoff of %s failed (the "
                    "decode pool will re-prefill)", self.node_id, rid,
                )
                image = None
        extracted = eng.extract(rid)
        if extracted is None:
            # Raced back into flight; re-flag and retry next pass.
            self._handoff_pending[rid] = flagged
            return
        old_table = list(req.routing_table)
        try:
            eng.cache.release(req)
        except Exception:
            logger.exception("%s: cache release for handoff %s failed",
                             self.node_id, rid)
        # Multi-stage prefill pipeline: downstream mirrors drop now.
        for peer in old_table:
            if peer != self.node_id:
                self.sender.send(
                    peer, proto.RELEASE,
                    {"rids": [rid], "abort": True}, best_effort=True,
                )
        now = time.monotonic()
        self._handoff_parked[rid] = {
            "req": req,
            "image": image,
            "grammar": grammar,
            "old_table": old_table,
            "parked_wall": time.time(),
            "parked": now,
            "deadline": now + self.HANDOFF_PARK_TIMEOUT_S,
            "next_attempt": now,
            "shipping": False,
            "awaiting_since": None,
            "target": None,
            "target_path": None,
            "t_ship": None,
            "kv_failed": False,
            # Set by a result timeout or a lane failure: the next ship
            # goes back to this target (checkpoint-only), so a slow but
            # successful transfer resolves through the duplicate ack
            # instead of double-decoding on a fresh target.
            "pinned_target": None,
            "pinned_path": None,
            # Static ladder rungs already counted for this entry: the
            # retry loop derives the same reason on every attempt.
            "fallbacks_counted": set(),
        }
        self.handoff_stats.note(
            rid, flag_to_park_ms=(now - flagged) * 1e3,
            park_ms=(now - t_park) * 1e3,
            pages=(int(image.layers[0].shape[0]) if image is not None
                   else 0),
            tokens=len(req.full_output_ids),
        )
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "handoff_park", node=self.node_id, request_id=rid,
            kv_pages=(int(image.layers[0].shape[0]) if image is not None
                      else 0),
            tokens=len(req.full_output_ids),
        )
        if req.traced:
            from parallax_tpu_torch.obs.trace import get_trace_store

            get_trace_store().add(
                rid, self.node_id, "kv_handoff_park",
                t0=time.perf_counter(), dur=0.0, args={},
            )

    def _ship_handoffs(self, entries: dict[str, dict]) -> None:
        """Ship thread: decode-pool targets from the scheduler, then per
        request either stream the KV image over the KV lane or ship the
        checkpoint inline (re-prefill rungs). Reads only parked (frozen)
        state; every entry ALWAYS gets a result posted."""
        results: dict[str, tuple] = {}
        try:
            self._ship_handoffs_inner(entries, results)
        except Exception:
            logger.exception("%s: handoff ship failed", self.node_id)
        finally:
            for rid in entries:
                results.setdefault(rid, ("retry", "ship error"))
            self._post(("handoff_shipped", results))

    def _ship_handoffs_inner(
        self, entries: dict[str, dict], results: dict[str, tuple]
    ) -> None:
        page = self.engine_config.page_size
        descriptors = [
            self._target_descriptor(e["req"], page)
            for e in entries.values()
            if not e.get("pinned_target")   # known target: no query
        ]
        targets = {}
        if descriptors:
            try:
                reply = self.sched_transport.call(
                    self.scheduler_peer, proto.DISAGG_TARGET,
                    {"requests": descriptors, "exclude": [self.node_id]},
                    timeout=15.0,
                )
                targets = (reply or {}).get("targets") or {}
            except Exception as exc:
                logger.warning("%s: disagg_target query failed: %s",
                               self.node_id, exc)
        for rid, e in entries.items():
            pinned = e.get("pinned_target")
            image = e["image"]
            if pinned:
                # Re-ship after a timeout: BACK to the original target,
                # checkpoint-only. If the slow transfer succeeded there,
                # the duplicate ack resolves it in place; no fresh router
                # charge was made for this path.
                path = [str(x) for x in (e.get("pinned_path") or [pinned])]
                head, kv_ok, charged = path[0], False, False
            else:
                t = targets.get(rid)
                if not isinstance(t, dict) or not t.get("path"):
                    # No decode / mixed pipeline serviceable: keep it
                    # local (mixed-mode decode), visible in the
                    # scheduler's disagg no_target counter.
                    results[rid] = ("local", "no serviceable decode "
                                    "pipeline")
                    continue
                path = [str(x) for x in t["path"]]
                head = path[0]
                charged = True
                predicted = int(t.get("predicted_cached_tokens") or 0)
                reason = None
                if image is None:
                    reason = "no_image"   # no host tier / partial park
                elif e["kv_failed"]:
                    pass                  # counted at the failure site
                elif len(path) != 1 or list(
                    t.get("head_layers") or []
                ) != [image.start_layer, image.end_layer]:
                    reason = "layout"     # raw pages cannot adopt there
                elif predicted >= image.computed_tokens - page:
                    # Smart skip: the target's radix already covers
                    # (within a page of) everything the image holds —
                    # re-prefilling there is about one page of compute,
                    # cheaper than the wire.
                    reason = "prefix_warm"
                kv_ok = (
                    image is not None and not e["kv_failed"]
                    and reason is None
                )
                if reason is not None \
                        and reason not in e["fallbacks_counted"]:
                    e["fallbacks_counted"].add(reason)
                    self.handoff_stats.record_fallback(reason)
            ckpt = kv_handoff.handoff_checkpoint(
                e["req"], path, kv=None, grammar=e["grammar"])
            ckpt.parked_wall = e["parked_wall"]
            wire = checkpoint_to_wire(ckpt)
            if kv_ok:
                frames = kv_handoff.image_to_frames(
                    rid, wire, image, self.kv_transfer_chunk_bytes)
                total_b = sum(b for _f, b in frames)
                t_first = time.monotonic()
                if not self._enqueue_kv_frames(head, frames):
                    # Backpressure deadline hit (lane wedged, or the image
                    # outruns the link): the assembler's sequence check
                    # nacks whatever partial landed, and this request
                    # takes the checkpoint-only rung NOW.
                    self.handoff_stats.record_fallback("transfer_failed")
                    e["kv_failed"] = True
                    results[rid] = ("retry", "kv lane backpressure")
                    self.sender.send(
                        self._sched_peer(), proto.REQUEST_COMPLETE,
                        {"path": path}, best_effort=True,
                    )
                    continue
                self.handoff_stats.record_transfer(
                    "out", frames=len(frames), nbytes=total_b)
                self.handoff_stats.note(
                    rid, target=head, frames=len(frames), bytes=total_b)
                results[rid] = ("sent", (head, path, t_first))
            else:
                # Checkpoint-only rung: the acknowledged migration wire;
                # the target re-prefills from its own radix and
                # teacher-forces the recorded tokens.
                try:
                    reply = self.transport.call(
                        head, proto.CHECKPOINT,
                        {"checkpoints": [wire]}, timeout=30.0,
                    )
                except Exception:
                    results[rid] = ("retry", f"target {head} unreachable")
                    if charged:
                        self.sender.send(
                            self._sched_peer(), proto.REQUEST_COMPLETE,
                            {"path": path}, best_effort=True,
                        )
                    # A pinned target stays pinned when UNREACHABLE: a
                    # call timeout to a live but overloaded head looks
                    # like death here, and shipping to a fresh target
                    # while the pinned one may own the request would fork
                    # it onto two heads. A dead target resolves at the
                    # park deadline (local restore).
                    continue
                accepted = set((reply or {}).get("accepted") or ())
                if rid in accepted:
                    results[rid] = ("ok", head)
                else:
                    rejected = (reply or {}).get("rejected") or {}
                    results[rid] = (
                        "retry",
                        str(rejected.get(rid) or "target rejected"),
                    )
                    if charged:
                        self.sender.send(
                            self._sched_peer(), proto.REQUEST_COMPLETE,
                            {"path": path}, best_effort=True,
                        )
                    if pinned:
                        # Explicit rejection: the pinned target does NOT
                        # own the request — release the kept charge and
                        # let the next round pick any decode replica.
                        self._release_pinned_charge(e)
                        e["pinned_target"] = None
                        e["pinned_path"] = None

    def _enqueue_kv_frames(self, head: str, frames: list) -> bool:
        """Feed one transfer's frames onto the KV lane WITH backpressure
        (the ship thread may block): enqueueing a many-frame image at once
        would overflow the lane's bounded queue — destroying the transfer
        and reporting a healthy decode head as down — because an enqueue
        is instantaneous while the drain runs at wire speed. False at the
        deadline; the caller falls back to checkpoint-only."""
        deadline = time.monotonic() + self.KV_LANE_DRAIN_TIMEOUT_S
        for f, b in frames:
            while self.kv_sender.queue_depth(head) >= self.KV_LANE_HIGH_WATER:
                if time.monotonic() > deadline or self._stop.is_set():
                    return False
                time.sleep(0.005)
            # The lazy tuple payload feeds the lane's telemetry; the frame
            # was built here on the ship thread, so the worker only packs.
            self.kv_sender.send(
                head, proto.KV_TRANSFER, (lambda f=f, b=b: (f, b, b)),
            )
        return True

    def _on_handoff_shipped(self, results: dict[str, tuple]) -> None:
        """Step thread: fold one ship round's outcomes back into the parked
        ledger."""
        self._handoff_progress += 1
        now = time.monotonic()
        for rid, (status, info) in results.items():
            e = self._handoff_parked.get(rid)
            if e is None:
                continue
            e["shipping"] = False
            if status == "ok":
                self._handoff_parked.pop(rid)
                self._finish_handoff(rid, e, info, with_kv=False)
            elif status == "sent":
                head, path, t_first = info
                e["awaiting_since"] = now
                e["t_ship"] = t_first
                e["target"] = head
                e["target_path"] = list(path)
                early = e.pop("early_result", None)
                if early is not None:
                    # The decode head answered before this ship round's
                    # results event landed (TCP and loopback can race):
                    # consume the stashed result now instead of stalling
                    # to the result timeout and re-shipping a request the
                    # target already owns.
                    self._on_handoff_result(early)
            elif status == "local":
                self._handoff_parked.pop(rid)
                self.handoff_stats.record_fallback("no_decode_pool")
                self._handoff_restore_local(e, str(info))
            else:   # retry
                e["next_attempt"] = now + self.HANDOFF_RETRY_S

    def _on_handoff_result(self, payload: dict) -> None:
        """Step thread: a decode head's KV_RESULT for one transfer."""
        rid = str(payload.get("rid") or "")
        e = self._handoff_parked.get(rid)
        if e is None:
            return      # late or duplicate result; already resolved
        if e["awaiting_since"] is None:
            if e["shipping"]:
                # Raced ahead of the ship round's own results event: stash
                # it — the "sent" transition consumes it.
                e["early_result"] = dict(payload)
            return
        self._handoff_progress += 1
        if payload.get("ok"):
            self._handoff_parked.pop(rid)
            now = time.monotonic()
            if e["t_ship"] is not None:
                # Out-leg latency: first frame enqueued -> accept.
                ms = (now - e["t_ship"]) * 1e3
                self.handoff_stats.record_transfer(
                    "out", frames=0, nbytes=0, ms=ms)
                self.handoff_stats.note(rid, ship_to_result_ms=ms)
            self.handoff_stats.note(
                rid, park_to_result_ms=(now - e["parked"]) * 1e3)
            self._finish_handoff(rid, e, e.get("target") or "?",
                                 with_kv=True)
        else:
            logger.warning(
                "%s: kv transfer of %s rejected by %s (%s); falling back "
                "to checkpoint-only", self.node_id, rid, e.get("target"),
                payload.get("reason") or "?",
            )
            # Explicit nack: the target does NOT own the request — the
            # re-ship may pick any decode replica.
            self._handoff_transfer_failed(
                rid, e, "transfer_failed", time.monotonic(), pin=False)

    def _finish_handoff(
        self, rid: str, e: dict, head: str, with_kv: bool
    ) -> None:
        """The decode head owns the request now: redirect pollers, release
        the old (prefill) path's load charge."""
        self._record_migrated(rid, head)
        self._chat_requests.pop(rid, None)
        self._request_events.pop(rid, None)
        self.sender.send(
            self._sched_peer(), proto.REQUEST_COMPLETE,
            {"path": e["old_table"] or [self.node_id]}, best_effort=True,
        )
        self.handoff_stats.note(rid, target=head,
                                outcome="image" if with_kv else "checkpoint")
        logger.info("%s: handed %s off to %s (%s)", self.node_id, rid,
                    head, "KV image" if with_kv else "checkpoint only")
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "handoff_out", node=self.node_id, request_id=rid,
            target=head, with_kv=with_kv,
        )
        if e["req"].traced:
            from parallax_tpu_torch.obs.trace import get_trace_store

            get_trace_store().add(
                rid, self.node_id, "kv_handoff_out",
                t0=time.perf_counter(), dur=0.0,
                args={"target": head, "with_kv": with_kv},
            )

    def _handoff_restore_local(self, e: dict, reason: str) -> None:
        """Mixed-mode rung: decode the parked request HERE, through the
        restore path a decode target runs (KV-image adoption through the
        host tier included), so the continuation is bit-identical whichever
        rung serves it.

        The restored request keeps its ORIGINAL routing table: on a
        multi-stage prefill pipeline the head hosts only its own layer
        slice, so decode still flows through the downstream stages (whose
        mirrors the replay's re-prefill rebuilds), and the finish releases
        exactly the path the dispatcher charged. The image is re-adopted
        only on a single-stage head: adopting it on a multi-stage head
        would skip the re-prefill that feeds the downstream stages their
        KV."""
        req = e["req"]
        rid = req.request_id
        logger.info("%s: restoring the handoff of %s locally (%s)",
                    self.node_id, rid, reason)
        self._release_pinned_charge(e)
        table = list(e["old_table"] or [self.node_id])
        ckpt = kv_handoff.handoff_checkpoint(
            req, table, kv=e["image"] if len(table) == 1 else None,
            grammar=e["grammar"])
        ckpt.parked_wall = e["parked_wall"]
        self.handoff_stats.note(rid, outcome="local")
        self._restore_checkpoint(ckpt, self.node_id)

    def _on_kv_transfer(self, peer: str, payload):
        """Decode-target side of the KV lane (a transport thread, CPU
        tensors only): assemble layer-chunked frames; on the end frame,
        admit like an rpc_checkpoint batch — the step thread adopts the
        pages — and answer KV_RESULT (the source releases its state only
        on ok)."""
        res = self._kv_assembler.feed(peer, payload)
        if res is None:
            return "ok"
        kind, val = res
        rid = payload.get("rid") if isinstance(payload, dict) else None
        if kind == "error":
            logger.warning("%s: kv transfer from %s rejected: %s",
                           self.node_id, peer, val)
            if rid:
                self.sender.send(
                    peer, proto.KV_RESULT,
                    {"rid": str(rid), "ok": False, "reason": str(val)},
                    best_effort=True,
                )
            return "ok"
        ckpt = val
        ok, reason = self._admit_restore(ckpt, peer)
        self.sender.send(
            peer, proto.KV_RESULT,
            {"rid": ckpt.request_id, "ok": ok, "reason": reason},
            best_effort=True,
        )
        return "ok"

    def _on_kv_result(self, _peer: str, payload: dict):
        self._post(("handoff_result", dict(payload or {})))
        return "ok"

    def _on_kv_send_failure(self, peer: str, reason: str) -> None:
        """KV lane failure. Unlike the data plane's, nothing routed through
        ``peer`` still runs here — handed-off requests were parked and
        extracted first — so no abort_path scan. Report the peer down and
        fail the awaiting transfers over to the checkpoint-only rung."""
        logger.error("%s: kv lane to %s failed: %s",
                     self.node_id, peer, reason)
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "kv_lane_down", node=self.node_id, peer=peer, reason=reason,
        )
        if not self.standalone and not self._is_scheduler(peer):
            self.sender.send(
                self._sched_peer(), proto.PEER_DOWN,
                {"reporter": self.node_id, "peer": peer,
                 "reason": f"kv lane: {reason}"},
                best_effort=True,
            )
        self._post(("kv_lane_down", peer))

    def _admit_restore(self, ckpt, peer: str) -> tuple[bool, str]:
        """Admission gate for migrated and handed-off checkpoints (inline
        rpc_checkpoint batches and assembled KV transfers): duplicate ships
        ack WITHOUT a second submit, saturation rejects so the source
        retries elsewhere, and the poll mirror registers BEFORE the ack so
        redirected pollers never see "unknown request"."""
        if self.engine is None:
            return False, "no engine"
        if ckpt.request_id in self._chat_requests:
            # Duplicate ship (our previous ack was lost in flight): the
            # request is already restoring or running here.
            return True, "duplicate"
        sched = self.engine.scheduler
        if len(sched.wait_queue) >= sched.max_queue_size:
            # Acceptance transfers ownership, so the later engine submit
            # must be going to succeed: reject while saturated.
            return False, "target queue full"
        self._chat_requests[ckpt.request_id] = build_resumed_request(ckpt)
        self._post(("restore", ckpt, peer))
        return True, ""

    def _on_checkpoint(self, peer: str, payload):
        """Target side: validate and accept a batch of migrating requests.
        Acceptance transfers ownership — the source releases its state
        only for acknowledged rids; a malformed frame is rejected cleanly
        (CheckpointError) and the source falls back."""
        accepted: list[str] = []
        rejected: dict[str, str] = {}
        frames = (payload or {}).get("checkpoints")
        if not isinstance(frames, list):
            return {"accepted": [], "rejected": {"?": "no checkpoints"}}
        for i, wire_ckpt in enumerate(frames):
            rid = (
                wire_ckpt.get("rid") if isinstance(wire_ckpt, dict) else None
            ) or f"frame-{i}"
            try:
                ckpt = checkpoint_from_wire(wire_ckpt)
            except CheckpointError as e:
                logger.warning("%s: rejected checkpoint %s from %s: %s",
                               self.node_id, rid, peer, e)
                rejected[str(rid)] = str(e)
                continue
            ok, reason = self._admit_restore(ckpt, peer)
            if ok:
                accepted.append(ckpt.request_id)
            else:
                rejected[ckpt.request_id] = reason
        return {"accepted": accepted, "rejected": rejected}

    def _restore_checkpoint(self, ckpt, from_peer: str) -> None:
        """Step thread: rebuild the request and resume it — KV-image
        swap-in when the layouts match, else re-prefill of the ORIGINAL
        prompt plus teacher-forced replay of the recorded outputs. Either
        way the continuation is bit-identical."""
        eng = self.engine
        req = build_resumed_request(ckpt)
        rid = req.request_id
        if eng is None:
            req.abort("migration target has no engine")
            self._chat_requests[rid] = req
            self._finish(req)
            return
        adopted = False
        if ckpt.kv is not None:
            try:
                adopted = eng.adopt_checkpoint_kv(req, ckpt.kv)
            except Exception:
                logger.exception("%s: KV adoption for %s failed; "
                                 "re-prefilling", self.node_id, rid)
                adopted = False
        if not adopted:
            # No image to swap in: restart from the original prompt and
            # replay the recorded outputs through decode steps.
            req = build_resumed_request(ckpt, replay=True)
        handoff = ckpt.handoff
        if handoff and from_peer == self.node_id:
            # Local-restore rung: this PREFILL head decodes the request
            # itself (no decode pool). Pin it local, or the next handoff
            # tick would flag it again the moment it resumes.
            req.handoff_local = True
        self._chat_requests[rid] = req
        try:
            ok = eng.submit(req)
        except Exception as e:
            ok = False
            req.abort(str(e))
        if not ok:
            if not req.status.is_finished:
                req.abort("migration target queue full")
            eng.cache.release(req)   # frees adopted handles, if any
            self._finish(req)
            return
        logger.info(
            "%s: restored %s request %s from %s (%d prior tokens, %s)",
            self.node_id, "handed-off" if handoff else "migrated", rid,
            from_peer, len(ckpt.output_ids),
            "KV image adopted" if adopted else "re-prefill + replay",
        )
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "handoff_in" if handoff else "migrate_in",
            node=self.node_id, request_id=rid,
            source=from_peer, kv_adopted=adopted,
            prior_tokens=len(ckpt.output_ids),
        )
        if ckpt.traced:
            # Stitch the source head's spans into this process's trace,
            # then mark the boundary: /debug/trace/<rid> here shows one
            # timeline across heads.
            try:
                from parallax_tpu_torch.obs.trace import get_trace_store
                from parallax_tpu_torch.runtime.checkpoint import (
                    spans_from_wire,
                )

                store = get_trace_store()
                if ckpt.trace_spans:
                    store.adopt(rid, spans_from_wire(ckpt.trace_spans))
                store.add(
                    rid, self.node_id,
                    "kv_handoff_in" if handoff else "migrate_in",
                    t0=time.perf_counter(), dur=0.0,
                    args={"source": from_peer, "kv_adopted": adopted},
                )
            except Exception:  # pragma: no cover - tracing is best-effort
                logger.exception("trace adoption failed for %s", rid)
        if handoff:
            # Planned phase handoffs count apart from churn migrations.
            self.handoff_stats.record_handoff(
                "local" if from_peer == self.node_id
                else ("kv_image" if adopted else "reprefill"))
        else:
            mode = "kv_image" if adopted else "replay"
            park_s = max(0.0, time.time() - ckpt.parked_wall)
            self.restores[rid] = (mode, park_s)
            while len(self.restores) > 4096:
                self.restores.popitem(last=False)
            self._count_migration_in(mode, park_s if ckpt.parked_wall
                                     else None)
        if not self.standalone:
            # Handoffs report through the same where_is table: pollers
            # that lose the prefill head still find the decode head.
            self.sender.send(
                self._sched_peer(), proto.MIGRATION_DONE,
                {"rid": rid, "head": self.node_id}, best_effort=True,
            )

    def _route_outputs(self, out) -> None:
        """Group packets by next hop and hand them to the sender pipeline
        (the step thread only enqueues; serialization runs on the
        per-peer workers)."""
        by_peer: dict[str, list] = {}
        for ireq in out.forward:
            table = ireq.routing_table
            if (ireq.next_token_id is not None
                    or ireq.spec_accepted is not None):
                target = table[0] if table else self.node_id
            else:
                try:
                    idx = table.index(self.node_id)
                    target = table[idx + 1]
                except (ValueError, IndexError):
                    logger.error(
                        "%s: no next hop for %s (table=%s)",
                        self.node_id, ireq.request_id, table,
                    )
                    continue
            h = ireq.hidden_states
            if h is not None and h.device.type != "cpu":
                raise RuntimeError(
                    f"{self.node_id}: a hidden state on {h.device} reached "
                    "the sender (the engine's host_hidden mode is off)")
            if target == self.node_id:
                self._post(("forward", ireq))
            else:
                by_peer.setdefault(target, []).append(ireq)
        for peer, ireqs in by_peer.items():
            self.sender.send(
                peer, proto.FORWARD, self._forward_payload(peer, ireqs)
            )
        for req in out.finished:
            self._finish(req)

    def _forward_payload(self, peer: str, ireqs: list):
        """Lazy FORWARD serialization for the sender worker: negotiate the
        link's wire dtype (first use only), pack the tensors, and report
        raw vs wire bytes for the compression telemetry."""

        def build():
            wd = self._wire_dtype_for(peer)
            raw = sum(
                i.hidden_states.numel() * i.hidden_states.element_size()
                for i in ireqs if i.hidden_states is not None
            )
            reqs = [proto.ireq_to_wire(i, wire_dtype=wd) for i in ireqs]
            wire = sum(
                proto.tensor_nbytes(r.get("hidden_states")) for r in reqs
            )
            return {"reqs": reqs}, raw, wire

        return build

    def _finish(self, req: Request) -> None:
        # Broadcast release to the rest of the path through the async
        # sender: these ride the same per-peer FIFO as the data frames, so
        # a RELEASE never overtakes the request's final FORWARD.
        aborted = req.status.value == "finished_abort"
        for peer in req.routing_table:
            if peer == self.node_id:
                continue
            # best_effort: a lost RELEASE leaks a mirror until its timeout;
            # it must never abort live requests.
            self.sender.send(
                peer, proto.RELEASE,
                {"rids": [req.request_id], "abort": aborted},
                best_effort=True,
            )
        if not self.standalone:
            # Fire-and-forget on the scheduler link's sender: the path's
            # load charge and this head's admission-time prefix hit.
            self.sender.send(
                self._sched_peer(), proto.REQUEST_COMPLETE,
                {
                    "path": req.routing_table or [self.node_id],
                    "rid": req.request_id,
                    "cached_tokens": req.num_cached_tokens,
                },
                best_effort=True,
            )
        self._finished.put(req)
        ev = self._request_events.pop(req.request_id, None)
        if ev is not None:
            ev.set()
