"""Scheduler state journal: versioned snapshot codec + append-only log
(port of ``parallax_tpu/ha/journal.py``).

The GlobalScheduler's replicated state — node registry, pipeline table,
CacheIndex digest mirrors, where_is (migration) table, refit index —
gains two serializations:

- :func:`snapshot_state` / :func:`restore_state` — a versioned full
  snapshot (plain JSON-able dicts, no wire codec), used to bootstrap a
  standby whose journal window was evicted and as the first record of a
  freshly-installed journal;
- :class:`StateJournal` — an append-only, sequence-numbered log of
  state-mutating events. **Every** mutation the scheduler replicates
  flows through the single :meth:`StateJournal.record` choke-point.

The snapshot has the JAX package's keys and version, so a snapshot or a
journal crosses between the packages either way. The port runs no QoS
and no timeline yet (ROADMAP queue 1 item 9): its snapshot writes those
keys at the values a JAX scheduler without QoS writes (``"qos": None``,
empty timeline cursors), a snapshot carrying QoS state is refused by
name, and the timeline cursors of a JAX snapshot are dropped (they are
observability, not replicated state). The JAX journal's metrics
(records by kind) are plain attributes here until the metrics registry
(item 9).

Soft state (in-flight load charges, CacheIndex staleness clocks) is NOT
snapshotted as truth: a promoted standby re-derives it from the bounded
heartbeat-replay window (the ``hb`` journal records), and
:func:`state_fingerprint` compares two schedulers' state field by field
(docs/ha.md).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import Counter, deque
from typing import Any, Dict, List, Optional, Tuple

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.utils import get_logger, unported

logger = get_logger(__name__)

SNAPSHOT_VERSION = 1


# -- snapshot codec ----------------------------------------------------------


def snapshot_state(scheduler) -> dict:
    """Serialize the scheduler's replicated state to plain dicts.

    Heartbeat clocks ship as AGES (``hb_age_s``), not absolute monotonic
    stamps — the standby's clock is not the primary's clock."""
    now = time.monotonic()
    mgr = scheduler.manager
    nodes = []
    for n in mgr.nodes():
        nodes.append({
            "node_id": n.node_id,
            "hardware": n.hardware.to_dict(),
            "start_layer": n.start_layer,
            "end_layer": n.end_layer,
            "load": n.load,
            "role": n.role,
            "is_ready": n.is_ready,
            "refit_version": n.refit_version,
            "layer_latency_ms": n.measured_layer_latency_ms,
            "lora_adapters": list(n.lora_adapters),
            "wire_formats": list(n.wire_formats),
            "digests_need_resync": n.digests_need_resync,
            "pending_drain": sorted(n.pending_drain),
            "reported_busy": n.reported_busy,
            "hb_age_s": max(0.0, now - n.last_heartbeat),
            "cache_index": n.cache_index.export(),
        })
    with scheduler._lock:
        migrations = list(scheduler._migrations.items())
        migration_stats = dict(scheduler.migration_stats)
        disagg_stats = dict(scheduler.disagg_stats)
        routing_accuracy = dict(scheduler.routing_accuracy)
    journal = getattr(scheduler, "journal", None)
    return {
        "v": SNAPSHOT_VERSION,
        "epoch": getattr(scheduler, "epoch", 1),
        "model": scheduler.model.model_name,
        "bootstrapped": scheduler.bootstrapped.is_set(),
        "refit_version": scheduler.refit_version,
        "refit_index": dict(scheduler.refit_index),
        # The journal position this snapshot is consistent with: a
        # standby that restores it resumes tailing from here.
        "journal_seq": journal.seq if journal is not None else 0,
        "nodes": nodes,
        "pipelines": [
            {"id": p.pipeline_id, "nodes": list(p.node_ids)}
            for p in mgr.pipelines
        ],
        "next_pipeline_id": mgr.next_pipeline_id,
        "migrations": migrations,
        "migration_stats": migration_stats,
        "disagg_stats": disagg_stats,
        "routing_accuracy": routing_accuracy,
        # What a JAX scheduler with an empty timeline and no QoS writes.
        "timeline": {"cursors": {}, "local_seq": {}},
        "qos": None,
    }


def restore_state(scheduler, snap: dict) -> None:
    """Rebuild a (passive) scheduler's state from a snapshot dict.

    Replaces the node registry and pipeline table wholesale; pipeline
    ids are preserved so the router's per-pipeline dispatch ledger and
    worker-visible ids stay stable across a promotion."""
    from parallax_tpu_torch.scheduling.node import Node
    from parallax_tpu_torch.scheduling.node_management import Pipeline
    from parallax_tpu_torch.utils.hw import HardwareInfo

    if snap.get("v") != SNAPSHOT_VERSION:
        raise ValueError(
            "snapshot version %r != %d" % (snap.get("v"), SNAPSHOT_VERSION)
        )
    model = snap.get("model")
    if model and model != scheduler.model.model_name:
        raise ValueError(
            "snapshot is for model %r, scheduler serves %r"
            % (model, scheduler.model.model_name)
        )
    if snap.get("qos") is not None:
        raise unported("QoS shed state in an HA snapshot (qos)", 9)
    now = time.monotonic()
    mgr = scheduler.manager
    mgr.standby_all()
    for n in mgr.nodes():
        mgr.remove(n.node_id)
    by_id: Dict[str, Any] = {}
    for nd in snap.get("nodes") or ():
        node = Node(
            node_id=nd["node_id"],
            hardware=HardwareInfo.from_dict(nd["hardware"]),
            model=scheduler.model,
        )
        # Layers BEFORE add() so the manager files it ACTIVE/STANDBY
        # correctly from has_allocation.
        node.set_layers(
            int(nd.get("start_layer", -1)), int(nd.get("end_layer", -1))
        )
        node.load = int(nd.get("load") or 0)
        node.role = nd.get("role") or "mixed"
        node.is_ready = bool(nd.get("is_ready"))
        node.refit_version = int(nd.get("refit_version") or 0)
        node.measured_layer_latency_ms = nd.get("layer_latency_ms")
        node.lora_adapters = tuple(nd.get("lora_adapters") or ())
        node.wire_formats = tuple(nd.get("wire_formats") or ())
        node.digests_need_resync = bool(nd.get("digests_need_resync"))
        node.pending_drain = set(nd.get("pending_drain") or ())
        node.reported_busy = bool(nd.get("reported_busy"))
        node.last_heartbeat = now - float(nd.get("hb_age_s") or 0.0)
        node.cache_index.adopt(nd.get("cache_index") or {})
        mgr.add(node)
        by_id[node.node_id] = node
    pipelines: List[Any] = []
    for pd in snap.get("pipelines") or ():
        members = [by_id.get(nid) for nid in (pd.get("nodes") or ())]
        if not members or any(m is None for m in members):
            continue
        p = Pipeline(nodes=members, pipeline_id=int(pd.get("id") or 0))
        try:
            p.validate(scheduler.model.num_hidden_layers)
        except ValueError:
            logger.warning("snapshot pipeline %s invalid; dropped",
                           pd.get("id"))
            continue
        pipelines.append(p)
    mgr.adopt_pipelines(pipelines, int(snap.get("next_pipeline_id") or 0))
    if snap.get("bootstrapped"):
        scheduler.bootstrapped.set()
    else:
        scheduler.bootstrapped.clear()
    with scheduler._lock:
        scheduler.refit_version = int(snap.get("refit_version") or 0)
        scheduler.refit_index = dict(snap.get("refit_index") or {})
        scheduler._migrations.clear()
        for rid, head in snap.get("migrations") or ():
            scheduler._migrations[str(rid)] = str(head)
        scheduler.migration_stats.update(snap.get("migration_stats") or {})
        scheduler.disagg_stats.update(snap.get("disagg_stats") or {})
        scheduler.routing_accuracy.update(
            snap.get("routing_accuracy") or {}
        )
    scheduler.epoch = max(
        getattr(scheduler, "epoch", 1), int(snap.get("epoch") or 1)
    )


# -- state fingerprints (equivalence proofs) ---------------------------------


def _index_fingerprint(idx) -> dict:
    exp = idx.export()
    h = hashlib.sha256()
    for d in sorted(exp["entries"]):
        h.update(str(d).encode())
    return {
        "block": exp["block"],
        "seq": exp["seq"],
        "n": len(exp["entries"]),
        "sha": h.hexdigest()[:16],
    }


def state_fingerprint(scheduler, include_soft: bool = True,
                      include_journal_only: bool = True) -> dict:
    """Canonical, order-independent digest of the scheduler's state.

    ``include_journal_only=False`` drops the parts only the journal can
    carry (migration table, refit index), for a comparison against a
    scheduler rebuilt from heartbeats. Pipeline identity is compared by
    node chains, not ids — a fresh scheduler numbers pipelines
    differently."""
    mgr = scheduler.manager
    nodes = {}
    for n in mgr.nodes():
        d = {
            "layers": [n.start_layer, n.end_layer],
            "role": n.role,
            "refit": n.refit_version,
            "wire_formats": sorted(n.wire_formats),
            "adapters": sorted(n.lora_adapters),
            "digests": _index_fingerprint(n.cache_index),
        }
        if include_soft:
            d["load"] = n.load
            d["ready"] = n.is_ready
            d["busy"] = n.reported_busy
        nodes[n.node_id] = d
    fp = {
        "model": scheduler.model.model_name,
        "bootstrapped": scheduler.bootstrapped.is_set(),
        "nodes": nodes,
        "pipelines": sorted(
            tuple(p.node_ids) for p in mgr.pipelines
        ),
    }
    if include_journal_only:
        with scheduler._lock:
            fp["migrations"] = dict(scheduler._migrations)
            fp["refit_index"] = dict(scheduler.refit_index)
            fp["refit_version"] = scheduler.refit_version
    return fp


def soft_state_fingerprint(scheduler) -> dict:
    """Just the heartbeat-derived soft state, for replay-window tests."""
    return {
        n.node_id: {
            "load": n.load, "ready": n.is_ready, "busy": n.reported_busy,
        }
        for n in scheduler.manager.nodes()
    }


# -- the append-only journal -------------------------------------------------


class StateJournal:
    """Sequence-numbered ring of state-mutating scheduler events.

    :meth:`record` is THE choke-point every replicated mutation flows
    through. Standbys consume it two ways: a push replicator thread
    streams records over the RPC plane to :meth:`attach`-ed peers, and
    the pull path (``ha_sync``) serves :meth:`records_since` — falling
    back to a full snapshot when the ring already evicted the requested
    window. An optional JSONL ``sink_path`` covers single-host mode (the
    standby tails the shared file instead of the RPC plane).

    Counters (the JAX journal's registry family, kept as attributes):
    ``records_by_kind``; ``pushes``, records a standby acknowledged on
    the push path; ``resyncs``, push peers dropped back to the pull path
    (a gap or a failed push)."""

    def __init__(self, capacity: int = 8192,
                 sink_path: Optional[str] = None, epoch: int = 1):
        self.capacity = capacity
        self.sink_path = sink_path
        self.seq = 0
        self.epoch = epoch
        self._records: deque = deque(maxlen=capacity)
        self._lock = make_lock("ha.journal")
        self._cond = threading.Condition(self._lock)
        # peer -> next journal seq to push (RPC replication targets).
        self._peers: Dict[str, int] = {}
        self.transport = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.records_by_kind: Counter = Counter()
        self.pushes = 0
        self.resyncs = 0

    # -- write path (the choke-point) -----------------------------------

    def record(self, kind: str, data: dict) -> dict:
        """Append one state-mutating event; wakes the replicator."""
        with self._cond:
            self.seq += 1
            rec = {
                "seq": self.seq,
                "kind": kind,
                "ts": time.time(),
                "data": data,
                "epoch": self.epoch,
            }
            self._records.append(rec)
            self.records_by_kind[kind] += 1
            self._cond.notify_all()
        if self.sink_path:
            try:
                with open(self.sink_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                logger.exception("journal sink write failed")
        return rec

    # -- read path -------------------------------------------------------

    def records_since(self, from_seq: int) -> Tuple[List[dict], bool]:
        """Records with seq > ``from_seq``, plus a contiguity bit: False
        means the ring evicted part of the window and the caller must
        take a full snapshot instead."""
        with self._lock:
            recs = [r for r in self._records if r["seq"] > from_seq]
            if from_seq >= self.seq:
                return [], True
            oldest = self._records[0]["seq"] if self._records else self.seq
            return recs, oldest <= from_seq + 1

    # -- push replication ------------------------------------------------

    def bind(self, transport) -> None:
        """Start pushing records to attached peers over ``transport``
        (Transport-shaped ``call``)."""
        self.transport = transport
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._replicate_loop, daemon=True,
                name="ha-journal-replicator",
            )
            self._thread.start()

    def attach(self, peer: str) -> None:
        # self._cond wraps self._lock, so holding the lock IS holding
        # the condition.
        with self._lock:
            self._peers.setdefault(peer, self.seq + 1)
            self._cond.notify_all()

    def detach(self, peer: str) -> None:
        with self._lock:
            self._peers.pop(peer, None)

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _replicate_loop(self) -> None:
        from parallax_tpu_torch.p2p import proto

        while not self._stop.is_set():
            with self._cond:
                pending = [
                    (peer, nxt) for peer, nxt in self._peers.items()
                    if nxt <= self.seq
                ]
                if not pending:
                    self._cond.wait(timeout=0.5)
                    continue
            for peer, nxt in pending:
                recs, contiguous = self.records_since(nxt - 1)
                if not contiguous:
                    # The peer fell behind the ring: drop it from the
                    # push set; its pull loop (ha_sync) will take the
                    # snapshot path and re-attach.
                    self.detach(peer)
                    with self._lock:
                        self.resyncs += 1
                    continue
                try:
                    for rec in recs:
                        self.transport.call(peer, proto.HA_JOURNAL, {
                            "seq": rec["seq"],
                            "kind": rec["kind"],
                            "ts": rec["ts"],
                            "data": rec["data"],
                            "epoch": rec["epoch"],
                        }, timeout=5.0)
                        with self._lock:
                            self.pushes += 1
                            if peer in self._peers:
                                self._peers[peer] = rec["seq"] + 1
                except Exception:
                    if self._stop.is_set():
                        return
                    logger.warning(
                        "journal push to %s failed; detaching "
                        "(peer re-syncs via ha_sync)", peer,
                    )
                    self.detach(peer)
                    with self._lock:
                        self.resyncs += 1


def install_journal(scheduler, journal: StateJournal) -> None:
    """Wire a journal into a live scheduler: the first record is a full
    snapshot (so a standby tailing from seq 0 needs no side channel),
    and every later mutation rides :meth:`StateJournal.record` via the
    scheduler's journal hooks."""
    scheduler.journal = journal
    journal.epoch = scheduler.epoch
    journal.record("snapshot", snapshot_state(scheduler))
    # Force the next pipeline-table diff to re-journal from scratch.
    scheduler._journaled_pipelines = None


def read_journal_file(path: str, from_seq: int = 0) -> List[dict]:
    """Single-host mode: read a JSONL journal sink (records with
    seq > ``from_seq``; malformed lines are skipped)."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and rec.get("seq", 0) > from_seq:
                    out.append(rec)
    except OSError:
        return out
    return out
