"""Warm-standby scheduler: journal tailing, lease watch, promotion (port
of ``parallax_tpu/ha/standby.py``).

A :class:`StandbyScheduler` wraps a second, PASSIVE
:class:`GlobalScheduler` process and keeps it a read-only mirror of the
primary by two complementary feeds:

- **push** — the primary's :class:`~parallax_tpu_torch.ha.journal.StateJournal`
  replicator streams ``ha_journal`` frames to us (we register the
  handler on our transport);
- **pull** — a tail thread sends ``ha_sync`` every ``sync_interval_s``
  carrying our applied seq; the reply is either the missing journal
  suffix or (when the primary's ring already evicted our window) a full
  snapshot. The pull doubles as the **lease probe**: every successful
  sync renews the primary's lease, and ``lease_s`` of silence triggers
  :meth:`promote`.

Promotion (docs/ha.md): bump the epoch past everything the mirror saw,
re-stamp every node's heartbeat clock (soft state was already re-derived
from the bounded ``hb`` replay window the journal carries), install a
fresh journal, flip the scheduler active and start its threads. Workers
discover the promotion through their failover wrapper
(:class:`~parallax_tpu_torch.ha.failover.SchedulerFailover`) and the
bumped epoch on heartbeat replies fences a revived old primary off.

Single-host mode needs no RPC plane: pass ``journal_path`` (the
primary's JSONL sink) instead of a transport and the tail thread reads
the shared file.

The JAX promotion's ``ha_promoted`` timeline event and its registry
families (promotions, replay ms) wait for the metrics plane (ROADMAP
queue 1 item 9); the standby keeps them as attributes: ``promotions``,
``replay_ms``, ``promoted_at`` (monotonic) and ``resyncs`` (gap answers
on the push path plus snapshots adopted on the pull path).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.ha.journal import (
    StateJournal,
    install_journal,
    read_journal_file,
    restore_state,
)
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


class StandbyScheduler:
    """Tail a primary scheduler's snapshot+journal; promote on lease
    expiry."""

    def __init__(
        self,
        scheduler,
        transport=None,
        primary: Optional[str] = None,
        *,
        journal_path: Optional[str] = None,
        lease_s: float = 6.0,
        sync_interval_s: float = 1.0,
        node_id: str = "standby",
        auto_promote: bool = True,
        on_promote: Optional[Callable[[int], None]] = None,
    ):
        if transport is None and journal_path is None:
            raise ValueError("need a transport+primary or a journal_path")
        self.scheduler = scheduler
        self.transport = transport
        self.primary = primary
        self.journal_path = journal_path
        self.lease_s = lease_s
        self.sync_interval_s = sync_interval_s
        self.node_id = node_id
        self.auto_promote = auto_promote
        self.on_promote = on_promote
        self.applied_seq = 0
        self.mirror_epoch = 1
        self.promoted = False
        self.lease_deadline = time.monotonic() + lease_s
        self.promotions = 0
        self.replay_ms: Optional[float] = None
        self.promoted_at: Optional[float] = None
        self.resyncs = 0
        self._apply_lock = make_lock("ha.standby", reentrant=True)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The mirror never runs its own event/dispatch threads or
        # answers mutating RPCs until promoted.
        scheduler.passive = True
        if self.transport is not None:
            from parallax_tpu_torch.p2p import proto

            self.transport.register(proto.HA_JOURNAL, self._on_journal)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._tail_loop, daemon=True, name="ha-standby-tail",
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- journal feeds ---------------------------------------------------

    def _on_journal(self, _peer, payload) -> dict:
        """Push path: one journal record streamed by the primary."""
        seq = payload.get("seq")
        if not isinstance(seq, int):
            return {"resync": True, "have": self.applied_seq}
        with self._apply_lock:
            if seq <= self.applied_seq:
                # Resend after a lost reply: already applied.
                return {"ok": True, "have": self.applied_seq}
            if seq != self.applied_seq + 1:
                # Gap: the pull loop catches up (or takes a snapshot).
                self.resyncs += 1
                return {"resync": True, "have": self.applied_seq}
            self.apply_record({
                "seq": seq,
                "kind": payload.get("kind"),
                "ts": payload.get("ts"),
                "data": payload.get("data"),
                "epoch": payload.get("epoch"),
            })
        self._renew_lease()
        return {"ok": True, "have": self.applied_seq}

    def sync_once(self) -> bool:
        """One pull: ask the primary (or the shared file) for everything
        past our applied seq. Returns True when the primary answered
        (lease renewed)."""
        if self.journal_path is not None:
            recs = read_journal_file(self.journal_path, self.applied_seq)
            with self._apply_lock:
                for rec in recs:
                    if rec.get("seq") == self.applied_seq + 1:
                        self.apply_record(rec)
            # File mode has no liveness signal of its own: a growing
            # file is the lease.
            if recs:
                self._renew_lease()
            return bool(recs)
        from parallax_tpu_torch.p2p import proto

        try:
            reply = self.transport.call(self.primary, proto.HA_SYNC, {
                "from_seq": self.applied_seq,
                "node_id": self.node_id,
            }, timeout=max(1.0, self.sync_interval_s * 2))
        except Exception:
            return False
        if not isinstance(reply, dict) or reply.get("error"):
            return False
        self._ingest_sync_reply(reply)
        self._renew_lease()
        return True

    def _ingest_sync_reply(self, reply: dict) -> None:
        with self._apply_lock:
            snap = reply.get("snapshot")
            if isinstance(snap, dict):
                restore_state(self.scheduler, snap)
                self.resyncs += 1
                self.applied_seq = int(snap.get("journal_seq") or 0)
                self.mirror_epoch = max(
                    self.mirror_epoch, int(snap.get("epoch") or 1)
                )
                logger.info(
                    "standby adopted snapshot @ journal seq %d (epoch %d)",
                    self.applied_seq, self.mirror_epoch,
                )
                return
            for rec in reply.get("records") or ():
                if (
                    isinstance(rec, dict)
                    and rec.get("seq") == self.applied_seq + 1
                ):
                    self.apply_record(rec)

    # -- record application ----------------------------------------------

    def apply_record(self, rec: dict) -> None:
        """Apply one in-sequence journal record to the mirror. The
        mirror mutates node/pipeline state DIRECTLY (no event queue: the
        passive scheduler's event thread isn't running, and applying
        synchronously keeps ``applied_seq`` exact)."""
        sched = self.scheduler
        mgr = sched.manager
        kind = rec.get("kind")
        data = rec.get("data") or {}
        with self._apply_lock:
            epoch = rec.get("epoch")
            if isinstance(epoch, int) and epoch > self.mirror_epoch:
                self.mirror_epoch = epoch
            if kind == "snapshot":
                restore_state(sched, data)
            elif kind == "join":
                self._apply_join(data)
            elif kind == "leave":
                mgr.remove(str(data.get("node_id")))
            elif kind == "peer_down":
                node = mgr.get(str(data.get("peer")))
                if node is not None:
                    node.cache_index.clear()
                    if node.peer_down_at is None:
                        node.peer_down_at = time.monotonic()
            elif kind == "hb":
                self._apply_hb(data)
            elif kind == "pipelines":
                self._apply_pipelines(data)
            elif kind == "migration_done":
                rid, head = data.get("rid"), data.get("head")
                if isinstance(rid, str) and isinstance(head, str):
                    sched.record_migration(rid, head)
            elif kind == "refit":
                with sched._lock:
                    sched.refit_version = int(data.get("version") or 0)
                    sched.refit_index = dict(data.get("index") or {})
            elif kind == "epoch":
                e = data.get("epoch")
                if isinstance(e, int):
                    self.mirror_epoch = max(self.mirror_epoch, e)
            seq = rec.get("seq")
            if isinstance(seq, int):
                self.applied_seq = seq

    def _apply_join(self, data: dict) -> None:
        from parallax_tpu_torch.scheduling.node import Node
        from parallax_tpu_torch.utils.hw import HardwareInfo

        node_id = data.get("node_id")
        if not isinstance(node_id, str):
            return
        node = Node(
            node_id=node_id,
            hardware=HardwareInfo.from_dict(data.get("hardware") or {}),
            model=self.scheduler.model,
        )
        if data.get("wire_formats"):
            node.wire_formats = tuple(data["wire_formats"])
        role = str(data.get("role") or "mixed").lower()
        node.role = role if role in ("prefill", "decode", "mixed") else "mixed"
        # NO allocator call: the primary's own allocation decision
        # arrives as the next "pipelines" record — the mirror must not
        # invent a different one.
        self.scheduler.manager.add(node)

    def _apply_hb(self, data: dict) -> None:
        """One heartbeat replay record: the bounded window these build
        is how a promoted standby re-derives soft state (load charges,
        readiness, CacheIndex continuity) instead of trusting a stale
        snapshot of someone else's clocks."""
        node = self.scheduler.manager.get(str(data.get("node_id")))
        if node is None:
            return
        node.touch()
        node.peer_down_at = None
        node.suspect = False
        if data.get("load") is not None:
            node.load = int(data["load"])
        if data.get("ready") is not None:
            node.is_ready = bool(data["ready"])
        if data.get("busy") is not None:
            node.reported_busy = bool(data["busy"])
        if data.get("latency_ms") is not None:
            node.measured_layer_latency_ms = data["latency_ms"]
        if data.get("refit_version") is not None:
            node.refit_version = int(data["refit_version"])
        digests = data.get("digests")
        if digests is not None:
            if node.cache_index.apply(digests):
                # Same contract as the live path: an out-of-sequence
                # delta means ONE resync ask on the worker's next beat
                # after promotion — never a full-snapshot storm.
                node.digests_need_resync = True

    def _apply_pipelines(self, data: dict) -> None:
        from parallax_tpu_torch.scheduling.node_management import Pipeline

        sched = self.scheduler
        mgr = sched.manager
        mgr.standby_all()
        by_id = {n.node_id: n for n in mgr.nodes()}
        pipelines = []
        for pd in data.get("pipelines") or ():
            members = []
            for m in pd.get("nodes") or ():
                node = by_id.get(m[0])
                if node is None:
                    members = None
                    break
                node.set_layers(int(m[1]), int(m[2]))
                if len(m) > 3 and m[3]:
                    node.role = str(m[3])
                members.append(node)
            if not members:
                continue
            p = Pipeline(nodes=members, pipeline_id=int(pd.get("id") or 0))
            try:
                p.validate(sched.model.num_hidden_layers)
            except ValueError:
                continue
            pipelines.append(p)
        mgr.adopt_pipelines(
            pipelines, int(data.get("next_id") or 0)
        )
        # Partial replicas (dynamic-join shards) are allocated but not
        # pipeline members.
        for m in data.get("replicas") or ():
            node = by_id.get(m[0])
            if node is not None:
                node.set_layers(int(m[1]), int(m[2]))
                mgr.set_active(node.node_id)
        if data.get("bootstrapped"):
            sched.bootstrapped.set()
        else:
            sched.bootstrapped.clear()

    # -- lease + promotion ------------------------------------------------

    def _renew_lease(self) -> None:
        self.lease_deadline = time.monotonic() + self.lease_s

    def lease_expired(self, now: Optional[float] = None) -> bool:
        return (now or time.monotonic()) > self.lease_deadline

    def _tail_loop(self) -> None:
        while not self._stop.is_set() and not self.promoted:
            self.sync_once()
            if (
                self.auto_promote
                and not self.promoted
                and self.lease_expired()
            ):
                try:
                    self.promote()
                except Exception:
                    logger.exception("promotion failed")
                return
            self._stop.wait(self.sync_interval_s)

    def promote(self, start_threads: bool = True) -> int:
        """Flip the mirror active. Returns the new (fencing) epoch."""
        t0 = time.monotonic()
        sched = self.scheduler
        with self._apply_lock:
            if self.promoted:
                return sched.epoch
            new_epoch = self.mirror_epoch + 1
            sched.epoch = new_epoch
            # Soft-state re-derivation already happened record by record
            # (the hb replay window); what remains is re-anchoring the
            # heartbeat clocks so the sweep measures silence against OUR
            # clock, not ages inherited from the dead primary.
            for node in sched.manager.nodes():
                node.touch()
            journal = StateJournal(epoch=new_epoch)
            if self.transport is not None:
                journal.bind(self.transport)
            install_journal(sched, journal)
            journal.record("epoch", {"epoch": new_epoch})
            sched.passive = False
            sched.fenced = False
            # Last, so that whoever reads ``promoted`` finds the scheduler
            # active (the JAX standby sets it first, and a reader polling
            # it can see a passive scheduler behind it).
            self.promoted = True
        if start_threads:
            sched.start()
        took_ms = (time.monotonic() - t0) * 1e3
        self.promotions += 1
        self.replay_ms = took_ms
        self.promoted_at = time.monotonic()
        logger.warning(
            "standby promoted: epoch %d, %d nodes, %d pipelines, "
            "journal seq %d, %.1f ms",
            new_epoch, len(sched.manager), len(sched.manager.pipelines),
            self.applied_seq, took_ms,
        )
        if self.on_promote is not None:
            try:
                self.on_promote(new_epoch)
            except Exception:
                logger.exception("on_promote callback failed")
        return new_epoch
