"""Cluster event timeline: one causally-ordered story of a churn episode.

Per-node flight recorders already capture the interesting events
— preemptions, abort_path link failures, migrate_flag/park/out/in,
watchdog health transitions — but during a churn episode they live in N
separate per-node rings, and reconstructing "what actually happened"
means eyeballing N JSON dumps with N clocks. This module merges them:

- flight events carry per-node **monotonic sequence numbers**
  (``obs/flight.py``) and ship to the scheduler in **bounded heartbeat
  batches** tagged with the worker's boot epoch;
- a scheduler-side :class:`ClusterTimeline` ring ingests the batches,
  dedupes resends (a beat whose reply was lost re-ships its batch),
  counts same-epoch sequence **gaps** loudly
  (``parallax_timeline_gaps_total``), and treats an epoch change as a
  node restart (fresh cursor, ``resets`` counter) rather than a gap;
- ``GET /debug/timeline`` serves the merged ring ordered by wall time
  (ties broken by node + sequence — per-node order is causal by
  construction), plus a Chrome-trace export (one lane per node) for
  chrome://tracing / Perfetto.

In-process swarms share one flight recorder, so event batches are
filtered to events tagged with the shipping node (or untagged); on real
deployments each worker process owns its ring and ships everything.
(Caveat, test harnesses only: UNTAGGED events in a shared ring match
every sibling's filter, so an in-process N-worker swarm merges them N
times under N node names — single-node-per-process deployments don't.)
"""

from __future__ import annotations

import time
from collections import deque

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.obs import names as mnames


class ClusterTimeline:
    """Bounded merge ring of per-node flight-event batches."""

    def __init__(self, capacity: int = 4096, registry=None):
        self.capacity = capacity
        self._events: deque[dict] = deque(maxlen=capacity)
        # (node) -> {"epoch": str | None, "seq": int}
        self._cursors: dict[str, dict] = {}
        # Synthesized sequences for locally-recorded events (the
        # scheduler's own decisions don't ride heartbeats).
        self._local_seq: dict[str, int] = {}
        self._lock = make_lock("obs.timeline")
        self.gaps = 0
        self.resets = 0
        self.ingested = 0
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._c_gaps = registry.counter(
            mnames.TIMELINE_GAPS_TOTAL,
            "Flight-event sequence gaps detected while merging node "
            "timelines (dropped heartbeats / ring overruns)",
        )
        self._c_events = registry.counter(
            mnames.TIMELINE_EVENTS_TOTAL,
            "Flight events merged into the cluster timeline",
        )

    # -- ingestion --------------------------------------------------------

    def ingest(self, node_id: str, payload: dict) -> None:
        """Merge one heartbeat event batch: ``{"epoch": str, "batch":
        [event, ...], "lost": int?}`` with every event carrying a
        per-node contiguous ``seq``. ``lost`` is the shipper's own count
        of events its flight ring evicted before they could ship —
        counted into the gap telemetry alongside any sequence jumps the
        merge itself detects. Malformed payloads are ignored — the
        timeline must survive anything the network feeds it."""
        if not isinstance(payload, dict):
            return
        batch = payload.get("batch")
        if not isinstance(batch, list):
            return
        try:
            lost = max(0, int(payload.get("lost") or 0))
        except (TypeError, ValueError):
            lost = 0
        if lost:
            self._c_gaps.inc(lost)
        epoch = payload.get("epoch")
        epoch = str(epoch) if epoch is not None else None
        with self._lock:
            if lost:
                self.gaps += lost
            cur = self._cursors.get(node_id)
            if cur is None or cur["epoch"] != epoch:
                # First contact, or the node restarted (new boot epoch):
                # fresh cursor, no gap accounting across the boundary.
                if cur is not None:
                    self.resets += 1
                cur = self._cursors[node_id] = {"epoch": epoch, "seq": 0}
            for ev in batch:
                if not isinstance(ev, dict):
                    continue
                try:
                    seq = int(ev["seq"])
                except (KeyError, TypeError, ValueError):
                    continue
                if seq <= cur["seq"]:
                    continue    # resend after a lost reply: already merged
                if cur["seq"] and seq > cur["seq"] + 1:
                    missed = seq - cur["seq"] - 1
                    self.gaps += missed
                    self._c_gaps.inc(missed)
                cur["seq"] = seq
                rec = dict(ev)
                rec["node"] = rec.get("node") or node_id
                self._events.append(rec)
                self.ingested += 1
                self._c_events.inc()

    def record(self, kind: str, node: str = "scheduler", **fields) -> None:
        """Append a locally-observed event — the merger's own decisions
        (node_leave, peer_down, drain directives) are part of the churn
        story but never ride a heartbeat. Sequence numbers are
        synthesized per local lane; never raises."""
        try:
            with self._lock:
                seq = self._local_seq.get(node, 0) + 1
                self._local_seq[node] = seq
                rec = {
                    "kind": kind, "time": time.time(), "seq": seq,
                    "node": node, **fields,
                }
                self._events.append(rec)
                self.ingested += 1
            self._c_events.inc()
        except Exception:  # pragma: no cover - obs must never raise
            pass

    # -- HA replication (parallax_tpu/ha) ---------------------------------

    def export_cursors(self) -> dict:
        """High-water merge cursors for the HA snapshot codec: a
        promoted standby that adopts them dedupes heartbeat-batch
        resends exactly where the dead primary left off (the events
        themselves are observability, not replicated state)."""
        with self._lock:
            return {
                "cursors": {n: dict(c) for n, c in self._cursors.items()},
                "local_seq": dict(self._local_seq),
            }

    def adopt_cursors(self, snap: dict) -> None:
        with self._lock:
            for n, c in (snap.get("cursors") or {}).items():
                if isinstance(c, dict) and "seq" in c:
                    self._cursors[n] = {
                        "epoch": c.get("epoch"), "seq": int(c["seq"]),
                    }
            for n, s in (snap.get("local_seq") or {}).items():
                try:
                    self._local_seq[n] = max(
                        self._local_seq.get(n, 0), int(s)
                    )
                except (TypeError, ValueError):
                    continue

    # -- export -----------------------------------------------------------

    def _sorted_events(self) -> list[dict]:
        with self._lock:
            events = list(self._events)
        # Wall-time order with (node, seq) tiebreak: per-node order is
        # causal by construction (monotonic seq), and cross-node wall
        # clocks are close enough on DCN to read as one story.
        events.sort(key=lambda e: (
            float(e.get("time") or 0.0), str(e.get("node") or ""),
            int(e.get("seq") or 0),
        ))
        return events

    def snapshot(self, limit: int | None = 1000) -> dict:
        events = self._sorted_events()
        if limit is not None and len(events) > limit:
            events = events[-limit:]
        with self._lock:
            cursors = {
                n: dict(c) for n, c in self._cursors.items()
            }
        return {
            "events": events,
            "gaps": self.gaps,
            "resets": self.resets,
            "ingested": self.ingested,
            "nodes": cursors,
        }

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON: instant events, one thread lane per
        node, rebased to the earliest event."""
        events = self._sorted_events()
        base = min(
            (float(e.get("time") or 0.0) for e in events), default=0.0
        )
        out = []
        for e in events:
            args = {
                k: v for k, v in e.items()
                if k not in ("kind", "time", "node", "seq")
            }
            args["seq"] = e.get("seq")
            out.append({
                "name": str(e.get("kind") or "event"),
                "cat": "cluster",
                "ph": "i",
                "s": "t",
                "ts": round(
                    (float(e.get("time") or 0.0) - base) * 1e6, 3
                ),
                "pid": 1,
                "tid": str(e.get("node") or "?"),
                "args": args,
            })
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "metadata": {
                "timeline": "cluster", "gaps": self.gaps,
                "resets": self.resets,
            },
        }


class LocalTimeline:
    """Single-host twin: pulls the local flight ring through a
    ClusterTimeline on demand, so ``/debug/timeline`` serves the same
    shape whether a scheduler merged N nodes or one process watched
    itself."""

    def __init__(self, node_id: str = "local", flight=None):
        self.node_id = node_id
        self._flight = flight
        self._timeline = ClusterTimeline()
        self._cursor = 0
        self._lock = make_lock("obs.timeline_local")

    def _pull(self) -> None:
        flight = self._flight
        if flight is None:
            from parallax_tpu_torch.obs.flight import get_flight

            flight = get_flight()
        with self._lock:
            batch, self._cursor = flight.events_since(self._cursor)
            if batch:
                self._timeline.ingest(
                    self.node_id, {"epoch": "local", "batch": batch}
                )

    def snapshot(self, limit: int | None = 1000) -> dict:
        self._pull()
        return self._timeline.snapshot(limit=limit)

    def export_chrome(self) -> dict:
        self._pull()
        return self._timeline.export_chrome()
