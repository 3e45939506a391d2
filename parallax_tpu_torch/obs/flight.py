"""Slow-request flight recorder: recent request timelines + engine events.

A bounded ring of completed-request summaries (head stage records on
finish) plus a ring of notable engine events (preemption, kv_oom,
abort_path, wire-dtype renegotiation, sender queue overflow), surfaced at
``GET /debug/flight``. Any request whose end-to-end latency exceeds the
configured slow threshold (``EngineConfig.slow_request_ms``) is captured
in a separate ``slow`` ring WITH its span breakdown and logged — the
"which of the five places was it" answer for a single slow request in a
heterogeneous swarm, without needing tracing enabled in advance (traced
requests get the full per-span breakdown; untraced ones the coarse
queue/ttft/decode split).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.analysis.sanitizer import make_lock

logger = get_logger(__name__)


class FlightRecorder:
    """Thread-safe bounded rings of request timelines and engine events."""

    def __init__(self, capacity: int = 256, slow_capacity: int = 64,
                 event_capacity: int = 512):
        self._requests: deque[dict] = deque(maxlen=capacity)
        self._slow: deque[dict] = deque(maxlen=slow_capacity)
        self._events: deque[dict] = deque(maxlen=event_capacity)
        self._lock = make_lock("obs.flight")
        self.slow_count = 0
        # Monotonic per-process event sequence: the cluster timeline
        # (obs/timeline.py) merges per-node rings by it, and a gap in a
        # node's shipped sequence is detected loudly scheduler-side.
        self._event_seq = 0

    # -- recording ---------------------------------------------------------

    def record_request(
        self,
        request_id: str,
        *,
        status: str,
        e2e_ms: float,
        ttft_ms: float | None = None,
        prompt_tokens: int = 0,
        output_tokens: int = 0,
        abort_reason: str | None = None,
        stage: str = "",
        breakdown: dict | None = None,
        slow_threshold_ms: float = 0.0,
        trace_id: str | None = None,
    ) -> None:
        rec = {
            "request_id": request_id,
            "time": time.time(),
            "status": status,
            "e2e_ms": round(e2e_ms, 3),
            "ttft_ms": round(ttft_ms, 3) if ttft_ms is not None else None,
            "prompt_tokens": prompt_tokens,
            "output_tokens": output_tokens,
            "stage": stage,
        }
        if abort_reason:
            rec["abort_reason"] = abort_reason
        if breakdown:
            rec["breakdown"] = breakdown
        if trace_id:
            # Trace-sampled request: the slow-ring entry links straight
            # to its full span timeline at /debug/trace/<trace_id>.
            rec["trace_id"] = trace_id
        slow = slow_threshold_ms > 0 and e2e_ms >= slow_threshold_ms
        with self._lock:
            self._requests.append(rec)
            if slow:
                self.slow_count += 1
                self._slow.append(rec)
        if slow:
            logger.warning(
                "slow request %s: e2e %.0f ms (threshold %.0f ms), "
                "ttft %s ms, %d+%d tokens, status %s, breakdown %s",
                request_id, e2e_ms, slow_threshold_ms,
                f"{ttft_ms:.0f}" if ttft_ms is not None else "?",
                prompt_tokens, output_tokens, status, breakdown,
            )

    def event(self, kind: str, **fields) -> None:
        """Record one engine event (preempt, kv_oom, abort_path,
        wire_dtype, queue_overflow, ...). Never raises — observability
        must not take down the path it observes."""
        try:
            rec = {"kind": kind, "time": time.time(), **fields}
            with self._lock:
                self._event_seq += 1
                rec["seq"] = self._event_seq
                self._events.append(rec)
        except Exception:  # pragma: no cover - defensive
            pass

    # -- export ------------------------------------------------------------

    def events_since(
        self, seq: int, limit: int = 256, node: str | None = None
    ) -> tuple[list[dict], int]:
        """Events with sequence number > ``seq`` (oldest first, at most
        ``limit``) and the new cursor to resume from — the bounded batch
        a worker heartbeat ships to the scheduler's cluster timeline.
        The cursor only covers what was RETURNED, so a caller whose send
        failed simply retries from the old cursor (the timeline dedupes
        resends by sequence). ``node`` filters to events tagged with
        that node id (or untagged) — in-process swarms share one ring,
        and each member must not ship its siblings' TAGGED events under
        its own name. Untagged events (engine/cache emitters don't know
        a node id) match every member's filter, so an in-process swarm
        ships them once per member — a test-harness artifact; real
        deployments run one node per process and attribute them
        correctly."""
        with self._lock:
            events = [e for e in self._events if e.get("seq", 0) > seq]
        if node is not None:
            events = [e for e in events if e.get("node") in (None, node)]
        events = events[:limit]
        return events, (events[-1]["seq"] if events else seq)

    def oldest_seq(self) -> int:
        """Sequence number of the oldest event still in the ring (0 when
        empty). A shipper whose cursor is older than this missed events
        to ring eviction — the loss signal the cluster timeline counts
        loudly."""
        with self._lock:
            return self._events[0].get("seq", 0) if self._events else 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": list(self._requests),
                "slow": list(self._slow),
                "slow_count": self.slow_count,
                "events": list(self._events),
            }


_FLIGHT = FlightRecorder()


def get_flight() -> FlightRecorder:
    """The process-wide flight recorder."""
    return _FLIGHT
