"""Request-lifecycle tracing: a lightweight span recorder.

One bounded process-global :class:`TraceStore` collects spans for sampled
requests (``EngineConfig.trace_sample_rate``; default 0 = off). The trace
id is the request id; the sampled flag rides the FORWARD wire frames
(``IntermediateRequest.trace`` -> ``p2p/proto.py``), so spans emitted on
different pipeline stages — and across the in-process wire roundtrip —
stitch into ONE trace retrievable as Chrome trace-event JSON via
``GET /debug/trace/<request_id>`` (load it in ``chrome://tracing`` or
Perfetto).

Cost model: when tracing is off nothing here runs — the engine's
dispatch/resolve hot path guards every hook behind an empty-set check,
so the overlapped decode loop's dispatch median is unaffected. When a
request IS sampled, per-step decode spans coalesce into "decode" epochs
(adjacent same-name spans within ``MERGE_GAP_S`` merge, bumping a step
counter) so a 10k-token generation yields a bounded span list, not 10k
events.

Span timestamps use ``time.perf_counter()`` seconds; export rebases them
to the trace's first span so the JSON is viewer-friendly.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from parallax_tpu_torch.analysis.sanitizer import make_lock

# Adjacent same-name spans on the same stage closer than this merge into
# one epoch span (decode steps arrive every few ms; a scheduling gap
# larger than this is interesting and breaks the epoch).
MERGE_GAP_S = 0.25


class TraceStore:
    """Bounded LRU store of per-request span lists (thread-safe)."""

    def __init__(self, capacity: int = 256, max_spans: int = 2048):
        self.capacity = capacity
        self.max_spans = max_spans
        self._traces: OrderedDict[str, list[dict]] = OrderedDict()
        self._lock = make_lock("obs.trace")

    # -- recording ---------------------------------------------------------

    def begin(self, trace_id: str) -> None:
        """Ensure a trace exists (idempotent — downstream stages call this
        when a sampled frame arrives for an id they have not seen)."""
        with self._lock:
            if trace_id in self._traces:
                return
            self._traces[trace_id] = {"spans": [], "open": {},
                                      "counters": []}
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)

    def has(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._traces

    def trace_ids(self) -> list[str]:
        """The ids of the traces held, oldest first (an addition of the
        port's: a worker's exit log lists its traces)."""
        with self._lock:
            return list(self._traces)

    def add(
        self,
        trace_id: str,
        stage: str,
        name: str,
        t0: float,
        dur: float = 0.0,
        args: dict | None = None,
        merge: bool = False,
    ) -> None:
        """Record one complete span. ``merge=True`` coalesces it into the
        trace's previous span of the same (stage, name) when that span
        ends within ``MERGE_GAP_S`` of this one's start — the decode-epoch
        mechanism. Per-(stage, name) merging keeps epochs intact even
        when stages interleave (multi-stage pipelines alternate decode
        spans across stages every token)."""
        with self._lock:
            trace = self._traces.get(trace_id)
            if trace is None:
                return
            spans = trace["spans"]
            if merge:
                last = trace["open"].get((stage, name))
                if (
                    last is not None
                    and t0 - (last["t0"] + last["dur"]) <= MERGE_GAP_S
                ):
                    last["dur"] = max(last["dur"], t0 + dur - last["t0"])
                    la = last.setdefault("args", {})
                    la["steps"] = la.get("steps", 1) + 1
                    if args:
                        for k, v in args.items():
                            if isinstance(v, (int, float)) and k in la:
                                la[k] += v
                            else:
                                la[k] = v
                    return
            if len(spans) >= self.max_spans:
                return
            span = {"name": name, "stage": stage, "t0": t0, "dur": dur}
            if args:
                span["args"] = dict(args)
            spans.append(span)
            if merge:
                trace["open"][(stage, name)] = span

    def counter(
        self,
        trace_id: str,
        stage: str,
        name: str,
        t0: float,
        values: dict,
    ) -> None:
        """Record one counter sample (device attribution plane: HBM
        headroom, per-program device-time share). Exports as a Chrome
        counter track (``ph: "C"``) alongside the span lanes; bounded by
        ``max_spans`` like everything else in the store."""
        with self._lock:
            trace = self._traces.get(trace_id)
            if trace is None:
                return
            counters = trace.setdefault("counters", [])
            if len(counters) >= self.max_spans:
                return
            counters.append({
                "name": name, "stage": stage, "t0": t0,
                "values": {
                    str(k): v for k, v in values.items()
                    if isinstance(v, (int, float))
                },
            })

    def adopt(self, trace_id: str, spans: list[dict]) -> int:
        """Seed a trace with spans recorded on ANOTHER host (live
        migration: the source head ships its TraceStore spans inside the
        checkpoint frame so ``/debug/trace/<rid>`` on the target shows
        one stitched timeline across heads). Spans are sanitized
        field-by-field — they arrive off the wire — and bounded by
        ``max_spans``; returns how many were adopted. Caller owns any
        clock rebasing (``t0`` must already be in this process's
        ``perf_counter`` domain)."""
        self.begin(trace_id)
        adopted = 0
        with self._lock:
            trace = self._traces.get(trace_id)
            if trace is None:
                return 0
            out = trace["spans"]
            for s in spans or ():
                if len(out) >= self.max_spans:
                    break
                if not isinstance(s, dict):
                    continue
                try:
                    span = {
                        "name": str(s["name"])[:64],
                        "stage": str(s.get("stage") or "?")[:64],
                        "t0": float(s["t0"]),
                        "dur": max(0.0, float(s.get("dur") or 0.0)),
                    }
                except (KeyError, TypeError, ValueError):
                    continue
                args = s.get("args")
                if isinstance(args, dict):
                    span["args"] = {
                        str(k)[:64]: v for k, v in list(args.items())[:16]
                        if isinstance(v, (int, float, str, bool))
                        or v is None
                    }
                out.append(span)
                adopted += 1
        return adopted

    # -- export ------------------------------------------------------------

    def spans(self, trace_id: str) -> list[dict] | None:
        with self._lock:
            trace = self._traces.get(trace_id)
            if trace is None:
                return None
            return [dict(s) for s in trace["spans"]]

    def counters(self, trace_id: str) -> list[dict]:
        with self._lock:
            trace = self._traces.get(trace_id)
            if trace is None:
                return []
            return [dict(c) for c in trace.get("counters", ())]

    def export_chrome(self, trace_id: str) -> dict | None:
        """Chrome trace-event JSON (``chrome://tracing`` / Perfetto):
        complete ("X") events, one thread lane per pipeline stage, plus
        counter ("C") tracks for the device attribution samples."""
        spans = self.spans(trace_id)
        if spans is None:
            return None
        counters = self.counters(trace_id)
        base = min(
            (s["t0"] for s in spans + counters), default=0.0
        )
        events = [
            {
                "name": s["name"],
                "cat": "request",
                "ph": "X",
                "ts": round((s["t0"] - base) * 1e6, 3),
                "dur": round(s["dur"] * 1e6, 3),
                "pid": 1,
                "tid": s["stage"],
                "args": s.get("args", {}),
            }
            for s in sorted(spans, key=lambda s: s["t0"])
        ]
        events.extend(
            {
                "name": c["name"],
                "cat": "device",
                "ph": "C",
                "ts": round((c["t0"] - base) * 1e6, 3),
                "pid": 1,
                "tid": c["stage"],
                "args": c["values"],
            }
            for c in sorted(counters, key=lambda c: c["t0"])
        )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"trace_id": trace_id},
        }

    def breakdown(self, trace_id: str) -> dict | None:
        """Total ms per span name — the flight recorder's slow-request
        breakdown payload."""
        spans = self.spans(trace_id)
        if not spans:
            return None
        out: dict[str, float] = {}
        for s in spans:
            out[s["name"]] = round(
                out.get(s["name"], 0.0) + s["dur"] * 1e3, 3
            )
        return out


_STORE = TraceStore()


def get_trace_store() -> TraceStore:
    """The process-wide trace store (all pipeline stages in one process
    share it, which is what stitches multi-stage spans into one trace)."""
    return _STORE
