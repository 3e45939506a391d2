"""Unified observability layer: metrics registry, request tracing,
flight recorder, and the production health plane (a port of
``parallax_tpu/obs``: the same classes, payloads, metric names and
exposition text, so a mixed swarm merges into one set of dashboards).

Seven pillars (docs/observability.md):

- :mod:`parallax_tpu_torch.obs.registry` — thread-safe Counter/Gauge/Histogram
  primitives with Prometheus text exposition; every engine/transport/HTTP
  series lives in one process-wide registry so ``/metrics`` exposes the
  full serving surface, and histogram snapshots ride worker heartbeats
  into cluster-wide percentiles.
- :mod:`parallax_tpu_torch.obs.trace` — request-lifecycle span recorder whose
  trace context rides the FORWARD wire frames (and the
  migration checkpoint frames), so spans emitted on different pipeline
  stages — and different heads — stitch into one Chrome-trace-viewable
  trace (``GET /debug/trace/<request_id>``).
- :mod:`parallax_tpu_torch.obs.flight` — bounded ring of recent request
  timelines plus sequence-numbered engine events, surfaced at
  ``GET /debug/flight`` and shipped in heartbeat batches to the cluster
  timeline.
- :mod:`parallax_tpu_torch.obs.goodput` — the goodput ledger: every
  device-step token classified committed / frozen_tail / replayed /
  preempted_rework / speculative_rejected, and serving time bucketed
  serve / compile / swap / migrate / idle; cluster-merged into
  tokens-useful-per-chip-second.
- :mod:`parallax_tpu_torch.obs.watchdog` — per-component progress watchdog
  (ok -> degraded -> stalled) feeding a deep ``/healthz`` and per-node
  health in ``/cluster/status``.
- :mod:`parallax_tpu_torch.obs.timeline` — the scheduler-side merge of every
  node's flight events into one causally-ordered swarm timeline
  (``GET /debug/timeline``, JSON + Chrome trace).
- :mod:`parallax_tpu_torch.obs.slo` — declarative TTFT/TPOT/availability
  objectives with windowed attainment and multi-window burn rates.

Beside them, :mod:`parallax_tpu_torch.obs.device` (the HBM ledger, the
compile observatory over CUDA-graph captures and library builds, and the
per-program device time from CUDA events) and the port's
:mod:`parallax_tpu_torch.obs.profiler` (``torch.profiler`` traces started
and stopped on the step thread).
"""

from parallax_tpu_torch.obs.flight import FlightRecorder, get_flight
from parallax_tpu_torch.obs.goodput import GoodputLedger, get_goodput, merge_goodput
from parallax_tpu_torch.obs.registry import (
    EXPOSITION_CONTENT_TYPE,
    MetricsRegistry,
    get_registry,
    merge_histogram_snapshots,
    summarize_snapshots,
)
from parallax_tpu_torch.obs.slo import SLOConfig, SLOTracker, parse_slo_spec
from parallax_tpu_torch.obs.timeline import ClusterTimeline, LocalTimeline
from parallax_tpu_torch.obs.trace import TraceStore, get_trace_store
from parallax_tpu_torch.obs.watchdog import StallWatchdog, worst_status

__all__ = [
    "EXPOSITION_CONTENT_TYPE",
    "ClusterTimeline",
    "FlightRecorder",
    "GoodputLedger",
    "LocalTimeline",
    "MetricsRegistry",
    "SLOConfig",
    "SLOTracker",
    "StallWatchdog",
    "TraceStore",
    "get_flight",
    "get_goodput",
    "get_registry",
    "get_trace_store",
    "merge_goodput",
    "merge_histogram_snapshots",
    "parse_slo_spec",
    "summarize_snapshots",
    "worst_status",
]
