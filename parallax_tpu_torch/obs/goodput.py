"""Goodput ledger: what fraction of device work served users.

Latency telemetry cannot tell a chip serving users from a chip
spinning on waste: a frozen multi-step tail, a migration replay, a
recompile storm and a preemption-rework loop all look like "steps ran".
Following the goodput framing of DistServe, this ledger classifies every
device-step TOKEN the engine dispatches into exactly one bucket:

- ``committed`` — a token a user stream actually received (useful);
- ``frozen_tail`` — multi-step decode window slots past a row's
  on-device stop point (the window's rollback: computed, never
  committed);
- ``replayed`` — teacher-forced commits of a migrated request's
  recorded outputs (a replay restore): the user already saw these tokens;
- ``preempted_rework`` — prefill recompute of positions a dead
  pipeline had already computed (replay-restore prompt re-prefill);
- ``speculative_rejected`` — speculative verify positions whose
  proposal lost.

and classifies host-visit + device TIME into ``serve`` / ``compile`` /
``swap`` / ``migrate`` buckets, with ``idle`` derived against wall
clock. Both surfaces export as registry counters plus a
``parallax_goodput_fraction`` gauge, ride worker heartbeats, and merge
cluster-wide into tokens-useful-per-chip-second in ``/cluster/status``
and bench JSON.

Accounting invariant (the bench churn probe asserts it): the per-kind
token counts sum EXACTLY to the ledger's total — every counted device
token lands in one bucket, none in two. Counting is a dict add under a
lock at commit/resolve granularity (never per device step), so the
default-config hot path cost is a few integer adds per host visit.
"""

from __future__ import annotations

import threading
import time
from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.obs import names as mnames

TOKEN_KINDS = (
    "committed",
    "frozen_tail",
    "replayed",
    "preempted_rework",
    "speculative_rejected",
)
# "idle" is derived (wall elapsed minus the explicit buckets), never
# recorded directly. "kv_transfer" is the disaggregation handoff lane
# (docs/disaggregation.md): on a prefill head, wall time from first
# KV frame enqueued to the decode head's accept/reject; on a decode
# head, begin-frame receipt to image assembly — the per-node cost of
# moving prompts between phase pools.
TIME_KINDS = ("serve", "compile", "swap", "migrate", "kv_transfer")

# Token kinds that served users. Replayed tokens are NOT useful: the
# client already streamed them before the migration; recomputing them
# is the price of the churn event.
USEFUL_KINDS = ("committed",)


class GoodputLedger:
    """Process-wide token/time usefulness accounting (thread-safe)."""

    def __init__(self, registry=None, clock=time.monotonic):
        self._clock = clock
        self._lock = make_lock("obs.goodput")
        self.tokens = {k: 0 for k in TOKEN_KINDS}
        self.time_s = {k: 0.0 for k in TIME_KINDS}
        self.requests = {"finished": 0, "aborted": 0}
        self._t0 = clock()
        self._registry = registry
        self._token_counters = None
        self._time_counters = None
        self._g_fraction = None
        self._c_requests = None

    # -- metric families (registered eagerly so /metrics carries the
    # zero-valued families even before any token is classified) ---------

    def bind_registry(self, registry=None) -> None:
        """Idempotently register this ledger's series. Called from the
        engine's ``_init_obs`` so the families exist the moment a stage
        serves; safe to call from tests with a private registry."""
        if self._token_counters is not None and registry is None:
            return
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._registry = registry
        tok = registry.counter(
            mnames.GOODPUT_TOKENS_TOTAL,
            "Device-step tokens classified by usefulness "
            "(committed / frozen_tail / replayed / preempted_rework / "
            "speculative_rejected)",
            labelnames=("kind",),
        )
        self._token_counters = {k: tok.labels(kind=k) for k in TOKEN_KINDS}
        tim = registry.counter(
            mnames.GOODPUT_TIME_SECONDS_TOTAL,
            "Host-visit and device seconds by activity bucket "
            "(serve / compile / swap / migrate / kv_transfer; idle is "
            "derived)",
            labelnames=("bucket",),
        )
        self._time_counters = {k: tim.labels(bucket=k) for k in TIME_KINDS}
        self._g_fraction = registry.gauge(
            mnames.GOODPUT_FRACTION,
            "Committed fraction of all classified device-step tokens "
            "on this node (0..1; 0 before any device work)",
        )
        req = registry.counter(
            mnames.REQUESTS_FINISHED_TOTAL,
            "Requests finished on this node's head stage, by outcome",
            labelnames=("outcome",),
        )
        self._c_requests = {
            "finished": req.labels(outcome="ok"),
            "aborted": req.labels(outcome="aborted"),
        }
        # The registry holds only a weakref; the ledger (module
        # singleton) keeps the bound method alive.
        registry.register_collector(self._collect)

    def _collect(self) -> None:
        self._g_fraction.set(self.goodput_fraction())

    # -- recording -------------------------------------------------------

    def count(self, kind: str, n: int) -> None:
        """Classify ``n`` device-step tokens into one bucket."""
        if n <= 0:
            return
        with self._lock:
            self.tokens[kind] += int(n)
        c = self._token_counters
        if c is not None:
            c[kind].inc(n)

    def add_time(self, kind: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self.time_s[kind] += float(seconds)
        c = self._time_counters
        if c is not None:
            c[kind].inc(seconds)

    def count_request(self, status_value: str) -> None:
        aborted = status_value == "finished_abort"
        with self._lock:
            self.requests["finished"] += 1
            if aborted:
                self.requests["aborted"] += 1
        c = self._c_requests
        if c is not None:
            c["aborted" if aborted else "finished"].inc()

    # -- derived ---------------------------------------------------------

    def total_tokens(self) -> int:
        with self._lock:
            return sum(self.tokens.values())

    def goodput_fraction(self) -> float:
        with self._lock:
            total = sum(self.tokens.values())
            useful = sum(self.tokens[k] for k in USEFUL_KINDS)
        return round(useful / total, 6) if total else 0.0

    def snapshot(self) -> dict:
        """Plain-dict state for tests and payload building."""
        with self._lock:
            return {
                "tokens": dict(self.tokens),
                "time_s": {k: round(v, 6) for k, v in self.time_s.items()},
                "requests": dict(self.requests),
            }

    def payload(self, chips: int = 1) -> dict:
        """Heartbeat / ``/cluster/status`` / bench JSON payload for this
        node. ``useful + wasted == total`` by construction — the exact
        equality the churn probe asserts."""
        now = self._clock()
        with self._lock:
            tokens = dict(self.tokens)
            time_s = dict(self.time_s)
            requests = dict(self.requests)
        total = sum(tokens.values())
        useful = sum(tokens[k] for k in USEFUL_KINDS)
        elapsed = max(0.0, now - self._t0)
        busy = sum(time_s.values())
        time_out = {k: round(v, 4) for k, v in time_s.items()}
        time_out["idle"] = round(max(0.0, elapsed - busy), 4)
        return {
            "tokens": tokens,
            "tokens_total": total,
            "tokens_useful": useful,
            "tokens_wasted": total - useful,
            "goodput_fraction": round(useful / total, 6) if total else 0.0,
            "time_s": time_out,
            "elapsed_s": round(elapsed, 4),
            "chips": max(1, int(chips)),
            "requests": requests,
        }


def merge_goodput(payloads: list) -> dict | None:
    """Cluster merge of per-node :meth:`GoodputLedger.payload` dicts:
    summed token buckets, cluster goodput fraction, and the headline
    tokens-useful-per-chip-second (useful tokens over summed wall
    chip-seconds). Malformed entries are skipped — cluster telemetry
    must survive heterogeneous builds."""
    tokens = {k: 0 for k in TOKEN_KINDS}
    requests = {"finished": 0, "aborted": 0}
    chip_seconds = 0.0
    serve_s = 0.0
    nodes = 0
    for p in payloads or ():
        if not isinstance(p, dict) or not isinstance(p.get("tokens"), dict):
            continue
        nodes += 1
        for k in TOKEN_KINDS:
            try:
                tokens[k] += int(p["tokens"].get(k) or 0)
            except (TypeError, ValueError):
                continue
        try:
            chip_seconds += (
                float(p.get("elapsed_s") or 0.0)
                * max(1, int(p.get("chips") or 1))
            )
            serve_s += float((p.get("time_s") or {}).get("serve") or 0.0)
        except (TypeError, ValueError):
            pass
        req = p.get("requests")
        if isinstance(req, dict):
            for k in requests:
                try:
                    requests[k] += int(req.get(k) or 0)
                except (TypeError, ValueError):
                    continue
    if not nodes:
        return None
    total = sum(tokens.values())
    useful = sum(tokens[k] for k in USEFUL_KINDS)
    return {
        "nodes": nodes,
        "tokens": tokens,
        "tokens_total": total,
        "tokens_useful": useful,
        "tokens_wasted": total - useful,
        "goodput_fraction": round(useful / total, 6) if total else 0.0,
        "tokens_useful_per_chip_second": (
            round(useful / chip_seconds, 3) if chip_seconds > 0 else 0.0
        ),
        "serve_seconds": round(serve_s, 3),
        "requests": requests,
    }


_LEDGER = GoodputLedger()


def get_goodput() -> GoodputLedger:
    """The process-wide goodput ledger (every stage engine, transport
    and migration path in one process accounts here; tests wanting
    isolation construct their own :class:`GoodputLedger`)."""
    return _LEDGER
