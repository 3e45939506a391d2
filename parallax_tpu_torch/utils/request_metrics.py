"""Request/step metrics helpers.

Client side — capability parity: reference
``src/parallax_utils/request_metrics.py:4-19`` (``get_request_metrics``:
TPS/TTFT/token counts parsed from the final SSE usage chunk). Used by the
chat CLI and the benchmark client to report per-request numbers without
trusting server-side aggregation.

Server side — :class:`StepTimingAggregator` folds the two-phase engine
step's ``host_ms``/``device_ms``/``overlapped`` telemetry (StepOutputs)
into EWMAs published via worker heartbeats and ``/cluster/status``, so
operators can see how much host scheduling time the overlapped decode
loop actually hides behind device compute.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


class StepTimingAggregator:
    """EWMA over per-step timing from the two-phase decode loop.

    Optionally feeds the same samples into metrics-registry histograms
    (``obs/registry.py``) so ``/metrics`` and cluster-wide heartbeat
    merges see full distributions, not just EWMAs — one choke point for
    every resolve path (sync, deferred-sampler, fused multistep).

    Multi-step decode commits K tokens per host visit, so the aggregator
    keeps TWO series: per-HOST-VISIT cost (``host_ms_ewma`` — what a
    dispatch/resolve pair blocks the step thread for) and per-TOKEN cost
    (``per_token_host_ms_ewma`` — the visit cost amortized over the
    tokens it committed, the number TPOT actually pays). Conflating the
    two made a K-step world look K-times slower per dispatch than the
    K=1 one it beats.
    """

    def __init__(self, alpha: float = 0.2, host_hist=None, device_hist=None,
                 per_token_hist=None):
        self.alpha = alpha
        self.host_ms_ewma: float | None = None
        self.device_ms_ewma: float | None = None
        self.per_token_host_ms_ewma: float | None = None
        self.steps = 0
        self.tokens = 0
        self.overlapped_steps = 0
        self.host_hist = host_hist
        self.device_hist = device_hist
        self.per_token_hist = per_token_hist

    def update(self, host_ms: float, device_ms: float,
               overlapped: bool, tokens: int = 1) -> None:
        a = self.alpha
        self.host_ms_ewma = (
            host_ms if self.host_ms_ewma is None
            else (1 - a) * self.host_ms_ewma + a * host_ms
        )
        self.device_ms_ewma = (
            device_ms if self.device_ms_ewma is None
            else (1 - a) * self.device_ms_ewma + a * device_ms
        )
        self.steps += 1
        self.tokens += max(0, tokens)
        if overlapped:
            self.overlapped_steps += 1
        if self.host_hist is not None:
            self.host_hist.observe(host_ms)
        if self.device_hist is not None:
            self.device_hist.observe(device_ms)
        if tokens > 0:
            per_tok = host_ms / tokens
            self.per_token_host_ms_ewma = (
                per_tok if self.per_token_host_ms_ewma is None
                else (1 - a) * self.per_token_host_ms_ewma + a * per_tok
            )
            if self.per_token_hist is not None:
                self.per_token_hist.observe(per_tok)

    def summary(self) -> dict | None:
        """Heartbeat/status payload; None before the first step."""
        if not self.steps:
            return None
        d = {
            "host_ms_ewma": round(self.host_ms_ewma, 3),
            "device_ms_ewma": round(self.device_ms_ewma, 3),
            "steps": self.steps,
            "host_visits": self.steps,
            "tokens": self.tokens,
            "tokens_per_visit": round(self.tokens / self.steps, 2),
            "overlapped_steps": self.overlapped_steps,
            "overlap_fraction": round(
                self.overlapped_steps / self.steps, 3
            ),
        }
        if self.per_token_host_ms_ewma is not None:
            d["per_token_host_ms_ewma"] = round(
                self.per_token_host_ms_ewma, 3
            )
        return d


@dataclasses.dataclass
class CacheStats:
    """Prefix-cache and memory-tier counters for one engine stage.

    Owned by the stage's cache manager (Python or native) and incremented
    on the admission / eviction / preemption paths; summarized per
    heartbeat for ``/cluster/status`` by :func:`cache_stats_summary`.
    """

    tokens_admitted: int = 0       # prompt tokens of admitted requests
    tokens_hit_device: int = 0     # skipped via device-resident prefixes
    tokens_hit_host: int = 0       # skipped via host-tier swap-ins
    tokens_chunk_skipped: int = 0  # of hit_device, skipped by a
    #                                mid-prefill radix re-consult
    pages_evicted: int = 0         # device pages reclaimed from the tree
    preemptions: int = 0           # decode-OOM swap-outs to host
    resumes: int = 0               # preempted requests swapped back in
    kv_oom_aborts: int = 0         # last-resort aborts (host tier full)
    pages_invalidated: int = 0     # tree pages a weight refit made
    #                                unmatchable (device and host)


def cache_stats_summary(cache) -> dict | None:
    """Heartbeat/status/bench payload for a CacheManager-like object;
    None when it carries no stats (metrics never break serving)."""
    stats = getattr(cache, "stats", None)
    if stats is None:
        return None
    try:
        admitted = stats.tokens_admitted
        hit = stats.tokens_hit_device + stats.tokens_hit_host
        num_pages = getattr(cache, "num_pages", 0)
        free = getattr(cache, "num_free_pages", 0)
        d = {
            "tokens_admitted": admitted,
            "tokens_hit_device": stats.tokens_hit_device,
            "tokens_hit_host": stats.tokens_hit_host,
            "tokens_chunk_skipped": getattr(
                stats, "tokens_chunk_skipped", 0
            ),
            "prefix_hit_rate": round(hit / admitted, 4) if admitted else 0.0,
            "host_hit_rate": (
                round(stats.tokens_hit_host / admitted, 4) if admitted
                else 0.0
            ),
            "pages_evicted": stats.pages_evicted,
            "preemptions": stats.preemptions,
            "resumes": stats.resumes,
            "kv_oom_aborts": stats.kv_oom_aborts,
            "page_occupancy": (
                round(1.0 - free / num_pages, 4) if num_pages else 0.0
            ),
            "cached_pages": getattr(
                getattr(cache, "prefix_cache", None), "num_cached_pages", 0
            ),
        }
        tier = getattr(cache, "host_tier", None)
        if tier is not None:
            d.update(
                host_pages=tier.num_host_pages,
                host_capacity_pages=tier.capacity_pages,
                pages_demoted=tier.pages_demoted,
                pages_swapped_in=tier.pages_swapped_in,
                host_evictions=tier.host_evictions,
            )
        return d
    except Exception:  # pragma: no cover - defensive; see docstring
        return None


def parse_usage_chunk(chunk: bytes | str | dict) -> dict | None:
    """The ``usage`` object of an SSE data chunk, or None."""
    try:
        if isinstance(chunk, bytes):
            chunk = chunk.decode("utf-8", errors="replace")
        if isinstance(chunk, str):
            chunk = chunk.strip()
            if chunk.startswith("data:"):
                chunk = chunk[len("data:"):].strip()
            if not chunk or chunk == "[DONE]":
                return None
            chunk = json.loads(chunk)
        usage = chunk.get("usage")
        return usage if isinstance(usage, dict) else None
    except Exception:
        return None


def request_metrics(
    final_chunk: Any,
    start_time: float,
    first_token_time: float | None,
    last_token_time: float | None,
) -> tuple[float | None, int | None, int | None, int | None]:
    """(tokens_per_second, ttft_ms, prompt_tokens, completion_tokens).

    All-None on any malformed input — metrics never break the request
    path (reference contract).
    """
    usage = parse_usage_chunk(final_chunk)
    if usage is None or first_token_time is None:
        return None, None, None, None
    try:
        out_tokens = int(usage["completion_tokens"])
        in_tokens = int(usage["prompt_tokens"])
        span = (last_token_time or first_token_time) - first_token_time
        # One-token replies have no measurable span; a rate would be
        # fabricated, so tps stays None while the counts remain usable.
        tps = out_tokens / span if span > 0 else None
        ttft_ms = int((first_token_time - start_time) * 1000)
        return tps, ttft_ms, in_tokens, out_tokens
    except Exception:
        return None, None, None, None
