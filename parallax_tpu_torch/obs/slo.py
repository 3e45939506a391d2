"""Declarative SLO tracking: per-window attainment + multi-window burn.

ROADMAP item 4 (SLO-aware multi-tenant serving) needs a decision-grade
signal: "is the swarm meeting its latency/availability objectives, and
how fast is the error budget burning?" — not raw p95s. This module
turns the existing cumulative histograms (``obs/registry.py``
snapshots, per node or cluster-merged) into exactly that:

- objectives are declared as a compact spec string
  (config/CLI ``--slo``), e.g.::

      ttft_p95_ms=500,tpot_p95_ms=50,availability=0.999

  ``<metric>_p<QQ>_ms=<threshold>`` reads "QQ% of requests must see
  <metric> at or under <threshold> ms"; ``availability=<target>`` is
  the non-aborted fraction of finished requests.

- an :class:`SLOTracker` keeps a bounded ring of cumulative samples
  and computes, per objective, the **windowed attainment** (fraction
  of the window's requests inside the objective) and the **burn rate**
  ``(1 - attainment) / (1 - target)`` over a short and a long window
  (the standard multi-window burn-rate alerting pair: burn > 1 means
  the error budget is being spent faster than it accrues).

Attainment comes from histogram bucket deltas (cumulative count at the
threshold bound, linearly interpolated inside the landing bucket), so
no per-request state is kept anywhere. Results export as
``parallax_slo_attainment`` / ``parallax_slo_burn_rate`` gauges and as
the ``slo`` section of ``/cluster/status`` — the admission-control
hook point for SLO-aware scheduling.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from collections import deque
from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.obs import names as mnames

# Spec keys -> registry metric names.
_LATENCY_METRICS = {
    "ttft": mnames.TTFT_MS,
    "tpot": mnames.TPOT_MS,
    "e2e": mnames.E2E_MS,
}

_LAT_RE = re.compile(r"^(ttft|tpot|e2e)_p(\d{1,2})_ms$")


@dataclasses.dataclass(frozen=True)
class Objective:
    name: str                 # spec form, e.g. "ttft_p95_ms=500"
    kind: str                 # "latency" | "availability"
    target: float             # required attainment fraction (0..1)
    metric: str = ""          # registry metric (latency objectives)
    threshold_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    objectives: tuple = ()
    window_s: float = 300.0         # short window
    long_window_factor: float = 12.0  # long window = factor * window_s

    @property
    def windows(self) -> tuple:
        return (self.window_s, self.window_s * self.long_window_factor)


def parse_slo_spec(
    spec: str, window_s: float = 300.0, long_window_factor: float = 12.0
) -> SLOConfig:
    """Parse the ``--slo`` spec string; raises ValueError on anything
    malformed so a typo'd objective fails at startup, not silently."""
    objectives = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"SLO objective {part!r} is not key=value")
        key, _, value = part.partition("=")
        key = key.strip()
        try:
            val = float(value)
        except ValueError:
            raise ValueError(f"SLO objective {part!r} has a non-numeric "
                             "value")
        if key == "availability":
            if not 0.0 < val < 1.0:
                raise ValueError("availability target must be in (0, 1)")
            objectives.append(Objective(
                name=part, kind="availability", target=val,
            ))
            continue
        m = _LAT_RE.match(key)
        if m is None:
            raise ValueError(
                f"unknown SLO objective {key!r} (want "
                "ttft_pNN_ms / tpot_pNN_ms / e2e_pNN_ms / availability)"
            )
        if val <= 0:
            raise ValueError(f"{key} threshold must be > 0 ms")
        objectives.append(Objective(
            name=part, kind="latency", target=int(m.group(2)) / 100.0,
            metric=_LATENCY_METRICS[m.group(1)], threshold_ms=val,
        ))
    if not objectives:
        raise ValueError("empty SLO spec")
    return SLOConfig(
        objectives=tuple(objectives), window_s=window_s,
        long_window_factor=long_window_factor,
    )


def fraction_below(snap: dict, threshold: float) -> tuple[float, int]:
    """(cumulative count at ``threshold``, total count) for one
    histogram snapshot, linearly interpolated inside the landing
    bucket. The +Inf bucket contributes only when the threshold is
    infinite — bucketed data cannot attest anything above its last
    bound."""
    try:
        bounds = list(snap["bounds"])
        counts = list(snap["counts"])
        # The attestable population is the BUCKET population: a
        # mixed-bounds merge folds sum/count-only children into "count"
        # without bucket attribution, and counting them in the
        # denominator would bias attainment low (false burn alerts).
        total = int(sum(counts))
    except (KeyError, TypeError, ValueError):
        return 0.0, 0
    if total <= 0 or len(counts) != len(bounds) + 1:
        return 0.0, 0
    under = 0.0
    lo = 0.0
    for i, n in enumerate(counts[:-1]):
        hi = bounds[i]
        if threshold >= hi:
            under += n
        elif threshold > lo:
            under += n * (threshold - lo) / (hi - lo)
            break
        else:
            break
        lo = hi
    # The +Inf bucket never contributes: bucketed data cannot attest
    # anything above its last finite bound.
    return under, total


def _metric_under_total(
    hists: dict, metric: str, threshold: float
) -> tuple[float, int]:
    """Sum (under, total) across every labeled child of ``metric`` in a
    ``histogram_snapshots()``-shaped payload. Per-child evaluation, so
    heterogeneous bucket lattices degrade per child, never silently."""
    under = 0.0
    total = 0
    children = (hists or {}).get(metric)
    if not isinstance(children, dict):
        return under, total
    for child in children.values():
        u, t = fraction_below(child, threshold)
        under += u
        total += t
    return under, total


class SLOTracker:
    """Windowed attainment + burn rates over cumulative samples.

    ``observe(sample)`` appends one cumulative sample::

        {"hists": <histogram_snapshots payload>,
         "finished": <int>, "aborted": <int>}

    ``evaluate()`` computes, per objective and window, the delta
    between now and the sample closest to the window's start (the
    earliest retained sample when history is shorter — a cold tracker
    reports over what it has, flagged via ``"window_covered_s"``).
    """

    def __init__(self, config: SLOConfig, registry=None,
                 clock=time.monotonic):
        self.config = config
        self._clock = clock
        self._lock = make_lock("obs.slo")
        horizon = max(config.windows) * 1.25 + 60.0
        self._horizon = horizon
        self._history: deque[tuple[float, dict]] = deque()
        # Times the cumulative inputs went BACKWARDS (a node holding
        # part of the merged totals died or restarted). Retained
        # history is discarded at that point — windows re-anchor on
        # post-regression samples instead of reporting the negative
        # delta as "no traffic, perfect attainment".
        self.resets = 0
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        lbl = ("objective", "window")
        self._g_attainment = registry.gauge(
            mnames.SLO_ATTAINMENT,
            "Windowed SLO attainment per objective (fraction of the "
            "window's requests inside the objective; 1.0 with no "
            "traffic)", labelnames=lbl,
        )
        self._g_burn = registry.gauge(
            mnames.SLO_BURN_RATE,
            "Windowed error-budget burn rate per objective "
            "((1 - attainment) / (1 - target); > 1 burns faster than "
            "the budget accrues)", labelnames=lbl,
        )

    def observe(self, sample: dict, now: float | None = None) -> None:
        if now is None:
            now = self._clock()
        keep = {
            "hists": sample.get("hists") or {},
            "finished": int(sample.get("finished") or 0),
            "aborted": int(sample.get("aborted") or 0),
        }
        with self._lock:
            if self._history and self._regressed(self._history[-1][1], keep):
                # Cumulative counters shrank: a contributing node died
                # or restarted, so deltas against the retained history
                # would under-count (clamped negatives read as "no
                # traffic = attained" exactly during the churn episode
                # SLO tracking exists to catch). Re-anchor loudly.
                self._history.clear()
                self.resets += 1
            self._history.append((now, keep))
            while (
                self._history
                and now - self._history[0][0] > self._horizon
            ):
                self._history.popleft()

    def _regressed(self, prev: dict, cur: dict) -> bool:
        """True when any objective's cumulative (good, total) counts
        moved backwards between consecutive samples."""
        for obj in self.config.objectives:
            g_prev, t_prev = self._objective_counts(obj, prev)
            g_cur, t_cur = self._objective_counts(obj, cur)
            if t_cur < t_prev or g_cur < g_prev - 1e-9:
                return True
        return False

    def _baseline(self, now: float, window: float):
        """Latest sample at or before the window start; the earliest
        retained one when history is shorter than the window."""
        base = None
        for t, s in self._history:
            if t <= now - window:
                base = (t, s)
            else:
                break
        if base is None and self._history:
            base = self._history[0]
        return base

    @staticmethod
    def _objective_counts(obj: Objective, sample: dict) -> tuple[float, int]:
        """(good, total) cumulative counts for one objective."""
        if obj.kind == "availability":
            total = sample["finished"]
            return float(total - sample["aborted"]), total
        return _metric_under_total(
            sample["hists"], obj.metric, obj.threshold_ms
        )

    def evaluate(self, now: float | None = None) -> dict:
        if now is None:
            now = self._clock()
        with self._lock:
            history = list(self._history)
        if not history:
            return {"objectives": {}, "windows_s": list(self.config.windows),
                    "resets": self.resets}
        cur_t, cur = history[-1]
        out: dict = {
            "objectives": {},
            "windows_s": [round(w, 1) for w in self.config.windows],
            "resets": self.resets,
        }
        for obj in self.config.objectives:
            good_now, total_now = self._objective_counts(obj, cur)
            windows = {}
            for w in self.config.windows:
                base = self._baseline(now, w)
                if base is None:
                    continue
                base_t, base_s = base
                good0, total0 = self._objective_counts(obj, base_s)
                d_total = max(0, total_now - total0)
                d_good = max(0.0, good_now - good0)
                # No traffic in the window = nothing violated the
                # objective: attained, zero burn.
                att = min(1.0, d_good / d_total) if d_total else 1.0
                burn = (1.0 - att) / max(1e-9, 1.0 - obj.target)
                key = f"{int(round(w))}s"
                windows[key] = {
                    "attainment": round(att, 6),
                    "burn_rate": round(burn, 4),
                    "samples": d_total,
                    "window_covered_s": round(
                        min(w, max(0.0, cur_t - base_t)), 1
                    ),
                }
                self._g_attainment.labels(
                    objective=obj.name, window=key
                ).set(att)
                self._g_burn.labels(objective=obj.name, window=key).set(burn)
            short = windows.get(f"{int(round(self.config.windows[0]))}s")
            out["objectives"][obj.name] = {
                "kind": obj.kind,
                "target": obj.target,
                **({"metric": obj.metric,
                    "threshold_ms": obj.threshold_ms}
                   if obj.kind == "latency" else {}),
                "windows": windows,
                "met": (
                    short is None or short["attainment"] >= obj.target
                ),
            }
        return out

    def observe_and_evaluate(
        self, sample: dict, now: float | None = None
    ) -> dict:
        self.observe(sample, now=now)
        return self.evaluate(now=now)
