"""Unified metrics registry: Counter / Gauge / Histogram + Prometheus text.

One process-wide registry (``get_registry()``) replaces the telemetry
islands that grew across PRs 1-3 (hand-rolled ``/metrics`` counters,
StepTimingAggregator EWMAs, AsyncSender link stats, CacheStats): every
component registers its series here, ``/metrics`` renders the whole
surface with proper ``# HELP``/``# TYPE`` lines and the Prometheus
``text/plain; version=0.0.4`` content type, and histogram snapshots ride
worker heartbeats so the global scheduler can merge them into
cluster-wide percentiles in ``/cluster/status``.

Design constraints:

- **Hot-path cheap.** ``Histogram.observe`` is one bisect + two adds
  under a per-child lock; no allocation. Derived/gauge values that would
  cost per-step work (queue depth, page occupancy, monotonic cache
  counters) are pulled lazily at render/snapshot time through registered
  *collector* callbacks (held by weakref so dead engines never pin).
- **Fixed log-spaced buckets.** Latency histograms share one bucket
  lattice (``DEFAULT_MS_BUCKETS``) so snapshots from heterogeneous nodes
  merge bucket-for-bucket.
- **Get-or-create.** Re-registering a metric with the same name and type
  returns the existing family (engines are rebuilt on elastic reloads;
  series must accumulate, not collide). A type mismatch raises.
"""

from __future__ import annotations

import bisect
import math
import weakref

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.obs import names as mnames

# The content type Prometheus scrapers require for text exposition.
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple[float, ...]:
    """Log-spaced bucket upper bounds covering [lo, hi]."""
    if lo <= 0 or hi <= lo or per_decade < 1:
        raise ValueError("want 0 < lo < hi and per_decade >= 1")
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    out = [round(lo * 10 ** (i / per_decade), 6) for i in range(n + 1)]
    # Float rounding can land the last bound just short of hi.
    if out[-1] < hi:
        out.append(round(hi, 6))
    return tuple(out)


# Shared lattice for every latency-in-milliseconds histogram: 0.1 ms ..
# 100 s, four buckets per decade. One lattice => cluster-wide merges are
# bucket-for-bucket.
DEFAULT_MS_BUCKETS = log_buckets(0.1, 100_000.0, per_decade=4)
# Counts (batch tokens, queue depths) use a coarser lattice.
DEFAULT_COUNT_BUCKETS = log_buckets(1.0, 65_536.0, per_decade=3)


def _escape_label(value: str) -> str:
    """Prometheus label-VALUE escaping (backslash, newline, quote).
    Every label value the registry renders routes through here — peer
    addresses, pipeline ids and request-derived strings are hostile
    input as far as the exposition format is concerned."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _escape_help(text: str) -> str:
    """HELP-line escaping per the exposition format (backslash and
    newline only; quotes are legal there)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_key(labelnames: tuple, kv: dict) -> tuple:
    if set(kv) != set(labelnames):
        raise ValueError(
            f"labels {sorted(kv)} do not match declared {sorted(labelnames)}"
        )
    return tuple(str(kv[name]) for name in labelnames)


class _Child:
    """One labeled series of a metric family."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = make_lock("obs.registry_child")


class CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount

    def set_total(self, total: float) -> None:
        """Monotonic set: adopt an externally-accumulated total (existing
        counter structs like CacheStats / sender link stats publish their
        running totals through this; the value never goes backwards)."""
        with self._lock:
            if total > self.value:
                self.value = total


class GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class HistogramChild(_Child):
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        super().__init__()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self.counts),
                "sum": self.sum,
                "count": self.count,
            }


class _Family:
    """A named metric family: type, help text, labeled children."""

    def __init__(self, name: str, help_text: str, kind: str,
                 labelnames: tuple[str, ...], child_factory,
                 bounds: tuple[float, ...] | None = None):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self.bounds = bounds  # histogram bucket lattice (None otherwise)
        self._child_factory = child_factory
        self._children: dict[tuple, _Child] = {}
        self._lock = make_lock("obs.registry_family")

    def labels(self, **kv) -> _Child:
        key = _labels_key(self.labelnames, kv)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._child_factory()
                    self._children[key] = child
        return child

    # Unlabeled convenience: a family declared with no labelnames proxies
    # straight to its single child.
    def _solo(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels()"
            )
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def set_total(self, total: float) -> None:
        self._solo().set_total(total)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    @property
    def value(self) -> float:
        return self._solo().value

    @property
    def total(self) -> float:
        """Sum of every child's value across labels (counters/gauges)."""
        with self._lock:
            return float(sum(c.value for c in self._children.values()))

    def _label_str(self, key: tuple, extra: str = "") -> str:
        parts = [
            f'{n}="{_escape_label(v)}"'
            for n, v in zip(self.labelnames, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self) -> list[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            if self.kind == "histogram":
                snap = child.snapshot()
                cum = 0
                for bound, n in zip(
                    snap["bounds"] + [math.inf],
                    snap["counts"],
                ):
                    cum += n
                    le = f'le="{_fmt(bound)}"'
                    lines.append(
                        f"{self.name}_bucket"
                        f"{self._label_str(key, le)} {cum}"
                    )
                lines.append(
                    f"{self.name}_sum{self._label_str(key)}"
                    f" {_fmt(snap['sum'])}"
                )
                lines.append(
                    f"{self.name}_count{self._label_str(key)}"
                    f" {snap['count']}"
                )
            else:
                lines.append(
                    f"{self.name}{self._label_str(key)} {_fmt(child.value)}"
                )
        return lines

    def histogram_snapshots(self) -> dict[str, dict]:
        """Snapshot every child, keyed by the rendered label string."""
        with self._lock:
            items = sorted(self._children.items())
        return {self._label_str(key): c.snapshot() for key, c in items}


class MetricsRegistry:
    """Get-or-create registry of metric families + collector callbacks."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = make_lock("obs.registry")
        # Weakly-held zero-arg callables run before every render/snapshot
        # to refresh pull-style series (gauges, adopted counters).
        self._collectors: list = []

    # -- registration ------------------------------------------------------

    def _family(self, name: str, help_text: str, kind: str,
                labelnames: tuple, child_factory,
                bounds: tuple | None = None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, not "
                        f"{kind}{tuple(labelnames)}"
                    )
                if fam.bounds != bounds:
                    # A silent lattice mismatch would drop this node's
                    # children from cluster merges with no error anywhere.
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.bounds}, not {bounds}"
                    )
                return fam
            fam = _Family(name, help_text, kind, labelnames, child_factory,
                          bounds=bounds)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str,
                labelnames: tuple = ()) -> _Family:
        return self._family(name, help_text, "counter", labelnames,
                            CounterChild)

    def gauge(self, name: str, help_text: str,
              labelnames: tuple = ()) -> _Family:
        return self._family(name, help_text, "gauge", labelnames, GaugeChild)

    def histogram(self, name: str, help_text: str,
                  buckets: tuple[float, ...] | None = None,
                  labelnames: tuple = ()) -> _Family:
        bounds = tuple(buckets or DEFAULT_MS_BUCKETS)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be strictly increasing")
        return self._family(
            name, help_text, "histogram", labelnames,
            lambda: HistogramChild(bounds), bounds=bounds,
        )

    def register_collector(self, fn) -> None:
        """Run ``fn()`` before every render/snapshot. Held by weakref —
        the owner must keep a strong reference (engines stash theirs on
        ``self``) and collection silently stops when it dies."""
        ref = (
            weakref.WeakMethod(fn)
            if hasattr(fn, "__self__") else weakref.ref(fn)
        )
        with self._lock:
            self._collectors.append(ref)

    def _run_collectors(self) -> None:
        with self._lock:
            refs = list(self._collectors)
        dead = []
        for ref in refs:
            fn = ref()
            if fn is None:
                dead.append(ref)
                continue
            try:
                fn()
            except Exception:  # pragma: no cover - metrics never break serving
                pass
        if dead:
            with self._lock:
                self._collectors = [
                    r for r in self._collectors if r not in dead
                ]

    # -- output ------------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition of every family."""
        self._run_collectors()
        with self._lock:
            fams = sorted(self._families.values(), key=lambda f: f.name)
        lines: list[str] = []
        for fam in fams:
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    def histogram_snapshots(self) -> dict:
        """All histogram children as mergeable snapshots:
        ``{name: {label_str: {bounds, counts, sum, count}}}`` — the
        heartbeat payload workers ship to the global scheduler."""
        self._run_collectors()
        with self._lock:
            fams = [
                f for f in self._families.values() if f.kind == "histogram"
            ]
        return {
            f.name: f.histogram_snapshots()
            for f in sorted(fams, key=lambda f: f.name)
        }


def _count_merge_skipped(n: int = 1) -> None:
    """Bump ``parallax_obs_merge_skipped_total`` (never raises)."""
    try:
        get_registry().counter(
            mnames.OBS_MERGE_SKIPPED_TOTAL,
            "Histogram children whose bucket lattice could not be "
            "merged bucket-for-bucket (heterogeneous-build swarm); "
            "their sum/count still fold in, percentiles degrade loudly",
        ).inc(n)
    except Exception:  # pragma: no cover - metrics never break merging
        pass


def merge_histogram_snapshots(snaps: list[dict]) -> dict:
    """Merge per-node ``histogram_snapshots()`` payloads element-wise.

    Children from different nodes merge bucket-for-bucket when their
    bounds match (they do, by the shared-lattice convention). A child
    whose lattice DISAGREES — a heterogeneous-build swarm — is no
    longer dropped silently: its ``sum``/``count`` still fold into the
    merged child, the child is flagged with ``mixed_bounds`` (how many
    children degraded to sum/count-only merging, propagated into
    :func:`summarize_snapshots` output), and
    ``parallax_obs_merge_skipped_total`` counts it — cluster p50/p95/
    p99 then degrade loudly, not silently. Children too malformed to
    even yield a sum/count are skipped and counted.
    """
    merged: dict[str, dict] = {}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for name, children in snap.items():
            if not isinstance(children, dict):
                continue
            out_children = merged.setdefault(name, {})
            for label, child in children.items():
                try:
                    csum = float(child["sum"])
                    ccount = int(child["count"])
                except (KeyError, TypeError, ValueError):
                    _count_merge_skipped()
                    continue
                try:
                    bounds = list(child["bounds"])
                    counts = [int(c) for c in child["counts"]]
                    if len(counts) != len(bounds) + 1:
                        bounds = counts = None
                except (KeyError, TypeError, ValueError):
                    bounds = counts = None
                cur = out_children.get(label)
                if cur is None:
                    if bounds is None:
                        # Lattice unusable: carry sum/count only, with
                        # a degenerate one-bucket lattice so downstream
                        # percentile code stays shape-safe.
                        _count_merge_skipped()
                        out_children[label] = {
                            "bounds": [], "counts": [0],
                            "sum": csum, "count": ccount,
                            "mixed_bounds": 1,
                        }
                    else:
                        out_children[label] = {
                            "bounds": bounds, "counts": counts,
                            "sum": csum, "count": ccount,
                        }
                elif bounds is not None and cur["bounds"] == bounds:
                    cur["counts"] = [
                        a + b for a, b in zip(cur["counts"], counts)
                    ]
                    cur["sum"] += csum
                    cur["count"] += ccount
                elif bounds is not None and not cur["bounds"]:
                    # The merged child so far is lattice-less (a
                    # malformed FIRST child pinned the degenerate []
                    # lattice): adopt this child's valid lattice so one
                    # bad node cannot destroy percentiles for everyone
                    # behind it — order must not change the answer.
                    cur["bounds"] = bounds
                    cur["counts"] = counts
                    cur["sum"] += csum
                    cur["count"] += ccount
                else:
                    # Bucket-lattice mismatch (or unusable lattice):
                    # fall back to sum/count-only merging and say so.
                    _count_merge_skipped()
                    cur["sum"] += csum
                    cur["count"] += ccount
                    cur["mixed_bounds"] = cur.get("mixed_bounds", 0) + 1
    return merged


def snapshot_quantile(snap: dict, q: float) -> float:
    """Estimate the q-quantile from one histogram snapshot (linear
    interpolation inside the landing bucket; the +Inf bucket reports its
    lower bound — the honest answer bucketed data can give).

    The quantile targets the BUCKET population (``sum(counts)``), not
    ``count``: a mixed-bounds merge (see merge_histogram_snapshots)
    folds sum/count-only children into ``count`` without bucket
    attribution, and targeting the inflated count would push every
    quantile toward the lattice max. For ordinary snapshots the two are
    equal."""
    count = sum(snap.get("counts") or ()) or snap.get("count", 0)
    if not count:
        return 0.0
    target = q * count
    bounds = snap["bounds"]
    cum = 0
    lo = 0.0
    for i, n in enumerate(snap["counts"]):
        hi = bounds[i] if i < len(bounds) else math.inf
        if cum + n >= target and n > 0:
            if hi == math.inf:
                return lo
            frac = (target - cum) / n
            return lo + (hi - lo) * frac
        cum += n
        lo = hi if hi != math.inf else lo
    return lo


def summarize_snapshots(snaps: dict, quantiles=(0.5, 0.95, 0.99)) -> dict:
    """Compact percentile summary of a (merged) snapshot payload:
    ``{metric: {label: {count, sum, p50, p95, p99}}}`` — what
    ``/cluster/status`` and bench JSON surface."""
    out: dict = {}
    for name, children in (snaps or {}).items():
        if not isinstance(children, dict):
            continue
        per = {}
        for label, child in children.items():
            try:
                entry = {
                    "count": int(child["count"]),
                    "sum": round(float(child["sum"]), 3),
                }
                for q in quantiles:
                    entry[f"p{int(q * 100)}"] = round(
                        snapshot_quantile(child, q), 3
                    )
                mixed = child.get("mixed_bounds")
                if mixed:
                    # Sum/count-only children were folded in: the
                    # percentiles cover only the bucket-compatible
                    # population — degrade loudly.
                    entry["mixed_bounds"] = int(mixed)
                per[label or ""] = entry
            except (KeyError, TypeError, ValueError):
                continue
        if per:
            out[name] = per
    return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (engines, transports and HTTP
    frontends all publish here; tests wanting isolation construct their
    own :class:`MetricsRegistry`)."""
    return _REGISTRY
