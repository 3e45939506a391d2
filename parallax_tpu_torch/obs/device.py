"""Device attribution plane: where the chip's HBM and time actually go.

The obs layer up to here answers "which request is slow and which node
is sick" (latency histograms, goodput buckets, health states) but not
"what is the HBM spent on" or "which program burned the device" — the
questions every capacity decision starts from. ROADMAP item 3 calls HBM
the admission ceiling; vLLM's startup memory profiler and DistServe's
goodput framing both show that byte- and time-ATTRIBUTION, not just
latency percentiles, is what makes those decisions debuggable. Three
always-on, always-cheap pillars:

- :class:`HbmLedger` — every device allocation class (model weights per
  dtype, KV page pool, host-tier staging buffers, speculative/draft
  buffers, grammar device tables, sampling workspace, XLA compile
  workspace headroom) registers its footprint; the ledger exports
  ``parallax_hbm_bytes{class=…}`` gauges, a high-watermark and derived
  headroom, and asserts the invariant ``sum(classes) + untracked ==
  device_total`` loudly: an untracked residual above threshold emits a
  flight event instead of silently lying.
- :class:`CompileObservatory` — replaces the bare process-wide compile
  counter with per-program-family accounting: compiles, cumulative
  compile ms, live executable count, and a *cause* label derived from
  the jit-key diff against the family's previous key (first /
  new_shape_bucket / k_change / sampling_feature / spec_toggle). A
  recompile-storm detector (N same-family compiles inside a sliding
  window) emits flight events and feeds the ``compile`` watchdog probe.
- :class:`DeviceTimeAttributor` — tags each dispatched program (prefill
  chunk, fused decode window, spec verify, swap gather/scatter) with
  its family so ``parallax_device_time_seconds_total{program=…}``
  splits the goodput ledger's one ``serve`` bucket.

Cost model (the zero-cost-on gate, same bar as trace sampling): the
steady-state decode path pays one dict add per HOST VISIT for time
attribution and nothing for the ledger or observatory — ledger classes
update only when allocations change, compile accounting only when a
compile happens, gauges refresh on the collector/heartbeat thread.

All three surfaces ride worker heartbeats (``payload()``), merge
cluster-wide (:func:`merge_device`, with counted skips for nodes
missing the payload — ``parallax_device_merge_skipped_total`` mirrors
the histogram-merge semantics), and serve locally via
``GET /debug/device`` and bench ``detail.device``.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.obs import names as mnames

logger = get_logger(__name__)

# Canonical allocation classes. The set is OPEN (a node may register
# classes this build has never heard of — the cluster merge keeps
# them), but the canonical spellings keep dashboards stable.
HBM_CLASSES = (
    "weights",            # model parameters; per-dtype via weights_<dtype>
    "kv_pages",           # device KV page pool
    "host_staging",       # pinned host-tier swap staging buffers
    "spec_draft",         # speculative/draft-model buffers
    "grammar_tables",     # dense device grammar tables
    "sampling_workspace", # sampling workspace (logits scratch, rng)
    "compile_headroom",   # XLA compile workspace reservation
)

# Canonical program families for device-time attribution. Open set,
# same convention as HBM_CLASSES.
PROGRAM_FAMILIES = (
    "prefill",       # chunked prefill step
    "sp_prefill",    # sequence-parallel prefill
    "decode",        # plain one-step decode
    "decode_window", # fused K-step decode window
    "spec_window",   # speculative propose+verify window
    "spec_verify",   # standalone speculative verify
    "swap_gather",   # KV gather device->host (preemption park)
    "swap_scatter",  # KV scatter host->device (resume)
)

# Recompile causes, most-specific first: the observatory labels each
# compile with exactly one (docs/kernels.md has the table).
COMPILE_CAUSES = (
    "first",            # family's first key — warmup, expected
    "new_shape_bucket", # batch/seq bucket lattice grew
    "k_change",         # decode lookahead K changed
    "sampling_feature", # sampling-feature component toggled
    "spec_toggle",      # speculative decoding flipped on/off
    "other",            # keys differ in an unclassified field
    "unknown",          # compile event with no noted program (leak!)
)

# Jit-key fields mapped to a cause when they differ from the family's
# previous key. Checked in order; first hit wins.
_CAUSE_FIELDS = (
    ("new_shape_bucket", ("batch", "batch_bucket", "seq", "seq_bucket",
                          "tokens", "pages", "chunk", "rows")),
    ("k_change", ("k", "lookahead")),
    ("sampling_feature", ("feats", "features", "sampled", "fused_sample",
                          "sampling")),
    ("spec_toggle", ("spec", "speculative", "draft")),
)


def _flight_event(kind: str, **fields) -> None:
    """Emit a flight-recorder event; never raises (obs must not take
    down the path it observes)."""
    try:
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(kind, **fields)
    except Exception:  # pragma: no cover - defensive
        pass


# Device index -> the card's total memory, read once per process.
_CAPACITY: dict[int, int] = {}


def torch_memory_stats(device) -> dict:
    """The JAX ``memory_stats()`` keys for a ``torch.device``: on a CUDA
    device ``bytes_in_use`` is the caching allocator's allocated bytes
    (``torch.cuda.memory_allocated``, graph pools included) and
    ``bytes_limit`` the card's total memory, read once from
    ``torch.cuda.get_device_properties``; empty on any other device."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    cap = _CAPACITY.get(idx)
    if cap is None:
        cap = _CAPACITY[idx] = int(
            torch.cuda.get_device_properties(idx).total_memory)
    return {"bytes_in_use": int(torch.cuda.memory_allocated(idx)),
            "bytes_limit": cap}


class HbmLedger:
    """Push-style device-memory accounting by allocation class.

    Allocation sites call :meth:`set_class` when their footprint
    changes (allocate / grow / free) — the ledger never polls them.
    ``device_total`` comes from the accelerator's ``memory_stats()``
    when available (``bytes_in_use`` / ``bytes_limit``; on a CUDA device
    the caching allocator's, :func:`torch_memory_stats`); on a CPU
    device, which reports no per-device stats, the tracked
    sum stands in for occupancy and capacity comes from
    :meth:`set_capacity` (the CPU smoke sets a synthetic capacity so
    the invariant stays assertable).
    """

    def __init__(self, registry=None, clock=time.monotonic,
                 untracked_threshold: float = 0.10):
        self._clock = clock
        self._lock = make_lock("obs.device.hbm")
        # (owner, class) -> bytes: owners keep multi-engine processes
        # (in-process pipelines) from clobbering each other's classes;
        # exports aggregate by class across owners.
        self._classes: dict[tuple[str, str], int] = {}
        self._capacity = 0
        self._capacity_source = "none"
        self._high_watermark = 0
        self._untracked = 0
        self._untracked_threshold = float(untracked_threshold)
        self._untracked_flagged = False
        self._registry = registry
        self._g_bytes = None
        self._g_headroom = None
        self._g_watermark = None

    # -- registration -----------------------------------------------------

    def bind_registry(self, registry=None) -> None:
        """Idempotently register this ledger's gauges (engine
        ``_init_obs`` / bench; tests may pass a private registry)."""
        if self._g_bytes is not None and registry is None:
            return
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._registry = registry
        self._g_bytes = registry.gauge(
            mnames.HBM_BYTES,
            mnames.help_text(mnames.HBM_BYTES),
            labelnames=("class",),
        )
        self._g_headroom = registry.gauge(
            mnames.HBM_HEADROOM_BYTES,
            mnames.help_text(mnames.HBM_HEADROOM_BYTES),
        )
        self._g_watermark = registry.gauge(
            mnames.HBM_HIGH_WATERMARK_BYTES,
            mnames.help_text(mnames.HBM_HIGH_WATERMARK_BYTES),
        )
        # Weakref-held collector: the plane singleton keeps us alive.
        registry.register_collector(self._collect)

    def _collect(self) -> None:
        snap = self.snapshot()
        g = self._g_bytes
        if g is None:
            return
        for cls, nbytes in snap["classes"].items():
            g.labels(**{"class": cls}).set(nbytes)
        g.labels(**{"class": "untracked"}).set(snap["untracked_bytes"])
        self._g_headroom.set(snap["headroom_bytes"])
        self._g_watermark.set(snap["high_watermark_bytes"])

    # -- recording --------------------------------------------------------

    def set_class(self, name: str, nbytes: int, owner: str = "") -> None:
        """Set one allocation class's current footprint (idempotent;
        call again whenever it changes; 0 keeps the series present).
        ``owner`` disambiguates multiple engines in one process — the
        exported class still aggregates across owners."""
        nbytes = max(0, int(nbytes))
        with self._lock:
            self._classes[(str(owner), str(name))] = nbytes
        self._refresh()

    def add_class(self, name: str, delta: int, owner: str = "") -> None:
        """Adjust one class by a delta (grow/shrink without re-summing
        at the call site)."""
        key = (str(owner), str(name))
        with self._lock:
            cur = self._classes.get(key, 0)
            self._classes[key] = max(0, cur + int(delta))
        self._refresh()

    def set_capacity(self, nbytes: int, source: str = "configured") -> None:
        """Set device capacity explicitly (CPU smoke / tests); a
        device-reported limit (:meth:`refresh_from_device`) wins."""
        with self._lock:
            if self._capacity_source != "device":
                self._capacity = max(0, int(nbytes))
                self._capacity_source = source
        self._refresh()

    def refresh_from_device(self, device=None) -> bool:
        """Pull ``bytes_in_use`` / ``bytes_limit`` from the accelerator.
        ``device`` is a ``torch.device`` (see :func:`torch_memory_stats`)
        or any object whose ``memory_stats()`` returns those keys. Returns
        False when it reports none (a CPU device, or None) — the tracked
        sum then stands in for occupancy. On a CUDA device this makes CUDA
        calls: only the thread that steps the device may make it (a graph
        capture in global mode fails on a CUDA call from another thread)."""
        try:
            if device is None:
                return False
            if hasattr(device, "memory_stats"):
                stats = device.memory_stats() or {}
            else:
                stats = torch_memory_stats(device)
        except Exception:  # pragma: no cover - backend specific
            return False
        limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
        in_use = stats.get("bytes_in_use")
        if not limit and not in_use:
            return False
        with self._lock:
            if limit:
                self._capacity = int(limit)
                self._capacity_source = "device"
            if in_use is not None:
                tracked = sum(self._classes.values())
                self._untracked = max(0, int(in_use) - tracked)
        self._refresh()
        return True

    def _refresh(self) -> None:
        """Recompute the watermark and check the untracked-residual
        invariant; emits ONE flight event per excursion (re-arms when
        the residual drops back under threshold)."""
        with self._lock:
            tracked = sum(self._classes.values())
            total = tracked + self._untracked
            if total > self._high_watermark:
                self._high_watermark = total
            cap = self._capacity
            untracked = self._untracked
            flagged = self._untracked_flagged
            over = bool(
                cap > 0 and untracked > self._untracked_threshold * cap
            )
            self._untracked_flagged = over
        if over and not flagged:
            _flight_event(
                "hbm_untracked",
                untracked_bytes=untracked,
                tracked_bytes=tracked,
                capacity_bytes=cap,
                threshold=self._untracked_threshold,
            )
            logger.warning(
                "HBM ledger untracked residual %d bytes exceeds %.0f%% "
                "of capacity %d — an allocation class is unregistered",
                untracked, self._untracked_threshold * 100, cap,
            )

    # -- derived ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict state; ``invariant_ok`` is the ledger contract
        ``tracked + untracked == device_total`` with the residual under
        threshold."""
        with self._lock:
            classes: dict[str, int] = {}
            for (_owner, name), nbytes in self._classes.items():
                classes[name] = classes.get(name, 0) + nbytes
            tracked = sum(classes.values())
            untracked = self._untracked
            cap = self._capacity
            total = tracked + untracked
            return {
                "classes": classes,
                "tracked_bytes": tracked,
                "untracked_bytes": untracked,
                "device_total_bytes": total,
                "capacity_bytes": cap,
                "capacity_source": self._capacity_source,
                "headroom_bytes": max(0, cap - total) if cap else 0,
                "high_watermark_bytes": self._high_watermark,
                "untracked_threshold": self._untracked_threshold,
                "invariant_ok": bool(
                    tracked + untracked == total
                    and (not cap
                         or untracked <= self._untracked_threshold * cap)
                ),
            }

    def payload(self) -> dict:
        return self.snapshot()


class _StormWindow:
    """One owner's storm window for one program family: the times of its
    counted captures and the keys it has captured."""

    __slots__ = ("times", "seen", "active")

    def __init__(self):
        self.times: collections.deque = collections.deque(maxlen=256)
        self.seen: set = set()
        self.active = False

    def expire(self, now: float, window_s: float) -> int:
        while self.times and now - self.times[0] > window_s:
            self.times.popleft()
        return len(self.times)


class _NoOwner:
    """The owner of compiles reported without one (library builds)."""


_NO_OWNER = _NoOwner()


class CompileObservatory:
    """Per-program-family compile accounting with cause labels. In
    parallax_tpu_torch a "compile" is a CUDA-graph capture of a decode
    window's step (``runtime/step_graph.py``) or the first-use build of
    the kernel / native library (``ops/cuda_kernels.py``,
    ``native/__init__.py``), each reported through :meth:`on_compile`
    right after the note that names it.

    Jit sites call :meth:`note_program` with a structured key dict the
    first time they see that key (i.e. at jit-cache-miss build time);
    the ``backend_compile`` monitoring event that fires during the
    subsequent invocation is matched LIFO against recent notes and
    attributed to that (family, cause). A compile with no live note —
    a program the engine never declared — lands in ``other`` with
    ``cause="unknown"``, and the CI smoke asserts that stays zero in
    steady-state decode.
    """

    # A note not consumed within this window is stale (persistent-cache
    # HIT: the build never fired a backend compile).
    NOTE_TTL_S = 120.0

    def __init__(self, registry=None, clock=time.monotonic,
                 storm_window_s: float = 30.0, storm_threshold: int = 5):
        self._clock = clock
        self._lock = make_lock("obs.device.compile")
        self._prev_key: dict[str, dict] = {}
        self._pending = collections.deque(maxlen=64)
        self.compiles: dict[tuple, int] = {}
        self.compile_ms: dict[str, float] = {}
        self._live_execs: dict[str, int] = {}
        # Storm windows per owner and family: one process may hold several
        # engines (two workers, a target and its draft), each capturing
        # the same keys; a leak is new keys within ONE engine. Owners are
        # held weakly, so a freed engine's windows go with it.
        self._windows: weakref.WeakKeyDictionary = (
            weakref.WeakKeyDictionary())
        self._window_s = float(storm_window_s)
        self._threshold = int(storm_threshold)
        self.storms: dict[str, int] = {}
        self._probe_progress = 0
        self._registry = registry
        self._c_compiles = None
        self._c_compile_ms = None
        self._g_live = None
        self._c_storms = None

    def bind_registry(self, registry=None) -> None:
        if self._c_compiles is not None and registry is None:
            return
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._registry = registry
        self._c_compiles = registry.counter(
            mnames.XLA_COMPILES_TOTAL,
            mnames.help_text(mnames.XLA_COMPILES_TOTAL),
            labelnames=("program", "cause"),
        )
        self._c_compile_ms = registry.counter(
            mnames.XLA_COMPILE_MS_TOTAL,
            mnames.help_text(mnames.XLA_COMPILE_MS_TOTAL),
            labelnames=("program",),
        )
        self._g_live = registry.gauge(
            mnames.XLA_LIVE_EXECUTABLES,
            mnames.help_text(mnames.XLA_LIVE_EXECUTABLES),
            labelnames=("program",),
        )
        self._c_storms = registry.counter(
            mnames.XLA_COMPILE_STORMS_TOTAL,
            mnames.help_text(mnames.XLA_COMPILE_STORMS_TOTAL),
            labelnames=("program",),
        )

    # -- program declarations --------------------------------------------

    @staticmethod
    def _diff_cause(prev: dict | None, key: dict) -> str:
        if prev is None:
            return "first"
        changed = {
            f for f in set(prev) | set(key) if prev.get(f) != key.get(f)
        }
        if not changed:
            return "other"
        for cause, fields in _CAUSE_FIELDS:
            if changed & set(fields):
                return cause
        return "other"

    def note_program(self, family: str, key: dict | None = None) -> str:
        """Declare that ``family`` is about to build/invoke a jit with
        ``key`` (a structured dict of the jit-cache key's components).
        Returns the derived cause and stages a pending attribution for
        the next ``backend_compile`` event. Call at jit-cache-miss
        build time only — the steady-state path never reaches here."""
        key = dict(key or {})
        now = self._clock()
        with self._lock:
            cause = self._diff_cause(self._prev_key.get(family), key)
            self._prev_key[family] = key
            self._pending.append((family, cause, now))
        return cause

    def set_live_executables(self, family: str, count: int) -> None:
        """Current live executable count for one family (the engine's
        jit-cache size); refreshed on build, O(1)."""
        count = max(0, int(count))
        with self._lock:
            self._live_execs[family] = count
        g = self._g_live
        if g is not None:
            g.labels(program=family).set(count)

    # -- compile events ---------------------------------------------------

    def on_compile(self, duration_s: float, owner=None,
                   key=None) -> None:
        """Attribute one compile (a graph capture or a library build,
        reported by the code that ran it). LIFO match: the compile
        follows the most recently noted program; stale notes expire.

        ``owner`` (the engine that captured: any object that takes a weak
        reference, held weakly) and ``key`` (what it captured) scope the
        storm rule: a capture counts against its own engine's window, and
        a key that engine has captured before does not count again. Two
        engines capturing the same keys raise no storm; one engine
        capturing ``storm_threshold`` new keys inside the window does."""
        now = self._clock()
        family, cause = "other", "unknown"
        with self._lock:
            while self._pending:
                fam, c, t = self._pending.pop()
                if now - t <= self.NOTE_TTL_S:
                    family, cause = fam, c
                    break
            k = (family, cause)
            self.compiles[k] = self.compiles.get(k, 0) + 1
            self.compile_ms[family] = (
                self.compile_ms.get(family, 0.0) + duration_s * 1000.0
            )
            new_storm = False
            if cause != "unknown":
                # Unmatched compiles stay out of the storm detector:
                # startup runs dozens of eager op-by-op compiles (rope
                # tables, rng seeding) that are normal, not a leaking
                # shape lattice. Their drift is still visible as
                # unexplained_compiles climbing.
                win = self._windows.setdefault(
                    _NO_OWNER if owner is None else owner, {}
                ).setdefault(family, _StormWindow())
                if key is None or key not in win.seen:
                    if key is not None:
                        win.seen.add(key)
                    win.times.append(now)
                in_window = win.expire(now, self._window_s)
                storm = in_window >= self._threshold
                new_storm = storm and not win.active
                win.active = storm
                if new_storm:
                    self.storms[family] = self.storms.get(family, 0) + 1
        c = self._c_compiles
        if c is not None:
            c.labels(program=family, cause=cause).inc()
            self._c_compile_ms.labels(program=family).inc(
                duration_s * 1000.0
            )
        if new_storm:
            if self._c_storms is not None:
                self._c_storms.labels(program=family).inc()
            _flight_event(
                "recompile_storm",
                program=family,
                compiles_in_window=in_window,
                window_s=self._window_s,
            )
            logger.warning(
                "recompile storm: %d %r compiles inside %.0fs — the "
                "shape lattice is leaking",
                in_window, family, self._window_s,
            )

    # -- watchdog probe ---------------------------------------------------

    def probe(self):
        """``compile`` watchdog probe: pending = compiles inside the
        sliding window (recent churn), progress advances only while no
        family is storming — an active storm freezes progress with
        pending work, driving ok -> degraded -> stalled."""
        now = self._clock()
        with self._lock:
            pending = 0
            storming = []
            for families in list(self._windows.values()):
                for family, win in families.items():
                    n = win.expire(now, self._window_s)
                    pending += n
                    win.active = n >= self._threshold
                    if win.active and family not in storming:
                        storming.append(family)
            if not storming:
                self._probe_progress += 1
            progress = self._probe_progress
        detail = (
            "storming: " + ",".join(sorted(storming)) if storming else ""
        )
        return float(pending), float(progress), detail

    # -- derived ----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            by_program: dict[str, dict] = {}
            for (fam, cause), n in self.compiles.items():
                rec = by_program.setdefault(
                    fam, {"compiles": 0, "by_cause": {}}
                )
                rec["compiles"] += n
                rec["by_cause"][cause] = rec["by_cause"].get(cause, 0) + n
            for fam, ms in self.compile_ms.items():
                by_program.setdefault(
                    fam, {"compiles": 0, "by_cause": {}}
                )["compile_ms"] = round(ms, 3)
            for fam, n in self._live_execs.items():
                by_program.setdefault(
                    fam, {"compiles": 0, "by_cause": {}}
                )["live_executables"] = n
            total = sum(self.compiles.values())
            unexplained = sum(
                n for (fam, cause), n in self.compiles.items()
                if cause == "unknown"
            )
            return {
                "programs": by_program,
                "compiles_total": total,
                "unexplained_compiles": unexplained,
                "compile_ms_total": round(
                    sum(self.compile_ms.values()), 3
                ),
                "storms": dict(self.storms),
                "storms_total": sum(self.storms.values()),
            }

    def payload(self) -> dict:
        return self.snapshot()


class DeviceTimeAttributor:
    """Per-program device/host-visit time: one dict add per host visit.

    Splits the goodput ledger's single ``serve`` bucket by program
    family — the engine calls :meth:`add` at resolve with the family it
    dispatched (the same place it feeds ``goodput.add_time("serve")``),
    so ``sum(programs) ≈ goodput serve seconds`` by construction.
    """

    def __init__(self, registry=None):
        self._lock = make_lock("obs.device.time")
        self.seconds: dict[str, float] = {}
        self._registry = registry
        self._c_seconds = None
        self._children: dict[str, object] = {}

    def bind_registry(self, registry=None) -> None:
        if self._c_seconds is not None and registry is None:
            return
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._registry = registry
        self._c_seconds = registry.counter(
            mnames.DEVICE_TIME_SECONDS_TOTAL,
            mnames.help_text(mnames.DEVICE_TIME_SECONDS_TOTAL),
            labelnames=("program",),
        )
        self._children = {}

    def add(self, program: str, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._lock:
            self.seconds[program] = (
                self.seconds.get(program, 0.0) + float(seconds)
            )
        c = self._c_seconds
        if c is not None:
            child = self._children.get(program)
            if child is None:
                child = c.labels(program=program)
                self._children[program] = child
            child.inc(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            secs = {k: round(v, 6) for k, v in self.seconds.items()}
        total = sum(secs.values())
        share = (
            {k: round(v / total, 4) for k, v in secs.items()}
            if total > 0 else {}
        )
        return {
            "seconds": secs,
            "seconds_total": round(total, 6),
            "share": share,
        }

    def payload(self) -> dict:
        return self.snapshot()


class DevicePlane:
    """Facade bundling the three pillars; one per process (the module
    singleton), with private instances in tests."""

    def __init__(self, registry=None, clock=time.monotonic):
        self.hbm = HbmLedger(registry=registry, clock=clock)
        self.compile = CompileObservatory(registry=registry, clock=clock)
        self.time = DeviceTimeAttributor(registry=registry)
        self._bound = False

    def bind_registry(self, registry=None) -> None:
        """Idempotent; called from the engine's ``_init_obs``, bench,
        and the serve entrypoints."""
        if self._bound and registry is None:
            return
        self.hbm.bind_registry(registry)
        self.compile.bind_registry(registry)
        self.time.bind_registry(registry)
        self._bound = True

    def payload(self) -> dict:
        """Heartbeat / ``/cluster/status`` / ``/debug/device`` / bench
        ``detail.device`` payload for this node."""
        return {
            "hbm": self.hbm.payload(),
            "compile": self.compile.payload(),
            "programs": self.time.payload(),
        }


def merge_device(payloads: list, registry=None) -> dict | None:
    """Cluster merge of per-node :meth:`DevicePlane.payload` dicts.

    Disjoint HBM classes and program families union without dropping
    series (a heterogeneous swarm where one node runs spec decoding and
    another doesn't must show both). A node whose heartbeat carries no
    ``device`` section (old build) is skipped LOUDLY: counted into
    ``parallax_device_merge_skipped_total`` and reported in the result,
    mirroring the histogram-merge skip semantics."""
    classes: dict[str, int] = {}
    capacity = 0
    tracked = 0
    untracked = 0
    watermark = 0
    invariant_ok = True
    compiles: dict[str, dict] = {}
    compiles_total = 0
    unexplained = 0
    compile_ms = 0.0
    storms_total = 0
    programs: dict[str, float] = {}
    nodes = 0
    skipped = 0
    for p in payloads or ():
        if not isinstance(p, dict) or not isinstance(p.get("hbm"), dict):
            skipped += 1
            continue
        nodes += 1
        hbm = p["hbm"]
        for cls, nbytes in (hbm.get("classes") or {}).items():
            try:
                classes[cls] = classes.get(cls, 0) + int(nbytes)
            except (TypeError, ValueError):
                continue
        try:
            capacity += int(hbm.get("capacity_bytes") or 0)
            tracked += int(hbm.get("tracked_bytes") or 0)
            untracked += int(hbm.get("untracked_bytes") or 0)
            watermark += int(hbm.get("high_watermark_bytes") or 0)
        except (TypeError, ValueError):
            pass
        if hbm.get("invariant_ok") is False:
            invariant_ok = False
        comp = p.get("compile") or {}
        for fam, rec in (comp.get("programs") or {}).items():
            if not isinstance(rec, dict):
                continue
            out = compiles.setdefault(
                fam, {"compiles": 0, "by_cause": {}, "compile_ms": 0.0}
            )
            try:
                out["compiles"] += int(rec.get("compiles") or 0)
                out["compile_ms"] = round(
                    out["compile_ms"] + float(rec.get("compile_ms") or 0.0),
                    3,
                )
            except (TypeError, ValueError):
                continue
            for cause, n in (rec.get("by_cause") or {}).items():
                try:
                    out["by_cause"][cause] = (
                        out["by_cause"].get(cause, 0) + int(n)
                    )
                except (TypeError, ValueError):
                    continue
        try:
            compiles_total += int(comp.get("compiles_total") or 0)
            unexplained += int(comp.get("unexplained_compiles") or 0)
            compile_ms += float(comp.get("compile_ms_total") or 0.0)
            storms_total += int(comp.get("storms_total") or 0)
        except (TypeError, ValueError):
            pass
        for fam, secs in ((p.get("programs") or {}).get("seconds")
                          or {}).items():
            try:
                programs[fam] = programs.get(fam, 0.0) + float(secs)
            except (TypeError, ValueError):
                continue
    if skipped:
        try:
            if registry is None:
                from parallax_tpu_torch.obs.registry import get_registry

                registry = get_registry()
            registry.counter(
                mnames.DEVICE_MERGE_SKIPPED_TOTAL,
                mnames.help_text(mnames.DEVICE_MERGE_SKIPPED_TOTAL),
            ).inc(skipped)
        except Exception:  # pragma: no cover - metrics never break merge
            pass
    if not nodes:
        return None
    secs_total = sum(programs.values())
    return {
        "nodes": nodes,
        "nodes_skipped": skipped,
        "hbm": {
            "classes": classes,
            "tracked_bytes": tracked,
            "untracked_bytes": untracked,
            "capacity_bytes": capacity,
            "headroom_bytes": max(0, capacity - tracked - untracked),
            "high_watermark_bytes": watermark,
            "invariant_ok": invariant_ok,
        },
        "compile": {
            "programs": compiles,
            "compiles_total": compiles_total,
            "unexplained_compiles": unexplained,
            "compile_ms_total": round(compile_ms, 3),
            "storms_total": storms_total,
        },
        "programs": {
            "seconds": {k: round(v, 6) for k, v in programs.items()},
            "seconds_total": round(secs_total, 6),
            "share": (
                {k: round(v / secs_total, 4) for k, v in programs.items()}
                if secs_total > 0 else {}
            ),
        },
    }


_PLANE = DevicePlane()


def get_device_plane() -> DevicePlane:
    """The process-wide device attribution plane (engine, compile-cache
    listener and swap paths all account here; tests wanting isolation
    construct their own :class:`DevicePlane`)."""
    return _PLANE


def note_build(family: str, key: dict, seconds: float) -> None:
    """A library build (nvcc, g++) finished: note its program and
    attribute its seconds to the compile observatory in one go. Never
    raises (obs must not take down the path it observes)."""
    try:
        from parallax_tpu_torch.obs.goodput import get_goodput

        comp = _PLANE.compile
        comp.note_program(family, key)
        comp.on_compile(seconds)
        get_goodput().add_time("compile", seconds)
    except Exception:  # pragma: no cover - defensive
        pass
