"""Stall watchdog: progress-based per-component health state machine.

The heartbeat sweep (scheduling/scheduler.py) detects DEAD nodes; this
detects SICK ones — a wedged step loop, a sender worker stuck behind a
hung peer, a migration park that never ships, an admission queue nobody
drains. A node in any of those states still answers heartbeats, so
binary alive/dead telemetry reports it healthy while it serves nothing.

Model: each *component* registers a probe returning ``(pending,
progress, detail)`` — how much work is waiting, a monotonic counter
that moves whenever the component does work, and a human hint. The
monitor evaluates every ``poll_interval_s``: a component with pending
work whose progress counter has not moved transitions

    ok -> degraded (after ``degraded_after_s``)
       -> stalled  (after ``stalled_after_s``)

with a cause string; any progress (or an empty backlog) snaps it back
to ok. Transitions emit flight-recorder events (so they land in the
cluster timeline) and bump ``parallax_watchdog_transitions_total``;
current states export as the ``parallax_health_state`` gauge
(0 = ok, 1 = degraded, 2 = stalled) and ride worker heartbeats so the
scheduler surfaces per-node health in ``/cluster/status`` and its
sweep/probation logic can consume it.

Cost model: when no watchdog is constructed (the default) nothing here
runs and the serving path is untouched. When one runs, probes execute
on the monitor thread at poll cadence — the step/sender hot paths pay
at most one integer increment per loop iteration.
"""

from __future__ import annotations

import threading
import time

from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.obs import names as mnames

logger = get_logger(__name__)

OK = "ok"
DEGRADED = "degraded"
STALLED = "stalled"

_LEVEL = {OK: 0, DEGRADED: 1, STALLED: 2}


class StallWatchdog:
    """Per-node monitor thread over progress probes (thread-safe)."""

    def __init__(
        self,
        node_id: str = "",
        degraded_after_s: float = 5.0,
        stalled_after_s: float = 15.0,
        poll_interval_s: float = 1.0,
        flight=None,
        registry=None,
        clock=time.monotonic,
    ):
        if stalled_after_s < degraded_after_s:
            raise ValueError("stalled_after_s must be >= degraded_after_s")
        self.node_id = node_id
        self.degraded_after_s = degraded_after_s
        self.stalled_after_s = stalled_after_s
        self.poll_interval_s = poll_interval_s
        self._clock = clock
        self._flight = flight
        self._lock = make_lock("obs.watchdog")
        # component -> probe() -> (pending: float, progress: float,
        # detail: str)
        self._probes: dict = {}
        # component -> {state, cause, last_progress, last_change,
        # pending}
        self._state: dict[str, dict] = {}
        self._beats: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._c_transitions = registry.counter(
            mnames.WATCHDOG_TRANSITIONS_TOTAL,
            "Health state-machine transitions per component",
            labelnames=("component", "to"),
        )
        self._g_state = registry.gauge(
            mnames.HEALTH_STATE,
            "Current component health (0 = ok, 1 = degraded, 2 = stalled)",
            labelnames=("component",),
        )

    # -- registration -----------------------------------------------------

    def register(self, component: str, probe) -> None:
        """``probe() -> (pending, progress, detail)``; exceptions in the
        probe skip the component for that poll (observability must not
        take down the path it observes)."""
        with self._lock:
            self._probes[component] = probe
            self._state.setdefault(component, {
                "state": OK, "cause": None, "last_progress": None,
                "last_change": self._clock(), "pending": 0.0,
            })
        self._g_state.labels(component=component).set(0)

    def register_beat(self, component: str, pending_fn) -> None:
        """Beat-driven component: the hot path calls :meth:`beat` (one
        dict increment), ``pending_fn()`` reports the backlog."""
        self._beats.setdefault(component, 0)

        def probe():
            return float(pending_fn()), float(self._beats[component]), ""

        self.register(component, probe)

    def beat(self, component: str) -> None:
        """Record forward progress for a beat-driven component."""
        self._beats[component] = self._beats.get(component, 0) + 1

    # -- evaluation -------------------------------------------------------

    def poll_once(self, now: float | None = None) -> list[dict]:
        """Evaluate every component once; returns the transitions that
        fired (also emitted as flight events). Exposed for deterministic
        tests; the monitor thread calls it at poll cadence."""
        if now is None:
            now = self._clock()
        with self._lock:
            probes = list(self._probes.items())
        transitions = []
        for component, probe in probes:
            try:
                pending, progress, detail = probe()
            except Exception:  # pragma: no cover - probe must not kill us
                continue
            st = self._state[component]
            if (
                st["last_progress"] is None
                or progress != st["last_progress"]
                or pending <= 0
                # Work just arrived after an idle stretch: the
                # no-progress clock starts NOW, not at the last idle
                # poll — otherwise the first poll after arrival could
                # report a false instant stall.
                or st["pending"] <= 0
            ):
                st["last_progress"] = progress
                st["last_change"] = now
                new, cause = OK, None
            else:
                age = now - st["last_change"]
                if age >= self.stalled_after_s:
                    new = STALLED
                elif age >= self.degraded_after_s:
                    new = DEGRADED
                else:
                    new = OK
                cause = (
                    f"no progress for {age:.1f}s with "
                    f"{pending:g} pending"
                    + (f" ({detail})" if detail else "")
                    if new != OK else None
                )
            st["pending"] = pending
            if new != st["state"]:
                transitions.append({
                    "component": component, "from": st["state"],
                    "to": new, "cause": cause,
                })
                st["state"], st["cause"] = new, cause
                self._g_state.labels(component=component).set(_LEVEL[new])
                self._c_transitions.labels(
                    component=component, to=new
                ).inc()
                self._emit(component, st, transitions[-1])
            else:
                st["cause"] = cause
        return transitions

    def _emit(self, component: str, st: dict, tr: dict) -> None:
        flight = self._flight
        if flight is None:
            from parallax_tpu_torch.obs.flight import get_flight

            flight = get_flight()
        flight.event(
            "health", node=self.node_id, component=component,
            state=tr["to"], prev=tr["from"], cause=tr["cause"],
            pending=st["pending"],
        )
        log = (
            logger.error if tr["to"] == STALLED
            else logger.warning if tr["to"] == DEGRADED
            else logger.info
        )
        log("%s: health %s: %s -> %s (%s)", self.node_id, component,
            tr["from"], tr["to"], tr["cause"] or "recovered")

    # -- export -----------------------------------------------------------

    def component_states(self) -> dict:
        with self._lock:
            return {
                c: {
                    "state": st["state"],
                    "cause": st["cause"],
                    "pending": st["pending"],
                }
                for c, st in self._state.items()
            }

    def summary(self) -> dict:
        """Heartbeat / ``/healthz`` payload: overall = worst component."""
        comps = self.component_states()
        overall = OK
        causes = []
        for c, st in comps.items():
            if _LEVEL[st["state"]] > _LEVEL[overall]:
                overall = st["state"]
            if st["state"] != OK and st["cause"]:
                causes.append(f"{c}: {st['cause']}")
        return {
            "status": overall,
            "components": comps,
            "causes": causes,
        }

    def is_healthy(self) -> bool:
        return self.summary()["status"] != STALLED

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="stall-watchdog"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # pragma: no cover - monitor must survive
                logger.exception("watchdog poll failed")


def worst_status(statuses) -> str:
    """The worst of a set of health status strings (unknown -> ok)."""
    worst = OK
    for s in statuses:
        if _LEVEL.get(s, 0) > _LEVEL[worst]:
            worst = s
    return worst
