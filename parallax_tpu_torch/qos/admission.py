"""Deadline-aware admission control: shed, park, release with hysteresis
(a copy of ``parallax_tpu/qos/admission.py``).

The acting half of the SLO plane. Two cooperating pieces:

- :class:`AdmissionController`: the shed/release state machine. It
  watches the interactive class's TTFT budget two ways: a **burn rate**
  over recent interactive finishes (windowed attainment against the
  class budget, ``(1 - attainment) / (1 - target)``) and a **queue
  pressure** trigger (a protected-class request waiting in admission
  with its deadline slack nearly gone while sheddable work holds
  capacity). Entering shed is immediate; leaving requires the burn back
  under the release threshold, no queue pressure, and a minimum hold
  time: the hysteresis band that keeps a borderline load from flapping
  park/resume swaps.

- :class:`QoSPolicy`: the per-stage enforcement hooks the local
  scheduler (``runtime/scheduler.py``) calls. It owns the EDF ordering
  key (deadline slack with a starvation guard), the shed gate for new
  admissions, the parkable test for running batch decodes (enforcement
  rides the host tier's PREEMPTED path: parked work resumes with the
  same bits, it is never aborted), and the ``parallax_qos_*`` series.

Every hook is reached only when the scheduler was built with a policy;
``--qos off`` (the default) wires ``None``.
"""

from __future__ import annotations

import time
from collections import deque

from parallax_tpu_torch.qos.classes import QoSConfig, RequestClass
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.obs import names as mnames

logger = get_logger(__name__)


class AdmissionController:
    """Hysteresis shed/release over the protected class's TTFT budget.

    Thread-safe: observed from engine finish paths, ticked from the
    scheduler's batch-formation path (or the global scheduler's event
    loop for the cluster-scope instance).
    """

    def __init__(self, config: QoSConfig, scope: str = "local",
                 registry=None, clock=time.monotonic):
        self.config = config
        self.scope = scope
        self._clock = clock
        self._lock = make_lock("qos.admission")
        self.protected = config.class_named(config.default_class)
        for c in config.classes:
            if not c.sheddable:
                self.protected = c
                break
        self.shedding = False
        # Remote override: the global scheduler's cluster-scope verdict
        # relayed through heartbeat replies — OR'd with the local state
        # so either signal protects the interactive budget.
        self.remote_shed = False
        self._shed_since: float | None = None
        self._pressure = False
        # Windowed (t, within_budget) samples of protected-class
        # finishes (local scope) ...
        self._finishes: deque[tuple[float, bool]] = deque()
        # ... or cumulative (t, under, total) histogram readings
        # (cluster scope, from merged heartbeat snapshots).
        self._cumulative: deque[tuple[float, float, int]] = deque()
        self.transitions = {"sheds": 0, "releases": 0}
        self.last_burn = 0.0
        # Protected-class finishes inside the last evaluated window —
        # burn-triggered sheds require config.min_burn_samples of them
        # (a 1-sample burn estimate is pure variance; a first-compile
        # TTFT must not hold batch work for a whole window).
        self.last_samples = 0
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._g_shedding = registry.gauge(
            mnames.QOS_SHEDDING,
            "1 while admission control is shedding sheddable-class work "
            "(0 otherwise)", labelnames=("scope",),
        ).labels(scope=scope)
        self._g_burn = registry.gauge(
            mnames.QOS_BURN_RATE,
            "Windowed burn rate of the protected class's TTFT budget "
            "((1 - attainment) / (1 - target))", labelnames=("scope",),
        ).labels(scope=scope)
        self._c_transitions = registry.counter(
            mnames.QOS_SHED_TRANSITIONS_TOTAL,
            "Admission-control state transitions", labelnames=(
                "scope", "kind",
            ),
        )

    # -- inputs -----------------------------------------------------------

    def observe_ttft(self, cls: RequestClass, ttft_ms: float,
                     now: float | None = None) -> None:
        """One protected-class finish (local scope input)."""
        if cls.name != self.protected.name:
            return
        if now is None:
            now = self._clock()
        with self._lock:
            self._finishes.append((now, ttft_ms <= cls.deadline_ms))
            self._trim(self._finishes, now)

    def observe_cumulative(self, under: float, total: int,
                           now: float | None = None) -> None:
        """One cumulative (under-budget, total) histogram reading of
        the protected class's TTFT (cluster scope input; the caller
        reads it off the merged heartbeat snapshots)."""
        if now is None:
            now = self._clock()
        with self._lock:
            if self._cumulative and (
                total < self._cumulative[-1][2]
                or under < self._cumulative[-1][1] - 1e-9
            ):
                # A contributing node died/restarted: deltas against
                # retained history would read as no-traffic-attained
                # exactly during the churn. Re-anchor (obs/slo.py does
                # the same).
                self._cumulative.clear()
            self._cumulative.append((now, under, total))
            self._trim(self._cumulative, now)

    def set_queue_pressure(self, pressure: bool) -> None:
        self._pressure = bool(pressure)

    def set_remote(self, shed: bool) -> None:
        self.remote_shed = bool(shed)

    def _trim(self, dq: deque, now: float) -> None:
        horizon = self.config.burn_window_s * 1.25 + 5.0
        while dq and now - dq[0][0] > horizon:
            dq.popleft()

    # -- burn -------------------------------------------------------------

    def burn_rate(self, now: float | None = None) -> float:
        """Windowed burn of the protected TTFT budget; 0.0 with no
        traffic in the window (nothing violated the objective)."""
        if now is None:
            now = self._clock()
        w = self.config.burn_window_s
        with self._lock:
            if self._cumulative:
                base = None
                for t, under, total in self._cumulative:
                    if t <= now - w:
                        base = (under, total)
                    else:
                        break
                if base is None:
                    base = (self._cumulative[0][1], self._cumulative[0][2])
                under = self._cumulative[-1][1] - base[0]
                total = self._cumulative[-1][2] - base[1]
            else:
                samples = [ok for t, ok in self._finishes if now - t <= w]
                under, total = float(sum(samples)), len(samples)
        self.last_samples = max(0, int(total))
        if total <= 0:
            return 0.0
        att = min(1.0, under / total)
        return (1.0 - att) / max(1e-9, 1.0 - self.config.target)

    # -- state machine ----------------------------------------------------

    def tick(self, now: float | None = None) -> bool:
        """Re-evaluate; returns True when the shed state CHANGED (the
        caller then emits its flight/timeline event)."""
        if now is None:
            now = self._clock()
        burn = self.burn_rate(now)
        self.last_burn = burn
        self._g_burn.set(burn)
        changed = False
        if not self.shedding:
            burn_trips = (
                burn > self.config.shed_burn
                and self.last_samples >= self.config.min_burn_samples
            )
            if burn_trips or self._pressure:
                self.shedding = True
                self._shed_since = now
                self.transitions["sheds"] += 1
                self._c_transitions.labels(
                    scope=self.scope, kind="shed"
                ).inc()
                changed = True
                logger.warning(
                    "qos[%s]: shedding %s admissions (burn %.2f, "
                    "queue_pressure=%s)", self.scope,
                    "/".join(c.name for c in self.config.classes
                             if c.sheddable),
                    burn, self._pressure,
                )
        else:
            held = now - (self._shed_since or now)
            if (
                burn < self.config.release_burn
                and not self._pressure
                and held >= self.config.min_shed_s
            ):
                self.shedding = False
                self._shed_since = None
                self.transitions["releases"] += 1
                self._c_transitions.labels(
                    scope=self.scope, kind="release"
                ).inc()
                changed = True
                logger.info(
                    "qos[%s]: burn recovered (%.2f) after %.1fs — "
                    "releasing shed work", self.scope, burn, held,
                )
        self._g_shedding.set(1.0 if (self.shedding or self.remote_shed)
                             else 0.0)
        return changed

    @property
    def active(self) -> bool:
        """Shedding in effect (local state OR the cluster's relayed
        verdict)."""
        return self.shedding or self.remote_shed

    def payload(self) -> dict:
        return {
            "scope": self.scope,
            "shedding": self.active,
            "shedding_local": self.shedding,
            "shedding_remote": self.remote_shed,
            "burn_rate": round(self.last_burn, 4),
            "queue_pressure": self._pressure,
            "protected_class": self.protected.name,
            "budget_ms": self.protected.deadline_ms,
            **self.transitions,
        }


class QoSPolicy:
    """Per-stage enforcement hooks for ``runtime/scheduler.py``.

    Everything here runs on the engine's step thread except
    ``observe_finish``/``set_remote_shed`` (engine finish path /
    heartbeat thread), which only touch thread-safe state.
    """

    def __init__(self, config: QoSConfig,
                 controller: AdmissionController | None = None,
                 stage_name: str = "stage", registry=None):
        self.config = config
        self.controller = controller or AdmissionController(
            config, scope=stage_name, registry=registry,
        )
        self.stage_name = stage_name
        self._last_tick: float | None = None   # no tick yet
        self._warned_no_tier = False
        self.counters = {"admitted": {}, "shed_held": {}, "parked": {},
                         "resumed": {}}
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        lbl = ("stage", "qos_class")
        self._c_admissions = registry.counter(
            mnames.QOS_ADMISSIONS_TOTAL,
            "Requests admitted into the running set, by QoS class",
            labelnames=lbl,
        )
        self._c_sheds = registry.counter(
            mnames.QOS_SHEDS_TOTAL,
            "Requests held back in admission by shed state, by QoS class",
            labelnames=lbl,
        )
        self._c_parks = registry.counter(
            mnames.QOS_PARKS_TOTAL,
            "Running decodes parked to the host tier by shed "
            "enforcement, by QoS class", labelnames=lbl,
        )
        self._h_slack = registry.histogram(
            mnames.QOS_DEADLINE_SLACK_MS,
            "Deadline slack at admission, milliseconds (negative slack "
            "is clamped into the first bucket)", labelnames=("stage",),
        ).labels(stage=stage_name)
        self._h_ttft = registry.histogram(
            mnames.QOS_TTFT_MS,
            "Time to first token by QoS class, milliseconds "
            "(the admission controller's burn-rate input)",
            labelnames=("qos_class",),
        )

    # -- class / deadline helpers -----------------------------------------

    def class_of(self, req) -> RequestClass:
        return self.config.class_of(getattr(req, "qos_class", None))

    def effective_deadline(self, req) -> float:
        dl = getattr(req, "deadline", None)
        if dl is not None:
            return dl
        return req.arrival_time + self.class_of(req).deadline_ms / 1e3

    def order_key(self, req, now: float,
                  guard: bool = True) -> tuple[int, float, int, float]:
        """Earliest-deadline-first; with ``guard`` (the WAIT-QUEUE
        admission path), requests waiting past ``starvation_s`` form a
        head bucket served FCFS so batch work under a permanent
        interactive stream still admits. RUNNING-row ordering (prefill
        chunk / decode-batch formation) passes ``guard=False``: age is
        not wait-time for a row being served, and an age guard there
        would put every old batch row ahead of a fresh interactive one
        — the exact inversion EDF exists to prevent. Running batch rows
        are still starvation-bounded WITHOUT the guard: their slack
        decays toward (and past) zero, so they overtake fresher
        deadlines within their own budget horizon."""
        cls = self.class_of(req)
        if guard and (now - req.arrival_time) > self.config.starvation_s:
            return (0, req.arrival_time, cls.priority, 0.0)
        return (
            1,
            self.effective_deadline(req) - now,
            cls.priority,
            req.arrival_time,
        )

    # -- admission hooks ---------------------------------------------------

    def maybe_tick(self, now: float, scheduler=None) -> None:
        """Rate-limited controller re-evaluation. ``scheduler`` (when
        given) feeds the queue-pressure trigger: a protected request
        waiting with under half its budget left while sheddable work
        occupies the running set."""
        if (self._last_tick is not None
                and now - self._last_tick < self.config.tick_interval_s):
            return
        self._last_tick = now
        if scheduler is not None:
            self.controller.set_queue_pressure(
                self._queue_pressure(scheduler, now)
            )
        if self.controller.tick(now):
            from parallax_tpu_torch.obs.flight import get_flight

            get_flight().event(
                "qos_shed" if self.controller.shedding else "qos_release",
                stage=self.stage_name,
                burn=round(self.controller.last_burn, 3),
            )

    def _queue_pressure(self, scheduler, now: float) -> bool:
        protected_waiting = False
        for req in scheduler.wait_queue.values():
            cls = self.class_of(req)
            if cls.sheddable or req.status.is_finished:
                continue
            slack = self.effective_deadline(req) - now
            if slack < cls.deadline_ms / 2e3:
                protected_waiting = True
                break
        if not protected_waiting:
            return False
        return any(
            self.class_of(r).sheddable
            for r in scheduler.running.values()
            if not r.status.is_finished
        )

    def admit_order(self, wait_queue, now: float) -> list:
        """The wait queue as ``(rid, req)`` pairs in EDF order."""
        items = list(wait_queue.items())
        items.sort(key=lambda kv: self.order_key(kv[1], now))
        return items

    def blocks_admission(self, req) -> bool:
        """Shed gate: while shedding, sheddable-class requests (new
        arrivals AND parked resumes) hold in the wait queue. Never
        blocks protected classes."""
        return self.controller.active and self.class_of(req).sheddable

    def on_admit(self, req, now: float) -> None:
        cls = self.class_of(req)
        slack_ms = (self.effective_deadline(req) - now) * 1e3
        self._h_slack.observe(max(0.1, slack_ms))
        self._c_admissions.labels(
            stage=self.stage_name, qos_class=cls.name
        ).inc()
        c = self.counters["admitted"]
        c[cls.name] = c.get(cls.name, 0) + 1

    def count_shed(self, req) -> None:
        """Count a request held by the shed gate — once per request
        (the admit loop revisits it every step)."""
        if getattr(req, "_qos_shed_counted", False):
            return
        req._qos_shed_counted = True
        cls = self.class_of(req)
        self._c_sheds.labels(
            stage=self.stage_name, qos_class=cls.name
        ).inc()
        c = self.counters["shed_held"]
        c[cls.name] = c.get(cls.name, 0) + 1

    # -- park enforcement --------------------------------------------------

    def parkable(self, req) -> bool:
        return self.class_of(req).sheddable

    def count_park(self, req) -> None:
        cls = self.class_of(req)
        self._c_parks.labels(
            stage=self.stage_name, qos_class=cls.name
        ).inc()
        c = self.counters["parked"]
        c[cls.name] = c.get(cls.name, 0) + 1
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            "qos_park", stage=self.stage_name,
            request_id=req.request_id, qos_class=cls.name,
        )

    def warn_no_tier_once(self) -> None:
        if self._warned_no_tier:
            return
        self._warned_no_tier = True
        # Park enforcement rides the preempt-to-host path; without the
        # tier (or on the native manager), shedding can only hold NEW
        # admissions.
        logger.warning(
            "qos park enforcement disabled: no host KV tier on this "
            "stage — shedding holds new admissions only (set "
            "--host-cache-bytes to let running batch decodes park)"
        )

    # -- finish / relay ----------------------------------------------------

    def observe_finish(self, req, ttft_ms: float | None) -> None:
        if ttft_ms is None:
            return
        cls = self.class_of(req)
        self._h_ttft.labels(qos_class=cls.name).observe(ttft_ms)
        self.controller.observe_ttft(cls, ttft_ms)

    def set_remote_shed(self, shed: bool) -> None:
        self.controller.set_remote(shed)

    def payload(self) -> dict:
        return {
            "enabled": True,
            "classes": [
                {"name": c.name, "priority": c.priority,
                 "deadline_ms": c.deadline_ms, "sheddable": c.sheddable}
                for c in self.config.classes
            ],
            "admission": self.controller.payload(),
            "counters": {k: dict(v) for k, v in self.counters.items()},
        }
