"""Multi-tenant QoS request classes and configuration (a copy of
``parallax_tpu/qos/classes.py``).

The vocabulary the acting layers share:

- **Request classes** (``interactive`` / ``agent`` / ``batch``), each
  with a priority, a default deadline budget (the TTFT the class is
  entitled to when the request names no explicit deadline), and a
  *sheddable* flag: whether admission control may hold the class back
  (and park its running decodes) when the interactive error budget
  burns.
- **QoSConfig**: the parsed ``--qos`` knob set: class budgets,
  shed/release burn-rate hysteresis, the EDF starvation guard, and the
  pool-autoscaler thresholds.
- **parse_qos_spec**: the CLI surface. ``off`` (the default) returns
  ``None``: every hook in the serving path is guarded on that None.

The spec grammar and its error texts are the JAX package's exactly: a
JAX scheduler and a port worker parse the same spec. Enforcement lives
in :mod:`parallax_tpu_torch.qos.admission` (shed / park / EDF) and
:mod:`parallax_tpu_torch.qos.autoscaler` (pool re-roling).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One QoS class: ``priority`` (lower = more urgent) breaks EDF
    ties, ``deadline_ms`` is the TTFT budget assumed when a request
    names no explicit deadline, and ``sheddable`` marks work admission
    control may hold back (enforcement parks, never aborts)."""

    name: str
    priority: int
    deadline_ms: float
    sheddable: bool = False


# The three classes of the survey's mixed-traffic model: humans waiting
# on a spinner, tool-calling agents with looser (but real) latency
# needs, and throughput work that should soak whatever capacity the
# latency classes leave behind.
DEFAULT_CLASSES: tuple[RequestClass, ...] = (
    RequestClass("interactive", 0, 1_000.0, sheddable=False),
    RequestClass("agent", 1, 5_000.0, sheddable=False),
    RequestClass("batch", 2, 120_000.0, sheddable=True),
)

QOS_CLASS_NAMES = tuple(c.name for c in DEFAULT_CLASSES)


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    """Parsed ``--qos`` configuration (immutable; shared across
    threads without locking)."""

    classes: tuple[RequestClass, ...] = DEFAULT_CLASSES
    # Class assumed for requests that name none. Untagged traffic in a
    # QoS-on deployment is almost always a human behind a client that
    # predates the header — default it to the protected class.
    default_class: str = "interactive"
    # Admission hysteresis over the interactive TTFT burn rate: shed at
    # ``shed_burn``, release only once the burn has recovered below
    # ``release_burn`` AND the shed has held for ``min_shed_s`` (the
    # flap guard — parking and resuming batch decodes has a swap cost).
    shed_burn: float = 2.0
    release_burn: float = 1.0
    min_shed_s: float = 2.0
    # Window the burn rate is evaluated over. Deliberately much shorter
    # than the SLO tracker's alerting windows: enforcement must react
    # while the flood is happening, not after the 5-minute alert fires.
    burn_window_s: float = 30.0
    # Attainment target for the budget (p95-in-budget by default).
    target: float = 0.95
    # Burn-triggered sheds need at least this many protected-class
    # finishes in the window: with one or two samples the burn estimate
    # is pure variance (a single first-compile TTFT would otherwise
    # hold batch work for the whole window). The queue-pressure trigger
    # is unaffected — a starving waiter is direct evidence.
    min_burn_samples: int = 5
    # EDF starvation guard: any request waiting longer than this is
    # served FCFS ahead of every deadline — batch work under a
    # permanent interactive stream must still progress.
    starvation_s: float = 10.0
    # Controller re-evaluation cadence (the scheduler calls maybe_tick
    # once per batch formation; this bounds the work to one evaluation
    # per interval).
    tick_interval_s: float = 0.25
    # Goodput-driven pool autoscaler (scheduler-side):
    # re-role whole pipelines between the prefill and decode pools when
    # one pool's queue-depth utilization crosses ``util_high`` while
    # the other sits under ``util_low``. Off by default — it only makes
    # sense on a disaggregated swarm.
    autoscale: bool = False
    autoscale_interval_s: float = 5.0
    autoscale_cooldown_s: float = 30.0
    autoscale_util_high: float = 0.75
    autoscale_util_low: float = 0.25

    def class_named(self, name: str) -> RequestClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(
            f"unknown QoS class {name!r} (want one of "
            f"{[c.name for c in self.classes]})"
        )

    def class_of(self, qos_class: str | None) -> RequestClass:
        """The effective class for a request tag (None/unknown tags
        degrade to the default class — a newer client's class name must
        not 500 on an older server)."""
        if qos_class is not None:
            for c in self.classes:
                if c.name == qos_class:
                    return c
        return self.class_named(self.default_class)


_OFF_VALUES = frozenset({"", "off", "0", "false", "none", "no"})

# Spec keys -> QoSConfig field (float fields settable from the spec).
_FLOAT_KEYS = {
    "shed_burn": "shed_burn",
    "release_burn": "release_burn",
    "min_shed_s": "min_shed_s",
    "burn_window_s": "burn_window_s",
    "target": "target",
    "min_burn_samples": "min_burn_samples",
    "starvation_s": "starvation_s",
    "tick_interval_s": "tick_interval_s",
    "autoscale_interval_s": "autoscale_interval_s",
    "autoscale_cooldown_s": "autoscale_cooldown_s",
    "autoscale_util_high": "autoscale_util_high",
    "autoscale_util_low": "autoscale_util_low",
}


def parse_qos_spec(spec: str | None) -> QoSConfig | None:
    """Parse the ``--qos`` value. ``off``/empty/None -> None (QoS off,
    the provably-inert default); ``on`` -> all defaults; otherwise a
    comma list of ``key=value`` overrides::

        --qos "interactive_ms=500,batch_ms=60000,shed_burn=1.5,autoscale=1"

    ``<class>_ms`` sets a class deadline budget; the float knobs above
    tune hysteresis/starvation/autoscaler; ``autoscale=0|1`` toggles
    pool re-roling. Malformed specs raise ValueError so a typo fails at
    startup, not silently."""
    if spec is None:
        return None
    text = str(spec).strip().lower()
    if text in _OFF_VALUES:
        return None
    fields: dict = {}
    budgets: dict[str, float] = {}
    sheddable: dict[str, bool] = {}
    if text != "on":
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"QoS spec entry {part!r} is not key=value")
            key, _, value = part.partition("=")
            key = key.strip()
            value = value.strip()
            if key == "autoscale":
                fields["autoscale"] = value in ("1", "true", "on", "yes")
                continue
            if key == "default_class":
                fields["default_class"] = value
                continue
            if key.endswith("_sheddable"):
                sheddable[key[: -len("_sheddable")]] = value in (
                    "1", "true", "on", "yes",
                )
                continue
            try:
                fval = float(value)
            except ValueError:
                raise ValueError(
                    f"QoS spec entry {part!r} has a non-numeric value"
                )
            if key.endswith("_ms"):
                budgets[key[:-3]] = fval
                continue
            if key not in _FLOAT_KEYS:
                raise ValueError(f"unknown QoS spec key {key!r}")
            fields[_FLOAT_KEYS[key]] = fval
    classes = []
    known = set()
    for c in DEFAULT_CLASSES:
        known.add(c.name)
        classes.append(dataclasses.replace(
            c,
            deadline_ms=budgets.pop(c.name, c.deadline_ms),
            sheddable=sheddable.pop(c.name, c.sheddable),
        ))
    for name, ms in sorted(budgets.items()):
        # Operator-defined extra classes slot in after the built-ins
        # (priority = position; sheddable only if flagged).
        classes.append(RequestClass(
            name, len(classes), ms, sheddable=sheddable.pop(name, False),
        ))
    if sheddable:
        raise ValueError(
            f"QoS spec marks unknown classes sheddable: {sorted(sheddable)}"
        )
    if "min_burn_samples" in fields:
        fields["min_burn_samples"] = int(fields["min_burn_samples"])
    cfg = QoSConfig(classes=tuple(classes), **fields)
    cfg.class_named(cfg.default_class)   # KeyError -> startup failure
    if cfg.shed_burn <= cfg.release_burn:
        raise ValueError(
            "QoS shed_burn must exceed release_burn (hysteresis band)"
        )
    return cfg


def qos_from_http(
    headers, body: dict, config: QoSConfig
) -> tuple[str, float, str | None]:
    """Extract ``(qos_class, deadline_ms, tenant)`` from an HTTP
    request: ``x-parallax-qos-class`` / body ``qos_class``,
    ``x-parallax-deadline-ms`` / body ``deadline_ms``,
    ``x-parallax-tenant`` / body ``tenant``. Raises ValueError on an
    unknown class or a non-positive deadline (mapped to 400 by the
    frontend); the returned deadline falls back to the class budget."""
    raw = headers.get("x-parallax-qos-class") or body.get("qos_class")
    if raw is not None:
        try:
            cls = config.class_named(str(raw))
        except KeyError as e:
            raise ValueError(str(e))
    else:
        cls = config.class_named(config.default_class)
    raw_dl = headers.get("x-parallax-deadline-ms")
    if raw_dl is None:
        raw_dl = body.get("deadline_ms")
    if raw_dl is None:
        deadline_ms = cls.deadline_ms
    else:
        deadline_ms = float(raw_dl)   # ValueError -> 400
        if deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
    tenant = headers.get("x-parallax-tenant") or body.get("tenant")
    return cls.name, deadline_ms, (str(tenant) if tenant else None)
