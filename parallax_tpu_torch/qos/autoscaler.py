"""Goodput-driven pool autoscaler: re-role pipelines between phase pools
(a copy of ``parallax_tpu/qos/autoscaler.py``).

From observed per-pool queue depth (head in-flight over capacity) and
goodput per chip (the goodput ledger, merged per pool from heartbeats),
the scheduler re-roles a WHOLE pipeline from the underemployed pool to
the saturated one.

A re-role is cheap and abort-free:

- the scheduler flips every member node's ``role``; the next heartbeat
  reply relays it and the worker switches behaviour in place (same
  layers, same weights, no engine reload);
- a pipeline leaving the decode pool drains its in-flight decodes
  through the KV-handoff machinery (its head, now prefill-role, hands
  finished prompts to the remaining decode pool like any prefill
  specialist);
- a pipeline leaving the prefill pool keeps its in-flight prompts: as a
  decode specialist it still finishes what it admitted.

Guard rails: hysteresis (donor under ``util_low`` while the receiver
is over ``util_high``), a cooldown between actions, and a donor pool
floor of one pipeline. Mixed-role pipelines are never touched.
"""

from __future__ import annotations

import time

from parallax_tpu_torch.qos.classes import QoSConfig
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.obs import names as mnames

logger = get_logger(__name__)

# The two specialized pools the autoscaler rebalances between.
_POOLS = ("prefill", "decode")


def pool_report(pipelines) -> dict:
    """Per-pool queue depth, capacity, utilization and goodput-per-chip
    from the scheduler's pipeline registry + heartbeat-fed node state.
    Shared by the autoscaler's decisions and the ``qos`` status
    section, so operators see exactly the numbers the loop acted on."""
    from parallax_tpu_torch.obs.goodput import merge_goodput

    pools: dict[str, dict] = {}
    for p in pipelines:
        d = pools.setdefault(p.role, {
            "pipelines": 0, "in_flight": 0, "capacity": 0,
            "_goodput": [],
        })
        d["pipelines"] += 1
        d["in_flight"] += p.nodes[0].load
        d["capacity"] += min(n.max_concurrent_requests() for n in p.nodes)
        d["_goodput"].extend(n.goodput for n in p.nodes if n.goodput)
    for d in pools.values():
        d["utilization"] = (
            round(d["in_flight"] / d["capacity"], 4)
            if d["capacity"] else 0.0
        )
        merged = merge_goodput(d.pop("_goodput"))
        d["goodput_per_chip"] = (
            merged["tokens_useful_per_chip_second"] if merged else None
        )
    return pools


class PoolAutoscaler:
    """Scheduler-side re-roling loop (ticked from the event thread, so
    every topology mutation stays single-threaded)."""

    def __init__(self, manager, config: QoSConfig, timeline=None,
                 registry=None, clock=time.monotonic):
        self.manager = manager
        self.config = config
        self.timeline = timeline
        self._clock = clock
        # None until the first tick / action: a cooldown counts from the
        # last action, not from the clock's origin (a monotonic clock on a
        # host up for less than the cooldown must not hold the first one).
        self._last_tick: float | None = None
        self._last_action: float | None = None
        self.stats = {"reroles": 0, "considered": 0, "last_action": None}
        if registry is None:
            from parallax_tpu_torch.obs.registry import get_registry

            registry = get_registry()
        self._c_reroles = registry.counter(
            mnames.QOS_REROLES_TOTAL,
            "Pipelines re-roled between phase pools by the autoscaler",
            labelnames=("direction",),
        )

    def tick(self, now: float | None = None) -> dict | None:
        """One control-loop pass; returns the action record when a
        pipeline was re-roled, else None."""
        if now is None:
            now = self._clock()
        if (self._last_tick is not None
                and now - self._last_tick < self.config.autoscale_interval_s):
            return None
        self._last_tick = now
        pipelines = self.manager.pipelines
        pools = pool_report(pipelines)
        if not all(r in pools for r in _POOLS):
            # Not a disaggregated swarm (or one pool died entirely) —
            # nothing to rebalance between.
            return None
        self.stats["considered"] += 1
        if (self._last_action is not None
                and now - self._last_action
                < self.config.autoscale_cooldown_s):
            return None
        hi, lo = (
            self.config.autoscale_util_high, self.config.autoscale_util_low,
        )
        action = None
        for needy, donor in (("prefill", "decode"), ("decode", "prefill")):
            if (
                pools[needy]["utilization"] >= hi
                and pools[donor]["utilization"] <= lo
                and pools[donor]["pipelines"] > 1
            ):
                action = (donor, needy)
                break
        if action is None:
            return None
        donor_role, new_role = action
        # Donor choice inside the pool: the pipeline with the least
        # in-flight work (fewest requests to drain through the handoff/
        # migration machinery) — and, among ties, the lowest
        # goodput-per-chip (the most underemployed chips move).
        from parallax_tpu_torch.obs.goodput import merge_goodput

        def _goodput_per_chip(p) -> float:
            merged = merge_goodput(
                [n.goodput for n in p.nodes if n.goodput]
            )
            return (
                merged["tokens_useful_per_chip_second"] if merged else 0.0
            )

        candidates = [p for p in pipelines if p.role == donor_role]
        candidates.sort(
            key=lambda p: (p.nodes[0].load, _goodput_per_chip(p))
        )
        pipeline = candidates[0]
        for n in pipeline.nodes:
            n.role = new_role
        self._last_action = now
        self.stats["reroles"] += 1
        direction = f"{donor_role}->{new_role}"
        self._c_reroles.labels(direction=direction).inc()
        record = {
            "pipeline_id": pipeline.pipeline_id,
            "direction": direction,
            "nodes": list(pipeline.node_ids),
            "pools": {
                r: {k: v for k, v in pools[r].items()}
                for r in _POOLS
            },
        }
        self.stats["last_action"] = record
        logger.warning(
            "qos autoscaler: re-roling pipeline %d (%s) %s — "
            "%s util %.2f vs %s util %.2f",
            pipeline.pipeline_id, ",".join(pipeline.node_ids), direction,
            new_role, pools[new_role]["utilization"],
            donor_role, pools[donor_role]["utilization"],
        )
        if self.timeline is not None:
            self.timeline.record(
                "qos_rerole", pipeline=pipeline.pipeline_id,
                direction=direction, nodes=list(pipeline.node_ids),
            )
        return record

    def payload(self) -> dict:
        return {
            "enabled": True,
            "interval_s": self.config.autoscale_interval_s,
            "cooldown_s": self.config.autoscale_cooldown_s,
            "util_high": self.config.autoscale_util_high,
            "util_low": self.config.autoscale_util_low,
            **{k: v for k, v in self.stats.items()},
        }
