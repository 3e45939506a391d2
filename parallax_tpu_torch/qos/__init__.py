"""Multi-tenant QoS control plane, a copy of ``parallax_tpu/qos``.

Request classes with priorities and deadline budgets, deadline-aware
admission control (shed / park / release with hysteresis over the
interactive burn rate), EDF local scheduling with a starvation guard,
and the goodput-driven pool autoscaler. ``--qos off`` (the default)
keeps every hook unwired: no per-step work, the same streams.
"""

from parallax_tpu_torch.qos.classes import (
    DEFAULT_CLASSES,
    QOS_CLASS_NAMES,
    QoSConfig,
    RequestClass,
    parse_qos_spec,
    qos_from_http,
)
from parallax_tpu_torch.qos.admission import AdmissionController, QoSPolicy
from parallax_tpu_torch.qos.autoscaler import PoolAutoscaler, pool_report

__all__ = [
    "AdmissionController",
    "DEFAULT_CLASSES",
    "PoolAutoscaler",
    "QOS_CLASS_NAMES",
    "QoSConfig",
    "QoSPolicy",
    "RequestClass",
    "parse_qos_spec",
    "pool_report",
    "qos_from_http",
]
