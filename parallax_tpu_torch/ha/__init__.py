"""Control-plane survivability: warm-standby scheduler HA (port of
``parallax_tpu/ha``; docs/ha.md).

The global scheduler is the one process whose death orphans the whole
swarm — every join, heartbeat, digest delta, route decision and
migration verdict flows through it. This package makes its state
survive:

- :mod:`.journal` — a versioned snapshot codec of the GlobalScheduler's
  replicated state plus an append-only journal of state-mutating
  events, written through one choke-point (``StateJournal.record``);
- :mod:`.standby` — a warm standby that tails snapshot+journal over the
  existing RPC plane (or a shared JSONL file in single-host mode),
  holds a read-only mirror, and promotes itself on lease expiry of the
  primary, bumping the scheduler **epoch** that fences a revived old
  primary off (split-brain guard);
- :mod:`.failover` — the Transport-shaped scheduler-RPC wrapper workers
  and the SwarmClient route through: peer rotation over the standby
  address list, ``not_primary`` redirect handling, epoch adoption;
- :mod:`.backoff` — exponential backoff with full jitter and a shared
  deadline for every scheduler-RPC retry loop.

Import-light by design: nothing here imports torch or the wire codec at
module level, and nothing touches a device.
"""

from parallax_tpu_torch.ha.backoff import Backoff, BackoffPolicy
from parallax_tpu_torch.ha.failover import SchedulerFailover
from parallax_tpu_torch.ha.journal import (
    SNAPSHOT_VERSION,
    StateJournal,
    restore_state,
    snapshot_state,
    soft_state_fingerprint,
    state_fingerprint,
)
from parallax_tpu_torch.ha.standby import StandbyScheduler

__all__ = [
    "Backoff",
    "BackoffPolicy",
    "SchedulerFailover",
    "SNAPSHOT_VERSION",
    "StateJournal",
    "StandbyScheduler",
    "restore_state",
    "snapshot_state",
    "soft_state_fingerprint",
    "state_fingerprint",
]
