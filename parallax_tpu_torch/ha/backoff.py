"""Exponential backoff with full jitter and a shared deadline (port of
``parallax_tpu/ha/backoff.py``).

Every scheduler-RPC retry loop in the package routes through this
policy (docs/ha.md): the failover wrapper's rotation, the worker's join
retry and the SwarmClient's poll retry. The failure mode it exists for:
a scheduler restart or standby promotion orphans every worker's
heartbeat and every client's poll at once. Fixed-interval loops retry
in phase, and the freshly-promoted standby eats a thundering herd
exactly when it is busiest. Full jitter (delay ~ U(0, min(cap, base *
mult^n)), the AWS architecture blog's variant) de-correlates the herd;
the shared deadline keeps a retry ladder from outliving the caller's own
budget.

Stdlib-only and clock-injectable: a test replays a retry schedule
deterministically by supplying its own clock, sleep and RNG.
"""

from __future__ import annotations

import dataclasses
import random
import time


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Retry shape shared by one subsystem's ladder: first delay drawn
    from U(0, ``base_s``), growing by ``multiplier`` per attempt, capped
    at ``cap_s``."""

    base_s: float = 0.2
    cap_s: float = 5.0
    multiplier: float = 2.0


# The package-wide default for scheduler RPCs: sub-second first retry
# (a promotion completes in well under a second), 5 s ceiling so a
# long outage costs at most one beat interval of extra discovery.
SCHEDULER_RPC_POLICY = BackoffPolicy(base_s=0.2, cap_s=5.0, multiplier=2.0)


class Backoff:
    """One retry ladder: jittered delays under a shared deadline.

    ``wait()`` sleeps the next jittered delay and returns False once the
    deadline would be exceeded — the caller then raises/gives up. The
    clock, sleep and RNG are injectable for deterministic replay.
    """

    def __init__(
        self,
        policy: BackoffPolicy | None = None,
        deadline_s: float | None = None,
        rng: "random.Random | None" = None,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.policy = policy or SCHEDULER_RPC_POLICY
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random
        self.attempts = 0
        self._deadline = (
            None if deadline_s is None else self._clock() + deadline_s
        )

    def remaining(self) -> float | None:
        """Seconds left under the shared deadline (None = unbounded)."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - self._clock())

    def next_delay(self) -> float:
        """Draw the next full-jitter delay (advances the attempt count)."""
        p = self.policy
        ceiling = min(p.cap_s, p.base_s * (p.multiplier ** self.attempts))
        self.attempts += 1
        return self._rng.uniform(0.0, ceiling)

    def wait(self) -> bool:
        """Sleep the next jittered delay. Returns False (without
        sleeping past it) when the shared deadline is exhausted."""
        delay = self.next_delay()
        rem = self.remaining()
        if rem is not None:
            if rem <= 0.0:
                return False
            delay = min(delay, rem)
        if delay > 0.0:
            self._sleep(delay)
        rem = self.remaining()
        return rem is None or rem > 0.0
