"""Transport-shaped scheduler-RPC wrapper with standby failover (port of
``parallax_tpu/ha/failover.py``).

Workers and the SwarmClient route every scheduler RPC through a
:class:`SchedulerFailover` instead of the raw transport. The wrapper
keeps the Transport ``call(peer, method, payload, timeout=...)`` shape,
so every call site still writes its payload as a dict literal against a
``proto.*`` frame constant.

What the wrapper adds on top of a plain call:

- **peer rotation** — an ordered address list (primary first, then the
  ``--scheduler-standby`` addresses); transport errors rotate to the
  next peer under one shared deadline with jittered backoff;
- **``not_primary`` redirects** — a passive or fenced scheduler answers
  ``{"not_primary": True}``; the wrapper rotates instead of surfacing
  the refusal to the caller;
- **epoch adoption** — any reply carrying ``"epoch"`` raises the
  wrapper's high-water epoch, which workers echo on heartbeats so a
  revived old primary fences itself (docs/ha.md);
- **standby discovery** — replies carrying ``"standbys"`` extend the
  rotation list, so a worker started before the standby existed still
  learns the failover address from the primary.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from parallax_tpu_torch.ha.backoff import Backoff, BackoffPolicy


class SchedulerFailover:
    """Route scheduler RPCs to whichever peer currently acts as primary.

    ``transport`` only needs a Transport-shaped
    ``call(peer, method, payload, timeout=...)``; the wrapper is wire-
    codec agnostic, so a loopback or scripted transport drives it too.
    """

    def __init__(
        self,
        transport: Any,
        peers: Sequence[str],
        policy: Optional[BackoffPolicy] = None,
    ):
        self.transport = transport
        self._policy = policy
        self._lock = threading.Lock()
        self._peers: List[str] = []
        for p in peers:
            if p and p not in self._peers:
                self._peers.append(p)
        if not self._peers:
            raise ValueError("SchedulerFailover needs at least one peer")
        self._active = 0
        self.epoch = 0

    @property
    def active_peer(self) -> str:
        with self._lock:
            return self._peers[self._active]

    @property
    def peers(self) -> List[str]:
        with self._lock:
            return list(self._peers)

    def note_epoch(self, epoch: Any) -> None:
        """Adopt a higher scheduler epoch seen in any reply."""
        try:
            epoch = int(epoch)
        except (TypeError, ValueError):
            return
        with self._lock:
            if epoch > self.epoch:
                self.epoch = epoch

    def add_standbys(self, addrs: Any) -> None:
        """Extend the rotation list with standby addresses a reply
        advertised (idempotent; order of first sight is kept)."""
        if not isinstance(addrs, (list, tuple)):
            return
        with self._lock:
            for a in addrs:
                if isinstance(a, str) and a and a not in self._peers:
                    self._peers.append(a)

    def _rotate(self, from_index: int) -> None:
        with self._lock:
            if self._active == from_index:
                self._active = (self._active + 1) % len(self._peers)

    def call(
        self,
        peer: str,
        method: str,
        payload: Dict[str, Any],
        timeout: float = 10.0,
    ):
        """Transport-shaped call. ``peer`` is advisory — the wrapper
        substitutes whichever peer it currently believes is primary and
        rotates through the rest on failure, all under one shared
        deadline equal to ``timeout``."""
        backoff = Backoff(self._policy, deadline_s=timeout)
        last_exc: Optional[Exception] = None
        redirected = False
        while True:
            with self._lock:
                idx = self._active
                target = self._peers[idx]
            remaining = backoff.remaining()
            if remaining is not None and remaining <= 0.0:
                break
            try:
                reply = self.transport.call(
                    target, method, payload, timeout=remaining
                )
            except Exception as exc:  # transport-level failure: rotate
                last_exc = exc
                self._rotate(idx)
                if not backoff.wait():
                    break
                continue
            if isinstance(reply, dict):
                if "epoch" in reply:
                    self.note_epoch(reply.get("epoch"))
                self.add_standbys(reply.get("standbys"))
                if reply.get("not_primary"):
                    redirected = True
                    self._rotate(idx)
                    if not backoff.wait():
                        break
                    continue
            return reply
        if last_exc is not None:
            raise last_exc
        if redirected:
            raise RuntimeError(
                "no primary scheduler among %s within %.1fs"
                % (self.peers, timeout)
            )
        raise TimeoutError(
            "scheduler call %s exhausted %.1fs deadline" % (method, timeout)
        )
