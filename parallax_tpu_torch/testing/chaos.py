"""Deterministic fault injection for swarm robustness testing (port of
``parallax_tpu/testing/chaos.py``).

A :class:`ChaosController` wraps live port transports
(``p2p/transport.Transport``) and worker nodes with seed-deterministic
faults, the churn events live migration and the KV handoff exist to
absorb:

- **frame faults**: drop or delay RPC frames, matched by method name,
  source, destination, with a probability and an optional budget;
- **node faults**: ``kill`` (abrupt crash: inbound AND outbound severed
  at the transport, no graceful leave), ``hang`` (the node stops
  answering for a while but comes back), ``slow`` (every frame touching
  the node pays an injected latency);
- **heartbeat faults**: ``break_heartbeats`` suppresses a worker's
  ``node_update`` frames, so the scheduler's sweep is exercised without
  killing the node.

Every random decision draws from one ``random.Random(seed)``, so a chaos
run replays its decisions from its seed. The harness touches only the
transport objects it is handed; the serving path never imports it.

The JAX controller also turns on the lock-order and protocol-conformance
sanitizers. The port has neither yet (ROADMAP queue 1 item 14), so this
controller's defaults are ``lock_sanitizer=False, conformance=False``,
and ``True``, :meth:`ChaosController.lock_report` and
:meth:`ChaosController.conformance_report` are refused by name.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.p2p.transport import Transport, TransportError
from parallax_tpu_torch.utils import get_logger, unported

logger = get_logger(__name__)


@dataclasses.dataclass
class ChaosRule:
    """One frame-fault rule: ``action`` applies when every non-None
    matcher agrees, with probability ``p``, at most ``limit`` times."""

    action: str                      # "drop" | "delay"
    method: str | None = None        # RPC method name, None = any
    src: str | None = None           # sending peer id, None = any
    dst: str | None = None           # receiving peer id, None = any
    p: float = 1.0
    limit: int | None = None         # max applications, None = unbounded
    delay_s: float = 0.0             # for "delay"
    hits: int = 0

    def matches(self, method: str, src: str, dst: str) -> bool:
        if self.limit is not None and self.hits >= self.limit:
            return False
        return (
            (self.method is None or self.method == method)
            and (self.src is None or self.src == src)
            and (self.dst is None or self.dst == dst)
        )


class _ChaosDropped(TransportError):
    """A frame the chaos layer ate (distinct type so tests can tell an
    injected fault from a real transport failure)."""


class ChaosController:
    """Seed-deterministic fault injector over in-process swarms.

    Wrap each transport BEFORE handing it to a worker/scheduler::

        chaos = ChaosController(seed=7)
        t = chaos.wrap(LoopbackTransport("w0", registry))
        ...
        chaos.drop_frames(method="node_update", src="w0")   # break beats
        chaos.kill(worker)                                  # crash

    The sanitizers the JAX controller turns on wait for ROADMAP queue 1
    item 14: ``lock_sanitizer=True`` / ``conformance=True`` raise.
    """

    def __init__(self, seed: int = 0, lock_sanitizer: bool = False,
                 conformance: bool = False):
        if lock_sanitizer:
            raise unported("the lock-order sanitizer (lock_sanitizer=True)",
                           14)
        if conformance:
            raise unported("the protocol-conformance sanitizer "
                           "(conformance=True)", 14)
        self.rng = random.Random(seed)
        self.rules: list[ChaosRule] = []
        # Peers whose transports are severed (crashed) or paused
        # (hanging until the stored deadline).
        self._dead: set[str] = set()
        self._hung: dict[str, float] = {}
        self._slow: dict[str, float] = {}
        self._lock = make_lock("testing.chaos", reentrant=True)
        self._wrapped: dict[str, Transport] = {}
        self.stats = {"dropped": 0, "delayed": 0, "severed_calls": 0}

    @staticmethod
    def lock_report() -> dict[str, Any]:
        """The lock-order sanitizer's verdict (ROADMAP queue 1 item 14)."""
        raise unported("the lock-order sanitizer (lock_report)", 14)

    @staticmethod
    def conformance_report() -> dict[str, Any]:
        """The protocol-conformance sanitizer's verdict (item 14)."""
        raise unported("the protocol-conformance sanitizer "
                       "(conformance_report)", 14)

    # -- frame faults -----------------------------------------------------

    def drop_frames(self, method: str | None = None, src: str | None = None,
                    dst: str | None = None, p: float = 1.0,
                    limit: int | None = None) -> ChaosRule:
        rule = ChaosRule("drop", method, src, dst, p=p, limit=limit)
        with self._lock:
            self.rules.append(rule)
        return rule

    def delay_frames(self, delay_s: float, method: str | None = None,
                     src: str | None = None, dst: str | None = None,
                     p: float = 1.0, limit: int | None = None) -> ChaosRule:
        rule = ChaosRule("delay", method, src, dst, p=p, limit=limit,
                         delay_s=delay_s)
        with self._lock:
            self.rules.append(rule)
        return rule

    def clear_rules(self) -> None:
        with self._lock:
            self.rules.clear()

    def break_heartbeats(self, node_id: str,
                         limit: int | None = None) -> ChaosRule:
        """Suppress a worker's outbound ``node_update`` frames: the
        scheduler sweep sees silence while the node keeps serving."""
        return self.drop_frames(method="node_update", src=node_id,
                                limit=limit)

    # -- node faults ------------------------------------------------------

    def kill(self, worker) -> None:
        """Abrupt crash: sever the worker's transport both ways (calls
        into AND out of it raise), then reap its threads. The graceful
        NODE_LEAVE in ``worker.stop()`` cannot get out — the scheduler
        must discover the death via send failures / heartbeat silence,
        exactly like a yanked spot instance."""
        peer = worker.node_id
        with self._lock:
            self._dead.add(peer)
        logger.info("chaos: killed %s", peer)
        # Reap threads AFTER severing: stop()'s leave call hits the
        # severed transport and dies silently, preserving crash
        # semantics while still joining threads for test hygiene.
        worker.stop()

    def hang(self, worker_or_id, seconds: float) -> None:
        """The node freezes (GC pause, driver stall): frames to and from
        it block/fail for ``seconds``, then it resumes untouched."""
        peer = getattr(worker_or_id, "node_id", worker_or_id)
        with self._lock:
            self._hung[peer] = time.monotonic() + float(seconds)
        logger.info("chaos: hung %s for %.2fs", peer, seconds)

    def slow(self, worker_or_id, delay_s: float) -> None:
        """Every frame touching the node pays ``delay_s`` (congested
        link / overloaded host). ``delay_s=0`` restores."""
        peer = getattr(worker_or_id, "node_id", worker_or_id)
        with self._lock:
            if delay_s > 0:
                self._slow[peer] = float(delay_s)
            else:
                self._slow.pop(peer, None)

    def is_dead(self, peer: str) -> bool:
        with self._lock:
            return peer in self._dead

    # -- transport wrapping ----------------------------------------------

    def wrap(self, transport: Transport) -> Transport:
        """Interpose on a transport's ``call``/``send``: every outbound
        frame consults the fault tables. Idempotent per transport."""
        if getattr(transport, "_chaos_wrapped", False):
            return transport
        me = transport.peer_id
        real_call = transport.call
        real_send = transport.send

        def call(peer: str, method: str, payload: Any,
                 timeout: float = 30.0):
            self._gate(me, peer, method, timeout)
            return real_call(peer, method, payload, timeout=timeout)

        def send(peer: str, method: str, payload: Any) -> None:
            self._gate(me, peer, method, 30.0)
            real_send(peer, method, payload)

        transport.call = call              # type: ignore[method-assign]
        transport.send = send             # type: ignore[method-assign]
        transport._chaos_wrapped = True   # type: ignore[attr-defined]
        with self._lock:
            self._wrapped[me] = transport
        return transport

    def _gate(self, src: str, dst: str, method: str,
              timeout: float) -> None:
        """Apply fault tables to one frame; raises to fail the frame."""
        with self._lock:
            if src in self._dead or dst in self._dead:
                self.stats["severed_calls"] += 1
                raise _ChaosDropped(
                    f"chaos: {src if src in self._dead else dst} is dead"
                )
            hung_until = max(
                self._hung.get(src, 0.0), self._hung.get(dst, 0.0)
            )
            slow_s = self._slow.get(src, 0.0) + self._slow.get(dst, 0.0)
            rule = None
            for r in self.rules:
                if r.matches(method, src, dst) and (
                    r.p >= 1.0 or self.rng.random() < r.p
                ):
                    r.hits += 1
                    rule = r
                    break
        # Sleeps happen OUTSIDE the lock: a hung node must not freeze
        # the whole harness.
        if hung_until:
            remaining = hung_until - time.monotonic()
            if remaining > 0:
                if remaining >= timeout:
                    time.sleep(min(remaining, timeout))
                    raise _ChaosDropped(
                        f"chaos: {dst} hung past the call timeout"
                    )
                time.sleep(remaining)
        if slow_s > 0:
            time.sleep(min(slow_s, timeout))
        if rule is None:
            return
        if rule.action == "drop":
            with self._lock:
                self.stats["dropped"] += 1
            raise _ChaosDropped(
                f"chaos: dropped {method} {src}->{dst}"
            )
        if rule.action == "delay":
            with self._lock:
                self.stats["delayed"] += 1
            time.sleep(min(rule.delay_s, timeout))
