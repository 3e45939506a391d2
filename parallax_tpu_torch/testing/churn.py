"""Virtual-time swarm churn harness (port of
``parallax_tpu/testing/churn.py``).

Replays a seeded, scripted multi-hundred-node join / leave / kill /
heartbeat trace over the port's REAL control plane (``GlobalScheduler``
event handling, layer allocation, routing, the QoS sweep, ``StateJournal``
and ``StandbyScheduler``) with NO model forward and NO wall clock: every
``time.*`` read the scheduler makes is served by a deterministic virtual
clock, so a 220-node, four-virtual-minute churn storm replays in seconds
of CPU and the same seed gives the SAME event log line for line.

Mid-trace the harness kills the primary scheduler and promotes a warm
standby that tailed the snapshot + journal stream (single-host shared
file), then checks:

- **state equivalence**: the promoted scheduler's state fingerprint
  equals the dead primary's at the moment of death, field by field, and
  its soft state (load / ready / busy) equals the harness's own heartbeat
  ledger;
- **routing quality**: once bootstrapped, every admitted request routes
  to a live contiguous pipeline covering the full layer range, across
  churn and across the promotion;
- **zero aborts, no leaked charges**: every routed request completes and
  the router's load returns to zero.

The fleet is the JAX harness's: its five hosts' figures are copied below
(the scheduler is device-agnostic), so both packages replay the same
trace. The virtual clock's origin is a parameter (``clock_start``): the
log is relative to it and must not depend on it. Importable with no
torch on the path::

    python -m parallax_tpu_torch.testing.churn --check-determinism
"""

from __future__ import annotations

import argparse
import contextlib
import random
import time

from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.utils.hw import HardwareInfo

logger = get_logger(__name__)

# The reference 28-layer 7B-class shape the scheduler tests use: big
# enough that v5e hosts chain into multi-stage pipelines (so churn
# exercises pipeline dissolution, not just replica counts).
DEFAULT_MODEL = dict(
    architectures=["Qwen2ForCausalLM"],
    hidden_size=3584, num_hidden_layers=28, num_attention_heads=28,
    num_key_value_heads=4, intermediate_size=18944, vocab_size=152064,
)

# Heterogeneous host menu (device kind, chips): the allocator's
# water-fill must keep working while hosts of different rooflines churn.
HW_MENU = (
    ("v5e", 4), ("v5e", 4), ("v5e", 2), ("v5p", 4), ("v5e", 1),
)

# Per-chip (bf16 TFLOPS, HBM GiB, HBM GB/s, ICI GB/s) of the menu's
# device kinds: the JAX package's ``utils/hw.TPU_CHIP_DB`` rows, copied so
# the replay runs the same fleet. They size the layer allocator's
# water-fill; nothing here runs on such a device.
CHIP_FIGURES: dict[str, tuple[float, float, float, float]] = {
    "v5e": (197.0, 16.0, 819.0, 186.0),
    "v5p": (459.0, 95.0, 2765.0, 200.0),
}


def _hardware(kind: str, chips: int) -> HardwareInfo:
    t, g, b, i = CHIP_FIGURES[kind]
    return HardwareInfo(kind, chips, t, g, b, i)


class VirtualClock:
    """Deterministic time source patched over the ``time`` module."""

    def __init__(self, start: float = 1_000.0):
        self.now = float(start)

    def monotonic(self) -> float:
        return self.now

    def time(self) -> float:
        # Arbitrary fixed wall anchor: journal record timestamps stay
        # deterministic across runs.
        return 1_700_000_000.0 + self.now

    def sleep(self, seconds: float) -> None:
        self.now += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        self.now += float(seconds)


@contextlib.contextmanager
def virtual_time(clock: VirtualClock):
    """Patch ``time.monotonic/time/perf_counter/sleep`` with the virtual
    clock. The harness drives everything synchronously on one thread, so
    nothing real blocks while time is frozen."""
    saved = (time.monotonic, time.time, time.perf_counter, time.sleep)
    time.monotonic = clock.monotonic
    time.time = clock.time
    time.perf_counter = clock.monotonic
    time.sleep = clock.sleep
    try:
        yield clock
    finally:
        (time.monotonic, time.time, time.perf_counter, time.sleep) = saved


class ChurnResult:
    """Outcome of one replay: the deterministic event log + counters."""

    def __init__(self) -> None:
        self.log: list[str] = []
        self.joined = 0
        self.left = 0
        self.killed = 0
        self.routed = 0
        self.route_failures = 0
        self.completed = 0
        self.promotion_epoch: int | None = None
        self.errors: list[str] = []

    @property
    def ok(self) -> bool:
        return not self.errors

    def event(self, t: float, kind: str, detail: str) -> None:
        self.log.append(f"{t:010.2f} {kind} {detail}")

    def fail(self, msg: str) -> None:
        self.errors.append(msg)


def _path_valid(scheduler, path: list[str]) -> str | None:
    """Routing-quality invariant: the path's nodes are live, allocated,
    and chain contiguously over the full layer range. Returns an error
    string, or None when valid."""
    if not path:
        return "empty path"
    expect = 0
    for nid in path:
        node = scheduler.manager.get(nid)
        if node is None:
            return f"routed through unknown node {nid}"
        if not node.has_allocation:
            return f"routed through unallocated node {nid}"
        if node.start_layer != expect:
            return (
                f"gap at {nid}: starts {node.start_layer}, expected "
                f"{expect}"
            )
        expect = node.end_layer
    total = scheduler.model.num_hidden_layers
    if expect != total:
        return f"path covers [0, {expect}) of {total} layers"
    return None


class ChurnHarness:
    """One deterministic replay. All state transitions are scripted from
    a seeded RNG against virtual time; the scheduler under test is the
    real one, driven through its synchronous twins (``drain_events`` /
    ``sweep_once`` / ``dispatch_once``)."""

    HEARTBEAT_S = 2.0
    TICK_S = 0.5

    def __init__(
        self,
        nodes: int = 220,
        seed: int = 7,
        duration_s: float = 240.0,
        journal_path: str | None = None,
        promote_at_s: float | None = 150.0,
        heartbeat_timeout_s: float = 12.0,
        routing: str = "rr",
        clock_start: float = 1_000.0,
    ):
        self.clock_start = float(clock_start)
        self.n_nodes = int(nodes)
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.journal_path = journal_path
        self.promote_at_s = promote_at_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.routing = routing

    # -- scripted swarm ----------------------------------------------------

    def run(self) -> ChurnResult:
        from parallax_tpu_torch.ha.journal import (
            StateJournal,
            install_journal,
            soft_state_fingerprint,
            state_fingerprint,
        )
        from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

        res = ChurnResult()
        rng = random.Random(self.seed)
        model = normalize_config(dict(DEFAULT_MODEL))
        clock = VirtualClock(self.clock_start)
        with virtual_time(clock):
            scheduler = GlobalScheduler(
                model, min_nodes_bootstrapping=2,
                routing=self.routing,
                heartbeat_timeout_s=self.heartbeat_timeout_s,
            )
            if self.journal_path:
                journal = StateJournal(
                    capacity=65536, sink_path=self.journal_path,
                    epoch=scheduler.epoch,
                )
                install_journal(scheduler, journal)
            # node_id -> {"hw": ..., "alive": bool, "beats": bool}
            fleet: dict[str, dict] = {}
            # harness-side heartbeat ledger: what the promoted standby's
            # soft state must replay to.
            hb_ledger: dict[str, dict] = {}
            in_flight: dict[str, list[str]] = {}
            # Requests enqueued but not yet resolved by the dispatcher.
            # The dispatcher RE-QUEUES unroutable requests until their
            # deadline, so resolution is observed via ``pr.event``, not
            # by assuming one ``dispatch_once`` serves the newest rid.
            pending: dict[str, object] = {}
            # Stagger every node's first join across the opening third.
            join_at = sorted(
                (rng.uniform(0.0, self.duration_s / 3.0), i)
                for i in range(self.n_nodes)
            )
            promoted = False
            next_rid = 0
            end = clock.now + self.duration_s
            t0 = clock.now

            def vt() -> float:
                return clock.now - t0

            def beat(nid: str, info: dict) -> None:
                load = len([
                    r for r, p in in_flight.items() if nid in p
                ])
                scheduler.enqueue_update(
                    nid, load=load, is_ready=True,
                    layer_latency_ms=rng.uniform(5.0, 40.0),
                    busy=False,
                )
                hb_ledger[nid] = {
                    "load": load, "ready": True, "busy": False,
                }
                info["last_beat"] = clock.now

            def settle(t: float) -> None:
                """Give the dispatcher a bounded number of turns (each
                pop may re-queue), then harvest every request whose
                event fired — routed or given up at deadline."""
                for _ in range(len(pending) + 1):
                    if not scheduler.dispatch_once():
                        break
                for rid in sorted(pending):
                    pr = pending[rid]
                    if not pr.event.is_set():
                        continue
                    del pending[rid]
                    if pr.path_ids:
                        err = _path_valid(scheduler, pr.path_ids)
                        if err:
                            res.fail(f"t={t:.1f} {rid}: {err}")
                        res.routed += 1
                        in_flight[rid] = list(pr.path_ids)
                        res.event(
                            t, "route",
                            f"{rid} -> {','.join(pr.path_ids)}",
                        )
                    else:
                        res.route_failures += 1
                        res.event(t, "route_fail", rid)

            while clock.now < end:
                t = vt()
                # 1) scripted joins
                while join_at and join_at[0][0] <= t:
                    _, i = join_at.pop(0)
                    nid = f"n{i:03d}"
                    kind, chips = HW_MENU[i % len(HW_MENU)]
                    info = {
                        "hw": _hardware(kind, chips),
                        "alive": True, "last_beat": clock.now,
                    }
                    fleet[nid] = info
                    scheduler.enqueue_join(nid, info["hw"])
                    res.joined += 1
                    res.event(t, "join", f"{nid} {kind}x{chips}")
                # 2) scripted churn: graceful leaves + silent kills
                live = [
                    n for n, s in fleet.items() if s["alive"]
                ]
                if len(live) > 8 and rng.random() < 0.25:
                    victim = rng.choice(sorted(live))
                    if rng.random() < 0.5:
                        scheduler.enqueue_leave(victim)
                        fleet[victim]["alive"] = False
                        hb_ledger.pop(victim, None)
                        res.left += 1
                        res.event(t, "leave", victim)
                    else:
                        # Silent kill: heartbeats just stop; the sweep
                        # must evict it after heartbeat_timeout_s.
                        fleet[victim]["alive"] = False
                        hb_ledger.pop(victim, None)
                        res.killed += 1
                        res.event(t, "kill", victim)
                # 3) heartbeats for live nodes
                for nid in sorted(fleet):
                    info = fleet[nid]
                    if not info["alive"]:
                        continue
                    if clock.now - info["last_beat"] >= self.HEARTBEAT_S:
                        beat(nid, info)
                # 4) drive the scheduler synchronously
                scheduler.drain_events()
                scheduler.sweep_once()
                scheduler.drain_events()
                # 5) routing traffic once bootstrapped
                if scheduler.bootstrapped.is_set() and rng.random() < 0.8:
                    rid = f"r{next_rid:05d}"
                    next_rid += 1
                    pending[rid] = scheduler.receive_request(rid)
                settle(t)
                # 6) finish a few in-flight requests (release charges)
                for rid in sorted(in_flight)[:4]:
                    if rng.random() < 0.6:
                        scheduler.complete_request(in_flight.pop(rid))
                        res.completed += 1
                # 7) the HA act: kill the primary, promote the standby
                if (
                    not promoted
                    and self.promote_at_s is not None
                    and self.journal_path
                    and t >= self.promote_at_s
                ):
                    promoted = True
                    # Flush one full heartbeat round first: the journal
                    # replicates soft state ONLY through hb records (in-
                    # flight dispatch charges are deliberately local),
                    # so the replay-window equivalence proof is defined
                    # at a heartbeat boundary — exactly the bounded
                    # window a real standby re-derives from.
                    for nid in sorted(fleet):
                        if fleet[nid]["alive"]:
                            beat(nid, fleet[nid])
                    scheduler.drain_events()
                    scheduler, epoch = self._promote(
                        scheduler, model, clock, res, t,
                        state_fingerprint, soft_state_fingerprint,
                        hb_ledger,
                    )
                    res.promotion_epoch = epoch
                    # Unresolved requests fail over with the clients:
                    # re-submit them against the promoted scheduler
                    # (mirrors SwarmClient._route_any's retry).
                    resub = sorted(pending)
                    pending.clear()
                    for rid in resub:
                        pending[rid] = scheduler.receive_request(rid)
                        res.event(t, "resubmit", rid)
                clock.advance(self.TICK_S)

            # Drain: let stragglers route or hit their deadline (the
            # dispatcher's retry ladder runs on virtual time), finish
            # everything in flight, then check the router's load ledger
            # drops to zero (no leaked charges).
            guard = 0
            while pending and guard < 100:
                guard += 1
                scheduler.drain_events()
                settle(vt())
                clock.advance(self.TICK_S)
            if pending:
                res.fail(f"{len(pending)} requests never resolved")
            for rid in sorted(in_flight):
                scheduler.complete_request(in_flight.pop(rid))
                res.completed += 1
            leaked = sum(
                n.load for n in scheduler.manager.nodes()
            )
            if leaked:
                res.fail(f"{leaked} load charges leaked after drain")
            if res.routed == 0:
                res.fail("no request ever routed")
            if (
                self.promote_at_s is not None
                and self.journal_path
                and res.promotion_epoch is None
            ):
                res.fail("promotion never happened")
        return res

    def _promote(
        self, scheduler, model, clock, res, t,
        state_fingerprint, soft_state_fingerprint, hb_ledger,
    ):
        """Kill the primary; stand up a mirror from the journal file;
        promote; assert field-by-field state equivalence."""
        from parallax_tpu_torch.ha.standby import StandbyScheduler
        from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

        want_hard = state_fingerprint(
            scheduler, include_soft=False, include_journal_only=True,
        )
        want_soft = soft_state_fingerprint(scheduler)
        mirror = GlobalScheduler(
            model, min_nodes_bootstrapping=2,
            routing=self.routing,
            heartbeat_timeout_s=self.heartbeat_timeout_s,
            passive=True,
        )
        standby = StandbyScheduler(
            mirror, journal_path=self.journal_path,
            lease_s=6.0, auto_promote=False,
        )
        standby.sync_once()
        # The primary is "dead" now: fence it so a stray late apply
        # cannot mutate, then promote the mirror (threads stay off —
        # the harness keeps driving synchronously).
        scheduler.fence(scheduler.epoch + 1)
        epoch = standby.promote(start_threads=False)
        got_hard = state_fingerprint(
            mirror, include_soft=False, include_journal_only=True,
        )
        got_soft = soft_state_fingerprint(mirror)
        if got_hard != want_hard:
            res.fail(
                "promoted state != primary state at death: "
                + _first_diff(want_hard, got_hard)
            )
        # Soft-state equivalence is defined over the heartbeat ledger's
        # keys: silently-killed nodes the sweep has not evicted yet are
        # stale on BOTH sides by definition (their beats stopped), so
        # they prove nothing about the replay window.
        ledger_soft = {nid: dict(v) for nid, v in hb_ledger.items()}
        for label, fp in (("primary", want_soft), ("promoted", got_soft)):
            view = {nid: fp.get(nid) for nid in ledger_soft}
            if view != ledger_soft:
                res.fail(
                    f"{label} soft state != heartbeat ledger: "
                    + _first_diff(ledger_soft, view)
                )
        res.event(t, "promote", f"epoch={epoch} nodes={len(ledger_soft)}")
        return mirror, epoch


def _first_diff(want, got) -> str:
    """Human-readable first divergence between two fingerprint dicts."""
    if isinstance(want, dict) and isinstance(got, dict):
        for k in sorted(set(want) | set(got), key=str):
            if k not in want:
                return f"unexpected key {k!r}"
            if k not in got:
                return f"missing key {k!r}"
            if want[k] != got[k]:
                sub = _first_diff(want[k], got[k])
                return f"{k!r}.{sub}" if "." in sub or "=" in sub else (
                    f"{k!r}: want {want[k]!r} got {got[k]!r}"
                )
        return "equal?"
    return f"want {want!r} got {got!r}"


def run_churn(
    nodes: int = 220, seed: int = 7, duration_s: float = 240.0,
    journal_path: str | None = None, promote_at_s: float | None = 150.0,
    routing: str = "rr", clock_start: float = 1_000.0,
) -> ChurnResult:
    """Library entry point (the tests call this)."""
    return ChurnHarness(
        nodes=nodes, seed=seed, duration_s=duration_s,
        journal_path=journal_path, promote_at_s=promote_at_s,
        routing=routing, clock_start=clock_start,
    ).run()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="virtual-time swarm churn replay"
    )
    ap.add_argument("--nodes", type=int, default=220)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--duration-s", type=float, default=240.0)
    ap.add_argument(
        "--no-promotion", action="store_true",
        help="churn only: skip the kill-primary/promote-standby act",
    )
    ap.add_argument(
        "--check-determinism", action="store_true",
        help="replay the trace twice and require identical event logs",
    )
    args = ap.parse_args(argv)

    import os
    import tempfile

    def one_run() -> ChurnResult:
        if args.no_promotion:
            return run_churn(
                nodes=args.nodes, seed=args.seed,
                duration_s=args.duration_s, journal_path=None,
                promote_at_s=None,
            )
        fd, path = tempfile.mkstemp(prefix="churn-journal-", suffix=".jsonl")
        os.close(fd)
        try:
            return run_churn(
                nodes=args.nodes, seed=args.seed,
                duration_s=args.duration_s, journal_path=path,
            )
        finally:
            os.unlink(path)

    wall0 = time.monotonic()
    res = one_run()
    if args.check_determinism:
        res2 = one_run()
        if res.log != res2.log:
            n = next(
                (i for i, (a, b) in enumerate(zip(res.log, res2.log))
                 if a != b),
                min(len(res.log), len(res2.log)),
            )
            res.fail(
                f"replay diverged at event {n}: "
                f"{res.log[n:n + 1]} vs {res2.log[n:n + 1]}"
            )
    wall = time.monotonic() - wall0
    print(
        f"churn: {res.joined} joins, {res.left} leaves, "
        f"{res.killed} kills, {res.routed} routed "
        f"({res.route_failures} unroutable), {res.completed} completed, "
        f"promotion_epoch={res.promotion_epoch}, "
        f"{len(res.log)} events, {wall:.1f}s wall"
    )
    for e in res.errors:
        print(f"FAIL: {e}")
    return 1 if res.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
