"""The port's fault-injection and churn harnesses
(``parallax_tpu_torch/testing/{chaos,churn}.py``) against the JAX
package's, on the CPU.

- ``ChaosController`` over the port's transports: drop, delay, kill,
  hang and slow, each failing or pausing exactly the frames it names;
  seeded probabilistic rules make the same decisions run after run, and
  the same decisions as the JAX controller with the same seed. The
  sanitizers the JAX controller turns on wait for ROADMAP item 14 and are
  refused by name.
- The port copy of tests/test_health_plane.py::TestWatchdog::
  test_sender_stall_under_chaos_hang.
- The churn replay (220 nodes, a primary killed and a standby promoted
  mid-trace over the port's GlobalScheduler, StateJournal and
  StandbyScheduler): ``ok``, the same log twice, the same log at virtual
  clock origins 1.0 and 1e9 (every clock it reaches is read at call
  time), and the same log as the JAX harness once the JAX node's
  import-bound heartbeat stamp is read at call time too. The CLI's
  ``--check-determinism`` passes.
"""

import os
import subprocess
import sys
import time

import pytest

import parallax_tpu.p2p.transport as j_transport
import parallax_tpu.testing.chaos as j_chaos
import parallax_tpu_torch.p2p.transport as p_transport
import parallax_tpu_torch.testing.chaos as p_chaos
import parallax_tpu_torch.testing.churn as p_churn
from parallax_tpu_torch.obs.registry import MetricsRegistry
from parallax_tpu_torch.obs.watchdog import StallWatchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(chaos, transport_mod=p_transport):
    reg: dict = {}
    got = []
    rx = transport_mod.LoopbackTransport("rx", reg)
    rx.register("blob", lambda peer, payload: got.append(payload) or "ok")
    tx = chaos.wrap(transport_mod.LoopbackTransport("tx", reg))
    return tx, got


def _outcomes(tx, n=64):
    out = []
    for i in range(n):
        try:
            tx.call("rx", "blob", {"i": i}, timeout=2.0)
            out.append(1)
        except Exception:   # noqa: BLE001 (an injected drop)
            out.append(0)
    return out


# -- frame faults -------------------------------------------------------------


def test_drop_rule_matches_method_peer_and_budget():
    chaos = p_chaos.ChaosController(seed=0)
    tx, got = _pair(chaos)
    rule = chaos.drop_frames(method="blob", dst="rx", limit=3)
    assert _outcomes(tx, 5) == [0, 0, 0, 1, 1]
    assert rule.hits == 3 and chaos.stats["dropped"] == 3
    assert [p["i"] for p in got] == [3, 4]
    chaos.clear_rules()
    chaos.drop_frames(method="other")
    assert _outcomes(tx, 2) == [1, 1]
    with pytest.raises(p_transport.TransportError):
        chaos.drop_frames(src="tx")
        tx.call("rx", "blob", {}, timeout=1.0)


def test_seeded_drops_replay_and_match_the_jax_controller():
    runs = []
    for _ in range(2):
        chaos = p_chaos.ChaosController(seed=42)
        tx, _got = _pair(chaos)
        chaos.drop_frames(method="blob", p=0.5)
        runs.append(_outcomes(tx))
    jchaos = j_chaos.ChaosController(seed=42, lock_sanitizer=False,
                                     conformance=False)
    jtx, _got = _pair(jchaos, j_transport)
    jchaos.drop_frames(method="blob", p=0.5)
    assert runs[0] == runs[1] == _outcomes(jtx)
    assert 0 < sum(runs[0]) < len(runs[0])


def test_delay_and_slow_pay_their_latency():
    chaos = p_chaos.ChaosController(seed=1)
    tx, got = _pair(chaos)
    chaos.delay_frames(0.2, method="blob", limit=1)
    t0 = time.monotonic()
    tx.call("rx", "blob", {"i": 0})
    assert time.monotonic() - t0 >= 0.2 and chaos.stats["delayed"] == 1
    t0 = time.monotonic()
    tx.call("rx", "blob", {"i": 1})
    assert time.monotonic() - t0 < 0.2
    chaos.slow("rx", 0.15)
    t0 = time.monotonic()
    tx.send("rx", "blob", {"i": 2})
    assert time.monotonic() - t0 >= 0.15
    chaos.slow("rx", 0.0)
    assert [p["i"] for p in got] == [0, 1, 2]


def test_hang_blocks_then_fails_past_the_timeout():
    chaos = p_chaos.ChaosController(seed=2)
    tx, got = _pair(chaos)
    chaos.hang("rx", 0.3)
    t0 = time.monotonic()
    tx.call("rx", "blob", {"i": 0}, timeout=5.0)    # waits the hang out
    assert time.monotonic() - t0 >= 0.25
    chaos.hang("rx", 2.0)
    with pytest.raises(p_transport.TransportError, match="hung"):
        tx.call("rx", "blob", {"i": 1}, timeout=0.2)
    assert [p["i"] for p in got] == [0]


def test_kill_severs_a_worker_both_ways():
    class Worker:
        node_id = "rx"
        stopped = False

        def stop(self):
            self.stopped = True

    chaos = p_chaos.ChaosController(seed=3)
    tx, _got = _pair(chaos)
    w = Worker()
    chaos.kill(w)
    assert w.stopped and chaos.is_dead("rx")
    with pytest.raises(p_transport.TransportError, match="dead"):
        tx.call("rx", "blob", {})
    assert chaos.stats["severed_calls"] == 1
    # Idempotent wrap.
    assert chaos.wrap(tx) is tx


def test_sanitizers_are_refused_as_item_14():
    for kw in (dict(lock_sanitizer=True), dict(conformance=True)):
        with pytest.raises(NotImplementedError, match=r"item 14\)"):
            p_chaos.ChaosController(seed=0, **kw)
    chaos = p_chaos.ChaosController(seed=0)
    for report in (chaos.lock_report, chaos.conformance_report):
        with pytest.raises(NotImplementedError, match=r"item 14\)"):
            report()


# -- the watchdog under a chaos hang -----------------------------------------


def test_sender_stall_under_chaos_hang():
    """Frames to a hung peer block the sender's worker: the watchdog's
    sender probe walks degraded -> stalled while the hang lasts and
    recovers after."""
    chaos = p_chaos.ChaosController(seed=3)
    reg: dict = {}
    rx = p_transport.LoopbackTransport("rx", reg)
    rx.register("blob", lambda peer, payload: "ok")
    tx = chaos.wrap(p_transport.LoopbackTransport("tx", reg))
    sender = p_transport.AsyncSender(tx, max_queue=64)
    try:
        chaos.hang("rx", 1.2)
        for _ in range(8):
            sender.send("rx", "blob", {"x": 1}, best_effort=True)
        clk = [1000.0]
        wd = StallWatchdog(node_id="tx", degraded_after_s=0.3,
                           stalled_after_s=0.6, registry=MetricsRegistry(),
                           clock=lambda: clk[0])

        def probe():
            stats = sender.stats()
            pending = sum(s.get("queue_depth", 0) for s in stats.values())
            progress = sum(s.get("frames_out", 0) + s.get("drops", 0)
                           + s.get("errors", 0) for s in stats.values())
            return float(pending), float(progress), ""

        wd.register("sender", probe)
        time.sleep(0.15)    # let the worker block inside the hang
        wd.poll_once()      # baseline
        assert wd.summary()["components"]["sender"]["state"] == "ok"
        clk[0] += 0.4
        wd.poll_once()
        assert wd.summary()["components"]["sender"]["state"] == "degraded"
        clk[0] += 0.4
        wd.poll_once()
        summary = wd.summary()
        assert summary["components"]["sender"]["state"] == "stalled"
        assert summary["causes"]
        deadline = time.monotonic() + 5.0
        recovered = False
        while time.monotonic() < deadline:
            clk[0] += 0.2
            wd.poll_once()
            if wd.summary()["components"]["sender"]["state"] == "ok":
                recovered = True
                break
            time.sleep(0.05)
        assert recovered
    finally:
        sender.close()


# -- the churn replay ---------------------------------------------------------


def _replay(tmp_path, name, **kw):
    path = str(tmp_path / f"{name}.jsonl")
    return p_churn.run_churn(journal_path=path, **kw)


@pytest.fixture(scope="module")
def base_replay(tmp_path_factory):
    return _replay(tmp_path_factory.mktemp("churn"), "base")


def test_churn_replay_is_deterministic(tmp_path, base_replay):
    a = base_replay
    b = _replay(tmp_path, "b")
    assert a.ok, a.errors
    assert a.log == b.log
    assert a.promotion_epoch == 2 and a.routed > 0
    assert a.completed == a.routed and a.route_failures == 0
    assert a.joined == 220 and a.left > 0 and a.killed > 0


@pytest.mark.parametrize("origin", [1.0, 1e9])
def test_churn_replay_does_not_depend_on_the_clock_origin(tmp_path, origin,
                                                         base_replay):
    """Every clock the harness reaches is read at call time: a node's
    first heartbeat stamp and a pending request's enqueue time follow
    the virtual clock, so the log is the same whatever its origin (and
    the host's uptime)."""
    got = _replay(tmp_path, "o", clock_start=origin)
    assert got.ok, got.errors
    assert got.log == base_replay.log


def test_churn_replay_matches_the_jax_harness(tmp_path, monkeypatch,
                                              base_replay):
    """The JAX harness replays the same trace over the JAX control plane
    once its node's heartbeat stamp and pending request's enqueue time
    are read at call time (the fault the port fixed in its own copy):
    the two logs are equal line for line."""
    import parallax_tpu.scheduling.node as j_node
    import parallax_tpu.scheduling.scheduler as j_sched
    import parallax_tpu.testing.churn as j_churn

    for cls, field in ((j_node.Node, "last_heartbeat"),
                       (j_sched.PendingRequest, "enqueue_time")):
        init = cls.__init__

        def stamped(self, *a, _init=init, _field=field, **kw):
            _init(self, *a, **kw)
            if _field not in kw:
                setattr(self, _field, time.monotonic())

        monkeypatch.setattr(cls, "__init__", stamped)
    want = j_churn.run_churn(journal_path=str(tmp_path / "j.jsonl"))
    assert want.ok, want.errors
    assert base_replay.log == want.log


def test_churn_cli_checks_determinism():
    res = subprocess.run(
        [sys.executable, "-m", "parallax_tpu_torch.testing.churn",
         "--check-determinism", "--nodes", "60", "--duration-s", "180",
         "--seed", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "promotion_epoch=2" in res.stdout and "FAIL" not in res.stdout


def test_harness_stays_off_the_serving_path():
    """Nothing the serving path imports pulls the test-support layer in."""
    code = ("import sys; import parallax_tpu_torch.backend.serve, "
            "parallax_tpu_torch.backend.run, parallax_tpu_torch.p2p.join; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('parallax_tpu_torch.testing')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
