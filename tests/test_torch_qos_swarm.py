"""The port's QoS plane across a swarm, on the CPU, with the port's and the
JAX package's schedulers and workers (tests/_torch_disagg.py's swarms; a
swarm that mixes the packages runs over TCP on localhost).

- The pool autoscaler's live re-role (tests/test_qos.py::
  test_autoscaler_reroles_live_swarm_with_zero_aborts): a prefill-starved
  swarm of port workers re-roles a decode pipeline to prefill, the worker
  adopts the role from its heartbeat reply in place (no reload), its
  in-flight decodes drain through the handoff to the other decode
  pipeline, and nothing aborts, under the port scheduler and under a JAX
  scheduler. ``cluster_status``'s ``qos`` section shows the re-role.
- The cluster shed verdict (``qos_shed``) reaches a port worker's
  controller from either scheduler, and a JAX worker's from the port's.
- A JAX head's QoS-tagged FORWARD packets pass through a port tail,
  whose mirrors take the head's classes.
- The HA snapshot's ``qos`` section replays across the packages.
"""

import dataclasses
import threading

import pytest

from tests._torch_disagg import (
    GEN,
    request_set,
    serve,
    swarm,
    wait_for,
)
from tests._torch_qos import PKGS

# Any queued prompt saturates the prefill pool; any decode load under
# half the pool's capacity marks it idle. The cooldown allows one action.
AUTOSCALE = dict(autoscale=True, autoscale_interval_s=0.2,
                 autoscale_cooldown_s=600.0, autoscale_util_high=1e-9,
                 autoscale_util_low=0.5)


def _status_qos(sched):
    return sched.cluster_status().get("qos") or {}


@pytest.mark.parametrize("sched_kind", ["port", "jax"])
def test_autoscaler_reroles_live_swarm_with_zero_aborts(sched_kind):
    from parallax_tpu_torch.runtime.request import SamplingParams

    chatty = request_set(2, gen=160)
    with swarm([("port", "prefill"), ("port", "decode"),
                ("port", "decode")], sched=sched_kind, qos="on",
               sched_qos=dict(AUTOSCALE, autoscale_util_high=2.0)) as (
            sched, _svc, client, workers):
        engines = {w.node_id: w.engine for w in workers}
        # Two long sessions, handed off one to each decode pipeline.
        done = []

        def run_chatty(i):
            done.append(serve(client, f"chat{i}", [chatty[i]],
                              qos_class="interactive"))

        threads = []
        for i in range(2):
            t = threading.Thread(target=run_chatty, args=(i,))
            t.start()
            threads.append(t)
            assert wait_for(lambda: sum(
                w.handoff_stats.handoffs.get("kv_image", 0)
                for w in workers[1:]) >= i + 1, timeout=60.0)
        decode_loads = sorted(w.engine.scheduler.num_requests()
                              for w in workers[1:])
        # Arm the autoscaler now (no utilization reaches 2.0), then flood
        # prompts at the prefill pool.
        assert sched.autoscaler.stats["reroles"] == 0
        if sched_kind == "jax":
            # The JAX autoscaler counts its cooldown from clock 0, so on a
            # host up for less than the cooldown its first action waits
            # (ROADMAP queue 3; the port counts from its last action).
            sched.autoscaler._last_action = float("-inf")
        sched.autoscaler.config = dataclasses.replace(
            sched.autoscaler.config,
            autoscale_util_high=AUTOSCALE["autoscale_util_high"])
        flood = [([11 + i, 12, 13, 14] * 4,
                  SamplingParams(temperature=0.0, max_new_tokens=1,
                                 ignore_eos=True)) for i in range(24)]
        stop = threading.Event()
        flooded = []

        def run_flood():
            for j in range(0, len(flood), 4):
                if stop.is_set():
                    return
                flooded.extend(serve(client, f"flood{j}", flood[j:j + 4],
                                     qos_class="batch"))

        ft = threading.Thread(target=run_flood)
        ft.start()
        try:
            assert wait_for(
                lambda: _status_qos(sched).get("autoscaler", {}).get(
                    "reroles", 0) >= 1, timeout=60.0, interval=0.1), \
                _status_qos(sched)
        finally:
            stop.set()
            ft.join(120.0)
        # The worker adopted the role in place: same engine, no reload.
        assert wait_for(lambda: sum(w.role == "prefill"
                                    for w in workers) == 2, timeout=20.0), \
            [w.role for w in workers]
        assert {w.node_id: w.engine for w in workers} == engines
        roles = sorted(p.role for p in sched.manager.pipelines)
        assert roles == ["decode", "prefill", "prefill"]
        action = _status_qos(sched)["autoscaler"]["last_action"]
        assert action["direction"] == "decode->prefill"
        for t in threads:
            t.join(120.0)
        reqs = [r for batch in done for r in batch] + flooded
        aborted = [r.request_id for r in reqs
                   if r.status.value == "finished_abort"]
        assert aborted == []
        assert all(len(r.output_ids) == 160 for b in done for r in b)
        assert all(r.status.value == "finished_length" for r in reqs)
        # Both decode pipelines held a session when the re-role fired:
        # the re-roled one drained it through the handoff.
        assert decode_loads == [1, 1]
        rerolled = next(w for w in workers[1:] if w.role == "prefill")
        survivor = next(w for w in workers[1:] if w.role == "decode")
        assert rerolled.handoff_stats.transfer_frames["out"] > 0
        assert sum(survivor.handoff_stats.handoffs.values()) >= 2, \
            survivor.handoff_stats.handoffs


@pytest.mark.parametrize("sched_kind,worker_kind", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_qos_shed_verdict_reaches_the_workers_controller(sched_kind,
                                                         worker_kind):
    with swarm([(worker_kind, None)], sched=sched_kind, qos="on",
               sched_qos={}) as (sched, _svc, _client, (worker,)):
        pol = worker.engine.scheduler.qos
        assert pol is not None and not pol.controller.remote_shed
        sched.qos_controller.shedding = True
        assert wait_for(lambda: pol.controller.remote_shed, timeout=10.0)
        assert pol.controller.active and pol.payload()["admission"][
            "shedding_remote"]
        sched.qos_controller.shedding = False
        assert wait_for(lambda: not pol.controller.remote_shed,
                        timeout=10.0)
        st = _status_qos(sched)
        assert st["enabled"] and st["autoscaler"] == {"enabled": False}


def test_jax_head_tagged_packets_pass_through_a_port_tail():
    from parallax_tpu.runtime.request import Request as JRequest
    from parallax_tpu.runtime.request import SamplingParams as JSampling
    from tests.test_torch_swarm import ENGINE, _serve
    from tests.test_torch_swarm import swarm as gossip_swarm

    prompts = [[1, 2, 3, 4, 5, 6, 7], [3] * 20, [200, 17, 5, 99, 31]]
    classes = ["batch", "interactive", "batch"]
    with gossip_swarm(("jax", "port"),
                      engine=dict(ENGINE, qos="on")) as (head, tail):
        reqs = [JRequest(f"q{i}", prompt_ids=list(p), qos_class=c,
                         sampling_params=JSampling(max_new_tokens=8,
                                                   temperature=0.0))
                for i, (p, c) in enumerate(zip(prompts, classes))]
        _serve(head, reqs)
        got = tail.engine.scheduler.qos.counters["admitted"]
        want = head.engine.scheduler.qos.counters["admitted"]
    assert got == {"batch": 2, "interactive": 1}
    assert want == got


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax"),
                                     ("port", "port")])
def test_ha_snapshot_qos_section_replays(src, dst):
    import parallax_tpu.ha.journal as j_journal
    import parallax_tpu.scheduling.scheduler as j_sched
    import parallax_tpu_torch.ha.journal as p_journal
    import parallax_tpu_torch.scheduling.scheduler as p_sched

    mods = {"jax": (j_sched, j_journal), "port": (p_sched, p_journal)}

    def scheduler(kind, passive=False):
        sched_mod = mods[kind][0]
        pkg = PKGS[kind]
        return sched_mod.GlobalScheduler(
            pkg.cfg, passive=passive, qos=pkg.qos.parse_qos_spec("on"))

    primary = scheduler(src)
    primary.qos_controller.shedding = True
    primary.qos_controller.last_burn = 3.25
    snap = mods[src][1].snapshot_state(primary)
    assert snap["qos"] == {"shedding": True, "last_burn": 3.25}
    mirror = scheduler(dst, passive=True)
    mods[dst][1].restore_state(mirror, snap)
    assert mirror.qos_controller.shedding is True
    assert mirror.qos_controller.last_burn == 3.25
    assert mods[dst][1].snapshot_state(mirror)["qos"] == snap["qos"]


def test_serve_streams_unchanged_by_qos_on_a_swarm():
    """QoS on every worker changes no stream of a prefill + decode pair."""
    requests = request_set()
    with swarm([("port", "prefill"), ("port", "decode")]) as (
            _s, _svc, client, _w):
        base = [r.output_ids for r in serve(client, "off", requests)]
    with swarm([("port", "prefill"), ("port", "decode")], qos="on",
               sched_qos={}) as (_s, _svc, client, _w):
        reqs = serve(client, "on", requests, qos_class="batch")
    assert [r.output_ids for r in reqs] == base
    assert all(len(r.output_ids) == GEN for r in reqs)
