"""The port's QoS units (``parallax_tpu_torch/qos``, the local scheduler's
QoS hooks, the class's propagation, the router's fairness term and the
pool autoscaler) against ``parallax_tpu``, on the CPU.

The classes of tests/test_qos.py run against both packages on the same
inputs, and what each package computes must be equal: parsed configs and
error texts, order keys, controller verdicts over one fake clock,
scheduler admissions and counters, wire payloads, routing choices and
``pool_report``.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from tests._torch_qos import HW, PAGE, PKGS, RAW

BOTH = ["jax", "port"]


def _both(fn):
    """``fn(pkg)`` on each package; the two results must be equal."""
    out = {name: fn(PKGS[name]) for name in BOTH}
    assert out["port"] == out["jax"]
    return out["port"]


def _error(fn):
    try:
        fn()
    except Exception as e:   # noqa: BLE001 (the type and text compared)
        return type(e).__name__, str(e)
    return None


# -- spec + HTTP parsing -----------------------------------------------------


class TestSpec:
    SPECS = [None, "", "off", "0", "false", "none", "on",
             "interactive_ms=500,batch_ms=60000,shed_burn=3,"
             "release_burn=0.5,starvation_s=4,autoscale=1,gold_ms=2000",
             "agent_sheddable=1,min_burn_samples=3,default_class=agent",
             "interactive_ms=200,tick_interval_s=0.0,starvation_s=60"]
    BAD = ["interactive=500", "nope_s=1", "shed_burn=x",
           "shed_burn=1,release_burn=2", "zzz_sheddable=1",
           "default_class=gold"]

    @pytest.mark.parametrize("spec", SPECS)
    def test_parsed_configs_equal(self, spec):
        _both(lambda p: None if p.qos.parse_qos_spec(spec) is None
              else dataclasses.asdict(p.qos.parse_qos_spec(spec)))

    @pytest.mark.parametrize("spec", BAD)
    def test_malformed_specs_raise_the_same_error(self, spec):
        err = _both(lambda p: _error(lambda: p.qos.parse_qos_spec(spec)))
        assert err is not None

    def test_class_of_degrades_unknown_to_default(self):
        got = _both(lambda p: [
            p.qos.parse_qos_spec("on").class_of(c).name
            for c in ("batch", None, "from-the-future")])
        assert got == ["batch", "interactive", "interactive"]

    def test_qos_from_http(self):
        cases = [
            ({}, {}),
            ({"x-parallax-qos-class": "batch",
              "x-parallax-deadline-ms": "2500",
              "x-parallax-tenant": "acme"}, {}),
            ({}, {"qos_class": "agent", "deadline_ms": 800, "tenant": "t2"}),
            ({"x-parallax-qos-class": "gold"}, {}),
            ({}, {"deadline_ms": -1}),
            ({"x-parallax-deadline-ms": "soon"}, {}),
        ]

        def run(p):
            cfg = p.qos.parse_qos_spec("on")
            return [_error(lambda: p.qos.qos_from_http(h, b, cfg))
                    or p.qos.qos_from_http(h, b, cfg) for h, b in cases]

        got = _both(run)
        assert got[1] == ("batch", 2500.0, "acme")


# -- EDF order key -----------------------------------------------------------


def _req(p, rid, qos_class=None, deadline=None, arrival=None):
    r = p.request.Request(rid, prompt_ids=[1, 2, 3], qos_class=qos_class,
                          deadline=deadline)
    if arrival is not None:
        r.arrival_time = arrival
    return r


class TestOrderKey:
    # (class, explicit deadline offset, arrival offset) at now = 100.
    ROWS = [("batch", None, -1.0), ("interactive", None, 0.0),
            ("batch", 0.1, 0.0), ("batch", None, -11.0),
            ("batch", None, -30.0), (None, None, 0.0), ("agent", 2.0, -3.0)]

    @pytest.mark.parametrize("guard", [True, False])
    def test_order_keys_equal(self, guard):
        def run(p):
            pol = p.qos.QoSPolicy(p.qos.parse_qos_spec("on"),
                                  stage_name=f"{p.name}-order")
            now = 100.0
            reqs = [_req(p, f"r{i}", c,
                         None if d is None else now + d, now + a)
                    for i, (c, d, a) in enumerate(self.ROWS)]
            keys = [pol.order_key(r, now, guard=guard) for r in reqs]
            order = [r.request_id for r in sorted(
                reqs, key=lambda r: pol.order_key(r, now, guard=guard))]
            return keys, order

        keys, order = _both(run)
        if guard:
            # The starvation guard puts the old batch rows first.
            assert order[:2] == ["r4", "r3"]
        else:
            assert order[0] == "r2"


# -- admission controller ----------------------------------------------------


class TestController:
    def _script(self, p, spec, steps):
        """Drive a controller over a fake clock: each step is ("ttft", ms,
        n) / ("cum", under, total) / ("advance", s) / ("pressure", b) /
        ("remote", b) / ("tick",) / ("burn",); returns every read."""
        clock = {"t": 1000.0}
        cfg = p.qos.parse_qos_spec(spec)
        ctl = p.qos.AdmissionController(
            cfg, scope=f"{p.name}-ctl", clock=lambda: clock["t"])
        inter = cfg.class_named("interactive")
        batch = cfg.class_named("batch")
        out = []
        for s in steps:
            if s[0] == "ttft":
                for _ in range(s[2]):
                    ctl.observe_ttft(inter, s[1])
            elif s[0] == "batch_ttft":
                for _ in range(s[2]):
                    ctl.observe_ttft(batch, s[1])
            elif s[0] == "cum":
                ctl.observe_cumulative(s[1], s[2])
            elif s[0] == "advance":
                clock["t"] += s[1]
            elif s[0] == "pressure":
                ctl.set_queue_pressure(s[1])
            elif s[0] == "remote":
                ctl.set_remote(s[1])
            elif s[0] == "tick":
                out.append((ctl.tick(), ctl.shedding, ctl.active))
            elif s[0] == "burn":
                out.append(round(ctl.burn_rate(), 9))
        out.append(ctl.payload())
        return out

    SCRIPTS = {
        "burn-hysteresis": (
            "burn_window_s=10,min_shed_s=2,shed_burn=2,release_burn=1",
            [("ttft", 100.0, 10), ("tick",), ("ttft", 5000.0, 10), ("tick",),
             ("tick",), ("advance", 11.0), ("ttft", 50.0, 20), ("tick",)]),
        "min-shed-holds": (
            "burn_window_s=1,min_shed_s=60,shed_burn=2,release_burn=1",
            [("ttft", 9000.0, 5), ("tick",), ("advance", 5.0), ("burn",),
             ("tick",)]),
        "single-violation": (
            "min_burn_samples=5",
            [("ttft", 1e6, 1), ("burn",), ("tick",), ("ttft", 1e6, 5),
             ("tick",)]),
        "queue-pressure": ("on", [("pressure", True), ("tick",),
                                  ("pressure", False), ("advance", 3.0),
                                  ("tick",)]),
        "non-protected": ("on", [("batch_ttft", 1e9, 50), ("burn",)]),
        "cumulative": (
            "burn_window_s=10",
            [("cum", 100.0, 100), ("advance", 5.0), ("cum", 100.0, 200),
             ("burn",), ("advance", 1.0), ("cum", 50.0, 60),
             ("advance", 1.0), ("cum", 60.0, 70), ("burn",)]),
        "remote-or": ("on", [("tick",), ("remote", True), ("tick",),
                             ("remote", False), ("tick",)]),
    }

    @pytest.mark.parametrize("name", sorted(SCRIPTS))
    def test_verdicts_equal_over_one_fake_clock(self, name):
        spec, steps = self.SCRIPTS[name]
        out = _both(lambda p: [
            {k: v for k, v in o.items() if k != "scope"}
            if isinstance(o, dict) else o
            for o in self._script(p, spec, steps)])
        if name == "burn-hysteresis":
            assert out[-1]["sheds"] == out[-1]["releases"] == 1


# -- scheduler integration ---------------------------------------------------


def _cache(p, num_pages=64, host_bytes=0):
    """A cache manager, optionally with a host tier over a fake device."""
    if p.name == "jax":
        from parallax_tpu.runtime.cache_manager import CacheManager
        from parallax_tpu.runtime.host_cache import HostKVTier

        dev = np.zeros((num_pages, PAGE * 2), np.float32)

        def gather(ids):
            return [dev[np.asarray(ids)].copy()]

        def scatter(ids, layers):
            dev[np.asarray(ids)] = layers[0]

        nbytes = dev[0].nbytes
    else:
        from parallax_tpu_torch.runtime.cache_manager import CacheManager
        from parallax_tpu_torch.runtime.host_cache import HostKVTier

        dev = torch.zeros((num_pages, PAGE * 2), dtype=torch.float32)

        def gather(ids):
            return [dev[torch.tensor(ids)].clone()]

        def scatter(ids, layers):
            dev[torch.tensor(ids)] = torch.stack(list(layers[0]))

        nbytes = dev[0].numel() * dev.element_size()
    tier = (HostKVTier(host_bytes, nbytes, gather, scatter)
            if host_bytes else None)
    return CacheManager(PAGE, num_pages, enable_prefix_cache=False,
                        max_model_len=256, host_tier=tier)


class TestSchedulerQoS:
    def spec(self, p):
        return p.qos.parse_qos_spec(
            "interactive_ms=200,tick_interval_s=0.0,starvation_s=60")

    def enqueue(self, p, sched, rid, qos_class, arrival=None):
        r = p.request.Request(
            rid, prompt_ids=list(range(1, 9)),
            sampling_params=p.request.SamplingParams(max_new_tokens=16,
                                                     ignore_eos=True),
            qos_class=qos_class)
        if arrival is not None:
            r.arrival_time = arrival
        assert sched.enqueue(r)
        return r

    def decoding(self, p, *reqs):
        for r in reqs:
            r.num_computed_tokens = r.num_prompt_tokens
            r.status = p.request.RequestStatus.DECODING
            r.output_ids.append(5)
            r.ready_for_step = True

    def test_off_mode_admits_fcfs(self):
        def run(p):
            sched = p.rsched.Scheduler(_cache(p), max_batch_size=2)
            for rid, c in (("b1", "batch"), ("i1", "interactive"),
                           ("b2", "batch")):
                self.enqueue(p, sched, rid, c)
            sched.admit_requests()
            return list(sched.running)

        assert _both(run) == ["b1", "i1"]

    def test_edf_admits_interactive_first(self):
        def run(p):
            pol = p.qos.QoSPolicy(self.spec(p), stage_name=f"{p.name}-edf")
            sched = p.rsched.Scheduler(_cache(p), max_batch_size=2, qos=pol)
            now = time.monotonic()
            self.enqueue(p, sched, "b1", "batch", arrival=now - 1.0)
            self.enqueue(p, sched, "b2", "batch", arrival=now - 0.5)
            self.enqueue(p, sched, "i1", "interactive", arrival=now)
            sched.admit_requests()
            return sorted(sched.running), pol.counters

        running, counters = _both(run)
        assert running == ["b1", "i1"]
        assert counters["admitted"] == {"interactive": 1, "batch": 1}

    @pytest.mark.parametrize("remote", [False, True])
    def test_shed_holds_batch_and_releases(self, remote):
        def run(p):
            pol = p.qos.QoSPolicy(self.spec(p), stage_name=f"{p.name}-shed")
            sched = p.rsched.Scheduler(_cache(p), max_batch_size=4, qos=pol)
            if remote:
                pol.set_remote_shed(True)
            else:
                pol.controller.shedding = True
            self.enqueue(p, sched, "b1", "batch")
            self.enqueue(p, sched, "i1", "interactive")
            sched.admit_requests()
            held = sorted(sched.running)
            pol.controller.shedding = False
            pol.controller.remote_shed = False
            sched.admit_requests()
            return held, sorted(sched.running), pol.counters

        held, after, counters = _both(run)
        assert held == ["i1"] and after == ["b1", "i1"]
        assert counters["shed_held"] == {"batch": 1}

    def test_enforce_parks_running_batch_decodes(self):
        def run(p):
            pol = p.qos.QoSPolicy(self.spec(p), stage_name=f"{p.name}-park")
            sched = p.rsched.Scheduler(
                _cache(p, host_bytes=1 << 22), max_batch_size=4, qos=pol)
            b = self.enqueue(p, sched, "b1", "batch")
            i = self.enqueue(p, sched, "i1", "interactive")
            sched.admit_requests()
            self.decoding(p, b, i)
            pol.controller.shedding = True
            sched.admit_requests()
            parked = (b.status.value, "b1" in sched.wait_queue,
                      i.status.value, dict(pol.counters["parked"]))
            pol.controller.shedding = False
            sched.admit_requests()
            return parked, b.status.value, "b1" in sched.running

        parked, resumed, running = _both(run)
        assert parked == ("preempted", True, "decoding", {"batch": 1})
        assert resumed == "decoding" and running

    def test_enforce_without_tier_warns_once_and_holds_admissions_only(self):
        def run(p):
            pol = p.qos.QoSPolicy(self.spec(p),
                                  stage_name=f"{p.name}-notier")
            sched = p.rsched.Scheduler(_cache(p), max_batch_size=4, qos=pol)
            b = self.enqueue(p, sched, "b1", "batch")
            sched.admit_requests()
            b.num_computed_tokens = b.num_prompt_tokens
            b.status = p.request.RequestStatus.DECODING
            b.ready_for_step = True
            pol.controller.shedding = True
            sched.admit_requests()
            sched.admit_requests()
            return b.status.value, pol.counters["parked"], \
                pol._warned_no_tier

        assert _both(run) == ("decoding", {}, True)

    def test_in_flight_rows_never_park(self):
        """A decode row whose step or window is in flight (neither
        ``ready_for_step`` nor ``device_feed_ready``) stays running."""
        def run(p):
            pol = p.qos.QoSPolicy(self.spec(p),
                                  stage_name=f"{p.name}-inflight")
            sched = p.rsched.Scheduler(
                _cache(p, host_bytes=1 << 22), max_batch_size=4, qos=pol)
            b = self.enqueue(p, sched, "b1", "batch")
            sched.admit_requests()
            self.decoding(p, b)
            b.ready_for_step = False
            b.device_feed_ready = False
            pol.controller.shedding = True
            sched.admit_requests()
            return b.status.value, pol.counters["parked"]

        assert _both(run) == ("decoding", {})

    def test_batch_formation_orders_by_deadline(self):
        """Under a batch cap the decode rows with the least slack go
        first (guard off: old batch rows do not jump fresh interactive
        ones)."""
        def run(p):
            pol = p.qos.QoSPolicy(self.spec(p), stage_name=f"{p.name}-form")
            sched = p.rsched.Scheduler(_cache(p), max_batch_size=2, qos=pol)
            now = time.monotonic()
            rows = [self.enqueue(p, sched, rid, c, arrival=now - a)
                    for rid, c, a in (("b1", "batch", 30.0),
                                      ("b2", "batch", 20.0),
                                      ("i1", "interactive", 0.0))]
            sched.max_batch_size = 3
            sched.admit_requests()
            self.decoding(p, *rows)
            sched.max_batch_size = 2
            plan = sched.form_batch()
            return [s.request.request_id for s in plan.seqs]

        assert _both(run) == ["i1", "b1"]


# -- class propagation -------------------------------------------------------


class TestPropagation:
    def test_proto_roundtrip_carries_qos_byte_for_byte(self):
        from parallax_tpu.p2p import proto as jproto
        from parallax_tpu_torch.p2p import proto as pproto
        from parallax_tpu_torch.p2p import wire

        def wire_of(p, proto):
            ireq = p.request.IntermediateRequest(
                request_id="r1", routing_table=["a", "b"], context_len=4,
                num_new_tokens=4, token_ids=[1, 2, 3, 4], qos_class="agent")
            return proto.ireq_to_wire(ireq)

        jw, pw = wire_of(PKGS["jax"], jproto), wire_of(PKGS["port"], pproto)
        assert wire.packb(pw) == wire.packb(jw)
        assert pproto.ireq_from_wire(jw).qos_class == "agent"
        jw.pop("qos")
        assert pproto.ireq_from_wire(jw).qos_class is None

    def test_mirror_inherits_class_and_packets_carry_it(self):
        """A downstream stage's mirror takes the packet's class; a head of
        a 2-stage pipeline stamps its class on the packets it forwards."""
        from parallax_tpu_torch.runtime.engine import drive_step
        from tests._torch_qos import weights
        from tests.test_torch_engine import _stage
        from parallax_tpu_torch.models import (
            create_stage_model,
            params_from_numpy,
        )

        p = PKGS["port"]
        _full, full_np = weights()

        def stage(s, e):
            return p.engine.StageEngine(
                create_stage_model(p.cfg, s, e),
                params_from_numpy(_stage(full_np, s, e), "cpu"),
                p.engine.EngineConfig(page_size=PAGE, num_pages=32,
                                      max_batch_size=2, max_model_len=128,
                                      kv_dtype="float32"),
                device="cpu")

        tail = stage(2, 4)
        tail.submit_intermediate(p.request.IntermediateRequest(
            request_id="m1", routing_table=[], context_len=4,
            num_new_tokens=4, token_ids=[1, 2, 3, 4],
            sampling_params=p.request.SamplingParams().to_dict(),
            is_last_chunk=False, qos_class="batch"))
        req = (tail.scheduler.wait_queue.get("m1")
               or tail.scheduler.running.get("m1"))
        assert req is not None and req.qos_class == "batch"
        head = stage(0, 2)
        r = p.request.Request(
            "fwd1", prompt_ids=list(range(1, 9)),
            sampling_params=p.request.SamplingParams(max_new_tokens=2),
            routing_table=["h", "t"], qos_class="interactive")
        assert head.submit(r)
        outs, pending = drive_step(head, None)
        if pending is not None:
            outs = list(outs) + list(drive_step(head, pending)[0])
        fwds = [i for o in outs for i in o.forward]
        assert fwds and all(i.qos_class == "interactive" for i in fwds)

    def test_swarm_client_ships_remaining_deadline(self):
        from parallax_tpu.backend.run import SwarmClient as JClient
        from parallax_tpu_torch.backend.run import SwarmClient as PClient

        for p, client in ((PKGS["jax"], JClient), (PKGS["port"], PClient)):
            r = p.request.Request("q1", prompt_ids=[1], qos_class="batch",
                                  deadline=time.monotonic() + 1.0,
                                  tenant_id="acme")
            out = client._qos_payload(r)
            assert out["qos_class"] == "batch" and out["tenant"] == "acme"
            assert 0.0 < out["deadline_ms"] <= 1000.0
            assert client._qos_payload(
                p.request.Request("q2", prompt_ids=[1])) == {}
        sub = PClient._submit_payload(
            PKGS["port"].request.Request("q3", prompt_ids=[1],
                                         qos_class="agent"), ["h"])
        assert sub["qos_class"] == "agent" and "deadline_ms" not in sub


# -- per-tenant routing fairness ---------------------------------------------


def _hw(p):
    return p.hw.HardwareInfo(*HW)


class TestTenantFairness:
    def replicas(self, p, num=2):
        mgr = p.mgmt.NodeManager(RAW["num_hidden_layers"])
        for i in range(num):
            n = p.node.Node(node_id=f"r{i}", hardware=_hw(p), model=p.cfg)
            n.set_layers(0, RAW["num_hidden_layers"])
            n.is_ready = True
            mgr.add(n)
            mgr.register_pipelines([p.mgmt.Pipeline(nodes=[n])])
        return mgr

    def meta(self, p, toks, tenant):
        return p.routing.RequestMeta("r", prompt_ids=list(toks),
                                     tenant_id=tenant)

    @pytest.mark.parametrize("gamma", [0.0, 10_000.0])
    def test_gamma_spreads_a_monopolizing_tenant(self, gamma):
        def run(p):
            if p.name == "jax":
                from parallax_tpu.runtime.radix_cache import block_hash_chain
            else:
                from parallax_tpu_torch.runtime.radix_cache import (
                    block_hash_chain,
                )
            toks = list(range(6 * PAGE))
            chain = block_hash_chain(toks, PAGE)
            mgr = self.replicas(p)
            router = p.routing.CacheAwareRouting(mgr, gamma=gamma)
            assert mgr.get("r0").cache_index.apply(
                {"seq": 0, "block": PAGE, "full": chain}) is False
            return [router.find_path(self.meta(p, toks, "acme"))[0].node_id
                    for _ in range(8)]

        chosen = _both(run)
        if gamma == 0.0:
            assert set(chosen) == {"r0"}
        else:
            assert "r1" in set(chosen)

    def test_untagged_requests_pay_no_fairness_cost(self):
        def run(p):
            router = p.routing.CacheAwareRouting(self.replicas(p),
                                                 gamma=10_000.0)
            paths = [[n.node_id for n in router.find_path(
                self.meta(p, list(range(16)), None))] for _ in range(4)]
            return paths, router._tenant_share

        paths, share = _both(run)
        assert share == {} and all(paths)


# -- pool autoscaler ---------------------------------------------------------


def _pool_manager(p, spec):
    mgr = p.mgmt.NodeManager(RAW["num_hidden_layers"])
    for nid, role, load in spec:
        n = p.node.Node(node_id=nid, hardware=_hw(p), model=p.cfg, role=role)
        n.set_layers(0, RAW["num_hidden_layers"])
        n.is_ready = True
        n.load = load
        mgr.add(n)
        mgr.register_pipelines([p.mgmt.Pipeline(nodes=[n])])
    return mgr


class TestAutoscaler:
    def config(self, p, **kw):
        base = dict(autoscale=True, autoscale_interval_s=0.0,
                    autoscale_cooldown_s=0.0, autoscale_util_high=0.5,
                    autoscale_util_low=0.25)
        base.update(kw)
        return dataclasses.replace(p.qos.parse_qos_spec("on"), **base)

    def _run(self, p, spec, saturate, fill=1.0, times=(0.0,), **kw):
        mgr = _pool_manager(p, spec)
        cap = mgr.get(saturate).max_concurrent_requests()
        mgr.get(saturate).load = int(cap * fill)
        clock = {"t": 100.0}
        scaler = p.qos.PoolAutoscaler(mgr, self.config(p, **kw),
                                      clock=lambda: clock["t"])
        actions = []
        for dt in times:
            clock["t"] += dt
            actions.append(scaler.tick())
        return (actions, sorted((n.node_id, n.role) for n in mgr.nodes()),
                p.qos.pool_report(mgr.pipelines), scaler.payload())

    CASES = {
        "reroles-idle-decode": ([("p0", "prefill", 0), ("d0", "decode", 0),
                                 ("d1", "decode", 0)], "p0", 1.0, (0.0,), {}),
        "never-empties-donor": ([("p0", "prefill", 0), ("d0", "decode", 0)],
                                "p0", 1.0, (0.0,), {}),
        "hysteresis-band": ([("p0", "prefill", 0), ("d0", "decode", 0),
                             ("d1", "decode", 0)], "p0", 0.4, (0.0,), {}),
        "cooldown": ([("p0", "prefill", 0), ("d0", "decode", 0),
                      ("d1", "decode", 0), ("d2", "decode", 0)], "p0", 1.0,
                     (0.0, 1.0, 60.0), {"autoscale_cooldown_s": 30.0}),
        "requires-both-pools": ([("m0", "mixed", 0), ("m1", "mixed", 0)],
                                "m0", 1.0, (0.0,), {}),
    }

    @pytest.mark.parametrize("name", sorted(CASES))
    def test_decisions_and_pool_report_equal(self, name):
        spec, sat, fill, times, kw = self.CASES[name]
        actions, roles, _pools, _payload = _both(
            lambda p: self._run(p, spec, sat, fill, times, **kw))
        done = [a for a in actions if a is not None]
        if name == "reroles-idle-decode":
            assert done[0]["direction"] == "decode->prefill"
            assert sorted(r for _n, r in roles) == [
                "decode", "prefill", "prefill"]
        elif name == "cooldown":
            assert [a is not None for a in actions] == [True, False, True]
        else:
            assert not done

    @pytest.mark.parametrize("origin", [0.5, 100.0, 1e6])
    def test_first_action_does_not_wait_for_the_clock_origin(self, origin):
        """The cooldown counts from the last action. The JAX autoscaler
        starts its last action at 0.0, so on a clock that reads less than
        the cooldown (a monotonic clock on a host up for less than it) its
        first action waits; the port's acts at its first tick whatever the
        clock's origin."""
        spec = [("p0", "prefill", 0), ("d0", "decode", 0),
                ("d1", "decode", 0)]
        got = {}
        for name in BOTH:
            p = PKGS[name]
            mgr = _pool_manager(p, spec)
            mgr.get("p0").load = mgr.get("p0").max_concurrent_requests()
            scaler = p.qos.PoolAutoscaler(
                mgr, self.config(p, autoscale_cooldown_s=600.0),
                clock=lambda: origin)
            got[name] = scaler.tick()
        assert got["port"] is not None
        assert got["port"]["direction"] == "decode->prefill"
        assert (got["jax"] is None) == (origin < 600.0)

