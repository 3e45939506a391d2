"""The port's global scheduling (parallax_tpu_torch.scheduling) against the
JAX package's (parallax_tpu.scheduling) on the cases of
tests/test_scheduling.py and tests/test_swarm_scale.py: the same
HardwareInfo, ModelConfig and events go through both packages, and the
results must be equal.

- Water-fill counts, greedy / DP allocations (node ids, layer ranges,
  pipeline ids), DP's minimum stage counts, the rebalance trigger,
  boundary trims, dynamic join and turning points.
- The rr, dp and seeded random routers' picks over the same sequence of
  requests, and load accounting.
- GlobalScheduler bootstrap, dispatch, leave + rebalance and heartbeat
  eviction, stepped through the synchronous twins of the event and
  dispatch loops so that both packages see the same event order.
- CacheIndex predictions and CacheAwareRouting picks from the same digest
  deltas (the radix trees' own digest payloads, equal in both packages).
- tests/test_swarm_scale.py's 50-node pool: allocation, churn, rejoin and
  1,000 seeded random routes.
- The refused options name their ROADMAP items.

Pure host code: nothing here touches a device.
"""

import time
import types

import pytest

import parallax_tpu.scheduling.layer_allocation as j_alloc
import parallax_tpu.scheduling.node as j_node
import parallax_tpu.scheduling.node_management as j_mgmt
import parallax_tpu.scheduling.request_routing as j_routing
import parallax_tpu.scheduling.scheduler as j_sched
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.runtime.radix_cache import RadixPageCache as JRadix
from parallax_tpu.utils.hw import HardwareInfo as JHardwareInfo
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.runtime.radix_cache import RadixPageCache
from parallax_tpu_torch.scheduling import layer_allocation as p_alloc
from parallax_tpu_torch.scheduling import node as p_node
from parallax_tpu_torch.scheduling import node_management as p_mgmt
from parallax_tpu_torch.scheduling import request_routing as p_routing
from parallax_tpu_torch.scheduling import scheduler as p_sched
from parallax_tpu_torch.utils.hw import HardwareInfo

RAW = dict(
    architectures=["Qwen2ForCausalLM"],
    hidden_size=3584, num_hidden_layers=28, num_attention_heads=28,
    num_key_value_heads=4, intermediate_size=18944, vocab_size=152064,
)
L = 28
# tests/test_scheduling.py's and tests/test_swarm_scale.py's presets.
HW = {
    "v5e_host": ("v5e", 4, 197.0, 16.0, 819.0, 186.0),
    "v5e_small": ("v5e", 1, 197.0, 16.0, 819.0, 186.0),
    "v5p_host": ("v5p", 4, 459.0, 95.0, 2765.0, 200.0),
}


def _pkg(name: str):
    if name == "jax":
        return types.SimpleNamespace(
            cfg=j_normalize(RAW), HW=JHardwareInfo, Node=j_node.Node,
            node=j_node, mgmt=j_mgmt, alloc=j_alloc, routing=j_routing,
            sched=j_sched, Radix=JRadix)
    return types.SimpleNamespace(
        cfg=normalize_config(RAW), HW=HardwareInfo, Node=p_node.Node,
        node=p_node, mgmt=p_mgmt, alloc=p_alloc, routing=p_routing,
        sched=p_sched, Radix=RadixPageCache)


PKGS = {"jax": _pkg("jax"), "port": _pkg("port")}


def both(fn):
    """``fn(pkg)`` in each package; asserts the results are equal and
    returns one."""
    got = {name: fn(pkg) for name, pkg in PKGS.items()}
    assert got["jax"] == got["port"], got
    return got["port"]


def make_node(pkg, nid, hw="v5e_host", ready=True, cap=None, lat=None,
              layers=None):
    n = pkg.Node(node_id=nid, hardware=pkg.HW(*HW[hw]), model=pkg.cfg)
    n.is_ready = ready
    if cap is not None:
        n.layer_capacity = lambda c=cap: c
    if lat is not None:
        n.measured_layer_latency_ms = lat
    if layers is not None:
        n.set_layers(*layers)
    return n


def layout(pipelines):
    return [(p.pipeline_id,
             [(n.node_id, n.start_layer, n.end_layer) for n in p.nodes])
            for p in pipelines]


# -- allocation ---------------------------------------------------------------

WATER_FILL = {
    "proportional": ([("fast", "v5p_host"), ("slow", "v5e_host")], 28),
    "capacity-cap": ([("tiny", "v5e_small"), ("big", "v5p_host")], 28),
    "infeasible": ([("t", "v5e_small"), ("t2", "v5e_small")], 10**6),
}


@pytest.mark.parametrize("case", sorted(WATER_FILL))
def test_water_fill_matches(case):
    specs, layers = WATER_FILL[case]

    def run(pkg):
        nodes = [make_node(pkg, nid, hw) for nid, hw in specs]
        return pkg.alloc.water_fill_layers(nodes, layers)

    counts = both(run)
    if case == "infeasible":
        assert counts is None
    else:
        assert sum(counts) == 28


ALLOCATIONS = {
    "four-small": (28, [dict(hw="v5e_small")] * 4),
    "solo-small": (28, [dict(hw="v5e_small")]),
    "six-small": (28, [dict(hw="v5e_small")] * 6),
    "interleave": (70, [dict(cap=c, lat=1.0)
                        for c in (40, 40, 20, 20, 10, 10)]),
    "big-and-two": (70, [dict(cap=c, lat=1.0) for c in (70, 35, 35)]),
    "hosts-mixed": (28, [dict(hw="v5p_host"), dict(hw="v5e_host"),
                         dict(hw="v5e_small"), dict(hw="v5e_small")]),
}


@pytest.mark.parametrize("allocator", ["greedy", "dp"])
@pytest.mark.parametrize("case", sorted(ALLOCATIONS))
def test_allocators_match(allocator, case):
    layers, specs = ALLOCATIONS[case]

    def run(pkg):
        cls = (pkg.alloc.GreedyLayerAllocator if allocator == "greedy"
               else pkg.alloc.DPLayerAllocator)
        nodes = [make_node(pkg, f"n{i}", **kw) for i, kw in enumerate(specs)]
        mgr = pkg.mgmt.NodeManager(layers)
        for n in nodes:
            mgr.add(n)
        mgr.register_pipelines(cls(layers).allocate(nodes))
        return layout(mgr.pipelines)

    got = both(run)
    if case == "four-small":
        assert len(got) == 2
    if case == "solo-small":
        assert got == []
    if case == "interleave":
        assert len(got) == (1 if allocator == "greedy" else 2)


@pytest.mark.parametrize("caps,k", [([70, 40, 30], 1), ([70, 35, 35], 2),
                                    ([40, 40, 20, 20, 10, 10], 2),
                                    ([30, 30], 1), ([20, 20], 1)])
def test_dp_min_stages_match(caps, k):
    both(lambda pkg: pkg.alloc.DPLayerAllocator(70)._min_stages(caps, k))


@pytest.mark.parametrize("layers", [(0, 14), (0, 28)])
def test_rebalance_trigger_matches(layers):
    got = both(lambda pkg: pkg.alloc.GreedyLayerAllocator(28)
               .should_global_rebalance([make_node(pkg, "a",
                                                   layers=layers)]))
    assert got == (layers == (0, 14))


@pytest.mark.parametrize("counts", [[20, 8], [8, 20], [14, 14]])
def test_trim_boundaries_match(counts):
    both(lambda pkg: pkg.alloc.trim_pipeline_boundaries(
        [make_node(pkg, "s", "v5e_host"), make_node(pkg, "f", "v5p_host")],
        counts))


@pytest.mark.parametrize("joiner", ["v5e_host", "v5e_small"])
def test_assign_to_lightest_layers_matches(joiner):
    def run(pkg):
        a = make_node(pkg, "a", "v5p_host", layers=(0, 14))
        b = make_node(pkg, "b", "v5e_host", layers=(14, 28))
        j = make_node(pkg, "j", joiner)
        ok = pkg.alloc.assign_to_lightest_layers(j, [a, b], 28)
        return ok, j.start_layer, j.end_layer

    both(run)


TURNING = {
    "tail": ([("A", 0, 4, 5.0), ("B", 2, 6, 0.1)], 6, {}),
    "head": ([("A", 0, 3, 0.1), ("B", 1, 6, 1.0)], 6, {}),
    "reenter": ([("A", 0, 28, 0.01), ("F", 10, 12, 0.0001)], 28,
                {"A": {"F": 1e-6}, "F": {"A": 1e-6}}),
    "uncovered": ([("A", 0, 3, 1.0)], 6, {}),
    "single": ([("A", 0, 6, 1.0)], 6, {}),
}


@pytest.mark.parametrize("case", sorted(TURNING))
def test_turning_points_match(case):
    specs, layers, rtt = TURNING[case]

    def run(pkg):
        nodes = []
        for nid, s, e, lat in specs:
            n = make_node(pkg, nid, lat=lat, layers=(s, e))
            n.rtt_s = dict(rtt.get(nid, {}))
            nodes.append(n)
        return pkg.routing.find_turning_points(nodes, layers)

    got = both(run)
    if case == "tail":
        assert ("A", 2, "tail") in got


@pytest.mark.parametrize("c_lat,c_load", [(0.005, 0), (None, 0),
                                          (0.005, 3)],
                         ids=["trimmed", "no-measurement", "busy"])
def test_scheduler_turning_point_trims_match(c_lat, c_load):
    """tests/test_scheduling.py's drifted replicas: only a measured, idle
    replica is trimmed; pipeline members never are."""
    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=1,
                                          routing="dp")
        mgr = sched.manager
        nodes = {}
        for nid, s, e, lat in (("a", 0, 15, 0.01), ("e", 15, 28, 0.01)):
            nodes[nid] = make_node(pkg, nid, lat=lat, layers=(s, e))
            mgr.add(nodes[nid])
        mgr.register_pipelines([pkg.mgmt.Pipeline(
            nodes=[nodes["a"], nodes["e"]])])
        for nid, s, e, lat in (("c", 10, 20, c_lat), ("d", 12, 28, 0.001)):
            nodes[nid] = make_node(pkg, nid, lat=lat, layers=(s, e))
            mgr.add(nodes[nid])
            mgr.set_active(nid)
        nodes["c"].load = c_load
        for n in nodes.values():
            n.rtt_s = {x: 1e-6 for x in nodes}
        sched._apply_turning_point_trims()
        return {nid: (n.start_layer, n.end_layer)
                for nid, n in sorted(nodes.items())}

    got = both(run)
    assert got["c"] == ((10, 12) if (c_lat, c_load) == (0.005, 0)
                        else (10, 20))


# -- routing ------------------------------------------------------------------

def registered(pkg, num_pipes=2):
    mgr = pkg.mgmt.NodeManager(28)
    pipes = []
    for i in range(num_pipes):
        a = make_node(pkg, f"p{i}a", layers=(0, 14))
        b = make_node(pkg, f"p{i}b", layers=(14, 28))
        mgr.add(a)
        mgr.add(b)
        pipes.append(pkg.mgmt.Pipeline(nodes=[a, b]))
    mgr.register_pipelines(pipes)
    return mgr


def _not_ready(mgr):
    mgr.pipelines[0].nodes[0].is_ready = False


def _stale_refit(mgr):
    for n in mgr.pipelines[1].nodes:
        n.refit_version = 2


@pytest.mark.parametrize("tweak", [None, _not_ready, _stale_refit],
                         ids=["cycle", "skip-not-ready", "skip-stale-refit"])
def test_round_robin_picks_match(tweak):
    def run(pkg):
        mgr = registered(pkg)
        if tweak is not None:
            tweak(mgr)
        rr = pkg.routing.RoundRobinRouting(mgr)
        picks = []
        for _ in range(5):
            path = rr.find_path()
            picks.append([n.node_id for n in path])
        return picks, rr.pipeline_dispatches

    picks, _ = both(run)
    if tweak is None:
        assert picks[0] != picks[1] and picks[2] == picks[0]


def _dp_fastest(pkg):
    mgr = pkg.mgmt.NodeManager(28)
    for nid, hw, s, e in (("slow_a", "v5e_host", 0, 14),
                          ("slow_b", "v5e_host", 14, 28),
                          ("fast_a", "v5p_host", 0, 14),
                          ("fast_b", "v5p_host", 14, 28)):
        mgr.add(make_node(pkg, nid, hw, layers=(s, e)))
    return mgr


def _dp_uncovered(pkg):
    mgr = pkg.mgmt.NodeManager(28)
    mgr.add(make_node(pkg, "a", layers=(0, 14)))
    return mgr


@pytest.mark.parametrize("build", [_dp_fastest, _dp_uncovered],
                         ids=["fastest-chain", "uncovered"])
def test_dp_routing_matches(build):
    def run(pkg):
        path = pkg.routing.DPRouting(build(pkg)).find_path()
        return None if path is None else [n.node_id for n in path]

    got = both(run)
    if build is _dp_fastest:
        assert got == ["fast_a", "fast_b"]


def _random_replicas(pkg):
    mgr = pkg.mgmt.NodeManager(28)
    for nid in ("p0a", "p0b"):
        mgr.add(make_node(pkg, nid, layers=(0, 14)))
    mgr.add(make_node(pkg, "tail", "v5p_host", layers=(14, 28)))
    return mgr


def _random_fanout(pkg):
    mgr = pkg.mgmt.NodeManager(28)
    for rep in range(7):
        for qi, (s, e) in enumerate([(0, 7), (7, 14), (14, 21), (21, 28)]):
            mgr.add(make_node(pkg, f"r{rep}q{qi}", layers=(s, e)))
    return mgr


def _random_full(pkg):
    mgr = pkg.mgmt.NodeManager(28)
    full = make_node(pkg, "full", layers=(0, 28))
    full.load = full.max_concurrent_requests()
    mgr.add(full)
    return mgr


@pytest.mark.parametrize("build,seed,n", [(_random_replicas, 7, 40),
                                          (_random_fanout, 0, 60),
                                          (_random_full, 1, 3)],
                         ids=["replicas", "fanout", "load-capped"])
def test_seeded_random_picks_match(build, seed, n):
    def run(pkg):
        router = pkg.routing.RandomizedRouting(build(pkg), seed=seed)
        picks = []
        for _ in range(n):
            path = router.find_path()
            picks.append(None if path is None
                         else [x.node_id for x in path])
        return picks

    picks = both(run)
    if build is _random_replicas:
        assert {p[0] for p in picks} == {"p0a", "p0b"}
    if build is _random_full:
        assert picks == [None] * n


def test_load_accounting_and_leave_match():
    def run(pkg):
        mgr = registered(pkg, 2)
        rr = pkg.routing.RoundRobinRouting(mgr)
        path = rr.find_path()
        rr.on_dispatch(path)
        loads = [n.load for n in path]
        rr.on_complete([n.node_id for n in path])
        displaced = mgr.remove("p0a")
        return (loads, [n.load for n in path],
                [n.node_id for n in displaced], mgr.state_of("p0b").value,
                layout(mgr.pipelines), mgr.capacity_report())

    got = both(run)
    assert got[0] == [1, 1] and got[1] == [0, 0] and got[2] == ["p0b"]


# -- the global scheduler ---------------------------------------------------------

def _hw(pkg, name="v5e_small"):
    return pkg.HW(*HW[name])


def _drive(pkg, sched, events):
    """Apply ``events`` in order through the scheduler's public enqueues
    and the synchronous loop twins; returns the layout after each."""
    out = []
    for ev in events:
        kind = ev[0]
        if kind == "join":
            sched.enqueue_join(ev[1], _hw(pkg, ev[2]))
        elif kind == "leave":
            sched.enqueue_leave(ev[1])
        elif kind == "ready":
            for nid in ev[1]:
                sched.enqueue_update(nid, is_ready=True)
        sched.drain_events()
        out.append((sched.bootstrapped.is_set(),
                    layout(sched.manager.pipelines),
                    sorted((n.node_id, n.start_layer, n.end_layer)
                           for n in sched.manager.nodes())))
    return out


SCHEDULES = {
    "bootstrap": [("join", "n0", "v5e_small"), ("join", "n1", "v5e_small"),
                  ("ready", ["n0", "n1"])],
    "leave-rebalance": [("join", f"n{i}", "v5e_small") for i in range(3)]
    + [("ready", ["n0", "n1", "n2"]), ("leave", "n0"),
       ("ready", ["n1", "n2"])],
    "extend": [("join", f"n{i}", "v5e_small") for i in range(4)]
    + [("leave", "n3"), ("join", "n3", "v5e_small"),
       ("ready", ["n0", "n1", "n2", "n3"])],
    "mixed-hosts": [("join", "big", "v5p_host"), ("join", "s0", "v5e_small"),
                    ("join", "s1", "v5e_small"), ("ready", ["big"]),
                    ("leave", "big"), ("ready", ["s0", "s1"])],
}


@pytest.mark.parametrize("routing", ["rr", "dp"])
@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_scheduler_events_match(case, routing):
    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=2,
                                          routing=routing)
        steps = _drive(pkg, sched, SCHEDULES[case])
        # Dispatch one request through dispatch_once.
        pr = sched.receive_request("req1")
        sched.dispatch_once()
        status = sched.cluster_status()
        return steps, pr.path_ids, status["num_pipelines"], \
            status["num_active"]

    steps, path, npipes, _ = both(run)
    assert steps[-1][0] and npipes >= 1 and path is not None


def test_heartbeat_eviction_matches():
    """n1 stops heartbeating: one sweep past the timeout evicts it and
    the pipeline dissolves in both packages."""
    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=2,
                                          heartbeat_timeout_s=0.2)
        _drive(pkg, sched, SCHEDULES["bootstrap"])
        sched.manager.get("n1").last_heartbeat -= 5.0
        sched.sweep_once()
        return (sorted(n.node_id for n in sched.manager.nodes()),
                layout(sched.manager.pipelines),
                sched.bootstrapped.is_set())

    assert both(run) == (["n0"], [], False)


def test_busy_probation_matches():
    """A node that reported a reload in progress is suspect, not evicted,
    inside the extended grace."""
    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=2,
                                          heartbeat_timeout_s=0.2)
        _drive(pkg, sched, SCHEDULES["bootstrap"])
        sched.enqueue_update("n1", busy=True)
        sched.drain_events()
        sched.manager.get("n1").last_heartbeat -= 0.5
        sched.sweep_once()
        return (sorted(n.node_id for n in sched.manager.nodes()),
                sched.manager.get("n1").suspect)

    assert both(run) == (["n0", "n1"], True)


def test_dynamic_join_matches(monkeypatch):
    """tests/test_scheduling.py's dynamic join under dp routing: a third
    node that cannot complete a pipeline replicates an existing stage."""
    for mod in (j_node, p_node):
        monkeypatch.setattr(mod.RooflinePerformanceModel,
                            "max_layers_in_memory",
                            lambda self, kv_fraction=0.35: 14)

    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=2,
                                          routing="dp")
        steps = _drive(pkg, sched, [("join", "a", "v5e_host"),
                                    ("join", "b", "v5e_host"),
                                    ("ready", ["a", "b"]),
                                    ("join", "c", "v5e_host")])
        return steps[-1], sched.manager.state_of("c").value

    last, state = both(run)
    assert state == "active"


def test_cluster_status_core_keys_match():
    """cluster_status's pipelines, node entries and routing section carry
    the JAX scheduler's keys and values for the same events."""
    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=2,
                                          routing="cache_aware")
        _drive(pkg, sched, SCHEDULES["bootstrap"])
        pr = sched.receive_request("r", meta=pkg.routing.RequestMeta(
            "r", prompt_ids=list(range(40))))
        sched.dispatch_once()
        sched.complete_request(pr.path_ids, request_id="r", cached_tokens=0)
        st = sched.cluster_status()
        return ({k: st[k] for k in ("num_nodes", "num_active",
                                    "num_pipelines", "bootstrapped",
                                    "routing")},
                st["pipelines"])

    both(run)


# -- prefix digests and cache-aware routing -------------------------------------

SEQS = [list(range(1, 41)), list(range(1, 25)) + [99] * 16,
        [7, 3] * 20, list(range(50, 90))]


def test_digest_payloads_and_cache_aware_picks_match():
    """The two packages' radix trees publish equal digest payloads for the
    same inserts and evictions; CacheIndex mirrors fed those payloads
    predict the same hits; CacheAwareRouting over two replicas sends a
    shared-prefix prompt to the warm head and spreads cold ones."""
    def run(pkg):
        page = 8
        mgr = registered(pkg, 2)
        heads = [p.nodes[0] for p in mgr.pipelines]
        payloads = []
        for head, seqs in zip(heads, (SEQS[:2], SEQS[2:])):
            tree = pkg.Radix(page, track_digests=True)
            pages = iter(range(1, 1000))
            seq = 0
            for tokens in seqs:
                n = len(tokens) // page
                tree.insert(tokens[:n * page], [next(pages) for _ in range(n)])
                for full in (True, False):
                    payload = tree.digest_payload(full=full)
                    seq += 1
                    payload["seq"] = seq
                    payloads.append(payload)
                    assert not head.cache_index.apply(payload)
            tree.evict(2)
            payload = tree.digest_payload()
            seq += 1
            payload["seq"] = seq
            payloads.append(payload)
            assert not head.cache_index.apply(payload)
        router = pkg.routing.CacheAwareRouting(mgr)
        picks = []
        for i, prompt in enumerate(SEQS + [SEQS[0][:20] + [5] * 30,
                                           [200] * 30]):
            meta = pkg.routing.RequestMeta(f"q{i}", prompt_ids=prompt)
            path = router.find_path(meta)
            picks.append(([n.node_id for n in path],
                          meta.predicted_cached_tokens))
        # An out-of-sequence delta asks for a resync.
        resync = heads[0].cache_index.apply(
            {"seq": 99, "block": page, "added": [1]})
        return payloads, picks, dict(router.decision_counters), resync

    _payloads, picks, decisions, resync = both(run)
    assert resync and decisions.get("chosen_by_cache", 0) >= 3
    # The first prompt's pages sit on p0a's tree (two of them evicted).
    assert picks[0] == (["p0a", "p0b"], 24)


# -- tests/test_swarm_scale.py's pool --------------------------------------------

def _mixed_pool(pkg):
    nodes = []
    for i in range(10):
        nodes.append(make_node(pkg, f"full{i}", "v5p_host", cap=28))
    for i in range(20):
        nodes.append(make_node(pkg, f"half{i}", "v5e_host", cap=14))
    for i in range(20):
        nodes.append(make_node(pkg, f"quarter{i}", "v5e_host", cap=7))
    return nodes


def test_fifty_node_pool_allocation_churn_and_routes_match():
    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=50,
                                          allocator="dp",
                                          routing="randomized")
        sched.router = pkg.routing.RandomizedRouting(sched.manager, seed=3)
        for n in _mixed_pool(pkg):
            sched.manager.add(n)
        sched._try_bootstrap_or_extend()
        out = [layout(sched.manager.pipelines)]
        routes = [[n.node_id for n in sched.router.find_path()]
                  for _ in range(1000)]
        for nid in ("full0", "half0", "half1", "quarter0", "quarter1"):
            sched._handle_leave(nid)
        out.append(layout(sched.manager.pipelines))
        for nid, hw, cap in (("full0", "v5p_host", 28),
                             ("half0", "v5e_host", 14),
                             ("half1", "v5e_host", 14),
                             ("quarter0", "v5e_host", 7),
                             ("quarter1", "v5e_host", 7)):
            sched.manager.add(make_node(pkg, nid, hw, cap=cap))
        sched._try_bootstrap_or_extend()
        out.append(layout(sched.manager.pipelines))
        out.append(sorted((n.node_id, n.start_layer, n.end_layer)
                          for n in sched.manager.nodes()))
        return out, routes

    t0 = time.perf_counter()
    out, routes = both(run)
    assert [len(x) for x in out[:3]] == [25, 22, 24]
    assert len({tuple(r) for r in routes}) > 10
    assert time.perf_counter() - t0 < 60


# -- refusals -------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,item", [
    (dict(slo=object()), "9"), (dict(qos=object()), "9"),
    (dict(routing="cache_aware", routing_kwargs=dict(gamma=0.5)), "9"),
])
def test_refused_scheduler_options_name_their_items(kwargs, item):
    if "slo" in kwargs:
        # SLO objectives are ported: a parsed spec builds the tracker.
        from parallax_tpu_torch.obs.slo import parse_slo_spec

        sched = p_sched.GlobalScheduler(
            normalize_config(RAW), slo=parse_slo_spec("ttft_p95_ms=500"))
        assert sched.slo_tracker is not None
        assert "slo" in sched.cluster_status()
        return
    if "qos" in kwargs or "routing_kwargs" in kwargs:
        # The QoS plane and the fairness term are ported.
        from parallax_tpu_torch.qos import parse_qos_spec

        if "qos" in kwargs:
            kwargs = dict(qos=parse_qos_spec("on"))
        sched = p_sched.GlobalScheduler(normalize_config(RAW), **kwargs)
        if "qos" in kwargs:
            assert sched.cluster_status()["qos"]["enabled"]
        else:
            assert sched.router.gamma == 0.5
        return
    with pytest.raises(NotImplementedError, match=rf"item {item}\)"):
        p_sched.GlobalScheduler(normalize_config(RAW), **kwargs)


@pytest.mark.parametrize("call,item", [
    (lambda s: s.begin_refit({}), "12"),
    (lambda s: p_routing.RequestMeta("r", prompt_ids=[1] * 9,
                                     lora_id="a").chain(8), "11"),
])
def test_refused_scheduler_calls_name_their_items(call, item):
    sched = p_sched.GlobalScheduler(normalize_config(RAW))
    with pytest.raises(NotImplementedError, match=rf"item {item}\)"):
        call(sched)


# -- scheduler HA: the passive mirror and the fence ------------------------------

@pytest.mark.parametrize("state", ["passive", "fenced"])
def test_passive_and_fenced_schedulers_match(state):
    """``passive=True`` (a warm-standby mirror) and ``fence(epoch)`` (an old
    primary a worker proved superseded) are ported: behind either package's
    SchedulerService every mutating RPC answers ``not_primary`` with the
    epoch and ``where_is`` still answers; the service starts no scheduler
    thread for a mirror; a fenced scheduler drops the events it is handed,
    where a mirror's registry stays writable for its standby."""
    import parallax_tpu.backend.scheduler_service as j_service
    import parallax_tpu_torch.backend.scheduler_service as p_service

    class _T:
        def register(self, *_a, **_k):
            pass

        def start(self):
            pass

        def stop(self):
            pass

    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg,
                                          passive=state == "passive")
        sched.record_migration("rid", "w9")
        if state == "fenced":
            sched.fence(3)
        svc = (j_service if pkg is PKGS["jax"] else p_service
               ).SchedulerService(sched, _T(), standby_addrs=["sb:1"])
        svc.start()
        threads = len(sched._threads)
        replies = [
            svc._on_join("w0", {"node_id": "w0",
                                "hardware": _hw(pkg).to_dict()}),
            svc._on_update("w0", {"node_id": "w0", "load": 1}),
            svc._on_leave("w0", {"node_id": "w0"}),
            svc._on_request_complete("w0", {"path": ["w0"]}),
            svc._on_peer_down("w0", {"peer": "w1"}),
            svc._on_migrate_target("w0", {"requests": []}),
            svc._on_disagg_target("w0", {"requests": []}),
            svc._on_migration_done("w0", {"rid": "r", "head": "w0"}),
            svc._on_route_request("w0", {"rid": "r"}),
            svc._on_where_is("w0", {"rid": "rid"}),
            svc.route_request("r", timeout_s=0.01),
        ]
        sched.enqueue_join("w1", _hw(pkg))
        sched.drain_events()
        svc.stop()
        return (replies, threads, sched.passive, sched.fenced,
                sched.manager.get("w1") is not None)

    replies, threads, passive, fenced, joined = both(run)
    assert replies[:-2] == [{"not_primary": True, "epoch": 1}] * 9
    assert replies[-2:] == [{"head": "w9"}, None]
    assert threads == (0 if state == "passive" else 2)
    assert (passive, fenced, joined) == (
        (True, False, True) if state == "passive" else (False, True, False))


# -- live migration's scheduler calls ---------------------------------------------


def _migration_scheduler(pkg):
    """A scheduler over two registered 2-stage pipelines (``registered``),
    the second pipeline's head warm for a 32-token chain."""
    chain = pkg.Radix(4, track_digests=True)
    chain.insert(list(range(32)), list(range(1, 9)))
    sched = pkg.sched.GlobalScheduler(pkg.cfg, routing="cache_aware")
    sched.manager = registered(pkg, 2)
    sched.router = pkg.routing.make_router("cache_aware", sched.manager)
    payload = chain.digest_payload(full=True)
    payload["seq"] = 1
    sched.manager.get("p1a").cache_index.apply(payload)
    return sched


def _descriptors():
    from parallax_tpu_torch.runtime.radix_cache import block_hash_chain

    chain = block_hash_chain(list(range(32)), 4)
    desc = {"prompt_tokens": 40, "chains": {"4": chain}, "lora_id": None}
    return [dict(desc, rid="m1"), dict(desc, rid="m2", chains={}),
            {"rid": 7}]


@pytest.mark.parametrize("case", ["warm", "excluded", "none", "loaded"])
def test_choose_migration_targets_matches(case):
    """The same pipelines, digests and descriptors pick the same targets
    (path, head layers, predicted cached tokens), charge the same loads
    and count the same choices in both packages."""
    exclude = {"warm": {"nX"}, "excluded": {"p1b"}, "none": {"p0a", "p1b"},
               "loaded": set()}[case]

    def run(pkg):
        sched = _migration_scheduler(pkg)
        if case == "loaded":
            sched.manager.get("p1a").load = 3
        got = sched.choose_migration_targets(_descriptors(), exclude)
        loads = {n.node_id: n.load for n in sched.manager.nodes()}
        return got, loads, sched.migration_stats["targets_chosen"]

    got, _loads, chosen = both(run)
    assert chosen == len(got)
    if case == "warm":
        assert got["m1"] == {"path": ["p1a", "p1b"], "head_layers": [0, 14],
                             "predicted_cached_tokens": 32}
    if case == "none":
        assert got == {}


def test_record_migration_and_where_is_match():
    def run(pkg):
        sched = pkg.sched.GlobalScheduler(pkg.cfg)
        assert sched.migrated_head("r1") is None
        for i in range(4100):
            sched.record_migration(f"r{i}", f"n{i % 2}")
        sched.record_migration("r5", "n9")
        return ([sched.migrated_head(r) for r in ("r0", "r4", "r5", "r4099")],
                dict(sched.migration_stats))

    heads, stats = both(run)
    assert heads == [None, "n0", "n9", "n1"] and stats["recorded"] == 4101
