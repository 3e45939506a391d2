"""The port's scheduled swarm against the JAX package's, and mixed swarms,
on the CPU over TCP on localhost, at the tiny size of tests/test_swarm_e2e.py
(4 layers, f32; each stage's ``jax.random.key(start * 1000 + end)`` tree,
carried across by ``params_from_numpy``).

- Same streams: a port scheduler with port workers, a JAX
  SchedulerService with port workers, and a port SchedulerService with
  JAX workers serve greedy streams under the tie-tolerant rule of
  tests/test_engine_e2e.py::assert_greedy_matches against the JAX model's
  one-shot logits, parting from a JAX scheduler swarm's only at
  near-ties. The mixed swarms hold the control-plane frames equal both
  ways.
- Heartbeat fields: the JAX scheduler takes the port worker's heartbeat
  and keeps every plane it sends: step timing, histogram snapshots,
  goodput and the device plane are filled once the workers served; the
  planes of features that did not run (speculation, constrained
  decoding, the watchdog) stay None.
- Digests: the two packages' engines publish equal ``cache_digests``
  payloads for the same request sequence, and ``cache_aware`` routing
  sends a shared-prefix follow-up to the warm replica in both packages'
  swarms.
"""

import contextlib
import threading

import jax
import numpy as np
import pytest

import parallax_tpu.scheduling.node as j_node
from parallax_tpu.backend.scheduler_service import (
    SchedulerService as JSchedulerService,
)
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.p2p.node import WorkerNode as JWorkerNode
from parallax_tpu.p2p.transport import TcpTransport as JTcpTransport
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu.scheduling.scheduler import GlobalScheduler as JScheduler
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import TcpTransport
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling import node as p_node
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from tests.test_torch_swarm import (
    CFG,
    DEADLINE_S,
    ENGINE,
    JCFG,
    N_NEW,
    PROMPTS,
    TOL,
    _jax_params,
    _merged_tree,
    _port_params,
    _reference_logits,
    _requests,
    _wait,
)

KINDS = {"port": (GlobalScheduler, SchedulerService, TcpTransport),
         "jax": (JScheduler, JSchedulerService, JTcpTransport)}


def _worker(kind: str, sched_addr: str, engine=None):
    engine = engine or ENGINE
    if kind == "port":
        t = TcpTransport("", "127.0.0.1")
        t.start()
        t.peer_id = t.address
        return WorkerNode(t, sched_addr, CFG, EngineConfig(**engine),
                          load_params=_port_params,
                          heartbeat_interval_s=0.2, device="cpu")
    t = JTcpTransport("", "127.0.0.1")
    t.start()
    t.peer_id = t.address
    return JWorkerNode(transport=t, scheduler_peer=sched_addr,
                       model_config=JCFG,
                       engine_config=JEngineConfig(**engine),
                       load_params=_jax_params, heartbeat_interval_s=0.2)


@contextlib.contextmanager
def swarm(sched_kind, worker_kinds, routing="rr", split=True,
          monkeypatch=None, engine=None, extra=None):
    """A ``sched_kind`` scheduler service with ``worker_kinds`` workers;
    ``split`` forces 2 layers a node (one [0, 2) + [2, 4) pipeline),
    otherwise each node hosts all 4 layers (replicas)."""
    if split:
        for mod in (j_node, p_node):
            monkeypatch.setattr(mod.RooflinePerformanceModel,
                                "max_layers_in_memory",
                                lambda self, kv_fraction=0.35: 2)
    sched_cls, svc_cls, t_cls = KINDS[sched_kind]
    cfg = CFG if sched_kind == "port" else JCFG
    sched = sched_cls(cfg, min_nodes_bootstrapping=len(worker_kinds),
                      routing=routing)
    st = t_cls("scheduler", "127.0.0.1")
    service = svc_cls(sched, st, join_timeout_s=DEADLINE_S)
    workers = []
    try:
        service.start()
        workers = [_worker(k, st.address, engine) for k in worker_kinds]
        starters = [threading.Thread(target=w.start) for w in workers]
        for s in starters:
            s.start()
        for s in starters:
            s.join(DEADLINE_S)

        def ready():
            st_ = sched.cluster_status()
            nodes = [n for p in st_["pipelines"] for n in p["nodes"]]
            return len(nodes) == len(workers) and all(
                n["ready"] for n in nodes)

        assert _wait(ready), sched.cluster_status()
        if extra is not None:
            # Workers the test starts later, stopped with the swarm.
            extra.append(lambda kind: _worker(kind, st.address, engine))
            extra.append(workers)
        yield service, {w.node_id: w for w in workers}
    finally:
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        service.stop()


def _serve(service, workers, reqs_of):
    """Route each request through the service and submit it at its head
    (``reqs_of(head)`` makes the head's package's requests)."""
    out = []
    events = []
    for i, p in enumerate(PROMPTS):
        rid = f"r{i}"
        path = service.route_request(rid, timeout_s=10.0,
                                     prompt_ids=list(p))
        assert path, rid
        head = workers[path[0]]
        req = reqs_of(head)[i]
        req.routing_table = list(path)
        out.append(req)
        events.append(head.submit(req))
    for r, ev in zip(out, events):
        assert ev.wait(DEADLINE_S), f"{r.request_id}: {r.status}"
        assert r.status.value == "finished_length", r.status
        assert len(r.output_ids) == N_NEW
    return out


def _reqs_of(head):
    port = isinstance(head, WorkerNode)
    return _requests(Request if port else JRequest,
                     SamplingParams if port else JSampling, seeded=False)


@pytest.fixture(scope="module")
def jax_sched_streams():
    with pytest.MonkeyPatch.context() as mp:
        with swarm("jax", ("jax", "jax"), monkeypatch=mp) as (svc, ws):
            return [r.output_ids for r in _serve(svc, ws, _reqs_of)]


def _assert_tie_tolerant(reqs, want, label):
    for r, ref_ids in zip(reqs, want):
        ctx = list(r.prompt_ids) + list(r.output_ids[:-1])
        logits = _reference_logits(ctx)
        p0 = len(r.prompt_ids) - 1
        for i, tok in enumerate(r.output_ids):
            row = logits[p0 + i]
            best = int(np.argmax(row))
            assert tok == best or float(row[best] - row[tok]) < TOL, \
                (label, r.request_id, i, tok, best)
        same = 0
        while same < N_NEW and r.output_ids[same] == ref_ids[same]:
            same += 1
        if same < N_NEW:
            row = logits[p0 + same]
            gap = abs(float(row[r.output_ids[same]] - row[ref_ids[same]]))
            assert gap < TOL, (label, r.request_id, same, gap)


@pytest.mark.parametrize("sched_kind,worker_kinds", [
    ("port", ("port", "port")), ("jax", ("port", "port")),
    ("port", ("jax", "jax")),
], ids=["port-sched-port-workers", "jax-sched-port-workers",
        "port-sched-jax-workers"])
def test_scheduled_swarms_match_jax(sched_kind, worker_kinds,
                                    jax_sched_streams, monkeypatch):
    with swarm(sched_kind, worker_kinds, monkeypatch=monkeypatch) as (
            service, workers):
        layers = sorted((w.start_layer, w.end_layer)
                        for w in workers.values())
        assert layers == [(0, 2), (2, 4)]
        reqs = _serve(service, workers, _reqs_of)
        if sched_kind == "jax":
            # The JAX scheduler took the port's heartbeats and kept every
            # plane; those of features that did not run stay None.
            for nid in workers:
                node = service.scheduler.manager.get(nid)
                assert node.is_ready and node.kernel["impl"] == "torch"
                assert node.cache_stats["tokens_admitted"] >= 0
                assert _wait(
                    lambda: node.measured_layer_latency_ms is not None)
                assert _wait(lambda: (node.goodput or {}).get(
                    "tokens_total", 0) > 0)
                assert node.step_timing["host_visits"] > 0
                assert node.metrics and node.device["hbm"]["classes"]
                for plane in ("spec", "constrained", "health"):
                    assert getattr(node, plane) is None, plane
            status = service.scheduler.cluster_status()
            assert status["goodput"]["tokens_total"] > 0
            assert status["device"]["nodes"] == 2
            assert status["metrics"]["parallax_step_host_ms"]
    _assert_tie_tolerant(reqs, jax_sched_streams,
                         f"{sched_kind}-{worker_kinds[0]}")


DIGEST_PROMPTS = [list(range(1, 41)), list(range(1, 25)) + [99] * 16,
                  [7, 3] * 20, list(range(1, 33)) + [5] * 9]


def test_engines_publish_equal_digest_payloads():
    """One full-model stage in each package, ``cache_digests=True``, the
    same greedy requests one after another: every heartbeat payload (a
    full snapshot, then deltas) is equal."""
    cfg = dict(ENGINE, cache_digests=True)
    jm = JStageModel(JCFG, 0, 4, use_pallas=False)
    jeng = JStageEngine(jm, _merged_tree(), JEngineConfig(**cfg))
    pm = create_stage_model(CFG, 0, 4)
    peng = StageEngine(pm, params_from_numpy(
        jax.tree.map(np.asarray, _merged_tree()), "cpu"),
        EngineConfig(**cfg), device="cpu")
    got = {"jax": [], "port": []}
    for name, eng, req_cls, sp_cls, pipe_cls in (
            ("jax", jeng, JRequest, JSampling, JPipeline),
            ("port", peng, Request, SamplingParams, InProcessPipeline)):
        pipe = pipe_cls([eng])
        got[name].append(eng.cache_digest_payload(full=True))
        for i, p in enumerate(DIGEST_PROMPTS):
            r = req_cls(f"d{i}", prompt_ids=list(p),
                        sampling_params=sp_cls(temperature=0.0,
                                               max_new_tokens=4))
            pipe.submit(r)
            pipe.run_until_complete()
            got[name].append(eng.cache_digest_payload())
        got[name].append(eng.cache_digest_payload(full=True))
    assert got["jax"] == got["port"]
    assert got["port"][1]["added"] and len(got["port"][-1]["full"]) >= 10


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_cache_aware_sends_the_follow_up_to_the_warm_replica(kind,
                                                             monkeypatch):
    with swarm(kind, (kind, kind), routing="cache_aware", split=False,
               monkeypatch=monkeypatch) as (service, workers):
        assert len(service.scheduler.manager.pipelines) == 2
        req_cls, sp_cls = ((Request, SamplingParams) if kind == "port"
                           else (JRequest, JSampling))
        prefix = list(range(1, 41))
        first = service.route_request("warm", timeout_s=10.0,
                                      prompt_ids=prefix + [7])
        head = workers[first[0]]
        r = req_cls("warm", prompt_ids=prefix + [7],
                    sampling_params=sp_cls(temperature=0.0,
                                           max_new_tokens=4),
                    routing_table=list(first))
        assert head.submit(r).wait(DEADLINE_S)
        # The warm head's digests reach the scheduler's mirror.
        warm = service.scheduler.manager.get(first[0])
        assert _wait(lambda: len(warm.cache_index) >= 5)
        follow = service.route_request("follow", timeout_s=10.0,
                                       prompt_ids=prefix + [9, 9])
        decisions = service.scheduler.router.decision_counters
        assert follow == first, (follow, first)
        assert decisions.get("chosen_by_cache") == 1, decisions

