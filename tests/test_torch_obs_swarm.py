"""The observability plane across a scheduled swarm on the CPU, over TCP
on localhost, at the tiny size of ``test_torch_sched_mixed``:

- a traced request's spans stitch across a [0, 2) + [2, 4) pipeline of
  port workers (one trace store in the process, a lane per stage);
- the port scheduler's ``cluster_status`` carries the merged histograms
  (each count the sum of the nodes'), goodput, the device merge, the
  timeline counters and every node's planes;
- a replica that served a grammar row shows its ``constrained`` section,
  under the port scheduler and under the JAX scheduler over port workers;
- a port worker's own flight event rides its heartbeat's ``events`` plane
  into either scheduler's timeline under that node, once, across a beat
  whose reply was lost;
- a prefill + decode pair records the JAX worker's handoff events;
- the port scheduler merges JAX workers' planes;
- the ``run`` frontend's hooks: the deep ``/healthz``, ``/debug/device``,
  ``/debug/timeline`` and the profile fan-out to every stage.
"""

import contextlib
import http.client
import json
import os
import threading
import time

import pytest

import parallax_tpu.scheduling.node as j_node
from parallax_tpu.backend.scheduler_service import (
    SchedulerService as JSchedulerService,
)
from parallax_tpu.p2p.transport import TcpTransport as JTcpTransport
from parallax_tpu.scheduling.scheduler import GlobalScheduler as JScheduler
from parallax_tpu_torch.backend.http_server import SimpleTokenizer
from parallax_tpu_torch.backend.run import build_swarm_frontend
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.obs.flight import get_flight
from parallax_tpu_torch.obs.trace import get_trace_store
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.p2p.transport import TcpTransport
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling import node as p_node
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from tests import _torch_disagg
from tests.test_torch_sched_mixed import _reqs_of, _serve, _worker
from tests.test_torch_sched_swarm import GRAMMAR_VOCAB, SCHEMA
from tests.test_torch_swarm import CFG, DEADLINE_S, ENGINE, JCFG, _wait

KINDS = {"port": (GlobalScheduler, SchedulerService, TcpTransport, CFG),
         "jax": (JScheduler, JSchedulerService, JTcpTransport, JCFG)}


@contextlib.contextmanager
def obs_swarm(sched_kind, worker_kinds, monkeypatch, split=True,
              engine=None, grammar=False, frontend=False):
    """A ``sched_kind`` scheduler with ``worker_kinds`` workers (split: one
    [0, 2) + [2, 4) pipeline; else full replicas); ``grammar`` seeds the
    byte vocabulary into the workers; ``frontend`` builds the ``run``
    frontend over the port scheduler and serves it on a thread."""
    if split:
        for mod in (j_node, p_node):
            monkeypatch.setattr(mod.RooflinePerformanceModel,
                                "max_layers_in_memory",
                                lambda self, kv_fraction=0.35: 2)
    sched_cls, svc_cls, t_cls, cfg = KINDS[sched_kind]
    sched = sched_cls(cfg, min_nodes_bootstrapping=len(worker_kinds))
    st = t_cls("scheduler", "127.0.0.1")
    fe = None
    if frontend:
        fe, service, _client = build_swarm_frontend(
            sched, st, SimpleTokenizer(), "tiny")
        service.join_timeout_s = DEADLINE_S
    else:
        service = svc_cls(sched, st, join_timeout_s=DEADLINE_S)
    workers, fe_thread = [], None
    try:
        service.start()
        workers = [_worker(k, st.address, engine) for k in worker_kinds]
        for w in workers:
            if grammar:
                w._grammar_vocab = GRAMMAR_VOCAB
        starters = [threading.Thread(target=w.start) for w in workers]
        for s in starters:
            s.start()
        for s in starters:
            s.join(DEADLINE_S)

        def ready():
            nodes = [n for p in sched.cluster_status()["pipelines"]
                     for n in p["nodes"]]
            return len(nodes) == len(workers) and all(
                n["ready"] for n in nodes)

        assert _wait(ready), sched.cluster_status()
        if fe is not None:
            bound = threading.Event()
            fe_thread = threading.Thread(
                target=fe.run, kwargs=dict(host="127.0.0.1", port=0,
                                           on_start=lambda _f: bound.set()),
                daemon=True)
            fe_thread.start()
            assert bound.wait(DEADLINE_S)
        yield service, {w.node_id: w for w in workers}, fe
    finally:
        if fe is not None and fe_thread is not None:
            fe.shutdown()
            fe_thread.join(10)
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        service.stop()


def _get(fe, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _planes_arrived(service, workers):
    def arrived():
        for nid in workers:
            node = service.scheduler.manager.get(nid)
            if not (node and (node.goodput or {}).get("tokens_total")):
                return False
            if not (node.metrics and node.device and node.step_timing):
                return False
        return True

    return _wait(arrived)


def test_trace_stitches_across_tcp_stages(monkeypatch):
    engine = dict(ENGINE, trace_sample_rate=1.0)
    with obs_swarm("port", ("port", "port"), monkeypatch,
                   engine=engine) as (service, workers, _):
        reqs = _serve(service, workers, _reqs_of)
        rid = reqs[0].request_id
        assert _wait(lambda: any(
            s["name"] == "finish" and s["stage"] == "0-2"
            for s in get_trace_store().spans(rid)))
        chrome = get_trace_store().export_chrome(rid)
        assert chrome["metadata"]["trace_id"] == rid
        lanes = {e["tid"] for e in chrome["traceEvents"]}
        assert {"0-2", "2-4"} <= lanes
        by_stage = {}
        for s in get_trace_store().spans(rid):
            by_stage.setdefault(s["stage"], []).append(s["name"])
        assert by_stage["0-2"][0] == "queue_wait"
        assert by_stage["0-2"][-1] == "finish", by_stage
        for stage in ("0-2", "2-4"):
            assert "prefill" in by_stage[stage], by_stage
            assert "decode" in by_stage[stage], by_stage


def test_port_cluster_status_merges_worker_planes(monkeypatch):
    with obs_swarm("port", ("port", "port"), monkeypatch) as (
            service, workers, _):
        _serve(service, workers, _reqs_of)
        assert _planes_arrived(service, workers)
        status = service.scheduler.cluster_status()
        nodes = [service.scheduler.manager.get(n) for n in workers]
        # The merged histogram is the sum of the nodes' snapshots.
        name = "parallax_step_host_ms"
        merged = status["metrics"][name]
        for label, summary in merged.items():
            want = sum(n.metrics.get(name, {}).get(label, {}).get(
                "count", 0) for n in nodes)
            assert summary["count"] == want > 0
        gp = status["goodput"]
        assert gp["nodes"] == 2 and gp["tokens_total"] > 0
        assert gp["tokens_useful"] + gp["tokens_wasted"] == gp["tokens_total"]
        dev = status["device"]
        assert dev["nodes"] == 2 and dev["hbm"]["classes"]["kv_pages"] > 0
        assert set(status["timeline"]) == {"ingested", "gaps", "resets"}
        for node in status["pipelines"][0]["nodes"]:
            assert node["step_timing"]["host_visits"] > 0
            assert node["goodput"] and node["device"]
            assert node["health"] is None       # watchdog off


@pytest.mark.parametrize("sched_kind", ["port", "jax"])
def test_constrained_plane_reaches_cluster_status(sched_kind, monkeypatch):
    """A replica that served a grammar row heartbeats its ``constrained``
    ledger, and the scheduler (the port's, or the JAX one over port
    workers) shows it for that node."""
    with obs_swarm(sched_kind, ("port", "port"), monkeypatch, split=False,
                   grammar=True) as (service, workers, _):
        path = service.route_request("gram", timeout_s=10.0,
                                     prompt_ids=[1, 2, 3])
        head = workers[path[0]]
        req = Request("gram", prompt_ids=[1, 2, 3], eos_token_ids=(269,),
                      routing_table=list(path),
                      sampling_params=SamplingParams(
                          temperature=0.0, max_new_tokens=30,
                          json_schema=SCHEMA))
        assert head.submit(req).wait(DEADLINE_S), req.status
        assert req.status.value.startswith("finished")
        node = service.scheduler.manager.get(path[0])
        assert _wait(lambda: node.constrained is not None)
        assert node.constrained == {
            **node.constrained, "enabled": True}
        assert node.constrained["window_rows"] + node.constrained[
            "fallbacks"] > 0
        status = service.scheduler.cluster_status()
        shown = {n["node_id"]: n["constrained"]
                 for p in status["pipelines"] for n in p["nodes"]}
        assert shown[path[0]] == node.constrained


@pytest.mark.parametrize("sched_kind", ["port", "jax"])
def test_worker_flight_event_reaches_the_timeline(sched_kind, monkeypatch):
    """The abort-path event a port worker records when its sender gives up
    on a next hop ships in the heartbeat's ``events`` batch and lands in
    the scheduler's timeline under that worker. The first beat that
    carries it loses its reply: the worker keeps its cursor, the next beat
    ships the event again under the same number, and the timeline merges
    it once, with no gap."""
    with obs_swarm(sched_kind, ("port", "port"), monkeypatch,
                   split=False) as (service, workers, _):
        nid, w = sorted(workers.items())[0]
        timeline = service.scheduler.timeline
        gaps = timeline.gaps
        reason = f"dead next hop seen by {nid}"
        carried = []
        real_call = w.sched_transport.call

        def call(peer, method, payload, timeout=10.0, **kw):
            reply = real_call(peer, method, payload, timeout=timeout, **kw)
            batch = ((payload or {}).get("events") or {}).get("batch", ())
            ours = [e["seq"] for e in batch if e.get("reason") == reason]
            if method == proto.NODE_UPDATE and ours:
                carried.append(ours)
                if len(carried) == 1:
                    raise TimeoutError("the reply was lost")
            return reply

        monkeypatch.setattr(w.sched_transport, "call", call)
        w._on_send_failure("127.0.0.1:9", reason)

        def merged():
            return [e for e in timeline.snapshot()["events"]
                    if e.get("kind") == "abort_path"
                    and e.get("reason") == reason]

        assert _wait(lambda: len(carried) >= 2 and merged())
        # Later beats: the adopted cursor keeps the event out of them.
        time.sleep(3 * w.heartbeat_interval_s)
        assert len(carried) == 2
        assert carried[0] == carried[1]
        events = merged()
        assert len(events) == 1, events
        assert events[0]["node"] == nid
        assert events[0]["peer"] == "127.0.0.1:9"
        assert timeline.gaps == gaps


def test_handoff_flight_events():
    """Each request a prefill head hands to a decode head leaves the JAX
    worker's events in the flight ring: ``handoff_flag``,
    ``handoff_park`` and ``handoff_out`` on the prefill head (the last
    naming the decode head, by image), ``handoff_in`` on the decode head."""
    requests = _torch_disagg.request_set()
    with _torch_disagg.swarm([("port", "prefill"), ("port", "decode")]) as (
            _sched, _svc, client, (prefill, decode)):
        cursor = get_flight().events_since(0, limit=10**6)[1]
        served = _torch_disagg.serve(client, "ev", requests)
        assert all(r.status.value == "finished_length" for r in served)
        rids = {r.request_id for r in served}

        def events():
            evs = get_flight().events_since(cursor, limit=10**6)[0]
            # The workers' own events carry their node; the engine's
            # (swap-in, preemption) do not.
            return [e for e in evs
                    if e.get("request_id") in rids and e.get("node")]

        assert _torch_disagg.wait_for(lambda: {
            e["request_id"] for e in events()
            if e["kind"] == "handoff_in"} == rids)
        by = {}
        for e in events():
            by.setdefault((e["kind"], e["node"]), []).append(e)
        for kind in ("handoff_flag", "handoff_park", "handoff_out"):
            got = by.get((kind, prefill.node_id), [])
            assert sorted(e["request_id"] for e in got) == sorted(rids)
        for e in by[("handoff_park", prefill.node_id)]:
            assert e["kv_pages"] == 3 and e["tokens"] >= 1
        for e in by[("handoff_out", prefill.node_id)]:
            assert e["target"] == decode.node_id and e["with_kv"] is True
        assert len(by[("handoff_in", decode.node_id)]) == len(rids)


def test_port_scheduler_merges_jax_worker_planes(monkeypatch):
    with obs_swarm("port", ("jax", "jax"), monkeypatch) as (
            service, workers, _):
        _serve(service, workers, _reqs_of)
        assert _planes_arrived(service, workers)
        status = service.scheduler.cluster_status()
        assert status["goodput"]["nodes"] == 2
        assert status["device"]["nodes"] == 2
        assert status["metrics"]["parallax_step_host_ms"]


def test_run_frontend_obs_hooks(monkeypatch, tmp_path):
    engine = dict(ENGINE, trace_sample_rate=1.0)
    with obs_swarm("port", ("port", "port"), monkeypatch, engine=engine,
                   frontend=True) as (service, workers, fe):
        _serve(service, workers, _reqs_of)
        assert _planes_arrived(service, workers)
        status, health = _get(fe, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["bootstrapped"] is True
        status, dev = _get(fe, "GET", "/debug/device")
        assert status == 200 and dev["cluster"]["nodes"] == 2
        assert set(dev["nodes"]) == set(workers)
        status, tl = _get(fe, "GET", "/debug/timeline")
        assert status == 200 and "events" in tl
        status, chrome = _get(fe, "GET", "/debug/timeline?format=chrome")
        assert status == 200 and "traceEvents" in chrome
        # The profile fan-out reaches every stage, each starting the trace
        # on its step thread. Both workers share this process, and a
        # process has one profiler (as one JAX trace): the first stage
        # starts it, the second answers "already running" in its row.
        body = {"pipeline": "all", "dir": str(tmp_path), "max_seconds": 60}
        status, out = _get(fe, "POST", "/profile/start", body)
        assert status == 200 and out["profiling"] is True
        assert {r["node_id"] for r in out["nodes"]} == set(workers)
        started = [r for r in out["nodes"] if r.get("profiling")]
        assert len(started) == 1
        assert ["already running" in r.get("error", "")
                for r in out["nodes"]].count(True) == 1
        status, again = _get(fe, "POST", "/profile/start", body)
        assert all("already running" in r["error"] for r in again["nodes"])
        for i in range(2):
            rid = f"prof{i}"
            path = service.route_request(rid, timeout_s=10.0,
                                         prompt_ids=[5, 6, 7])
            req = Request(rid, prompt_ids=[5, 6, 7], routing_table=path,
                          sampling_params=SamplingParams(
                              temperature=0.0, max_new_tokens=4))
            assert workers[path[0]].submit(req).wait(DEADLINE_S)
        status, out = _get(fe, "POST", "/profile/stop", {"pipeline": "all"})
        assert status == 200 and out["profiling"] is False
        traces = [r["trace"] for r in out["nodes"] if "trace" in r]
        assert [r["node_id"] for r in out["nodes"] if "trace" in r] == [
            started[0]["node_id"]]
        for path in traces:
            assert os.path.dirname(path) == str(tmp_path)
            with open(path) as f:
                assert json.load(f)["traceEvents"]
        status, err = _get(fe, "POST", "/profile/start",
                           {"pipeline": "nope"})
        assert status == 400
