"""The observability plane's HTTP and control surfaces in the port, on the
CPU (a real loopback socket; the JAX frontend through aiohttp's test
client where a reply is compared):

- ``/metrics`` after a chat completion carries the families the JAX
  frontend exposes for the same traffic (names, TYPE lines), with the
  core series non-zero; ``/debug/trace/<id>`` stitches a two-stage
  in-process pipeline; ``/debug/flight``, ``/debug/device`` (local and
  ``device_fn``), ``/healthz`` with a watchdog, the ``/cluster/status``
  stream surviving a failing ``status_fn``;
- ``/profile/start`` and its auto-stop deadline (the profiler stubbed as
  the JAX test stubs ``jax.profiler``), and a real CPU ``torch.profiler``
  trace started and stopped through the runner thread;
- the cluster fan-out (a ``pipeline`` body, 501 without a swarm, 400 for
  an unknown pipeline) and the worker's ``PROFILE`` handler;
- the scheduler's update wiring (health, goodput, events, metrics), the
  SLO section and the heterogeneous device merge with a counted skip;
- a traced checkpoint's spans shipped and adopted through the port's
  codec.
"""

import asyncio
import contextlib
import http.client
import json
import threading
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer

from parallax_tpu.backend.serve import build_local_frontend as j_build
from parallax_tpu.obs import registry as j_registry
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu_torch.backend.http_server import (
    OpenAIFrontend,
    SimpleTokenizer,
)
from parallax_tpu_torch.backend.serve import build_local_frontend
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.obs import profiler
from parallax_tpu_torch.obs import registry as p_registry
from parallax_tpu_torch.obs.device import DevicePlane
from parallax_tpu_torch.obs.flight import get_flight
from parallax_tpu_torch.obs.goodput import GoodputLedger
from parallax_tpu_torch.obs.slo import parse_slo_spec
from parallax_tpu_torch.obs.trace import TraceStore, get_trace_store
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from parallax_tpu_torch.utils.hw import HardwareInfo
from tests.test_torch_http import ENGINE, TINY, _jax_params

CHAT = {"messages": [{"role": "user", "content": "hello there"}],
        "max_tokens": 5, "temperature": 0}
N_LAYERS = TINY["num_hidden_layers"]


def _port_engines(bounds, **cfg):
    import jax
    import numpy as np

    tree = jax.tree.map(np.asarray, _jax_params()[1])
    out = []
    for s, e in bounds:
        model = create_stage_model(normalize_config(TINY), s, e)
        p = {"layers": tree["layers"][s:e]}
        if s == 0 or (e == N_LAYERS and "lm_head" not in tree):
            p["embed_tokens"] = tree["embed_tokens"]
        if e == N_LAYERS:
            p["norm"] = tree["norm"]
            if "lm_head" in tree:
                p["lm_head"] = tree["lm_head"]
        out.append(StageEngine(model, params_from_numpy(p, "cpu"),
                               EngineConfig(**dict(ENGINE, **cfg)),
                               device="cpu"))
    return out


@contextlib.contextmanager
def serving(fe):
    bound = threading.Event()
    t = threading.Thread(target=fe.run, kwargs=dict(
        host="127.0.0.1", port=0, on_start=lambda _f: bound.set()),
        daemon=True)
    t.start()
    assert bound.wait(30)
    try:
        yield fe
    finally:
        fe.shutdown()
        t.join(10)


def _call(fe, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        text = resp.read().decode()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, (json.loads(text)
                             if ctype.startswith("application/json")
                             else text), ctype
    finally:
        conn.close()


def _families(text: str) -> dict:
    return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def _jax_metrics_after_chat() -> str:
    """The JAX frontend's /metrics after the same chat completion, on a
    fresh JAX registry."""
    cfg, params = _jax_params()
    engine = JStageEngine(JStageModel(cfg, 0, N_LAYERS, use_pallas=False),
                          params, JEngineConfig(**ENGINE))
    fe, runner = j_build([engine], SimpleTokenizer(), model_name="tiny")

    async def go():
        client = TestClient(TestServer(fe.app))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json=CHAT)
            assert resp.status == 200
            return await (await client.get("/metrics")).text()
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()
        runner.stop()


def test_metrics_exposition_carries_the_jax_families(monkeypatch):
    monkeypatch.setattr(j_registry, "_REGISTRY", j_registry.MetricsRegistry())
    monkeypatch.setattr(p_registry, "_REGISTRY", p_registry.MetricsRegistry())
    # Bound families of the process singletons re-register on the fresh
    # registries.
    from parallax_tpu.obs import device as j_device
    from parallax_tpu.obs import goodput as j_goodput
    from parallax_tpu_torch.obs import device as p_device
    from parallax_tpu_torch.obs import goodput as p_goodput

    for mod, attr, cls in ((j_goodput, "_LEDGER", j_goodput.GoodputLedger),
                           (p_goodput, "_LEDGER", p_goodput.GoodputLedger),
                           (j_device, "_PLANE", j_device.DevicePlane),
                           (p_device, "_PLANE", p_device.DevicePlane)):
        monkeypatch.setattr(mod, attr, cls())
    want = _families(_jax_metrics_after_chat())
    fe, runner = build_local_frontend(_port_engines([(0, N_LAYERS)]),
                                      SimpleTokenizer(), model_name="tiny")
    try:
        with serving(fe):
            status, _body, _ = _call(fe, "POST", "/v1/chat/completions",
                                     CHAT)
            assert status == 200
            status, text, ctype = _call(fe, "GET", "/metrics")
    finally:
        runner.stop()
    assert status == 200
    assert ctype == p_registry.EXPOSITION_CONTENT_TYPE
    got = _families(text)
    assert got == want

    def series_value(name):
        vals = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith(name) and not line.startswith("#")]
        assert vals, f"series {name} missing"
        return max(vals)

    for name in ("parallax_tpu_requests_total", "parallax_ttft_ms_count",
                 "parallax_e2e_ms_count", "parallax_step_host_ms_count",
                 "parallax_tpu_completion_tokens_total",
                 "parallax_goodput_tokens_total"):
        assert series_value(name) > 0, name


@pytest.fixture(scope="module")
def traced_frontend():
    fe, runner = build_local_frontend(
        _port_engines([(0, 1), (1, 2)], trace_sample_rate=1.0),
        SimpleTokenizer(), model_name="tiny-obs", watchdog=True,
        slo_config=parse_slo_spec("ttft_p95_ms=60000,availability=0.5"))
    with serving(fe):
        yield fe
    runner.stop()
    fe.watchdog.stop()


def test_debug_trace_flight_device_and_status(traced_frontend):
    fe = traced_frontend
    status, body, _ = _call(fe, "POST", "/v1/chat/completions",
                            dict(CHAT, max_tokens=6))
    assert status == 200, body
    rid = body["id"]
    status, trace, _ = _call(fe, "GET", f"/debug/trace/{rid}")
    assert status == 200
    assert trace["metadata"]["trace_id"] == rid
    assert {"0-1", "1-2"} <= {e["tid"] for e in trace["traceEvents"]}
    assert _call(fe, "GET", "/debug/trace/nope-unknown")[0] == 404
    status, flight, _ = _call(fe, "GET", "/debug/flight")
    assert status == 200
    rec = [r for r in flight["requests"] if r["request_id"] == rid]
    assert rec and rec[-1]["trace_id"] == rid
    status, dev, _ = _call(fe, "GET", "/debug/device")
    assert status == 200 and {"hbm", "compile", "programs"} <= set(dev)
    assert dev["programs"]["seconds"]["prefill"] > 0
    status, health, _ = _call(fe, "GET", "/healthz")
    assert status == 200 and set(health["components"]) == {
        "step_loop", "admission[0]", "admission[1]"}
    status, st, _ = _call(fe, "GET", "/cluster/status_json")
    assert status == 200 and st["mode"] == "single-host"
    assert st["goodput"]["tokens_total"] > 0
    assert st["health"]["status"] in ("ok", "degraded")
    assert "ttft_p95_ms=60000" in st["slo"]["objectives"]
    assert [s["layers"] for s in st["stages"]] == [[0, 1], [1, 2]]
    assert st["stages"][0]["step_timing"]["host_visits"] > 0
    status, tl, _ = _call(fe, "GET", "/debug/timeline?limit=5")
    assert status == 200 and "events" in tl


def test_cluster_status_stream_survives_status_fn_errors():
    calls = {"n": 0}

    def status_fn():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("scraper-visible failure")
        return {"ok": calls["n"]}

    fe = OpenAIFrontend(SimpleTokenizer(), submit_fn=None,
                        status_fn=status_fn)
    with serving(fe):
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        conn.request("GET", "/cluster/status?interval=0.01")
        resp = conn.getresponse()
        records = [json.loads(resp.readline()) for _ in range(3)]
        conn.close()
    assert records[0] == {"ok": 1}
    assert "scraper-visible" in records[1]["error"]
    assert records[2] == {"ok": 3}


def test_debug_device_fn_override_and_error_and_healthz_codes():
    calls = {"n": 0}

    def device_fn():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("merge exploded")
        return {"cluster": {"nodes": 3}, "nodes": {}}

    stalled = {"status": "stalled", "components": {}, "causes": ["x"]}
    fe = OpenAIFrontend(SimpleTokenizer(), submit_fn=None,
                        device_fn=device_fn, healthz_fn=lambda: stalled)
    with serving(fe):
        status, body, _ = _call(fe, "GET", "/debug/device")
        assert status == 200 and body["cluster"]["nodes"] == 3
        assert _call(fe, "GET", "/debug/device")[0] == 500
        assert _call(fe, "GET", "/healthz")[0] == 503
        assert _call(fe, "GET", "/debug/timeline")[0] == 404


def test_profile_start_autostop_deadline(monkeypatch):
    calls = {"start": 0, "stop": 0, "threads": set()}

    def start(_d):
        calls["start"] += 1
        calls["threads"].add(threading.current_thread().name)

    def stop():
        calls["stop"] += 1
        calls["threads"].add(threading.current_thread().name)
        return "/dev/null"

    monkeypatch.setattr(profiler, "start_trace", start)
    monkeypatch.setattr(profiler, "stop_trace", stop)
    ran = []

    def step_call(fn):
        ran.append(fn)
        return fn()

    fe = OpenAIFrontend(SimpleTokenizer(), submit_fn=None,
                        step_call=step_call)
    with serving(fe):
        status, body, _ = _call(fe, "POST", "/profile/start",
                                {"max_seconds": 0.15})
        assert status == 200 and body["max_seconds"] == 0.15
        time.sleep(0.5)                       # the deadline fires
        assert (calls["start"], calls["stop"]) == (1, 1)
        assert fe._profiling is False
        assert _call(fe, "POST", "/profile/start",
                     {"max_seconds": 30})[0] == 200
        assert _call(fe, "POST", "/profile/start", {})[0] == 409
        assert _call(fe, "POST", "/profile/stop", {})[0] == 200
        assert fe._profile_timer is None
        time.sleep(0.05)
        assert (calls["start"], calls["stop"]) == (2, 2)
        assert _call(fe, "POST", "/profile/stop", {})[0] == 409
        assert _call(fe, "POST", "/profile/start",
                     {"max_seconds": -1})[0] == 400
    # Every start and stop went through step_call.
    assert len(ran) == 4


def test_profile_runs_on_the_runner_thread(tmp_path):
    """A real CPU torch.profiler trace, started and stopped on serve's
    runner thread (``LocalRunner.call``), around a completion."""
    fe, runner = build_local_frontend(_port_engines([(0, N_LAYERS)]),
                                      SimpleTokenizer(), model_name="tiny")
    seen = []
    real = runner.call

    def call(fn, timeout=60.0):
        seen.append(threading.current_thread().name)
        return real(lambda: (seen.append(threading.current_thread().name),
                             fn())[1], timeout)

    fe.step_call = call
    try:
        with serving(fe):
            assert _call(fe, "POST", "/profile/start",
                         {"dir": str(tmp_path)})[0] == 200
            assert _call(fe, "POST", "/v1/chat/completions", CHAT)[0] == 200
            status, body, _ = _call(fe, "POST", "/profile/stop", {})
    finally:
        runner.stop()
    assert status == 200
    with open(body["trace"]) as f:
        events = json.load(f)["traceEvents"]
    assert events
    assert seen.count("pipeline-runner") == 2


def test_profile_cluster_fanout_501_and_400():
    seen = []

    def profile_cluster(action, pipeline, out_dir, max_seconds):
        if pipeline == "nope":
            raise ValueError(f"unknown pipeline {pipeline!r}")
        seen.append((action, pipeline, out_dir, max_seconds))
        return [{"node_id": "w0", "profiling": action == "start",
                 "dir": out_dir},
                {"node_id": "w1", "error": "profiler already running"}]

    fe = OpenAIFrontend(SimpleTokenizer(), submit_fn=None,
                        profile_cluster_fn=profile_cluster)
    plain = OpenAIFrontend(SimpleTokenizer(), submit_fn=None)
    with serving(fe), serving(plain):
        status, body, _ = _call(fe, "POST", "/profile/start",
                                {"pipeline": "all", "max_seconds": 7})
        assert status == 200 and body["profiling"] is True
        assert body["pipeline"] == "all"
        assert body["nodes"][0]["profiling"] is True
        status, body, _ = _call(fe, "POST", "/profile/stop",
                                {"pipeline": "all"})
        assert status == 200 and body["profiling"] is False
        assert _call(fe, "POST", "/profile/start",
                     {"pipeline": "nope"})[0] == 400
        assert _call(plain, "POST", "/profile/start",
                     {"pipeline": "all"})[0] == 501
    assert seen[0][0] == "start" and seen[0][3] == 7.0
    assert seen[1][0] == "stop"


class TestWorkerProfileHandler:
    """The target of each fanned-out PROFILE frame, driven directly, the
    profiler stubbed and the step-thread hop run inline."""

    def _stub(self, monkeypatch):
        from parallax_tpu_torch.p2p.node import WorkerNode

        calls = {"start": [], "stop": 0}
        monkeypatch.setattr(profiler, "start_trace",
                            lambda d: calls["start"].append(d))

        def stop():
            calls["stop"] += 1
            return "/tmp/x.json"

        monkeypatch.setattr(profiler, "stop_trace", stop)
        node = object.__new__(WorkerNode)
        node.node_id = "w0"
        node._profiling = False
        node._profile_dir = None
        node._profile_timer = None
        node._profile_lock = threading.Lock()
        node._call_on_step = lambda fn, timeout=60.0: fn()
        return node, calls

    def test_start_stop_roundtrip(self, monkeypatch):
        node, calls = self._stub(monkeypatch)
        out = node._on_profile("peer", {"action": "start",
                                        "dir": "/tmp/px-prof",
                                        "max_seconds": 30})
        assert out == {"node_id": "w0", "profiling": True,
                       "dir": "/tmp/px-prof"}
        assert calls["start"] == ["/tmp/px-prof"]
        assert node._profile_timer is not None
        out = node._on_profile("peer", {"action": "start"})
        assert "error" in out and len(calls["start"]) == 1
        out = node._on_profile("peer", {"action": "stop"})
        assert out["profiling"] is False and out["trace"] == "/tmp/x.json"
        assert calls["stop"] == 1 and node._profile_timer is None
        out = node._on_profile("peer", {"action": "stop"})
        assert "error" in out and calls["stop"] == 1

    def test_autostop_deadline(self, monkeypatch):
        node, calls = self._stub(monkeypatch)
        node._on_profile("peer", {"action": "start", "max_seconds": 5})
        node._profile_timer.cancel()
        node._profile_autostop()
        assert calls["stop"] == 1 and node._profiling is False
        assert "error" in node._on_profile("peer", {"action": "stop"})

    def test_unknown_action(self, monkeypatch):
        node, _ = self._stub(monkeypatch)
        assert "error" in node._on_profile("peer", {"action": "fondle"})


# -- the scheduler ---------------------------------------------------------------

HW = HardwareInfo("v5e", 1, 197.0, 16.0, 819.0, 186.0)


class TestSchedulerWiring:
    def _sched(self, **kw):
        return GlobalScheduler(normalize_config(TINY),
                               min_nodes_bootstrapping=1, **kw)

    def test_update_carries_health_goodput_events_metrics(self):
        sched = self._sched()
        sched.enqueue_join("w0", HW)
        led = GoodputLedger()
        led.count("committed", 10)
        led.count("replayed", 2)
        reg = p_registry.MetricsRegistry()
        reg.histogram("parallax_ttft_ms", "t").observe(5.0)
        sched.enqueue_update(
            "w0", load=1, is_ready=True, goodput=led.payload(),
            health={"status": "stalled", "components": {},
                    "causes": ["step: x"]},
            events={"epoch": "b1", "batch": [
                {"seq": 1, "kind": "health", "time": 1.0}]},
            metrics=reg.histogram_snapshots())
        sched.drain_events()
        node = sched.manager.get("w0")
        assert node.health["status"] == "stalled"
        assert node.goodput["tokens_useful"] == 10
        assert node.metrics["parallax_ttft_ms"][""]["count"] == 1
        assert sched.timeline.ingested >= 2   # the batch + node_health
        kinds = [e["kind"] for e in sched.timeline.snapshot()["events"]]
        assert "node_health" in kinds
        status = sched.cluster_status()
        assert status["goodput"]["tokens_total"] == 12
        assert status["health"] == {"status": "stalled",
                                    "sick_nodes": ["w0"]}
        assert status["metrics"]["parallax_ttft_ms"][""]["count"] == 1
        assert status["timeline"]["ingested"] >= 2

    def test_cluster_status_slo_section(self):
        sched = self._sched(
            slo=parse_slo_spec("availability=0.9", window_s=0.001))
        status = sched.cluster_status()
        assert "availability=0.9" in status["slo"]["objectives"]

    def test_service_passes_metrics_and_events_through(self):
        from parallax_tpu_torch.backend.scheduler_service import (
            SchedulerService,
        )
        from parallax_tpu_torch.p2p.transport import LoopbackTransport

        sched = self._sched()
        sched.enqueue_join("w0", HW)
        sched.drain_events()
        svc = SchedulerService(sched, LoopbackTransport("sched", {}))
        snap = {"parallax_ttft_ms": {"": {
            "bounds": [1.0], "counts": [1, 0], "sum": 0.5, "count": 1}}}
        svc._on_update("w0", {"node_id": "w0", "metrics": snap,
                              "events": {"epoch": "e", "batch": [
                                  {"seq": 1, "kind": "k", "time": 1.0}]}})
        sched.drain_events()
        assert sched.manager.get("w0").metrics == snap
        assert sched.timeline.ingested == 1

    def test_heterogeneous_device_merge_and_counted_skip(self):
        sched = self._sched()
        sched.min_nodes = 2
        sched.enqueue_join("n0", HW)
        sched.enqueue_join("n1", HW)
        sched.drain_events()

        def payload(classes, programs):
            plane = DevicePlane(registry=p_registry.MetricsRegistry())
            for c, nb in classes.items():
                plane.hbm.set_class(c, nb)
            for p, s in programs.items():
                plane.time.add(p, s)
            return plane.payload()

        sched.enqueue_update("n0", is_ready=True, device=payload(
            {"kv_pages": 100, "spec_draft": 32}, {"decode_window": 4.0}))
        sched.enqueue_update("n1", is_ready=True, device=payload(
            {"kv_pages": 60, "grammar_tables": 16}, {"prefill": 1.0}))
        sched.drain_events()
        dev = sched.cluster_status()["device"]
        assert dev["nodes"] == 2 and dev["nodes_skipped"] == 0
        assert dev["hbm"]["classes"] == {
            "kv_pages": 160, "spec_draft": 32, "grammar_tables": 16}
        assert dev["programs"]["seconds"] == {"decode_window": 4.0,
                                              "prefill": 1.0}
        sched.manager.get("n0").device = None
        dev = sched.cluster_status()["device"]
        assert dev["nodes"] == 1 and dev["nodes_skipped"] == 1


def test_cluster_status_merges_node_histograms():
    from parallax_tpu_torch.scheduling.node import Node
    from parallax_tpu_torch.scheduling.node_management import Pipeline

    cfg = normalize_config(TINY)
    sched = GlobalScheduler(cfg)
    nodes = []
    for i, vals in enumerate(([5.0] * 10, [500.0] * 10)):
        reg = p_registry.MetricsRegistry()
        h = reg.histogram("parallax_ttft_ms", "ttft", labelnames=("stage",))
        for v in vals:
            h.labels(stage="0-4").observe(v)
        node = Node(node_id=f"n{i}", hardware=HW, model=cfg)
        node.set_layers(i, i + 1)
        node.metrics = reg.histogram_snapshots()
        sched.manager.add(node)
        nodes.append(node)
    sched.manager.register_pipelines([Pipeline(nodes=nodes)])
    merged = sched.cluster_status()["metrics"]["parallax_ttft_ms"]
    entry = merged[next(iter(merged))]
    assert entry["count"] == 20 and entry["p50"] < 50.0 < entry["p99"]


# -- migrated traces ---------------------------------------------------------------


def test_checkpoint_ships_and_adopts_spans():
    from parallax_tpu_torch.runtime.checkpoint import (
        checkpoint_from_request,
        checkpoint_from_wire,
        checkpoint_to_wire,
        spans_from_wire,
    )

    rid = "mig-trace-1"
    store = get_trace_store()
    store.begin(rid)
    t0 = time.perf_counter() - 2.0
    store.add(rid, "head-a", "prefill", t0=t0, dur=0.5, args={"tokens": 64})
    store.add(rid, "head-a", "decode", t0=t0 + 0.5, dur=1.0,
              args={"steps": 12})
    req = Request(rid, prompt_ids=[1, 2, 3],
                  sampling_params=SamplingParams(max_new_tokens=8))
    req.traced = True
    req.commit_token(42)
    ckpt = checkpoint_from_request(req)
    assert ckpt.trace_spans and len(ckpt.trace_spans) == 2
    restored = checkpoint_from_wire(
        json.loads(json.dumps(checkpoint_to_wire(ckpt))))
    assert restored.traced and len(restored.trace_spans) == 2
    target = TraceStore()
    assert target.adopt(rid, spans_from_wire(restored.trace_spans)) == 2
    target.add(rid, "head-b", "migrate_in", t0=time.perf_counter(), dur=0.0)
    chrome = target.export_chrome(rid)
    assert [e["name"] for e in chrome["traceEvents"]] == [
        "prefill", "decode", "migrate_in"]
    assert {e["tid"] for e in chrome["traceEvents"]} == {"head-a", "head-b"}
    untraced = Request("mig-untraced", prompt_ids=[1, 2],
                       sampling_params=SamplingParams(max_new_tokens=4))
    plain = checkpoint_from_request(untraced)
    assert plain.trace_spans is None
    assert "trace_spans" not in checkpoint_to_wire(plain)


def test_restore_adopts_spans_and_records_migrate_in():
    """A worker restoring a traced checkpoint stitches the source's spans
    into its trace store and marks the boundary; the flight recorder
    gets ``migrate_in``."""
    from parallax_tpu_torch.p2p.node import WorkerNode
    from parallax_tpu_torch.p2p.transport import LoopbackTransport
    from parallax_tpu_torch.runtime.checkpoint import checkpoint_from_request

    rid = "mig-restore-1"
    store = get_trace_store()
    store.begin(rid)
    store.add(rid, "src", "prefill", t0=time.perf_counter() - 1.0, dur=0.2)
    src = Request(rid, prompt_ids=[3, 5, 7, 9],
                  sampling_params=SamplingParams(temperature=0.0,
                                                 max_new_tokens=4))
    src.traced = True
    src.commit_token(11)
    ckpt = checkpoint_from_request(src)
    store._traces.pop(rid)                  # a fresh target process
    node = WorkerNode(LoopbackTransport("w-mig", {}), None,
                      normalize_config(TINY), EngineConfig(**ENGINE),
                      layers=(0, N_LAYERS), device="cpu")
    node.engine = _port_engines([(0, N_LAYERS)])[0]
    node._restore_checkpoint(ckpt, "src-node")
    names = [s["name"] for s in store.spans(rid)]
    assert names[:2] == ["prefill", "migrate_in"]
    kinds = [e["kind"] for e in get_flight().snapshot()["events"]
             if e.get("request_id") == rid]
    assert "migrate_in" in kinds
