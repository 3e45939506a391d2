"""The port's scheduled swarm on the CPU: a port GlobalScheduler behind its
SchedulerService and port WorkerNodes with ``scheduler_peer`` set, over
real TCP sockets on localhost, at the tiny size of tests/test_swarm_e2e.py
(4 layers, f32). Layer capacity is forced to 2 as that file does, so the
scheduler lays out one [0, 2) + [2, 4) pipeline.

- The greedy and seeded streams, routed and polled through a SwarmClient
  on the service, equal the port's InProcessPipeline's bit for bit.
- Reallocation aborts in-flight requests: the head's ("node
  reallocated", tests/test_swarm_e2e.py:492) and, through the release
  broadcast, the head's clients when the tail reloads (:523).
- Leave: the tail's node_leave dissolves the pipeline and routing
  answers None; the head parks its in-flight request as a checkpoint
  (live migration) instead of aborting it, retries the scheduler until a
  pipeline exists, and once a new tail joins restores it there by
  re-prefill and teacher-forced replay — the stream continues
  bit-identically and ``where_is`` answers the head. With no new tail the
  request aborts at the park deadline with "migration: no serviceable
  pipeline". The new pipeline serves.
- Heartbeat eviction: a worker whose beats stop is evicted by the sweep;
  when its beats resume the scheduler asks it to rejoin, and the swarm
  serves again.
- ``run`` on a thread and two ``join --scheduler-addr --device cpu``
  processes answer a chat completion over HTTP, serve
  ``/cluster/status_json``, and exit 0 on SIGTERM.

Every wait has its own deadline and every transport stops in ``finally``.
"""

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import threading

import pytest

import parallax_tpu.scheduling.node as j_node
from parallax_tpu_torch import cli
from parallax_tpu_torch.backend.run import SwarmClient, run_main
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import TcpTransport
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling import node as p_node
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from tests.test_torch_swarm import (
    CFG,
    DEADLINE_S,
    ENGINE,
    N_NEW,
    PROMPTS,
    REPO,
    _in_process,
    _port_params,
    _post,
    _requests,
    _wait,
    _write_checkpoint,
)


@pytest.fixture(autouse=True)
def two_layer_capacity(monkeypatch):
    """Every node holds 2 of the 4 layers (both packages' roofline)."""
    for mod in (j_node, p_node):
        monkeypatch.setattr(mod.RooflinePerformanceModel,
                            "max_layers_in_memory",
                            lambda self, kv_fraction=0.35: 2)


def _port_worker(sched_addr: str, engine=None) -> WorkerNode:
    t = TcpTransport("", "127.0.0.1")
    t.start()
    t.peer_id = t.address
    return WorkerNode(t, sched_addr, CFG, EngineConfig(**(engine or ENGINE)),
                      load_params=_port_params, heartbeat_interval_s=0.2,
                      device="cpu")


def _start_all(workers) -> None:
    """Start workers together: each join blocks until the scheduler has
    bootstrapped."""
    starters = [threading.Thread(target=w.start) for w in workers]
    for s in starters:
        s.start()
    for s in starters:
        s.join(DEADLINE_S)


def _ready(service, n_nodes=2) -> bool:
    st = service.scheduler.cluster_status()
    nodes = [n for p in st["pipelines"] for n in p["nodes"]]
    return len(nodes) == n_nodes and all(n["ready"] for n in nodes)


@contextlib.contextmanager
def sched_swarm(engine=None, heartbeat_timeout_s=30.0, grammar_vocab=None):
    sched = GlobalScheduler(CFG, min_nodes_bootstrapping=2,
                            heartbeat_timeout_s=heartbeat_timeout_s)
    st = TcpTransport("scheduler", "127.0.0.1")
    service = SchedulerService(sched, st, join_timeout_s=DEADLINE_S)
    workers = []
    try:
        service.start()
        workers = [_port_worker(st.address, engine) for _ in range(2)]
        for w in workers:
            # No tokenizer files in this synthetic swarm: seed the grammar
            # vocabulary the last stage's _wire_grammar hands its engine.
            w._grammar_vocab = grammar_vocab
        _start_all(workers)
        assert _wait(lambda: _ready(service)), sched.cluster_status()
        yield service, workers
    finally:
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        service.stop()


def _by_path(service, workers):
    path = [n["node_id"] for n in
            service.scheduler.cluster_status()["pipelines"][0]["nodes"]]
    ids = {w.node_id: w for w in workers}
    return path, ids[path[0]], ids[path[-1]]


def test_scheduled_swarm_matches_in_process_pipeline():
    with sched_swarm() as (service, workers):
        path, head, tail = _by_path(service, workers)
        assert [(w.start_layer, w.end_layer) for w in (head, tail)] == [
            (0, 2), (2, 4)]
        client = SwarmClient(service.transport, service)
        reqs = _requests(Request, SamplingParams)
        events = []
        for r in reqs:
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            assert r.routing_table == path
            events.append(client.submit(r))
        for r, ev in zip(reqs, events):
            assert ev.wait(DEADLINE_S), f"{r.request_id}: {r.status}"
            assert r.status.value == "finished_length"
            assert len(r.output_ids) == N_NEW
        # Every path's load charge came back through request_complete,
        # and the tail's mirrors were released.
        assert _wait(lambda: all(
            n.load == 0 for n in service.scheduler.manager.nodes()))
        assert _wait(lambda: tail.engine.scheduler.num_requests() == 0)
        routing = service.scheduler.cluster_status()["routing"]
        assert routing["pipeline_dispatches"] == {"0": len(reqs)}
    ref = _in_process()
    assert [r.output_ids for r in reqs] == [r.output_ids for r in ref]


# The byte grammar vocabulary over the 270-id model, EOS last.
GRAMMAR_VOCAB = ([bytes([i]) for i in range(256)] + [b""] * 14, 269)
SCHEMA = json.dumps({"type": "object",
                     "properties": {"v": {"enum": ["x", "y"]}},
                     "required": ["v"]})


def _feature_requests():
    return [
        Request("gram", prompt_ids=[1, 2, 3], eos_token_ids=(269,),
                sampling_params=SamplingParams(
                    temperature=0.0, max_new_tokens=30, json_schema=SCHEMA)),
        Request("pen", prompt_ids=[9, 8, 7, 6], sampling_params=SamplingParams(
            temperature=0.8, top_k=20, seed=7, max_new_tokens=N_NEW,
            repetition_penalty=1.3, presence_penalty=0.5,
            frequency_penalty=0.2, logprobs=True,
            logit_bias={5: 3.0})),
        Request("free", prompt_ids=[42, 43], sampling_params=SamplingParams(
            temperature=0.0, max_new_tokens=N_NEW)),
    ]


def test_scheduled_swarm_samples_with_features():
    """A grammar row (its vocabulary seeded into the workers, as the JAX
    test does), a seeded penalised, biased logprob row and a free row
    through the scheduled 2 + 2 swarm: the tail samples with the features
    (penalties from its mirror's generated ids, the logprob back to the
    head in ``token_logprob``), and every stream equals the in-process
    pipeline's, logprobs included."""
    with sched_swarm(grammar_vocab=GRAMMAR_VOCAB) as (service, workers):
        path, head, tail = _by_path(service, workers)
        assert tail.engine.grammar is not None and head.engine.grammar is None
        client = SwarmClient(service.transport, service)
        reqs = _feature_requests()
        events = []
        for r in reqs:
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            events.append(client.submit(r))
        for r, ev in zip(reqs, events):
            assert ev.wait(DEADLINE_S), f"{r.request_id}: {r.status}"
    engines = [StageEngine(create_stage_model(CFG, s, e),
                           _port_params(create_stage_model(CFG, s, e)),
                           EngineConfig(**ENGINE), device="cpu")
               for s, e in ((0, 2), (2, 4))]
    engines[-1].set_grammar_vocab(*GRAMMAR_VOCAB)
    ref = _feature_requests()
    pipe = InProcessPipeline(engines)
    for r in ref:
        pipe.submit(r)
    pipe.run_until_complete()
    for a, b in zip(reqs, ref):
        assert a.status.value == b.status.value, a.request_id
        assert a.output_ids == b.output_ids, a.request_id
        assert a.output_logprobs == b.output_logprobs
    obj = json.loads(bytes(t for t in reqs[0].output_ids if t < 256))
    assert obj["v"] in ("x", "y")
    assert reqs[0].status.value == "finished_eos"
    assert len(reqs[1].output_logprobs) == N_NEW


def _long_request(rid, path, prompt=(1, 2, 3)):
    return Request(rid, prompt_ids=list(prompt),
                   sampling_params=SamplingParams(
                       temperature=0.0, max_new_tokens=10_000,
                       ignore_eos=True),
                   routing_table=list(path))


LONG = dict(ENGINE, max_model_len=4096, num_pages=520)


@pytest.mark.parametrize("stage", ["head", "tail"])
def test_reallocation_aborts_in_flight_requests(stage):
    """A worker forced to reload (as a rebalance would) aborts its
    in-flight requests; a tail reload unblocks the head's client through
    the release broadcast."""
    with sched_swarm(engine=LONG) as (service, workers):
        path, head, tail = _by_path(service, workers)
        req = _long_request(f"inflight-{stage}", path)
        ev = head.submit(req)
        assert _wait(lambda: len(req.output_ids) > 2), req.status
        if stage == "head":
            head._post(("reload", {"start_layer": 0, "end_layer": 3}))
        else:
            tail._post(("reload", {"start_layer": 1, "end_layer": 4}))
        assert ev.wait(DEADLINE_S), "in-flight request hung"
        assert req.status.value == "finished_abort"
        if stage == "head":
            assert req.abort_reason == "node reallocated"


def _reference_stream(prompt, n):
    """The unchurned greedy stream of ``prompt`` through the in-process
    [0, 2) + [2, 4) pipeline."""
    engines = [StageEngine(create_stage_model(CFG, s, e),
                           _port_params(create_stage_model(CFG, s, e)),
                           EngineConfig(**LONG), device="cpu")
               for s, e in ((0, 2), (2, 4))]
    pipe = InProcessPipeline(engines)
    r = Request("ref", prompt_ids=list(prompt), sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=n, ignore_eos=True))
    pipe.submit(r)
    pipe.run_until_complete()
    return r.output_ids


def test_leave_dissolves_and_a_new_tail_recovers():
    """What the JAX worker does under the same leave and rejoin
    (tests/test_torch_sched_mixed.py runs it with JAX workers): park,
    retry until a pipeline exists, restore by replay, continue."""
    with sched_swarm(engine=LONG) as (service, workers):
        path, head, tail = _by_path(service, workers)
        req = _long_request("before-leave", path)
        ev = head.submit(req)
        assert _wait(lambda: len(req.output_ids) > 2)
        tail.stop()
        # node_leave: the pipeline dissolves; the head parks the request
        # (its sender's failure or the drain directive) and keeps asking
        # the scheduler for a target.
        assert _wait(lambda: "before-leave" in head._migration_parked)
        assert not req.status.is_finished
        assert _wait(lambda: not service.scheduler.manager.pipelines)
        assert service.scheduler.manager.get(tail.node_id) is None
        assert service.route_request("no-path", timeout_s=0.5) is None
        before = list(req.output_ids)
        new = _port_worker(service.transport.address, LONG)
        workers.append(new)
        _start_all([new])
        assert _wait(lambda: _ready(service)), \
            service.scheduler.cluster_status()
        path, head, _ = _by_path(service, workers)
        assert new.node_id in path
        # Restored on the new pipeline's head by re-prefill + replay, the
        # stream continuing past what it had; where_is answers the head.
        assert _wait(lambda: "before-leave" in head.restores), \
            head._migration_parked
        assert head.restores["before-leave"][0] == "replay"
        moved = head._chat_requests["before-leave"]
        assert _wait(lambda: len(moved.output_ids) > len(before) + 8)
        assert not ev.is_set() and not moved.status.is_finished
        assert service.scheduler.migrated_head("before-leave") == head.node_id
        got = list(moved.output_ids[:len(before) + 8])
        assert got[:len(before)] == before
        assert got == _reference_stream((1, 2, 3), len(got))
        client = SwarmClient(service.transport, service)
        r = Request("after-leave", prompt_ids=list(PROMPTS[0]),
                    sampling_params=SamplingParams(temperature=0.0,
                                                   max_new_tokens=N_NEW))
        r.routing_table = client.route(r.request_id, prompt_ids=r.prompt_ids)
        assert client.submit(r).wait(DEADLINE_S), r.status
        assert r.status.value == "finished_length"
    assert r.output_ids == _in_process(seeded=False)[0].output_ids


def test_leave_without_a_new_tail_aborts_at_the_park_deadline():
    with sched_swarm(engine=LONG) as (service, workers):
        path, head, tail = _by_path(service, workers)
        head.MIGRATION_PARK_TIMEOUT_S = 1.0
        req = _long_request("stranded", path)
        ev = head.submit(req)
        assert _wait(lambda: len(req.output_ids) > 2)
        tail.stop()
        assert ev.wait(DEADLINE_S), req.status
        assert req.status.value == "finished_abort"
        assert req.abort_reason == "migration: no serviceable pipeline"
        assert not head._migration_parked and not head._migration_pending


def test_heartbeat_eviction_then_rejoin():
    with sched_swarm(heartbeat_timeout_s=1.0) as (service, workers):
        quiet = workers[1]
        quiet._heartbeat = lambda: None
        assert _wait(lambda: service.scheduler.manager.get(quiet.node_id)
                     is None), service.scheduler.cluster_status()
        assert not service.scheduler.manager.pipelines
        del quiet._heartbeat
        # The next beat gets {"rejoin": True}: the worker rejoins and the
        # scheduler bootstraps again.
        assert _wait(lambda: _ready(service)), \
            service.scheduler.cluster_status()
        path, head, _ = _by_path(service, workers)
        r = Request("after-rejoin", prompt_ids=list(PROMPTS[1]),
                    sampling_params=SamplingParams(temperature=0.0,
                                                   max_new_tokens=N_NEW),
                    routing_table=path)
        assert head.submit(r).wait(DEADLINE_S), r.status
        assert r.status.value == "finished_length"
    assert r.output_ids == _in_process(seeded=False)[1].output_ids


def test_run_and_join_processes_serve_over_http(tmp_path):
    """The entry points as a user starts them: ``run`` (its parser and
    run_main, on a thread) and two ``join --scheduler-addr --device cpu``
    processes; one chat completion; ``/cluster/status_json`` shows the
    pipeline; SIGTERM: each worker exits 0 with no step loop error."""
    ckpt = str(tmp_path)
    _write_checkpoint(ckpt)
    args = cli.build_parser().parse_args(
        ["run", "--model-name", ckpt, "--min-nodes", "2", "--port", "0",
         "--host", "127.0.0.1"])
    assert cli.unported_flags(args) == []
    box, started = [], threading.Event()
    server = threading.Thread(
        target=run_main,
        args=(args, lambda fe, svc: (box.extend((fe, svc)), started.set())),
        daemon=True)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    procs, logs = [], []
    try:
        server.start()
        assert started.wait(DEADLINE_S)
        fe, svc = box
        for i in range(2):
            log = open(os.path.join(ckpt, f"join{i}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "parallax_tpu_torch", "join",
                 "--scheduler-addr", svc.transport.address,
                 "--model-path", ckpt, "--device", "cpu",
                 "--advertise-addr", "127.0.0.1", "--port", "0"],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))

        def ready():
            _, st = _post(fe.port, "/cluster/status_json", None, "GET")
            nodes = [n for p in st["pipelines"] for n in p["nodes"]]
            return len(nodes) == 2 and all(n["ready"] for n in nodes)

        assert _wait(ready, 90.0)
        status, st = _post(fe.port, "/cluster/status_json", None, "GET")
        assert status == 200 and st["num_pipelines"] == 1
        assert [n["layers"] for n in st["pipelines"][0]["nodes"]] == [
            [0, 2], [2, 4]]
        assert st["routing"]["strategy"] == "rr"
        body = {"messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 5, "temperature": 0.0, "ignore_eos": True}
        status, reply = _post(fe.port, "/v1/chat/completions", body,
                              timeout=120.0)
        assert status == 200, reply
        assert reply["usage"]["completion_tokens"] == 5
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(30) == 0
        # Both workers said node_leave.
        assert _wait(lambda: _post(fe.port, "/cluster/status_json", None,
                                   "GET")[1]["num_nodes"] == 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        if box:
            box[0].shutdown()
        server.join(DEADLINE_S)
    for log in logs:
        log.seek(0)
        text = log.read()
        log.close()
        assert "step loop error" not in text and "Traceback" not in text, \
            text[-3000:]
        # The exit lines: the plain path launched no kernel.
        m = re.search(r"kernel launches: (\{.*\})", text)
        assert m is not None and not any(json.loads(m.group(1)).values())
