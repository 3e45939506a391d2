"""The port's scheduler-less swarm (parallax_tpu_torch.p2p.node.WorkerNode,
p2p/join.py, backend/run.py) on the CPU, at the tiny size of
tests/test_swarm_e2e.py (4 layers, f32), stages [0, 2) + [2, 4) over real
TCP sockets on localhost.

- Gossip converges and the head computes its own route; the greedy and
  seeded streams equal the port's InProcessPipeline's bit for bit on the
  same weights, and the mirrors are released.
- The JAX package's scheduler-less swarm on the same weights (each stage's
  ``jax.random.key(start * 1000 + end)`` tree, carried across by
  ``params_from_numpy``), and the mixed pipelines (a JAX stage 0 with a
  port stage 1, and the reverse): greedy streams under the tie-tolerant
  rule of tests/test_engine_e2e.py::assert_greedy_matches against the JAX
  model's one-shot logits, parting from the JAX swarm's only at
  near-ties.
- A RELEASE reaches the tail after the request's last FORWARD, and a
  slowed FORWARD handler lets no later frame overtake its own.
- RPC fields the port does not run are refused by name and item.
- Tail death: the route disappears and the in-flight request aborts.
- ``chat-host``'s frontend answers /v1/chat/completions through the head.
- ``python -m parallax_tpu_torch join --device cpu`` twice (subprocesses)
  with a chat host in front: a chat completion over HTTP, then both
  workers exit 0 on SIGTERM; the refused ``join`` flags exit 2 naming
  their ROADMAP items.

Every wait has its own deadline and every transport stops in ``finally``.
"""

import contextlib
import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.p2p.node import WorkerNode as JWorkerNode
from parallax_tpu.p2p.transport import TcpTransport as JTcpTransport
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch import cli
from parallax_tpu_torch.backend.run import build_chat_host_frontend
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.p2p.join import build_worker
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import TcpTransport
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_swarm_e2e.py's tiny model, with a vocabulary that covers the
# byte tokenizer's ids (BOS 256, EOS 257).
RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=270, max_position_embeddings=256, tie_word_embeddings=False,
    torch_dtype="float32",
)
JCFG, CFG = j_normalize(RAW), normalize_config(RAW)
ENGINE = dict(page_size=8, num_pages=64, max_model_len=128,
              kv_dtype="float32", max_num_tokens_per_batch=128,
              max_batch_size=8)
BOUNDS = [(0, 2), (2, 4)]
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5, 4, 3, 2, 1, 10, 11, 12],
           [3] * 20, [200, 17, 5, 99, 31]]
SEEDED = {3: dict(temperature=0.8, top_k=20, seed=11)}
N_NEW = 8
TOL = 5e-3
DEADLINE_S = 30.0

_TREES: dict = {}


def _stage_tree(s: int, e: int):
    """Stage [s, e)'s JAX random tree (the JAX worker's own seed), and the
    same as numpy."""
    if (s, e) not in _TREES:
        tree = JStageModel(JCFG, s, e, use_pallas=False).init_params(
            jax.random.key(s * 1000 + e), dtype=jnp.float32)
        _TREES[(s, e)] = (tree, jax.tree.map(np.asarray, tree))
    return _TREES[(s, e)]


def _jax_params(model):
    return _stage_tree(model.start_layer, model.end_layer)[0]


def _port_params(model):
    return params_from_numpy(
        _stage_tree(model.start_layer, model.end_layer)[1], "cpu")


def _wait(cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return bool(cond())


@contextlib.contextmanager
def swarm(kinds=("port", "port"), engine=None, transport_cls=None):
    """Workers of ``kinds`` ("port" / "jax") on BOUNDS, gossiping over
    TCP; yields them once the head has its route, stops them all."""
    engine = engine or ENGINE
    workers, transports = [], []
    try:
        for kind in kinds:
            cls = transport_cls or (TcpTransport if kind == "port"
                                    else JTcpTransport)
            t = cls("", "127.0.0.1")
            t.start()
            t.peer_id = t.address
            transports.append(t)
        addrs = [t.address for t in transports]
        for kind, t, (s, e) in zip(kinds, transports, BOUNDS):
            peers = [a for a in addrs if a != t.address]
            if kind == "port":
                w = WorkerNode(t, None, CFG, EngineConfig(**engine),
                               load_params=_port_params,
                               heartbeat_interval_s=0.2, static_peers=peers,
                               layers=(s, e), device="cpu")
            else:
                w = JWorkerNode(transport=t, scheduler_peer=None,
                                model_config=JCFG,
                                engine_config=JEngineConfig(**engine),
                                load_params=_jax_params,
                                heartbeat_interval_s=0.2,
                                static_peers=peers, layers=(s, e))
            workers.append(w)
        for w in workers:
            w.start()
        assert _wait(lambda: workers[0].local_route() == addrs), \
            workers[0].local_route()
        yield workers
    finally:
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        for t in transports:
            with contextlib.suppress(Exception):
                t.stop()


def _requests(cls_req, cls_sp, seeded=True, prompts=PROMPTS):
    out = []
    for i, p in enumerate(prompts):
        kw = SEEDED.get(i, dict(temperature=0.0)) if seeded else \
            dict(temperature=0.0)
        out.append(cls_req(f"r{i}", prompt_ids=list(p),
                           sampling_params=cls_sp(max_new_tokens=N_NEW,
                                                  **kw)))
    return out


def _serve(head, reqs):
    events = [head.submit(r) for r in reqs]
    for r, ev in zip(reqs, events):
        assert ev.wait(DEADLINE_S), f"{r.request_id}: {r.status}"
        assert r.status.value == "finished_length", (r.request_id, r.status)
        assert len(r.output_ids) == N_NEW
    return reqs


def _in_process(seeded=True, engine=None, prompts=PROMPTS):
    engines = [StageEngine(create_stage_model(CFG, s, e),
                           _port_params(create_stage_model(CFG, s, e)),
                           EngineConfig(**(engine or ENGINE)), device="cpu")
               for s, e in BOUNDS]
    pipe = InProcessPipeline(engines)
    reqs = _requests(Request, SamplingParams, seeded, prompts)
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


# Prompts of several 16-token chunks each: the head keeps a step in
# flight across their chunks, and the tail receives several before it
# steps.
LONG_PROMPTS = [list(range(1, 41)), [7, 3] * 25, [200, 17, 5] * 11,
                list(range(100, 120))]


@pytest.mark.parametrize("chunk,prompts", [(1024, PROMPTS),
                                           (16, LONG_PROMPTS)],
                         ids=["one-chunk", "chunked"])
def test_port_swarm_matches_in_process_pipeline(chunk, prompts):
    engine = dict(ENGINE, prefill_chunk_size=chunk)
    with swarm(engine=engine) as (head, tail):
        got = _serve(head, _requests(Request, SamplingParams,
                                     prompts=prompts))
        # The head releases the tail's mirrors.
        assert _wait(lambda: tail.engine.scheduler.num_requests() == 0)
        summaries = [w.engine.kernel_dispatch_summary() for w in (head, tail)]
        stats = head.transport_stats()[tail.node_id]
        rx = tail.transport_stats()[head.node_id]
    ref = _in_process(engine=engine, prompts=prompts)
    assert [r.output_ids for r in got] == [r.output_ids for r in ref]
    for s in summaries:
        assert s["impl"] == "torch" and not s["cuda_graphs"]
    # Only the tail samples; the head only forwards.
    assert not any(k.endswith("/sample")
                   for k in summaries[0]["dispatch_total"])
    assert any(k.endswith("/sample") for k in summaries[1]["dispatch_total"])
    # Every hidden row crossed the hop once, at 4 bytes a value.
    rows = sum(len(p) + N_NEW - 1 for p in prompts)
    assert stats["bytes_out"] == rx["bytes_in"] == rows * 64 * 4
    assert stats["errors"] == stats["drops"] == 0


def _merged_tree():
    s0, s1 = _stage_tree(0, 2)[0], _stage_tree(2, 4)[0]
    return {"embed_tokens": s0["embed_tokens"],
            "layers": list(s0["layers"]) + list(s1["layers"]),
            "norm": s1["norm"], "lm_head": s1["lm_head"]}


def _reference_logits(ctx: list[int]) -> np.ndarray:
    """The JAX model's logits at every position of ``ctx`` (one forward
    over the stages' weights)."""
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = JStageModel(JCFG, 0, 4, use_pallas=False)
    page = 8
    npages = (n + page - 1) // page
    kv = model.new_kv_caches(npages + 1, page, jnp.float32)
    tok = np.zeros(t, np.int32)
    tok[:n] = ctx
    pos = np.zeros(t, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(t, -1, np.int32)
    slots[:n] = np.arange(n) + page
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray([n], jnp.int32),
        page_indices=jnp.asarray(np.arange(1, npages + 1)[None], jnp.int32),
        cu_q_lens=jnp.asarray([0, n], jnp.int32),
        num_seqs=jnp.asarray([1], jnp.int32), slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32),
    )
    logits, _ = model(_merged_tree(), kv, inp)
    return np.asarray(logits)[:n]


@pytest.fixture(scope="module")
def jax_streams():
    with swarm(("jax", "jax")) as (head, _tail):
        reqs = _serve(head, _requests(JRequest, JSampling, seeded=False))
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("kinds", [("port", "port"), ("jax", "port"),
                                   ("port", "jax")],
                         ids=["port-port", "jax-port", "port-jax"])
def test_swarm_matches_jax_swarm(kinds, jax_streams):
    req_cls, sp_cls = ((Request, SamplingParams) if kinds[0] == "port"
                       else (JRequest, JSampling))
    with swarm(kinds) as (head, _tail):
        got = _serve(head, _requests(req_cls, sp_cls, seeded=False))
    for r, want in zip(got, jax_streams):
        ctx = list(r.prompt_ids) + list(r.output_ids[:-1])
        logits = _reference_logits(ctx)
        p0 = len(r.prompt_ids) - 1
        for i, tok in enumerate(r.output_ids):
            row = logits[p0 + i]
            best = int(np.argmax(row))
            assert tok == best or float(row[best] - row[tok]) < TOL, \
                (kinds, r.request_id, i, tok, best)
        same = 0
        while same < N_NEW and r.output_ids[same] == want[same]:
            same += 1
        if same < N_NEW:
            row = logits[p0 + same]
            gap = abs(float(row[r.output_ids[same]] - row[want[same]]))
            assert gap < TOL, (kinds, r.request_id, same, gap)


def test_release_never_overtakes_the_last_forward():
    """The head's RELEASE rides the FORWARD frames' FIFO into the tail's
    inbox: each request's RELEASE lands after its last FORWARD (chunked
    prompts, so a request sends several FORWARD frames back to back)."""
    engine = dict(ENGINE, prefill_chunk_size=16)
    with swarm(engine=engine) as (head, tail):
        order, post = [], tail._post

        def recording_post(item):
            if item[0] in ("forward", "release"):
                rid = item[1].request_id if item[0] == "forward" else item[1]
                order.append((item[0], rid))
            post(item)

        tail._post = recording_post
        _serve(head, _requests(Request, SamplingParams,
                               prompts=LONG_PROMPTS))
        assert _wait(lambda: sum(k == "release" for k, _ in order)
                     == len(LONG_PROMPTS))
        seen = list(order)
    for i in range(len(LONG_PROMPTS)):
        rid = f"r{i}"
        fwd = [k for k, e in enumerate(seen) if e == ("forward", rid)]
        rel = [k for k, e in enumerate(seen) if e == ("release", rid)]
        assert fwd and len(rel) == 1 and max(fwd) < rel[0], (rid, seen)


@pytest.mark.parametrize("delay", ["first-frame", "jitter"])
def test_slow_frames_are_not_overtaken(delay):
    """The tail's FORWARD handler is slowed: by 0.3 s on each request's
    first frame, or by a seeded 0-50 ms on every frame. Later frames of
    the connection then reach the receiving transport while an earlier
    one is still in its handler. The transport hands them to the inbox in
    arrival order all the same, so every chunked request finishes and
    the streams equal the in-process pipeline's. (Handed over as their
    handlers finish, both give wrong streams, and the jitter can leave a
    request decoding for ever.)"""
    import random

    engine = dict(ENGINE, prefill_chunk_size=16)
    rng = random.Random(3)
    with swarm(engine=engine) as (head, tail):
        seen, on_forward = set(), tail._on_forward

        def slow(peer, payload):
            rids = {r["rid"] for r in payload["reqs"]}
            if delay == "jitter":
                time.sleep(rng.random() * 0.05)
            elif rids - seen:
                seen.update(rids)
                time.sleep(0.3)
            return on_forward(peer, payload)

        tail.transport.register(proto.FORWARD, slow)
        got = _serve(head, _requests(Request, SamplingParams,
                                     prompts=LONG_PROMPTS))
    ref = _in_process(engine=engine, prompts=LONG_PROMPTS)
    assert [r.output_ids for r in got] == [r.output_ids for r in ref]


def test_tail_death_drops_the_route_and_aborts_in_flight():
    long_cfg = dict(ENGINE, max_model_len=4096, num_pages=520)
    with swarm(engine=long_cfg) as (head, tail):
        head.peer_ttl_s = 1.0
        req = Request("midserve", prompt_ids=[1, 2, 3, 4, 5],
                      sampling_params=SamplingParams(
                          temperature=0.0, max_new_tokens=4000,
                          ignore_eos=True))
        ev = head.submit(req)
        assert _wait(lambda: len(req.output_ids) > 4)
        tail.stop()
        assert ev.wait(DEADLINE_S), f"request hung: {req.status}"
        assert req.status.value == "finished_abort"
        assert _wait(lambda: head.local_route() is None)


def _post(port: int, path: str, body: dict | None, method="POST",
          timeout=DEADLINE_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_chat_host_fronts_port_swarm():
    host_t = TcpTransport("", "127.0.0.1")
    frontend = server = None
    try:
        with swarm() as (head, _tail):
            host_t.start()
            host_t.peer_id = host_t.address
            frontend, _client = build_chat_host_frontend(
                head.node_id, SimpleTokenizer(), "tiny", transport=host_t)
            started = threading.Event()
            server = threading.Thread(
                target=frontend.run,
                kwargs=dict(host="127.0.0.1", port=0,
                            on_start=lambda _fe: started.set()),
                daemon=True)
            server.start()
            assert started.wait(DEADLINE_S)
            status, body = _post(frontend.port, "/v1/chat/completions", {
                "model": "tiny",
                "messages": [{"role": "user", "content": "hi there"}],
                "max_tokens": 6, "temperature": 0.0, "ignore_eos": True,
            })
            assert status == 200, body
            assert body["usage"]["completion_tokens"] == 6
            assert body["choices"][0]["finish_reason"] == "length"
            # The chat page (the JAX frontend's bytes).
            conn = http.client.HTTPConnection("127.0.0.1", frontend.port,
                                              timeout=DEADLINE_S)
            conn.request("GET", "/chat")
            resp = conn.getresponse()
            page = resp.read().decode()
            conn.close()
            assert resp.status == 200 and "parallax-tpu chat" in page
    finally:
        if frontend is not None and frontend.server is not None:
            frontend.shutdown()
        if server is not None:
            server.join(DEADLINE_S)
        host_t.stop()


def test_chat_host_answers_503_without_a_route():
    host_t = TcpTransport("", "127.0.0.1")
    dead = TcpTransport("", "127.0.0.1")
    frontend = server = None
    try:
        dead.start()
        dead.peer_id = dead.address
        host_t.start()
        host_t.peer_id = host_t.address
        # A head that has no CHAT_READY handler is not ready.
        frontend, client = build_chat_host_frontend(
            dead.address, SimpleTokenizer(), "tiny", transport=host_t)
        assert client.route("x") is None
        started = threading.Event()
        server = threading.Thread(
            target=frontend.run, kwargs=dict(
                host="127.0.0.1", port=0,
                on_start=lambda _fe: started.set()), daemon=True)
        server.start()
        assert started.wait(DEADLINE_S)
        status, body = _post(frontend.port, "/v1/completions",
                             {"prompt": "hi", "max_tokens": 2})
        assert status == 503, body
    finally:
        if frontend is not None and frontend.server is not None:
            frontend.shutdown()
        if server is not None:
            server.join(DEADLINE_S)
        host_t.stop()
        dead.stop()


@pytest.mark.parametrize("argv,item", [
    (["--refit-cache-dir", "/x"], 12),
    (["--compilation-cache-dir", "/x"], 12),
    (["--lora-adapters", "a=/x"], 11),
    (["--lora-max-adapters", "2"], 11),
    (["--wire-dtype", "fp8"], 11),
    (["--sp-size", "2"], 10),
    (["--speculative-tokens", "4", "--sp-size", "2"], 10),
    (["--trace-sample-rate", "0.5"], 9),
    (["--watchdog"], 9),
    (["--qos", "on"], 9),
])
def test_refused_join_flags_exit_2(tmp_path, capsys, argv, item):
    if argv[0] in ("--trace-sample-rate", "--watchdog", "--qos"):
        # Ported with the observability and QoS planes: they pass now.
        args = cli.build_parser().parse_args(
            ["join", "--model-path", str(tmp_path), "--start-layer", "0",
             "--end-layer", "2", *argv])
        assert cli.unported_flags(args) == []
        return
    assert cli.main(["join", "--model-path", str(tmp_path), "--start-layer",
                     "0", "--end-layer", "2", *argv]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"item {item})" in err
    args = cli.build_parser().parse_args(
        ["join", "--model-path", str(tmp_path), "--wire-dtype", "bf16",
         "--peers", "a:1", "--decode-lookahead", "4", "--no-decode-fused"])
    assert cli.unported_flags(args) == []


_SUBMIT = {"rid": "q", "prompt_ids": [1, 2, 3]}
_PACKET = {"rid": "q", "ctx": 3}


@pytest.mark.parametrize("method,payload,item", [
    (proto.CHAT_SUBMIT, dict(_SUBMIT, qos_class="interactive"), 9),
    (proto.CHAT_SUBMIT, dict(_SUBMIT, deadline_ms=500), 9),
    (proto.CHAT_SUBMIT, dict(_SUBMIT, tenant="t0"), 9),
    (proto.FORWARD, {"reqs": [dict(_PACKET, qos="batch")]}, 9),
    (proto.FORWARD, {"reqs": [dict(_PACKET, lora_id="a")]}, 11),
    # Pipeline speculation's packets are ported, and traced ones too now.
    (proto.FORWARD, {"reqs": [dict(_PACKET, spec_len=2, trace=True)]}, 9),
    (proto.FORWARD, b"\x12\x0b\x0a\x01q\x42\x06tenant", 11),
    (proto.PROFILE, {}, 9),
], ids=["qos_class", "deadline_ms", "tenant", "qos-packet",
        "lora-packet", "spec-packet", "protobuf-lora", "profile"])
def test_refused_rpcs_name_their_items(method, payload, item):
    """A worker refuses, by name and ROADMAP item, every RPC field it does
    not run; it accepts none of them to ignore it. Nothing reaches the
    step loop, so the worker need not start."""
    from parallax_tpu_torch.p2p.transport import LoopbackTransport

    reg = {}
    node = WorkerNode(LoopbackTransport("w", reg), None, CFG,
                      EngineConfig(**ENGINE), layers=(0, 2), device="cpu")
    if item == 9 and method == proto.CHAT_SUBMIT:
        # QoS is ported: the fields reach the request (the deadline as a
        # remaining budget on this process's clock).
        LoopbackTransport("c", reg).call("w", method, payload)
        req = node._chat_requests["q"]
        assert req.qos_class == payload.get("qos_class")
        assert req.tenant_id == payload.get("tenant")
        assert (req.deadline is not None) == ("deadline_ms" in payload)
        return
    if method == proto.FORWARD and "qos" in str(payload):
        # A QoS-tagged packet is accepted: its class lands in the inbox.
        from parallax_tpu_torch.runtime.request import IntermediateRequest

        whole = proto.ireq_to_wire(IntermediateRequest(
            request_id="q", routing_table=["w"], context_len=3,
            num_new_tokens=3, token_ids=[1, 2, 3], qos_class="batch"))
        LoopbackTransport("c", reg).call("w", method, {"reqs": [whole]})
        kind, ireq = node._inbox.get_nowait()
        assert kind == "forward" and ireq.qos_class == "batch"
        return
    if method == proto.PROFILE:
        # Profiling is ported: an action-less frame is an error reply,
        # and nothing reaches the step loop.
        reply = LoopbackTransport("c", reg).call("w", method, payload)
        assert reply == {"node_id": "w", "error": "unknown action ''"}
        assert node._inbox.empty()
        return
    if isinstance(payload, dict) and any(
            p.get("trace") for p in payload.get("reqs", ())):
        # A traced packet is accepted now: a whole one (this row's stub
        # carries only the fields a refusal read) lands in the step inbox.
        from parallax_tpu_torch.runtime.request import IntermediateRequest

        whole = proto.ireq_to_wire(IntermediateRequest(
            request_id="q", routing_table=["w"], context_len=3,
            num_new_tokens=3, token_ids=[1, 2, 3], spec_len=2, trace=True))
        LoopbackTransport("c", reg).call("w", method, {"reqs": [whole]})
        kind, ireq = node._inbox.get_nowait()
        assert kind == "forward" and ireq.trace and ireq.spec_len == 2
        return
    with pytest.raises(NotImplementedError, match=rf"item {item}\)"):
        LoopbackTransport("c", reg).call("w", method, payload)
    assert node._inbox.empty() and not node._chat_requests


def test_join_host_cache_bytes_builds_the_tier(tmp_path):
    """``join --host-cache-bytes`` is ported: the flag passes, the worker's
    engine config carries the budget, and an engine built from it has the
    tier; without the flag on the CPU the tier is off, as the JAX join's
    default is. (The worker is not started: its config is what ``join``
    decides; only config.json is written.)"""
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(RAW, f)
    base = ["join", "--model-path", str(tmp_path), "--start-layer", "0",
            "--end-layer", "4", "--device", "cpu", "--port", "0",
            "--advertise-addr", "127.0.0.1"]
    args = cli.build_parser().parse_args(base + ["--host-cache-bytes",
                                                 str(1 << 20)])
    assert cli.unported_flags(args) == []
    configs = []
    for argv in (args, cli.build_parser().parse_args(base)):
        node = build_worker(argv)
        node.transport.stop()
        configs.append(node.engine_config)
    assert configs[0].host_cache_bytes == 1 << 20
    assert configs[1].host_cache_bytes == 0
    model = create_stage_model(CFG, 0, 4)
    eng = StageEngine(model, _port_params(model),
                      dataclasses.replace(configs[0], **ENGINE),
                      device="cpu")
    tier = eng.host_tier
    assert tier is not None and tier.capacity_pages == (
        (1 << 20) // tier.pool.page_nbytes)


@pytest.mark.parametrize("argv,peers", [
    (["--scheduler-addr", "10.0.0.1:3002", "--scheduler-standby",
      "10.0.0.2:3002, 10.0.0.3:3002"],
     ["10.0.0.1:3002", "10.0.0.2:3002", "10.0.0.3:3002"]),
    (["--scheduler-standby", "10.0.0.2:3002", "--peers", "a:1"], None),
], ids=["scheduled", "scheduler-less"])
def test_join_scheduler_standby_seeds_the_failover(tmp_path, argv, peers):
    """``join --scheduler-standby`` is ported, as the JAX join takes it: a
    scheduled worker routes its scheduler RPCs through a failover rotation
    over the primary and the standbys, and a scheduler-less worker has no
    scheduler to fail over (the flag is inert, as in the JAX worker). The
    worker is not started; only config.json is written."""
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(RAW, f)
    args = cli.build_parser().parse_args(
        ["join", "--model-path", str(tmp_path), "--start-layer", "0",
         "--end-layer", "4", "--device", "cpu", "--port", "0",
         "--advertise-addr", "127.0.0.1", *argv])
    assert cli.unported_flags(args) == []
    node = build_worker(args)
    node.transport.stop()
    if peers is None:
        assert node.standalone and node.sched_transport is None
    else:
        assert node.sched_transport.peers == peers
        assert node._sched_peer() == peers[0]
        assert all(node._is_scheduler(p) for p in peers)


def _write_checkpoint(path: str) -> None:
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tree = _merged_tree()
    cs.write_checkpoint(cs.hf_tensors(params_from_numpy(
        jax.tree.map(np.asarray, tree), "cpu")), RAW, path)


def _logged_address(log, proc, timeout=60.0) -> str:
    """The address a ``join`` on port 0 logs once it serves."""
    found = []

    def seen():
        log.seek(0)
        found[:] = re.findall(r"worker (\S+) serving layers", log.read())
        return bool(found) or proc.poll() is not None

    assert _wait(seen, timeout) and found, "a worker did not start"
    return found[0]


def test_join_processes_and_chat_host_serve_over_http(tmp_path):
    """The entry points as a user starts them: two ``join --device cpu``
    processes and ``chat-host`` on a thread (the CLI's parser and
    chat_host_main), one chat completion, then SIGTERM: each worker exits
    0 with no step loop error in its log."""
    from parallax_tpu_torch.backend.run import chat_host_main

    ckpt = str(tmp_path)
    _write_checkpoint(ckpt)
    # Two threads a worker: the test shares its CPUs with other test
    # processes, and the workers' plain path runs on them.
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    procs, logs, addrs = [], [], []
    box, started = [], threading.Event()
    host = None
    try:
        # Each worker binds port 0 and logs its address; the tail takes
        # the head as its peer, and the head learns the tail from its
        # announcements.
        for i, (s, e) in enumerate(BOUNDS):
            log = open(os.path.join(ckpt, f"join{i}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "parallax_tpu_torch", "join",
                 "--model-path", ckpt, "--device", "cpu",
                 "--start-layer", str(s), "--end-layer", str(e),
                 *(["--peers", addrs[0]] if addrs else []),
                 "--advertise-addr", "127.0.0.1", "--port", "0"],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
            addrs.append(_logged_address(log, procs[-1]))
        args = cli.build_parser().parse_args(
            ["chat-host", "--head", addrs[0], "--host", "127.0.0.1",
             "--port", "0", "--model-path", ckpt])
        assert cli.unported_flags(args) == []
        host = threading.Thread(
            target=chat_host_main,
            args=(args, lambda fe: (box.append(fe), started.set())),
            daemon=True)
        host.start()
        assert started.wait(DEADLINE_S)
        fe = box[0]
        body = {"messages": [{"role": "user", "content": "hello"}],
                "max_tokens": 5, "temperature": 0.0, "ignore_eos": True}
        deadline = time.monotonic() + 60.0
        while True:
            # The CPU workers run the plain path over the JAX join's
            # 8,192-token context (the join has no --max-model-len).
            status, reply = _post(fe.port, "/v1/chat/completions", body,
                                  timeout=120.0)
            if status != 503 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert status == 200, reply
        assert reply["usage"]["completion_tokens"] == 5
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        if box:
            box[0].shutdown()
        if host is not None:
            host.join(DEADLINE_S)
    for log in logs:
        log.seek(0)
        text = log.read()
        log.close()
        assert "step loop error" not in text and "Traceback" not in text, \
            text[-3000:]


def test_stage_samples_once_when_chunks_arrive_together():
    """A stage of a swarm can receive every prefill chunk of a request
    before it steps; it then schedules its own chunks and must sample only
    after the one that reaches the end of the prompt (the in-process
    pipeline's stream), not after each of them."""
    cfg = dict(ENGINE, prefill_chunk_size=16)
    head, tail = [StageEngine(create_stage_model(CFG, s, e),
                              _port_params(create_stage_model(CFG, s, e)),
                              EngineConfig(**cfg), device="cpu")
                  for s, e in BOUNDS]
    req = Request("r", prompt_ids=list(range(1, 41)),
                  sampling_params=SamplingParams(temperature=0.0,
                                                 max_new_tokens=4))
    head.submit(req)
    packets = []
    for _ in range(3):
        packets += head.step().forward
    assert [(p.num_new_tokens, p.is_last_chunk) for p in packets] == [
        (16, False), (16, False), (8, True)]
    for p in packets:
        tail.submit_intermediate(p)
    tokens = []
    for _ in range(4):
        tokens += [(p.next_token_id, p.context_len)
                   for p in tail.step().forward]
    ref = Request("r", prompt_ids=list(range(1, 41)),
                  sampling_params=SamplingParams(temperature=0.0,
                                                 max_new_tokens=4))
    engines = [StageEngine(create_stage_model(CFG, s, e),
                           _port_params(create_stage_model(CFG, s, e)),
                           EngineConfig(**cfg), device="cpu")
               for s, e in BOUNDS]
    pipe = InProcessPipeline(engines)
    pipe.submit(ref)
    pipe.run_until_complete()
    assert tokens == [(ref.output_ids[0], 41)]


def test_head_flags_only_the_last_chunk_with_a_step_in_flight():
    """Under the one-in-flight loop the head dispatches a prompt's next
    chunk before its previous chunk resolves; only the chunk that ends the
    prompt goes out flagged last."""
    from parallax_tpu_torch.runtime.engine import drive_step

    head = StageEngine(create_stage_model(CFG, 0, 2),
                       _port_params(create_stage_model(CFG, 0, 2)),
                       EngineConfig(**dict(ENGINE, prefill_chunk_size=16)),
                       device="cpu")
    head.submit(Request("r", prompt_ids=list(range(1, 41)),
                        sampling_params=SamplingParams(temperature=0.0,
                                                       max_new_tokens=4),
                        routing_table=["h", "t"]))
    packets, pending = [], None
    for _ in range(5):
        outs, pending = drive_step(head, pending)
        for out in outs:
            packets += out.forward
    assert [(p.num_new_tokens, p.is_last_chunk) for p in packets] == [
        (16, False), (16, False), (8, True)]


def test_bf16_wire_link_halves_the_bytes():
    """``wire_dtype="bfloat16"`` on f32 workers: the head probes the tail's
    wire_caps, ships its hidden rows as bf16 (half the bytes, restored to
    f32 on receipt), and the streams stay within the tie-tolerant rule of
    the f32 model."""
    engine = dict(ENGINE, wire_dtype="bfloat16")
    with swarm(engine=engine) as (head, tail):
        got = _serve(head, _requests(Request, SamplingParams, seeded=False))
        stats = head.transport_stats()[tail.node_id]
        assert head._wire_dtypes[tail.node_id][0] == "bfloat16"
    assert stats["compression_ratio"] == 2.0
    rows = sum(len(p) + N_NEW - 1 for p in PROMPTS)
    assert stats["bytes_out"] == rows * 64 * 2
    for r in got:
        logits = _reference_logits(list(r.prompt_ids) + r.output_ids[:-1])
        p0 = len(r.prompt_ids) - 1
        for i, tok in enumerate(r.output_ids):
            row = logits[p0 + i]
            assert float(row.max() - row[tok]) < 0.05, (r.request_id, i)
