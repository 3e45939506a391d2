"""The swarm harness of the disaggregation tests (tests/test_torch_disagg_*):
tests/test_disaggregation.py's swarm — workers behind a cache-aware
scheduler, each tagged with its phase role — for port workers, JAX
workers or both, on the tiny model of tests/test_torch_swarm.py (4
layers, f32, each stage's ``jax.random.key(start * 1000 + end)`` tree,
carried to the port by ``params_from_numpy``).

One package's swarm runs on its LoopbackTransport; a swarm that mixes the
packages runs on their TcpTransports on localhost. Requests are routed and
polled by the port's SwarmClient in either case.
"""

import contextlib
import dataclasses
import threading
import time

from parallax_tpu.backend.scheduler_service import (
    SchedulerService as JSchedulerService,
)
from parallax_tpu.p2p.node import WorkerNode as JWorkerNode
from parallax_tpu.p2p.transport import LoopbackTransport as JLoopback
from parallax_tpu.p2p.transport import TcpTransport as JTcpTransport
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.scheduling.scheduler import GlobalScheduler as JScheduler
from parallax_tpu_torch.backend.run import SwarmClient
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import LoopbackTransport, TcpTransport
from parallax_tpu_torch.runtime.engine import EngineConfig
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from tests.test_torch_swarm import CFG, JCFG, _jax_params, _port_params

GEN = 16
DEADLINE_S = 90.0
# tests/test_disaggregation.py's engine, with its host tier and digests.
ENGINE = dict(page_size=8, num_pages=96, max_model_len=192,
              kv_dtype="float32", max_num_tokens_per_batch=192,
              max_batch_size=4, cache_digests=True)
# The byte tokenizer's grammar vocabulary (BOS 256, EOS 257) over the
# tiny model's 270 ids.
GRAMMAR_VOCAB = ([bytes([i]) for i in range(256)] + [b"", b""], 257)


def wait_for(cond, timeout=10.0, interval=0.01):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(interval)
    return bool(cond())


def request_set(n=4, gen=GEN):
    """tests/test_disaggregation.py's mix: a shared 16-token prefix, greedy
    and seeded rows in turn."""
    base = [7, 8, 9, 10] * 4
    out = []
    for i in range(n):
        sp = (SamplingParams(temperature=0.0, max_new_tokens=gen,
                             ignore_eos=True)
              if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=8, seed=55 + i,
                             max_new_tokens=gen, ignore_eos=True))
        out.append((base + [30 + i, 40 + i, 50 + i], sp))
    return out


def _wire_test_grammar(node) -> None:
    node.engine.set_grammar_vocab(*GRAMMAR_VOCAB)


@contextlib.contextmanager
def swarm(workers, sched="port", lookahead=1, overlap=True,
          host_cache=1 << 24, chunk_bytes=1 << 20, min_pipelines=None,
          chaos=None, grammar=False, monkeypatch=None):
    """``workers`` is a list of (package, role) pairs behind a
    ``sched``-package cache-aware scheduler. Single-stage full-model
    pipelines unless the caller capped a node's layers (then
    ``min_pipelines`` says how many pipelines bootstrap forms). ``chaos``
    (a ChaosController) wraps every transport; ``grammar`` wires the byte
    tokenizer's grammar vocabulary into every worker (``monkeypatch``
    required). Yields (scheduler, service, client, workers)."""
    kinds = {k for k, _r in workers} | {sched}
    tcp = len(kinds) > 1
    wrap = chaos.wrap if chaos is not None else (lambda t: t)
    registries = {"port": {}, "jax": {}}

    def transport(kind, name):
        if tcp:
            cls = TcpTransport if kind == "port" else JTcpTransport
            t = cls("", "127.0.0.1")
            t.start()
            t.peer_id = t.address
            return wrap(t)
        cls = LoopbackTransport if kind == "port" else JLoopback
        return wrap(cls(name, registries[kind]))

    if grammar:
        for cls in (WorkerNode, JWorkerNode):
            monkeypatch.setattr(cls, "_wire_grammar", _wire_test_grammar)
    sched_cls, svc_cls, cfg = (
        (GlobalScheduler, SchedulerService, CFG) if sched == "port"
        else (JScheduler, JSchedulerService, JCFG))
    scheduler = sched_cls(cfg, min_nodes_bootstrapping=len(workers),
                          heartbeat_timeout_s=2.0, routing="cache_aware")
    st = transport(sched, "sched")
    service = svc_cls(scheduler, st, join_timeout_s=30.0)
    nodes = []
    try:
        service.start()
        sched_addr = st.peer_id
        for i, (kind, role) in enumerate(workers):
            t = transport(kind, f"dg{i}")
            ecfg = dict(ENGINE, overlap_steps=overlap,
                        decode_lookahead=lookahead,
                        host_cache_bytes=host_cache)
            if kind == "port":
                nodes.append(WorkerNode(
                    t, sched_addr, CFG, EngineConfig(**ecfg),
                    load_params=_port_params, heartbeat_interval_s=0.1,
                    device="cpu", role=role,
                    kv_transfer_chunk_bytes=chunk_bytes))
            else:
                nodes.append(JWorkerNode(
                    transport=t, scheduler_peer=sched_addr,
                    model_config=JCFG, engine_config=JEngineConfig(**ecfg),
                    load_params=_jax_params, heartbeat_interval_s=0.1,
                    role=role, kv_transfer_chunk_bytes=chunk_bytes))
        starters = [threading.Thread(target=w.start) for w in nodes]
        for s in starters:
            s.start()
        for s in starters:
            s.join(120.0)
        want = min_pipelines if min_pipelines is not None else len(nodes)
        assert wait_for(
            lambda: len(scheduler.manager.pipelines) >= want and all(
                n.is_ready for p in scheduler.manager.pipelines
                for n in p.nodes),
            timeout=60.0), scheduler.cluster_status()
        client_t = transport(sched, "client")
        client = SwarmClient(client_t, service, poll_interval_s=0.002)
        yield scheduler, service, client, nodes
    finally:
        for w in nodes:
            if chaos is None or not chaos.is_dead(w.node_id):
                with contextlib.suppress(Exception):
                    w.stop()
        service.stop()


def serve(client, tag, prompts_and_sp, on_tokens=None):
    """Route and submit each request through the client; ``on_tokens(i,
    req)`` runs once per request when its first token lands. Returns the
    requests once all finished."""
    reqs, evs = [], []
    for i, (prompt, sp) in enumerate(prompts_and_sp):
        rid = f"{tag}-{i}"
        path = client.route(rid, prompt_ids=list(prompt))
        assert path, f"no path for {rid}"
        req = Request(request_id=rid, prompt_ids=list(prompt),
                      sampling_params=dataclasses.replace(sp),
                      routing_table=list(path))
        evs.append(client.submit(req))
        reqs.append(req)
    if on_tokens is not None:
        fired = set()
        deadline = time.monotonic() + 60.0
        while len(fired) < len(reqs) and time.monotonic() < deadline:
            for i, req in enumerate(reqs):
                if i not in fired and (
                        len(req.output_ids) >= 1 or req.status.is_finished):
                    fired.add(i)
                    on_tokens(i, req)
            time.sleep(0.002)
    for ev, req in zip(evs, reqs):
        assert ev.wait(DEADLINE_S), (
            f"{req.request_id} stuck: {req.status} "
            f"({len(req.output_ids)} tokens)")
    return reqs


def streams(reqs) -> dict:
    """Request index -> output ids."""
    return {r.request_id.split("-", 1)[1]: list(r.output_ids) for r in reqs}
