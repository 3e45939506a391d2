"""Per-request LoRA across the port's swarm and front doors, on the CPU,
held against the JAX package: two tenants through a scheduled two-stage
TCP swarm whose workers load PEFT directories, heartbeats advertising the
adapters and the ``run`` frontend's cross-node intersection, the
cache-aware router's adapter digest namespaces (the JAX router's
predictions), a parked request's namespaced chain descriptor, and the HTTP
``<model>:<adapter>`` variants.

Streams: equal to the port's in-process pipeline over the same stages
(bitwise), and under the tie-tolerant greedy rule of
tests/test_engine_e2e.py (tol 5e-3) against the JAX model with the same
adapter. Every wait has its own deadline and every transport stops in
``finally``.
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from tests._torch_lora import (
    CFG,
    ENGINE,
    RAW,
    TOL,
    jax_params,
    port_engines,
    run,
    stage_np,
)

from parallax_tpu.ops import lora as jlora
from parallax_tpu.p2p.node import WorkerNode as JWorkerNode
from parallax_tpu.runtime.radix_cache import block_hash_chain as j_chain
from parallax_tpu.scheduling import node as j_node
from parallax_tpu.scheduling.request_routing import RequestMeta as JMeta
from parallax_tpu_torch.backend.run import SwarmClient, build_swarm_frontend
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.models import params_from_numpy
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import TcpTransport
from parallax_tpu_torch.runtime.cache_manager import derive_ns_salt
from parallax_tpu_torch.runtime.engine import EngineConfig
from parallax_tpu_torch.runtime.radix_cache import block_hash_chain
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling import node as p_node
from parallax_tpu_torch.scheduling.node import Node
from parallax_tpu_torch.scheduling.node_management import (
    NodeManager,
    Pipeline,
)
from parallax_tpu_torch.scheduling.request_routing import (
    CacheAwareRouting,
    RequestMeta,
)
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from parallax_tpu_torch.utils.st_writer import write_peft_adapter
from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer

DEADLINE_S = 30.0
PROMPT = [1, 2, 3, 4, 5, 6, 7]


@pytest.fixture(autouse=True)
def two_layer_capacity(monkeypatch):
    """Every node holds 2 of the 4 layers (both packages' roofline)."""
    for mod in (j_node, p_node):
        monkeypatch.setattr(mod.RooflinePerformanceModel,
                            "max_layers_in_memory",
                            lambda self, kv_fraction=0.35: 2)


def _wait(cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return bool(cond())


def _peft(tmp_path, name, seed):
    """The JAX swarm test's adapter: rank 4 on every layer's q_proj,
    alpha 8 (scale 2)."""
    rng = np.random.default_rng(seed)
    h = RAW["hidden_size"]
    tree = {gi: {"self_attn.q_proj": (
        rng.standard_normal((4, h)).astype(np.float32) * 0.1,
        rng.standard_normal((h, 4)).astype(np.float32) * 0.1, 2.0)}
        for gi in range(RAW["num_hidden_layers"])}
    path = str(tmp_path / name)
    write_peft_adapter(path, tree, rank=4, alpha=8.0)
    return path


def _port_params(model):
    return params_from_numpy(
        stage_np(jax_params()[1], model.start_layer, model.end_layer), "cpu")


@contextlib.contextmanager
def _sched_swarm(adapter_sets, frontend=False):
    """A scheduled two-worker swarm over TCP, each worker with its own
    ``lora_adapters``; yields (service, workers, frontend or None)."""
    sched = GlobalScheduler(CFG, min_nodes_bootstrapping=2)
    st = TcpTransport("scheduler", "127.0.0.1")
    fe = None
    if frontend:
        fe, service, _ = build_swarm_frontend(sched, st, SimpleTokenizer(),
                                              "tiny")
    else:
        service = SchedulerService(sched, st, join_timeout_s=DEADLINE_S)
    workers = []
    try:
        service.start()
        for ads in adapter_sets:
            t = TcpTransport("", "127.0.0.1")
            t.start()
            t.peer_id = t.address
            workers.append(WorkerNode(
                t, st.address, CFG, EngineConfig(**ENGINE),
                load_params=_port_params, heartbeat_interval_s=0.2,
                device="cpu", lora_adapters=ads))
        starters = [threading.Thread(target=w.start) for w in workers]
        for s in starters:
            s.start()
        for s in starters:
            s.join(DEADLINE_S)

        def ready():
            nodes = [n for n in sched.manager.nodes()
                     if n.has_allocation and n.is_ready]
            return len(nodes) == 2 and all(n.lora_adapters for n in nodes)

        assert _wait(ready), sched.cluster_status()
        yield service, workers, fe
    finally:
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        service.stop()


def _jax_reference(ctx, tree):
    """The JAX StageModel's logits over ``ctx`` with ``tree`` applied (its
    own stacked delta)."""
    from tests._torch_lora import reference_logits

    return reference_logits(ctx, tree)


def test_swarm_two_tenants_adapter_correct(tmp_path):
    """Two concurrent tenants through a scheduled two-stage TCP swarm whose
    workers load the PEFT directories: each stream equals the port's
    in-process pipeline with the same adapters and passes the greedy rule
    against the JAX model with the same adapter."""
    ad1, ad2 = _peft(tmp_path, "ad1", 11), _peft(tmp_path, "ad2", 22)
    paths = {"ad1": ad1, "ad2": ad2}
    with _sched_swarm([paths, paths]) as (service, workers, _):
        client = SwarmClient(service.transport, service)
        reqs, events = [], []
        for i, lid in enumerate(["ad1", "ad2"]):
            r = Request(f"lr{i}", prompt_ids=list(PROMPT), lora_id=lid,
                        sampling_params=SamplingParams(
                            temperature=0.0, max_new_tokens=6,
                            ignore_eos=True))
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids,
                                           lora_id=lid)
            assert r.routing_table and len(r.routing_table) == 2
            reqs.append(r)
            events.append(client.submit(r))
        for ev, r in zip(events, reqs):
            assert ev.wait(DEADLINE_S), f"{r.request_id}: {r.status}"
            assert len(r.output_ids) == 6
        # The heartbeats carried the real adapter lists.
        assert all(n.lora_adapters == ("ad1", "ad2")
                   for n in service.scheduler.manager.nodes())
    trees = {n: jlora.adapter_tree_from_peft(p, 0, 4)
             for n, p in paths.items()}
    engines = port_engines(trees, ((0, 2), (2, 4)))
    ref = run(engines, [(r.request_id, PROMPT, r.lora_id) for r in reqs],
              n=6)
    assert [r.output_ids for r in reqs] == [r.output_ids for r in ref]
    for r in reqs:
        logits = _jax_reference(PROMPT + r.output_ids[:-1],
                                trees[r.lora_id])
        for i, tok in enumerate(r.output_ids):
            row = logits[len(PROMPT) - 1 + i]
            assert float(row.max() - row[tok]) < TOL, (r.request_id, i)
    assert reqs[0].output_ids != reqs[1].output_ids


def test_swarm_heartbeats_advertise_adapters(tmp_path):
    """Workers report their adapters over heartbeats; the ``run``
    frontend's ``/v1/models`` lists the cross-node intersection."""
    shared, extra = _peft(tmp_path, "shared", 1), _peft(tmp_path, "extra", 2)
    with _sched_swarm([{"common": shared, "only1": extra},
                       {"common": shared}], frontend=True) as (
            service, workers, fe):
        assert fe.adapters_fn() == ["common"]
        got = sorted(n.lora_adapters for n in
                     service.scheduler.manager.nodes())
        assert got == [("common",), ("common", "only1")]


# -- routing: the adapter digest namespaces -----------------------------------

PAGE = 4


def _replica_manager(pkg_node, pkg_mgr, pkg_pipe, hw, model):
    mgr = pkg_mgr(28)
    pipes = []
    for i in range(2):
        n = pkg_node(node_id=f"r{i}", hardware=hw, model=model)
        n.is_ready = True
        n.set_layers(0, 28)
        mgr.add(n)
        pipes.append(pkg_pipe(nodes=[n]))
    mgr.register_pipelines(pipes)
    return mgr


def _feed(node, chain, seq=1):
    assert node.cache_index.apply(
        {"seq": seq, "block": PAGE, "full": list(chain)}) is False


def test_lora_requests_match_their_own_namespace():
    """The cache-aware router with adapter requests, in both packages:
    base-namespace digests never match an adapter request, the adapter's
    own namespace routes to the warm replica, other adapters and base see
    none of it; the predictions are the JAX router's."""
    from parallax_tpu.config import normalize_config as j_normalize
    from parallax_tpu.scheduling import NodeManager as JNodeManager
    from parallax_tpu.scheduling import Pipeline as JPipeline
    from parallax_tpu.scheduling.request_routing import (
        CacheAwareRouting as JRouting,
    )
    from parallax_tpu.utils.hw import HardwareInfo as JHW
    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.utils.hw import HardwareInfo

    model = dict(architectures=["Qwen2ForCausalLM"], hidden_size=3584,
                 num_hidden_layers=28, num_attention_heads=28,
                 num_key_value_heads=4, intermediate_size=18944,
                 vocab_size=152064)
    hw = ("v5e", 4, 197.0, 16.0, 819.0, 186.0)
    sides = [
        (_replica_manager(Node, NodeManager, Pipeline, HardwareInfo(*hw),
                          normalize_config(model)),
         CacheAwareRouting, RequestMeta, block_hash_chain),
        (_replica_manager(j_node.Node, JNodeManager, JPipeline, JHW(*hw),
                          j_normalize(model)),
         JRouting, JMeta, j_chain),
    ]
    toks = list(range(6 * PAGE))
    results = []
    for mgr, routing_cls, meta_cls, chain in sides:
        router = routing_cls(mgr)
        salt = derive_ns_salt("tenant-a")
        out = []
        _feed(mgr.get("r1"), chain(toks, PAGE))
        meta = meta_cls("rid", prompt_ids=list(toks), lora_id="tenant-a")
        router.find_path(meta)
        out.append(meta.predicted_cached_tokens)
        _feed(mgr.get("r1"), chain([t ^ salt for t in toks], PAGE), seq=2)
        meta = meta_cls("rid", prompt_ids=list(toks), lora_id="tenant-a")
        out.append(router.find_path(meta)[0].node_id)
        out.append(meta.predicted_cached_tokens)
        out.append(router.decision_counters.get("chosen_by_cache", 0))
        for lid in ("tenant-b", None):
            meta = meta_cls("rid", prompt_ids=list(toks), lora_id=lid)
            router.find_path(meta)
            out.append(meta.predicted_cached_tokens)
        results.append(out)
    assert results[0] == results[1]
    assert results[0][:4] == [0, "r1", results[0][2], 1]
    assert results[0][2] > 0 and results[0][4:] == [0, 0]


def test_parked_request_descriptor_hashes_in_its_namespace():
    """A parked adapter request's chain descriptor (migration targeting)
    is the JAX worker's: its history XOR-salted by the adapter's
    deterministic salt."""
    from parallax_tpu.runtime.request import Request as JRequest
    from parallax_tpu.runtime.request import SamplingParams as JSampling

    for lid in ("tenant-a", None):
        r = Request("q", prompt_ids=list(range(1, 20)), lora_id=lid,
                    sampling_params=SamplingParams())
        r.output_ids.extend([5, 6])
        jr = JRequest("q", prompt_ids=list(range(1, 20)), lora_id=lid,
                      sampling_params=JSampling())
        jr.output_ids.extend([5, 6])
        got = WorkerNode._target_descriptor(r, 8)
        # The JAX worker's is an instance method that reads no state.
        want = JWorkerNode._target_descriptor(None, jr, 8)
        assert got == want
        assert (got["chains"]["8"] == block_hash_chain(
            r.all_token_ids, 8)) == (lid is None)


# -- the HTTP variants --------------------------------------------------------

def test_adapter_model_variants():
    """``/v1/models`` lists ``<model>:<adapter>`` for each adapter; that
    model name selects the adapter (the library's tokens for it), the
    ``"lora"`` field does too, and an unknown adapter fails loudly (the
    JAX front door's 502), never as base traffic."""
    import http.client
    import json

    from parallax_tpu_torch.backend.serve import build_local_frontend

    import torch

    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import StageEngine

    rng = np.random.default_rng(2)
    tree = {0: {"self_attn.q_proj": (
        rng.standard_normal((4, 64)).astype(np.float32),
        rng.standard_normal((64, 4)).astype(np.float32), 0.9)}}
    # The byte tokenizer's ids (BOS 256) need a 270-id vocabulary.
    model = create_stage_model(normalize_config(dict(RAW, vocab_size=270)),
                               0, 4)
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.float32, "cpu")

    def engine():
        eng = StageEngine(model, params, EngineConfig(**ENGINE),
                          device="cpu")
        eng.load_adapter("tenant-x", tree)
        return eng

    eng = engine()
    fe, runner = build_local_frontend([eng], SimpleTokenizer(),
                                      model_name="tiny")
    server = threading.Thread(
        target=fe.run, kwargs=dict(host="127.0.0.1", port=0), daemon=True)
    server.start()
    try:
        assert _wait(lambda: fe.server is not None)
        port = fe.server.server_address[1]

        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=DEADLINE_S)
            conn.request(method, path,
                         body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = resp.status, json.loads(resp.read())
            conn.close()
            return out

        status, models = call("GET", "/v1/models")
        assert status == 200
        assert [m["id"] for m in models["data"]] == ["tiny", "tiny:tenant-x"]
        body = {"prompt": "hello", "max_tokens": 6, "temperature": 0.0,
                "ignore_eos": True}
        replies = {}
        for key, extra in (("base", {"model": "tiny"}),
                           ("variant", {"model": "tiny:tenant-x"}),
                           ("field", {"lora": "tenant-x"})):
            status, reply = call("POST", "/v1/completions",
                                 {**body, **extra})
            assert status == 200, reply
            replies[key] = reply["choices"][0]["text"]
        assert replies["variant"] == replies["field"] != replies["base"]
        status, reply = call("POST", "/v1/completions",
                             {**body, "model": "tiny:nope"})
        assert status == 502
        assert "unknown lora adapter 'nope'" in reply["error"]["message"]
    finally:
        fe.shutdown()
        runner.stop()
    # The variant's text is the library's stream for the same adapter.
    tok = SimpleTokenizer()
    (lib,) = run([engine()], [("l", tok.encode("hello"), "tenant-x")], n=6)
    assert replies["variant"] == tok.decode(lib.output_ids)
