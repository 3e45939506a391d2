"""Weight refit in the port (``parallax_tpu_torch/p2p/refit.py``) held
against the JAX package's (``parallax_tpu/p2p/refit.py``) on the CPU, at
the tiny size of tests/test_weight_refit.py, with trees drawn by the JAX
``init_params`` and carried across as numpy.

- The seven cases of tests/test_weight_refit.py on the port: swap,
  checksum refused, shape refused, layer-range filter, atomic on a partial
  failure, per-expert names into the stacked experts, swarm propagation.
- One safetensors blob, written by the port's writer and read by both
  packages, applied to a JAX engine and a port engine on the same numpy
  tree: the trees after the swap are bitwise equal (f32 and bf16), the
  greedy streams agree under the tie-tolerant rule.
- The reference fault, held both ways: after a refit the JAX engine still
  reuses the old weights' prefix KV (and decodes other tokens than a fresh
  engine on the donor); the port reuses none and decodes what a fresh port
  engine decodes, with both cache managers and in an adapter namespace.
- In place: every weight keeps its storage; K = 8 windows and K = 1 agree
  bitwise after the refit; a quantized tree refuses, untouched.
- Transport and control plane: an http:// index, mixed swarms (a JAX
  scheduler with port workers and the reverse), an HA primary's refit in
  the promoted standby, and the refit version store.
"""

import contextlib
import functools
import http.server
import os
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
from parallax_tpu.models.registry import create_stage_model as j_create
from parallax_tpu.p2p import refit as jrefit
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch import native
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.p2p import refit
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import LoopbackTransport
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.utils.st_writer import write_safetensors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_weight_refit.py's model and engine.
RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=151,
)
CFG, JCFG = normalize_config(RAW), j_normalize(RAW)
ENGINE = dict(page_size=8, num_pages=64, max_model_len=128,
              kv_dtype="float32")
K1_SYNC = dict(decode_lookahead=1, overlap_steps=False)
# The reproduction's prompt: 40 ids, five full pages (32 of them reusable:
# one prompt token is always recomputed).
PROMPT = [int(x) for x in np.random.default_rng(7).integers(1, 151, 40)]
N_NEW = 8
TOL = 5e-3            # tests/test_engine_e2e.py's tie-tolerant limit
DEADLINE_S = 30.0

_TREES: dict = {}


def jax_tree(seed: int, start: int = 0, end: int = 2, cfg=JCFG,
             dtype=jnp.float32):
    """A stage's JAX ``init_params`` tree (``jax.random.key(seed)``) and
    the same as numpy."""
    key = (seed, start, end, id(cfg), str(dtype))
    if key not in _TREES:
        tree = j_create(cfg, start, end, use_pallas=False).init_params(
            jax.random.key(seed), dtype=dtype)
        _TREES[key] = (tree, jax.tree.map(np.asarray, tree))
    return _TREES[key]


def hf_names(tree_np, start: int = 0) -> dict:
    """A stage tree (numpy) under its HF global names (the inverse of
    ``shard_key_filter``)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}.{k}")
            else:
                out[f"{prefix}.{k}"] = np.asarray(v)

    for li, layer in enumerate(tree_np["layers"]):
        walk(layer, f"model.layers.{start + li}")
    for key, name in (("embed_tokens", "model.embed_tokens.weight"),
                      ("norm", "model.norm.weight"),
                      ("lm_head", "lm_head.weight")):
        if key in tree_np:
            out[name] = np.asarray(tree_np[key]["weight"])
    return out


def write_blob(path, tensors: dict) -> str:
    """``tensors`` (numpy) as one safetensors file, by the port's writer."""
    write_safetensors(str(path), {k: torch.from_numpy(np.array(v))
                                  for k, v in tensors.items()})
    return str(path)


def port_engine(tree_np, start=0, end=2, cfg=CFG, dtype=None,
                use_native=False, **kw):
    model = create_stage_model(cfg, start, end)
    return StageEngine(model, params_from_numpy(tree_np, "cpu", dtype),
                       EngineConfig(**{**ENGINE, **kw}), device="cpu",
                       use_native=use_native)


def own(tree):
    """The tree's containers copied (leaves shared): the JAX apply
    rebinds leaves in the engine's dicts, which must not reach a cached
    tree."""
    return jax.tree.map(lambda x: x, tree)


def jax_engine(tree, **kw):
    model = JStageModel(JCFG, 0, 2, use_pallas=False)
    return JStageEngine(model, own(tree), JEngineConfig(**{**ENGINE, **kw}))


def port_run(engine, prompts, lora_id=None, n=N_NEW) -> list[Request]:
    pipe = InProcessPipeline([engine])
    reqs = [Request(f"p{time.monotonic_ns()}-{i}", prompt_ids=list(p),
                    sampling_params=SamplingParams(
                        temperature=0.0, max_new_tokens=n, ignore_eos=True),
                    lora_id=lora_id)
            for i, p in enumerate(prompts)]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def jax_run(engine, prompts, n=N_NEW) -> list:
    pipe = JPipeline([engine])
    reqs = [JRequest(f"j{time.monotonic_ns()}-{i}", prompt_ids=list(p),
                     sampling_params=JSampling(
                         temperature=0.0, max_new_tokens=n, ignore_eos=True))
            for i, p in enumerate(prompts)]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def reference_logits(tree, ctx) -> np.ndarray:
    """The JAX model's logits at every position of ``ctx`` (one forward
    over ``tree``)."""
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = JStageModel(JCFG, 0, 2, use_pallas=False)
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
    logits, _ = model(tree, kv, inp)
    return np.asarray(logits)[:n]


def assert_greedy_matches(tree, prompt, tokens):
    """tests/test_engine_e2e.py's rule: each token within TOL of the
    reference argmax at its position."""
    rows = reference_logits(tree, list(prompt) + list(tokens)[:-1])
    for i, tok in enumerate(tokens):
        row = rows[len(prompt) - 1 + i]
        gap = float(row.max() - row[tok])
        assert gap < TOL, (i, tok, int(row.argmax()), gap)


# -- the seven cases of tests/test_weight_refit.py -----------------------------


def test_apply_refit_swaps_weights(tmp_path):
    engine = port_engine(jax_tree(0)[1])
    before = port_run(engine, [[1, 2, 3, 4]])[0].output_ids
    tensors = hf_names(jax_tree(99)[1])
    index = refit.build_index_map(write_blob(tmp_path / "r.safetensors",
                                             tensors))
    assert refit.apply_refit(engine, index, version=1) == len(tensors)
    after = port_run(engine, [[1, 2, 3, 4]])[0].output_ids
    assert after != before
    # The engine now IS the donor model.
    assert after == port_run(port_engine(jax_tree(99)[1]),
                             [[1, 2, 3, 4]])[0].output_ids


def test_refit_checksum_rejected(tmp_path):
    engine = port_engine(jax_tree(0)[1])
    index = refit.build_index_map(write_blob(
        tmp_path / "w.safetensors", hf_names(jax_tree(0)[1])))
    for entry in index.values():
        entry["sha256"] = "0" * 64
    with pytest.raises(ValueError, match="checksum"):
        refit.apply_refit(engine, index, version=1)


def test_refit_shape_mismatch_rejected(tmp_path):
    engine = port_engine(jax_tree(0)[1])
    path = write_blob(tmp_path / "bad.safetensors",
                      {"model.norm.weight": np.zeros((7,), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        refit.apply_refit(engine, refit.build_index_map(path), version=1)


def test_refit_filters_layer_range(tmp_path):
    """A stage loads only the tensors inside its layer range."""
    engine = port_engine(jax_tree(0, 1, 2)[1], start=1, end=2)
    tensors = hf_names(jax_tree(5)[1])
    path = write_blob(tmp_path / "full.safetensors", tensors)
    n = refit.apply_refit(engine, refit.build_index_map(path), version=1)
    # Layer 1 (as local 0) + norm + lm_head (no embed: not first, untied).
    assert n == sum(1 for k in tensors if k.startswith("model.layers.1.")) + 2
    jeng = JStageEngine(JStageModel(JCFG, 1, 2, use_pallas=False),
                        own(jax_tree(0, 1, 2)[0]), JEngineConfig(**ENGINE))
    assert jrefit.apply_refit(jeng, refit.build_index_map(path), 1) == n
    np.testing.assert_array_equal(
        engine.params["layers"][0]["mlp"]["down_proj"]["weight"].numpy(),
        tensors["model.layers.1.mlp.down_proj.weight"])


def test_refit_atomic_on_partial_failure(tmp_path):
    """A bad entry anywhere in the index leaves EVERY weight untouched."""
    engine = port_engine(jax_tree(0)[1])
    before = {k: v.clone() for k, v in leaves(engine.params)}
    path = write_blob(tmp_path / "mix.safetensors", {
        "model.norm.weight": np.full((64,), 2.0, np.float32),
        "lm_head.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        refit.apply_refit(engine, refit.build_index_map(path), version=1)
    for k, v in leaves(engine.params):
        assert torch.equal(v, before[k]), k
    # A dtype that cannot be cast (integers into a float weight) is the
    # same refusal's other half.
    path = write_blob(tmp_path / "int.safetensors", {
        "model.norm.weight": np.full((64,), 2.0, np.float32),
        "lm_head.weight": np.zeros((151, 64), np.int32)})
    with pytest.raises(ValueError, match="dtype mismatch"):
        refit.apply_refit(engine, refit.build_index_map(path), version=1)
    for k, v in leaves(engine.params):
        assert torch.equal(v, before[k]), k


MOE_RAW = dict(
    architectures=["Qwen3MoeForCausalLM"], hidden_size=32,
    num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
    head_dim=8, intermediate_size=64, moe_intermediate_size=16,
    num_experts=4, num_experts_per_tok=2, decoder_sparse_step=1,
    mlp_only_layers=[], vocab_size=64,
)


def test_refit_per_expert_paths_into_stacked(tmp_path):
    """Per-expert HF names update one row of the stacked expert tensors,
    in place, in both packages alike."""
    jcfg = j_normalize(MOE_RAW)
    tree, tree_np = jax_tree(0, 0, 1, cfg=jcfg)
    engine = port_engine(tree_np, 0, 1, cfg=normalize_config(MOE_RAW))
    stacked = engine.params["layers"][0]["mlp"]["experts"]["gate_proj"]
    ptr = stacked.data_ptr()
    new_w = np.full((16, 32), 3.0, np.float32)
    path = write_blob(tmp_path / "expert.safetensors",
                      {"model.layers.0.mlp.experts.2.gate_proj.weight": new_w})
    assert refit.apply_refit(engine, refit.build_index_map(path), 1) == 1
    np.testing.assert_array_equal(stacked[2].numpy(), new_w)
    assert not np.allclose(stacked[1].numpy(), new_w)
    assert stacked.data_ptr() == ptr
    jm = j_create(jcfg, 0, 1, use_pallas=False)
    jeng = JStageEngine(jm, own(tree), JEngineConfig(**ENGINE))
    jrefit.apply_refit(jeng, refit.build_index_map(path), 1)
    np.testing.assert_array_equal(
        np.asarray(jeng.params["layers"][0]["mlp"]["experts"]["gate_proj"]),
        stacked.numpy())


def _swarm_workers(service_addr, n, **kw):
    from parallax_tpu_torch.p2p.transport import TcpTransport

    out = []
    for _ in range(n):
        t = TcpTransport("", "127.0.0.1")
        t.start()
        t.peer_id = t.address
        out.append(WorkerNode(
            t, service_addr, CFG, EngineConfig(**ENGINE),
            load_params=lambda m: params_from_numpy(
                jax_tree(m.start_layer, m.start_layer, m.end_layer)[1],
                "cpu"),
            heartbeat_interval_s=0.15, device="cpu", **kw))
    return out


def _wait(cond, timeout=DEADLINE_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return bool(cond())


def test_swarm_refit_propagates(tmp_path, monkeypatch):
    """begin_refit -> heartbeat replies -> each worker fetches its layer
    range, saves it to its store and swaps in place -> the scheduler sees
    the version and routes again; the workers' weights are the donor's."""
    from parallax_tpu_torch.backend.scheduler_service import (
        SchedulerService,
    )
    from parallax_tpu_torch.p2p.transport import TcpTransport
    from parallax_tpu_torch.scheduling import node as node_mod
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler

    monkeypatch.setattr(node_mod.RooflinePerformanceModel,
                        "max_layers_in_memory",
                        lambda self, kv_fraction=0.35: 1)
    sched = GlobalScheduler(CFG, min_nodes_bootstrapping=2)
    st = TcpTransport("scheduler", "127.0.0.1")
    service = SchedulerService(sched, st)
    service.start()
    workers = _swarm_workers(st.address, 2,
                             refit_cache_dir=str(tmp_path / "store"))
    threads = [threading.Thread(target=w.start) for w in workers]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert _wait(lambda: all(w.engine is not None for w in workers))
        donor = hf_names(jax_tree(123)[1])
        path = write_blob(tmp_path / "v1.safetensors", donor)
        assert sched.begin_refit(refit.build_index_map(path)) == 1
        assert _wait(lambda: all(w.refit_version == 1 for w in workers)), [
            w.refit_version for w in workers]
        assert _wait(lambda: all(n.refit_version == 1
                                 for n in sched.manager.nodes()))
        status = sched.cluster_status()["refit"]
        assert status["version"] == 1
        assert sorted(status["nodes"]) == sorted(w.node_id for w in workers)
        assert set(status["nodes"].values()) == {1}
        assert service.route_request("post-refit", timeout_s=10.0)
        for w in workers:
            s = w.start_layer
            got = w.engine.params["layers"][0]["self_attn"]["q_proj"]
            np.testing.assert_array_equal(
                got["weight"].numpy(),
                donor[f"model.layers.{s}.self_attn.q_proj.weight"])
            assert w.refit_log and w.refit_log[-1]["version"] == 1
            assert w.refit_store.versions() == [1]
    finally:
        for w in workers:
            w.stop()
        service.stop()


# -- one blob, both packages ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_blob_gives_both_packages_the_same_tree(tmp_path, dtype):
    """A blob of f32 tensors written by the port's writer, read by both
    packages and applied to a JAX engine and a port engine on the same
    numpy tree: the trees after the swap are bitwise equal (cast to bf16
    by both where the tree is bf16); on f32, both engines' greedy streams
    follow the donor's one-shot logits under the tie-tolerant rule."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tree, tree_np = jax_tree(0, dtype=jdt)
    peng = port_engine(tree_np)
    jeng = jax_engine(tree)
    donor = hf_names(jax_tree(77)[1])
    index = refit.build_index_map(write_blob(tmp_path / "b.safetensors",
                                             donor))
    assert refit.apply_refit(peng, index, 1) == jrefit.apply_refit(
        jeng, index, 1) == len(donor)
    jleaves = dict(leaves(jax.tree.map(np.asarray, jeng.params)))
    for name, t in leaves(peng.params):
        j = jleaves[name]
        if dtype == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), j), name
    if dtype == "bfloat16":
        return
    prompts = [[5, 9, 2, 7, 1], [3] * 12, [100, 17, 5, 99, 31, 64, 8]]
    port, ref = port_run(peng, prompts), jax_run(jeng, prompts)
    for p, pr, jr in zip(prompts, port, ref):
        assert pr.num_cached_tokens == jr.num_cached_tokens == 0
        assert_greedy_matches(jeng.params, p, pr.output_ids)
        assert_greedy_matches(jeng.params, p, jr.output_ids)


# -- the reference's fault, held both ways ------------------------------------


@pytest.fixture(scope="module")
def jax_fault(tmp_path_factory):
    """The JAX engine's run of the reproduction: the prompt before the
    refit, the same prompt after it, and a fresh engine on the donor."""
    path = write_blob(tmp_path_factory.mktemp("fault") / "d.safetensors",
                      hf_names(jax_tree(123)[1]))
    eng = jax_engine(jax_tree(0)[0])
    first = jax_run(eng, [PROMPT])[0]
    jrefit.apply_refit(eng, refit.build_index_map(path), 1)
    again = jax_run(eng, [PROMPT])[0]
    fresh = jax_run(jax_engine(jax_tree(123)[0]), [PROMPT])[0]
    return first, again, fresh, path


def test_jax_refit_reuses_stale_prefix_kv(jax_fault):
    first, again, fresh, _ = jax_fault
    assert first.num_cached_tokens == 0
    # 32 tokens of KV computed under the old weights are reused...
    assert again.num_cached_tokens == 32
    # ... so the stream is not the donor's.
    assert again.output_ids != fresh.output_ids


def _adapter():
    from tests._torch_lora import make_adapter

    return make_adapter(41, (0, 1))


@pytest.mark.parametrize("native_mgr", [False, True],
                         ids=["python", "native"])
@pytest.mark.parametrize("lora", [None, "a"], ids=["base", "adapter"])
def test_port_refit_drops_stale_prefix_kv(jax_fault, native_mgr, lora):
    """After the same refit the port reuses 0 pre-refit tokens (its prefix
    cache was invalidated, pages counted) and decodes exactly what a fresh
    port engine on the donor decodes, with both cache managers and in an
    adapter namespace; a prompt served after the refit is cached again."""
    if native_mgr and not native.native_available():
        pytest.skip("g++ cannot build the native library")
    *_, path = jax_fault
    eng = port_engine(jax_tree(0)[1], use_native=native_mgr)
    fresh = port_engine(jax_tree(123)[1], use_native=native_mgr)
    if lora:
        eng.load_adapter(lora, _adapter())
        fresh.load_adapter(lora, _adapter())
    assert type(eng.cache).__name__ == (
        "NativeCacheManager" if native_mgr else "CacheManager")
    assert port_run(eng, [PROMPT], lora)[0].num_cached_tokens == 0
    assert port_run(eng, [PROMPT], lora)[0].num_cached_tokens == 32
    refit.apply_refit(eng, refit.build_index_map(path), 1)
    stats = eng.cache_stats()
    assert stats["pages_invalidated"] >= 4, stats
    again = port_run(eng, [PROMPT], lora)[0]
    assert again.num_cached_tokens == 0
    want = port_run(fresh, [PROMPT], lora)[0]
    assert again.output_ids == want.output_ids
    # The post-refit KV is cached again, and reused.
    assert port_run(eng, [PROMPT], lora)[0].num_cached_tokens == 32


def test_refit_drops_the_host_tiers_pages(jax_fault):
    """Prefix pages demoted to the host tier are dropped by the refit too:
    the pool is empty after it, and the repeated prompt hits neither
    tier."""
    *_, path = jax_fault
    kw = dict(num_pages=14, host_cache_bytes=1 << 24)
    eng = port_engine(jax_tree(0)[1], **kw)
    assert type(eng.cache).__name__ == "CacheManager"
    port_run(eng, [PROMPT])
    # A longer prompt needs the pages PROMPT left in the tree: they demote.
    port_run(eng, [[3, 1, 4, 1, 5, 9, 2, 6] * 10])
    host_pages = eng.host_tier.num_host_pages
    assert host_pages > 0
    refit.apply_refit(eng, refit.build_index_map(path), 1)
    assert eng.host_tier.num_host_pages == 0
    assert eng.cache_stats()["pages_invalidated"] >= host_pages
    hit_host = eng.cache_stats()["tokens_hit_host"]
    again = port_run(eng, [PROMPT])[0]
    assert again.num_cached_tokens == 0
    assert eng.cache_stats()["tokens_hit_host"] == hit_host
    want = port_run(port_engine(jax_tree(123)[1], **kw), [PROMPT])[0]
    assert again.output_ids == want.output_ids


@pytest.mark.parametrize("native_mgr", [False, True],
                         ids=["python", "native"])
def test_in_flight_request_finishes_and_donates_nothing(tmp_path,
                                                         native_mgr):
    """A request holding pages (some of them a shared prefix) when the
    refit lands keeps them and finishes; its pages never enter the new
    prefix cache, and every page comes back to the allocator."""
    if native_mgr and not native.native_available():
        pytest.skip("g++ cannot build the native library")
    from parallax_tpu_torch.runtime.engine import drive_step

    path = write_blob(tmp_path / "d.safetensors", hf_names(jax_tree(3)[1]))
    eng = port_engine(jax_tree(0)[1], use_native=native_mgr,
                      **K1_SYNC)
    port_run(eng, [PROMPT])                      # PROMPT's pages cached
    r = Request("inflight", prompt_ids=PROMPT + [7, 7],
                sampling_params=SamplingParams(temperature=0.0,
                                               max_new_tokens=16,
                                               ignore_eos=True))
    eng.submit(r)
    pending = None
    for _ in range(3):
        _, pending = drive_step(eng, pending)
    assert r.num_cached_tokens >= 32 and not r.status.is_finished
    refit.apply_refit(eng, refit.build_index_map(path), 1)
    while eng.has_work() or pending is not None:
        _, pending = drive_step(eng, pending)
    assert r.status.value == "finished_length" and len(r.output_ids) == 16
    assert port_run(eng, [PROMPT + [7, 7]])[0].num_cached_tokens == 0
    cache = eng.cache
    assert cache.num_free_pages + cache.prefix_cache.num_cached_pages == (
        ENGINE["num_pages"] - 1)
    assert not cache._stale


def test_in_place_keeps_every_pointer_and_windows_agree(tmp_path):
    """Every weight keeps its storage through the refit (the window graphs
    on the card read those addresses), and after it the K = 8 window loop
    and K = 1 sync decode the same tokens."""
    path = write_blob(tmp_path / "d.safetensors", hf_names(jax_tree(8)[1]))
    index = refit.build_index_map(path)
    prompts = [[5, 9, 2, 7, 1], [3] * 12, PROMPT]
    runs = []
    for kw in ({}, K1_SYNC):
        eng = port_engine(jax_tree(0)[1], **kw)
        port_run(eng, prompts)
        ptrs = {k: v.data_ptr() for k, v in leaves(eng.params)}
        refit.apply_refit(eng, index, 1)
        assert {k: v.data_ptr() for k, v in leaves(eng.params)} == ptrs
        runs.append([r.output_ids for r in port_run(eng, prompts, n=16)])
    assert runs[0] == runs[1]
    summary = eng.kernel_dispatch_summary()
    assert summary["dispatch_total"]


def test_refit_into_quantized_tree_raises_untouched(tmp_path):
    """A refit into a quantized tree (no float ``weight`` leaf) raises in
    both packages and changes nothing."""
    from parallax_tpu.ops.quant import quantize_tree as j_quantize
    from parallax_tpu_torch.ops.quant import quantize_tree

    path = write_blob(tmp_path / "d.safetensors", hf_names(jax_tree(8)[1]))
    index = refit.build_index_map(path)
    eng = port_engine(jax_tree(0)[1])
    quantize_tree(eng.params, bits=8, group_size=32, dtype=torch.float32)
    assert "qweight" in eng.params["layers"][0]["mlp"]["down_proj"]
    before = {k: v.clone() for k, v in leaves(eng.params)}
    with pytest.raises(KeyError):
        refit.apply_refit(eng, index, 1)
    for k, v in leaves(eng.params):
        assert torch.equal(v, before[k]), k
    jtree = j_quantize(own(jax_tree(0)[0]), bits=8, group_size=32,
                       dtype=jnp.float32)
    jeng = jax_engine(jtree)
    jbefore = dict(leaves(jax.tree.map(np.asarray, jeng.params)))
    with pytest.raises((KeyError, AttributeError, TypeError)):
        jrefit.apply_refit(jeng, index, 1)
    for k, v in leaves(jax.tree.map(np.asarray, jeng.params)):
        assert np.array_equal(v, jbefore[k]), k


def test_refit_under_graph_capture_refuses(monkeypatch):
    eng = port_engine(jax_tree(0)[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        refit.apply_prefetched(eng, {"norm.weight": torch.ones(64)}, 1)


def test_http_index_from_a_local_server(tmp_path):
    """An ``http://127.0.0.1`` index, served by ``http.server`` on a
    thread: the same tensors as the file index."""
    tensors = hf_names(jax_tree(11)[1])
    write_blob(tmp_path / "w.safetensors", tensors)
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(tmp_path))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/w.safetensors"
        index = refit.build_index_map(str(tmp_path / "w.safetensors"),
                                      base_uri=url)
        assert {e["uri"] for e in index.values()} == {url}
        eng = port_engine(jax_tree(0)[1])
        stats: dict = {}
        got = refit.fetch_refit_tensors(eng, index, stats=stats)
        assert stats["bytes"] == os.path.getsize(tmp_path / "w.safetensors")
        assert refit.apply_prefetched(eng, got, 1) == len(tensors)
        np.testing.assert_array_equal(
            eng.params["norm"]["weight"].numpy(),
            tensors["model.norm.weight"])
    finally:
        server.shutdown()
        server.server_close()


def test_refit_runs_without_safetensors_or_jax(tmp_path):
    """On the card there is no ``safetensors`` package: the index, the
    fetch and the swap run with it, jax and parallax_tpu blocked."""
    from tests.test_torch_imports import _BLOCKER

    path = write_blob(tmp_path / "w.safetensors", hf_names(jax_tree(11)[1]))
    code = _BLOCKER + f"""
import torch
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.p2p import refit
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
cfg = normalize_config({RAW!r})
m = create_stage_model(cfg, 0, 2)
eng = StageEngine(m, m.init_params(torch.Generator().manual_seed(0),
                                   torch.float32, "cpu"),
                  EngineConfig(**{ENGINE!r}), device="cpu")
n = refit.apply_refit(eng, refit.build_index_map({path!r}), 1)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("ok", n)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok", str(len(hf_names(jax_tree(11)[1])))]


# -- mixed swarms, HA, the store ----------------------------------------------


@pytest.mark.parametrize("sched_kind,kinds", [
    ("jax", ("port", "port")), ("port", ("jax", "jax")),
    ("jax", ("port", "jax")),
], ids=["jax-sched-port-workers", "port-sched-jax-workers", "jax-sched-mixed"])
def test_mixed_swarm_refit(tmp_path, monkeypatch, sched_kind, kinds):
    """The refit travels the same way whichever package schedules and
    whichever serves: every worker reaches version 1 with the donor's
    weights on its layer range, and the scheduler routes again."""
    from tests.test_torch_sched_mixed import swarm
    from tests.test_torch_swarm import JCFG as SW_JCFG

    donor_tree = jax.tree.map(np.asarray, JStageModel(
        SW_JCFG, 0, 4, use_pallas=False).init_params(
            jax.random.key(555), dtype=jnp.float32))
    donor = hf_names(donor_tree)
    index = refit.build_index_map(write_blob(tmp_path / "d.safetensors",
                                             donor))
    with swarm(sched_kind, list(kinds), monkeypatch=monkeypatch) as (
            service, workers):
        assert service.scheduler.begin_refit(index) == 1
        assert _wait(lambda: all(w.refit_version == 1
                                 for w in workers.values())), [
            w.refit_version for w in workers.values()]
        assert _wait(lambda: all(n.refit_version == 1 for n in
                                 service.scheduler.manager.nodes()))
        assert service.route_request("after", timeout_s=10.0)
        for w in workers.values():
            s = w.start_layer
            got = w.engine.params["layers"][0]["mlp"]["up_proj"]["weight"]
            np.testing.assert_array_equal(
                np.asarray(got),
                donor[f"model.layers.{s}.mlp.up_proj.weight"])


def test_ha_primary_refit_reaches_promoted_standby():
    """``begin_refit`` on an HA primary is journaled: the standby promoted
    after the primary stops holds its version and index."""
    from tests._torch_ha import scheduler_pair

    pair = scheduler_pair("port")
    try:
        index = {"model.norm.weight": {"uri": "file:///x", "sha256": None}}
        assert pair.service.scheduler.begin_refit(index) == 1
        assert pair.service.scheduler.begin_refit(index) == 2
        time.sleep(0.5)
        pair.service.stop()
        assert _wait(lambda: pair.standby.promoted_at is not None)
        mirror = pair.mirror_service.scheduler
        assert mirror.refit_version == 2
        assert mirror.refit_index == index
    finally:
        pair.standby.stop()
        pair.journal.stop()
        if pair.mirror_service.scheduler.journal is not None:
            pair.mirror_service.scheduler.journal.stop()
        pair.mirror_service.stop()
        with contextlib.suppress(Exception):
            pair.service.stop()


def test_refit_store_keeps_three_versions(tmp_path):
    store = refit.RefitVersionStore(str(tmp_path / "refit"), keep=3)
    for v in range(1, 6):
        store.save(v, {"w": torch.full((2,), float(v))})
    assert store.versions() == [3, 4, 5]
    assert torch.equal(store.load(5)["w"], torch.full((2,), 5.0))
    from parallax_tpu.p2p.refit import RefitVersionStore as JStore

    # The JAX store reads the port's files.
    assert JStore(str(tmp_path / "refit")).versions() == [3, 4, 5]
    np.testing.assert_array_equal(
        np.asarray(JStore(str(tmp_path / "refit")).load(4)["w"]),
        [4.0, 4.0])


def test_restarted_worker_restores_newest_matching_version(tmp_path):
    """A worker (re)built with a refit store applies the newest version
    cached for its model and layer range (v2), skipping a newer one cached
    for another range (v3), and reports it in its heartbeats."""
    store = refit.RefitVersionStore(str(tmp_path / "store"))
    meta = {"model_name": CFG.model_name, "start_layer": 0, "end_layer": 2}
    for v, seed in ((1, 21), (2, 22)):
        store.save(v, {k: torch.from_numpy(np.array(a)) for k, a in
                       _local_names(jax_tree(seed)[1]).items()}, meta=meta)
    store.save(3, {"norm.weight": torch.zeros(64)},
               meta={**meta, "start_layer": 1})
    node = WorkerNode(LoopbackTransport("w", {}), None, CFG,
                      EngineConfig(**ENGINE), layers=(0, 2), device="cpu",
                      load_params=lambda m: params_from_numpy(
                          jax_tree(0)[1], "cpu"),
                      refit_cache_dir=str(tmp_path / "store"))
    node.start()
    try:
        assert _wait(lambda: node.engine is not None
                     and node.refit_version == 2), node.refit_version
        np.testing.assert_array_equal(
            node.engine.params["norm"]["weight"].numpy(),
            jax_tree(22)[1]["norm"]["weight"])
        # A reload builds a new engine from the checkpoint: it restores
        # the cached version again instead of claiming it untouched.
        node._post(("reload", {"start_layer": 0, "end_layer": 2,
                               "want_digests": True}))
        assert _wait(lambda: node.engine is not None
                     and node.engine_config.cache_digests
                     and node.refit_version == 2)
        np.testing.assert_array_equal(
            node.engine.params["norm"]["weight"].numpy(),
            jax_tree(22)[1]["norm"]["weight"])
    finally:
        node.stop()


def _local_names(tree_np) -> dict:
    """A stage tree (numpy) under its stage-local paths (the store's
    keys)."""
    from parallax_tpu_torch.models.loader import shard_key_filter

    return {shard_key_filter(k, 0, 2, 2): v
            for k, v in hf_names(tree_np).items()}
