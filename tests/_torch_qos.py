"""Shared pieces of the port's QoS tests (``parallax_tpu_torch/qos`` and
its hooks) against ``parallax_tpu/qos``: the packages side by side, the
tiny model's weights drawn once from a seed and carried into both
engines, and the mixed flood-then-interactive workload of
tests/test_qos.py.

The cases are in tests/test_torch_qos*.py.
"""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

import parallax_tpu.qos as j_qos
import parallax_tpu.runtime.engine as j_engine
import parallax_tpu.runtime.request as j_request
import parallax_tpu.runtime.scheduler as j_rsched
import parallax_tpu.scheduling.node as j_node
import parallax_tpu.scheduling.node_management as j_mgmt
import parallax_tpu.scheduling.request_routing as j_routing
import parallax_tpu.utils.hw as j_hw
import parallax_tpu_torch.qos as p_qos
import parallax_tpu_torch.runtime.engine as p_engine
import parallax_tpu_torch.runtime.request as p_request
import parallax_tpu_torch.runtime.scheduler as p_rsched
import parallax_tpu_torch.scheduling.node as p_node
import parallax_tpu_torch.scheduling.node_management as p_mgmt
import parallax_tpu_torch.scheduling.request_routing as p_routing
import parallax_tpu_torch.utils.hw as p_hw
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu_torch.config import normalize_config as p_normalize
from parallax_tpu_torch.models import create_stage_model, params_from_numpy

RAW = dict(
    architectures=["Qwen2ForCausalLM"],
    hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, intermediate_size=128, vocab_size=151,
    max_position_embeddings=512,
)
PAGE = 8
HW = ("v5e", 1, 197.0, 16.0, 819.0, 186.0)

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", qos=j_qos, engine=j_engine, request=j_request,
        rsched=j_rsched, node=j_node, mgmt=j_mgmt, routing=j_routing,
        hw=j_hw, cfg=j_normalize(RAW)),
    "port": types.SimpleNamespace(
        name="port", qos=p_qos, engine=p_engine, request=p_request,
        rsched=p_rsched, node=p_node, mgmt=p_mgmt, routing=p_routing,
        hw=p_hw, cfg=p_normalize(RAW)),
}

# The JAX suite's engine spec (tests/test_qos.py QOS_SPEC).
QOS_SPEC = (
    "interactive_ms=200,tick_interval_s=0.01,min_shed_s=0.05,"
    "burn_window_s=1.0,starvation_s=60"
)

_WEIGHTS: dict = {}


def weights():
    """(JAX params, the same params as numpy) for the tiny model."""
    if "w" not in _WEIGHTS:
        full = JStageModel(PKGS["jax"].cfg, 0, 4, use_pallas=False
                           ).init_params(jax.random.key(0),
                                         dtype=jnp.float32)
        _WEIGHTS["w"] = (full, jax.tree.map(np.asarray, full))
    return _WEIGHTS["w"]


def engine(pkg, qos, overlap, lookahead, num_pages, host_bytes,
           max_batch=4, use_native=False):
    """A one-stage engine of ``pkg`` on the shared weights (the JAX suite's
    ``_engine`` configuration, the prefix cache on)."""
    full, full_np = weights()
    cfg = dict(
        page_size=PAGE, num_pages=num_pages, max_batch_size=max_batch,
        max_model_len=256, kv_dtype="float32", enable_prefix_cache=True,
        host_cache_bytes=host_bytes, overlap_steps=overlap,
        decode_lookahead=lookahead, qos=qos,
    )
    if pkg.name == "jax":
        return j_engine.StageEngine(
            JStageModel(pkg.cfg, 0, 4, use_pallas=False), full,
            j_engine.EngineConfig(**cfg))
    return p_engine.StageEngine(
        create_stage_model(pkg.cfg, 0, 4), params_from_numpy(full_np, "cpu"),
        p_engine.EngineConfig(**cfg), device="cpu", use_native=use_native)


def mixed_workload(flood_gen=24):
    """4 batch-flood rows (greedy + seeded) then 2 interactive rows."""
    rng = np.random.default_rng(11)
    vocab = RAW["vocab_size"]

    def prompt(salt):
        p = [int(x) for x in rng.integers(1, vocab - 1, size=2 * PAGE)]
        p[-1] = salt + 1
        return p

    flood = []
    for i in range(4):
        sp = (
            dict(temperature=0.0, max_new_tokens=flood_gen, ignore_eos=True)
            if i % 2 == 0 else
            dict(temperature=0.8, top_k=8, seed=41 + i,
                 max_new_tokens=flood_gen, ignore_eos=True)
        )
        flood.append((f"batch{i}", prompt(i), sp, "batch"))
    inter = []
    for i in range(2):
        sp = (
            dict(temperature=0.0, max_new_tokens=6, ignore_eos=True)
            if i % 2 == 0 else
            dict(temperature=0.7, top_k=8, seed=97, max_new_tokens=6,
                 ignore_eos=True)
        )
        inter.append((f"inter{i}", prompt(20 + i), sp, "interactive"))
    return flood, inter


def run_mixed(pkg, eng, flood_gen=24, due=False):
    """Serve the mixed workload on ``eng`` to completion: the flood first,
    the interactive rows once every flood row decodes. ``due=True`` gives
    the interactive rows a deadline already due, so the queue-pressure
    trigger fires on the first admission that sees them, whatever the
    host's speed. Returns ({rid: stream}, {rid: request})."""
    flood, inter = mixed_workload(flood_gen)
    reqs, pending = {}, None

    def submit(rid, p, sp, cls, deadline=None):
        r = pkg.request.Request(
            rid, prompt_ids=list(p),
            sampling_params=pkg.request.SamplingParams(**sp),
            qos_class=cls, deadline=deadline)
        reqs[rid] = r
        assert eng.submit(r)

    for item in flood:
        submit(*item)
    guard = 0
    while guard < 5000 and not all(r.output_ids for r in reqs.values()):
        guard += 1
        _outs, pending = pkg.engine.drive_step(eng, pending)
    for item in inter:
        submit(*item, deadline=time.monotonic() - 1.0 if due else None)
    end = time.monotonic() + 120.0
    while (eng.has_work() or pending is not None) and time.monotonic() < end:
        _outs, pending = pkg.engine.drive_step(eng, pending)
    return {rid: list(r.output_ids) for rid, r in reqs.items()}, reqs


def assert_all_finished(pkg, reqs):
    for r in reqs.values():
        assert r.status.is_finished, r.request_id
        assert r.status is not pkg.request.RequestStatus.FINISHED_ABORT, (
            r.request_id, r.abort_reason)
        assert len(r.output_ids) == r.sampling_params.max_new_tokens
