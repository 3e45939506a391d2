"""The port's gpt-oss stage model and engine against parallax_tpu's on the
same weights (float32, CPU).

The JAX ``GptOssStageModel.init_params`` tree is carried across with
``params_from_numpy``, with random sinks and biases so that each matters.
The tiny config has 4 layers alternating a sliding window of 8 and full
attention, and the prompts are longer than the window. Checked:
- ``gpt_oss_moe_ffn`` against JAX's with forced router ties, values past
  both clamps and non-zero biases: within 1e-5 relative;
- stage logits of a ragged prefill and a decode step, one stage and two,
  the decode step on each route (ragged, split plain, split kernels,
  fused): within 1e-4 (f32 summation order through 4 layers);
- engine greedy streams against the JAX engine (K=1 sync) under the
  tie-tolerant rule of tests/test_engine_e2e.py, and inside the port the
  fused, split-kernel and plain engines' streams, each route reaching its
  wrappers once per layer and step;
- ``init_params`` shapes, f32 sinks through ``params_from_numpy``, the
  registry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.gpt_oss import GptOssStageModel as JGptOss
from parallax_tpu.models.gpt_oss import gpt_oss_moe_ffn as j_moe_ffn
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    GptOssStageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.gpt_oss import LIMIT, gpt_oss_moe_ffn
from parallax_tpu_torch.models.registry import unported_features
from parallax_tpu_torch.ops import (
    decode_fused,
    gqa_decode,
    kernel_select,
    prefill_fused,
)
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from tests.test_torch_deepseek_engine import ENGINE, N_NEW, TOL, _serve
from tests.test_torch_deepseek_routes import _spy

TINY = dict(
    architectures=["GptOssForCausalLM"], hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=32, moe_intermediate_size=32,
    num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
    layer_types=["sliding_attention", "full_attention"] * 2,
    vocab_size=199, max_position_embeddings=512, rms_norm_eps=1e-6,
    tie_word_embeddings=False,
)
N_LAYERS = 4
PAGE = 8
_WEIGHTS: dict = {}


def _weights():
    """(JAX config, JAX params, the same params as numpy): random sinks,
    router and expert biases."""
    if not _WEIGHTS:
        cfg = j_normalize(TINY)
        full = JGptOss(cfg, 0, N_LAYERS, use_pallas=False).init_params(
            jax.random.key(0), dtype=jnp.float32)
        full_np = jax.tree.map(np.asarray, full)
        rng = np.random.default_rng(7)
        for layer in full_np["layers"]:
            attn, mlp = layer["self_attn"], layer["mlp"]
            attn["sinks"] = rng.normal(size=attn["sinks"].shape).astype(
                np.float32)
            for leaf, scale in ((mlp["router"], 0.5),
                                (mlp["experts"], 0.3)):
                for k in [k for k in leaf if k.endswith("bias")]:
                    leaf[k] = (rng.normal(size=leaf[k].shape)
                               * scale).astype(np.float32)
        _WEIGHTS["w"] = (cfg, jax.tree.map(jnp.asarray, full_np), full_np)
    return _WEIGHTS["w"]


def _stage(tree, s, e):
    p = {"layers": tree["layers"][s:e]}
    if s == 0:
        p["embed_tokens"] = tree["embed_tokens"]
    if e == N_LAYERS:
        p["norm"] = tree["norm"]
        p["lm_head"] = tree["lm_head"]
    return p


# -- the MoE FFN ------------------------------------------------------------


def test_moe_ffn_matches_jax_with_ties_clamps_and_biases():
    rng = np.random.default_rng(3)
    e, h, i, t = 6, 32, 16, 13
    w_router = rng.normal(size=(e, h)).astype(np.float32) * h ** -0.5
    # Experts 1, 2 and 3 tie on every token, above the rest: top-2 must
    # take 1 and 2 (jax.lax.top_k's lower-index order).
    w_router[1:4] = rng.normal(size=h).astype(np.float32)
    bias = np.zeros(e, np.float32)
    bias[1:4] = 5.0
    p = {
        "router": {"weight": w_router, "bias": bias},
        "experts": {
            "gate_up_proj": rng.normal(size=(e, h, 2 * i)).astype(np.float32),
            "gate_up_proj_bias": rng.normal(size=(e, 2 * i)).astype(
                np.float32) * 3.0,
            "down_proj": rng.normal(size=(e, i, h)).astype(np.float32)
            * i ** -0.5,
            "down_proj_bias": rng.normal(size=(e, h)).astype(np.float32),
        },
    }
    x = rng.normal(size=(t, h)).astype(np.float32)
    gu = np.einsum("th,ehi->eti", x, p["experts"]["gate_up_proj"])
    gu += p["experts"]["gate_up_proj_bias"][:, None]
    assert (gu[..., 0::2] > LIMIT).any()              # gate clamped above
    assert (gu[..., 1::2] > LIMIT).any() and (gu[..., 1::2] < -LIMIT).any()
    ref = np.asarray(j_moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                               2))
    got = gpt_oss_moe_ffn(torch.from_numpy(x), params_from_numpy(p), 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # Doubling expert 2's weights changes the output: it was picked.
    p["experts"]["down_proj"][2] *= 2.0
    moved = gpt_oss_moe_ffn(torch.from_numpy(x), params_from_numpy(p), 2)
    assert not torch.allclose(moved, got)
    p["experts"]["down_proj"][2] /= 2.0
    p["experts"]["down_proj"][3] *= 2.0                # the tie's loser
    np.testing.assert_array_equal(
        gpt_oss_moe_ffn(torch.from_numpy(x), params_from_numpy(p), 2),
        got.numpy())


# -- stage logits -----------------------------------------------------------


def _batches():
    """A ragged prefill of two sequences (11 and 19 tokens, both past the
    window of 8, in a 32-token bucket), then one decode token for each."""
    rng = np.random.default_rng(0)
    pages = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    n0, n1 = 11, 19
    tok = rng.integers(1, 190, size=n0 + n1).astype(np.int32)
    t = 32
    pre = dict(token_ids=np.zeros(t, np.int32),
               positions=np.zeros(t, np.int32),
               slot_mapping=np.full(t, -1, np.int32))
    pre["token_ids"][:n0 + n1] = tok
    pos = np.concatenate([np.arange(n0), np.arange(n1)])
    pre["positions"][:n0 + n1] = pos
    seq = np.array([0] * n0 + [1] * n1)
    pre["slot_mapping"][:n0 + n1] = pages[seq, pos // PAGE] * PAGE + pos % PAGE
    pre.update(kv_lens=np.array([n0, n1], np.int32), page_indices=pages,
               cu_q_lens=np.array([0, n0, n0 + n1], np.int32),
               num_seqs=np.array([2], np.int32),
               logits_indices=np.array([n0 - 1, n0 + n1 - 1], np.int32))
    dec = dict(token_ids=np.array([5, 9], np.int32),
               positions=np.array([n0, n1], np.int32),
               kv_lens=np.array([n0 + 1, n1 + 1], np.int32),
               page_indices=pages,
               cu_q_lens=np.array([0, 1, 2], np.int32),
               num_seqs=np.array([2], np.int32),
               slot_mapping=np.array([2 * PAGE + 3, 5 * PAGE + 3], np.int32),
               logits_indices=np.array([0, 1], np.int32))
    return [pre, dec]


_KEYS = ("positions", "kv_lens", "page_indices", "cu_q_lens", "num_seqs",
         "slot_mapping", "logits_indices")
# route -> (decode-step flags, the port model's use_kernels)
_ROUTES = {
    "ragged": ({}, None),
    "split": (dict(decode_only=True), None),
    "split-kernel": (dict(decode_only=True), True),
    "fused": (dict(decode_only=True, decode_fused=True), None),
}


def _run_stages(models, params, bounds, batch_cls, to_dev, kvs, flags):
    outs = []
    for step, b in enumerate(_batches()):
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = batch_cls(
                token_ids=to_dev(b["token_ids"]) if m.is_first else None,
                hidden_states=hidden,
                **{k: to_dev(np.asarray(b[k])) for k in _KEYS},
                **(flags if step else {}),
            )
            hidden, kvs[i] = m(_stage(params, s, e), kvs[i], inp)
        outs.append(np.asarray(hidden))
    return outs


@pytest.mark.parametrize("bounds,route", [
    ([(0, 4)], "ragged"), ([(0, 4)], "split"), ([(0, 4)], "split-kernel"),
    ([(0, 4)], "fused"), ([(0, 2), (2, 4)], "ragged"),
    ([(0, 1), (1, 4)], "split-kernel"),
], ids=["1-stage", "1-stage-split", "1-stage-split-kernel", "1-stage-fused",
        "2-stage", "2-stage-split-kernel"])
def test_stage_logits_match_jax(bounds, route):
    jcfg, full_j, full_np = _weights()
    tcfg = normalize_config(TINY)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    flags, use_kernels = _ROUTES[route]
    jmodels = [JGptOss(jcfg, s, e, use_pallas=False) for s, e in bounds]
    ref = _run_stages(jmodels, full_j, bounds, JBatch, jnp.asarray,
                      [m.new_kv_caches(8, PAGE, jnp.float32) for m in jmodels],
                      flags)
    models = [create_stage_model(tcfg, s, e, use_kernels=use_kernels)
              for s, e in bounds]
    with torch.no_grad():
        got = _run_stages(
            models, params_from_numpy(full_np, "cpu"), bounds, BatchInputs,
            lambda a: torch.from_numpy(np.asarray(a)),
            [m.new_kv_caches(8, PAGE, torch.float32, "cpu") for m in models],
            flags)
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (2, tcfg.vocab_size)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


# -- engines ----------------------------------------------------------------


def _reference_logits(ctxs):
    """The JAX model's logits at every position of each context, from one
    ragged forward over all of them."""
    cfg, full, _ = _weights()
    lens = [len(c) for c in ctxs]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n = int(cu[-1])
    t = 1 << (n - 1).bit_length()
    model = JGptOss(cfg, 0, N_LAYERS, use_pallas=False)
    pps = max((m + PAGE - 1) // PAGE for m in lens)
    pages = 1 + np.arange(len(ctxs) * pps, dtype=np.int32).reshape(-1, pps)
    kv = model.new_kv_caches(len(ctxs) * pps + 1, PAGE, jnp.float32)
    tok = np.zeros(t, np.int32)
    pos = np.zeros(t, np.int32)
    slots = np.full(t, -1, np.int32)
    for i, c in enumerate(ctxs):
        p = np.arange(len(c))
        tok[cu[i]:cu[i + 1]] = c
        pos[cu[i]:cu[i + 1]] = p
        slots[cu[i]:cu[i + 1]] = pages[i, p // PAGE] * PAGE + p % PAGE
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray(lens, jnp.int32),
        page_indices=jnp.asarray(pages), cu_q_lens=jnp.asarray(cu),
        num_seqs=jnp.asarray([len(ctxs)], jnp.int32),
        slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32),
    )
    logits, _ = model(full, kv, inp)
    logits = np.asarray(logits)
    return [logits[cu[i]:cu[i + 1]] for i in range(len(ctxs))]


def _port_engines(bounds, use_kernels=None, **cfg):
    tcfg = normalize_config(TINY)
    tfull = params_from_numpy(_weights()[2], "cpu")
    return [StageEngine(create_stage_model(tcfg, s, e,
                                           use_kernels=use_kernels),
                        _stage(tfull, s, e), EngineConfig(**ENGINE, **cfg),
                        device="cpu")
            for s, e in bounds]


@pytest.mark.parametrize("bounds", [[(0, 4)], [(0, 2), (2, 4)]],
                         ids=["1-stage", "2-stage"])
def test_engine_streams_match_jax(bounds):
    cfg, full, _ = _weights()
    port = _serve(InProcessPipeline(_port_engines(bounds)), Request,
                  SamplingParams)
    jeng = [JStageEngine(JGptOss(cfg, s, e, use_pallas=False),
                         _stage(full, s, e),
                         JEngineConfig(**ENGINE, decode_lookahead=1,
                                       overlap_steps=False))
            for s, e in bounds]
    ref = _serve(JPipeline(jeng), JRequest, JSampling)
    all_logits = _reference_logits(
        [pr.prompt_ids + pr.output_ids[:-1] for pr in port])
    for pr, jr, logits in zip(port, ref, all_logits):
        assert pr.status.value == "finished_length"
        assert len(pr.output_ids) == N_NEW
        p0 = len(pr.prompt_ids) - 1
        for i, tok in enumerate(pr.output_ids):
            row = logits[p0 + i]
            gap = float(row.max() - row[tok])
            assert gap < TOL, (pr.request_id, i, tok, int(row.argmax()), gap)
        same = 0
        while same < N_NEW and pr.output_ids[same] == jr.output_ids[same]:
            same += 1
        if same < N_NEW:
            row = logits[p0 + same]
            gap = abs(float(row[pr.output_ids[same]]
                            - row[jr.output_ids[same]]))
            assert gap < TOL, (pr.request_id, same, gap)
    assert port[-1].num_cached_tokens > 0
    assert ref[-1].num_cached_tokens == port[-1].num_cached_tokens


def test_fused_split_and_plain_streams_identical(monkeypatch):
    """Within the port: the fused route, the split route through the split
    kernels' wrappers (A9 for decode steps, A1 attend-only for the rest)
    and the plain split route give the same streams, greedy and seeded,
    and label their dispatches as the JAX engine does. (On the CPU every
    wrapper runs its plain version; the test lets the engine take the fused
    route on the CPU.)"""
    monkeypatch.setattr(kernel_select, "_check_kernel_device",
                        lambda device, what: None)
    calls: dict[str, int] = {}
    _spy(monkeypatch, decode_fused, "gqa_fused_decode", calls)
    _spy(monkeypatch, prefill_fused, "gqa_fused_prefill", calls)
    _spy(monkeypatch, gqa_decode, "gqa_decode_attention", calls)
    _spy(monkeypatch, prefill_fused, "gqa_prefill_attend", calls)
    streams, seen = {}, {}
    for route, fused, kernels in (("fused", True, None),
                                  ("split-kernel", False, True),
                                  ("plain", False, None)):
        calls.clear()
        engines = _port_engines([(0, 4)], use_kernels=kernels,
                                decode_fused=fused, prefill_fused=fused)
        reqs = _serve(InProcessPipeline(engines), Request, SamplingParams,
                      seeded=True)
        streams[route] = [r.output_ids for r in reqs]
        seen[route] = (dict(calls), engines[0].kernel_dispatch_summary())
    assert streams["fused"] == streams["split-kernel"] == streams["plain"]
    for route, (c, summary) in seen.items():
        totals = summary["dispatch_total"]
        # Single steps and the decode windows' forward steps.
        decode = sum(totals.get(f"{summary['impl']}/{path}", 0)
                     for path in ("decode", "multistep"))
        prefill = totals.get(f"{summary['prefill_impl']}/prefill", 0)
        assert decode > 0 and prefill > 0
        # Sink models mark every one-token step decode_only: all decode
        # dispatches carry the decode label.
        assert sum(n for k, n in totals.items()
                   if not k.endswith("/sample")) == decode + prefill
        want = {"fused": {"gqa_fused_decode": decode,
                          "gqa_fused_prefill": prefill},
                "split-kernel": {"gqa_decode_attention": decode,
                                 "gqa_prefill_attend": prefill},
                "plain": {}}[route]
        # gqa_fused_prefill calls gqa_prefill_attend only on CUDA tensors.
        assert {k: v for k, v in c.items() if v} == {
            k: N_LAYERS * n for k, n in want.items()}, route
    impl = {r: (s["impl"], s["prefill_impl"]) for r, (_, s) in seen.items()}
    assert impl == {"fused": ("cuda-fused", "cuda-fused"),
                    "split-kernel": ("cuda-split", "cuda-split"),
                    "plain": ("torch", "torch")}


# -- params, registry ---------------------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("s,e", [(0, 4), (1, 3)])
def test_init_params_shapes_match_jax(s, e):
    ref = JGptOss(j_normalize(TINY), s, e, use_pallas=False).init_params(
        jax.random.key(0), dtype=jnp.float32)
    model = create_stage_model(normalize_config(TINY), s, e)
    got = model.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                            "cpu")
    assert _shapes(got) == _shapes(ref)
    for layer in got["layers"]:
        assert layer["self_attn"]["sinks"].dtype == torch.float32
        assert not layer["self_attn"]["sinks"].any()
        assert layer["mlp"]["experts"]["down_proj"].dtype == torch.bfloat16
        assert not layer["mlp"]["router"]["bias"].any()
    again = model.init_params(torch.Generator().manual_seed(0),
                              torch.bfloat16, "cpu")
    assert torch.equal(again["layers"][0]["mlp"]["experts"]["gate_up_proj"],
                       got["layers"][0]["mlp"]["experts"]["gate_up_proj"])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16, torch.float32])
def test_params_from_numpy_keeps_sinks_f32(dtype):
    _, _, full_np = _weights()
    tree = params_from_numpy(full_np, "cpu", dtype)
    for lnp, layer in zip(full_np["layers"], tree["layers"]):
        sinks = layer["self_attn"]["sinks"]
        assert sinks.dtype == torch.float32
        np.testing.assert_array_equal(sinks.numpy(), lnp["self_attn"]["sinks"])
        want = dtype or torch.float32
        assert layer["mlp"]["experts"]["gate_up_proj"].dtype == want
    # A bf16 leaf (a checkpoint's sinks) comes out f32 too.
    bf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        full_np["layers"][0]["self_attn"])
    got = params_from_numpy({"sinks": bf16["sinks"]}, "cpu")["sinks"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(bf16["sinks"], np.float32))


def test_registry_builds_gpt_oss():
    cfg = normalize_config(TINY)
    assert cfg.use_attention_sinks
    assert unported_features(cfg) == []
    model = create_stage_model(cfg, 0, N_LAYERS)
    assert type(model) is GptOssStageModel
    assert model.runs_moe
    with pytest.raises(ValueError, match="MoE"):
        GptOssStageModel(dataclasses.replace(cfg, moe=None), 0, N_LAYERS)
