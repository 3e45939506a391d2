"""The port's Qwen3-MoE / Qwen2-MoE stage model against parallax_tpu's on
the same weights (float32, CPU).

The JAX ``MoEStageModel.init_params`` tree (stacked experts) is carried
across with ``params_from_numpy``. Both tiny configs mix dense and MoE
layers (``mlp_only_layers`` / ``decoder_sparse_step``); the Qwen2-MoE one
adds a shared expert and its gate. Checked:
- stage logits of a ragged prefill and a decode step, one stage and two
  stages: within 1e-4 (f32 summation order through 4 layers);
- engine greedy streams against the JAX engine under the tie-tolerant rule
  of tests/test_engine_e2e.py (every token within 5e-3 of the reference
  argmax; where the engines part, they part at a near-tie);
- ``init_params`` shapes, ``finalize_params`` stacking, the registry and the
  presets table against the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.presets import MODEL_DB as J_MODEL_DB
from parallax_tpu.models.presets import PRESETS as J_PRESETS
from parallax_tpu.models.presets import get_preset as j_get_preset
from parallax_tpu.models.qwen3_moe import MoEStageModel as JMoEStageModel
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    MoEStageModel,
    StageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.presets import get_preset
from parallax_tpu_torch.models.registry import unported_features
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams

# Layer 1 is dense (mlp_only_layers); 0, 2, 3 are MoE.
QWEN3_MOE = dict(
    architectures=["Qwen3MoeForCausalLM"], hidden_size=128,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=32, intermediate_size=96, moe_intermediate_size=64,
    num_experts=8, num_experts_per_tok=2, decoder_sparse_step=1,
    mlp_only_layers=[1], vocab_size=199, max_position_embeddings=512,
    rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False,
    torch_dtype="float32",
)
# Every second layer is MoE (1 and 3); raw top-k probabilities, q/k/v bias,
# and a shared expert with a sigmoid gate on the MoE layers.
QWEN2_MOE = dict(
    architectures=["Qwen2MoeForCausalLM"], hidden_size=128,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=96, moe_intermediate_size=64,
    shared_expert_intermediate_size=80, num_experts=8,
    num_experts_per_tok=2, decoder_sparse_step=2, norm_topk_prob=False,
    attention_bias=True, vocab_size=199, max_position_embeddings=512,
    rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False,
    torch_dtype="float32",
)
RAWS = {"qwen3-moe": QWEN3_MOE, "qwen2-moe-shared": QWEN2_MOE}
PAGE = 8
N_LAYERS = 4

_WEIGHTS: dict = {}


def _weights(name):
    """(JAX config, JAX params, the same params as numpy) for ``name``."""
    if name not in _WEIGHTS:
        raw = RAWS[name]
        cfg = j_normalize(raw)
        full = JMoEStageModel(cfg, 0, N_LAYERS, use_pallas=False).init_params(
            jax.random.key(0), dtype=jnp.float32
        )
        full_np = jax.tree.map(np.asarray, full)
        if name == "qwen2-moe-shared":
            rng = np.random.default_rng(4)
            h, si = raw["hidden_size"], raw["shared_expert_intermediate_size"]

            def dense(o, i):
                return {"weight": (rng.standard_normal((o, i)) * i ** -0.5)
                        .astype(np.float32)}

            for li, layer in enumerate(full_np["layers"]):
                if cfg.is_moe_layer(li):
                    layer["mlp"]["shared_expert"] = {
                        "gate_proj": dense(si, h), "up_proj": dense(si, h),
                        "down_proj": dense(h, si)}
                    layer["mlp"]["shared_expert_gate"] = dense(1, h)
            full = jax.tree.map(jnp.asarray, full_np)
        _WEIGHTS[name] = (cfg, full, full_np)
    return _WEIGHTS[name]


def _stage(tree, s, e):
    p = {"layers": tree["layers"][s:e]}
    if s == 0:
        p["embed_tokens"] = tree["embed_tokens"]
    if e == N_LAYERS:
        p["norm"] = tree["norm"]
        p["lm_head"] = tree["lm_head"]
    return p


def _batches():
    """A ragged prefill of two sequences (7 and 12 tokens in a 32-token
    bucket), then one decode token for each."""
    rng = np.random.default_rng(0)
    pages = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    tok = rng.integers(1, 190, size=19).astype(np.int32)
    t = 32
    pre = dict(token_ids=np.zeros(t, np.int32),
               positions=np.zeros(t, np.int32),
               slot_mapping=np.full(t, -1, np.int32))
    pre["token_ids"][:19] = tok
    pos = np.concatenate([np.arange(7), np.arange(12)])
    pre["positions"][:19] = pos
    seq = np.array([0] * 7 + [1] * 12)
    pre["slot_mapping"][:19] = pages[seq, pos // PAGE] * PAGE + pos % PAGE
    pre.update(kv_lens=np.array([7, 12], np.int32), page_indices=pages,
               cu_q_lens=np.array([0, 7, 19], np.int32),
               num_seqs=np.array([2], np.int32),
               logits_indices=np.array([6, 18], np.int32))
    dec = dict(token_ids=np.array([5, 9], np.int32),
               positions=np.array([7, 12], np.int32),
               kv_lens=np.array([8, 13], np.int32), page_indices=pages,
               cu_q_lens=np.array([0, 1, 2], np.int32),
               num_seqs=np.array([2], np.int32),
               slot_mapping=np.array([1 * PAGE + 7, 5 * PAGE + 4], np.int32),
               logits_indices=np.array([0, 1], np.int32))
    return [pre, dec]


_KEYS = ("positions", "kv_lens", "page_indices", "cu_q_lens", "num_seqs",
         "slot_mapping", "logits_indices")


def _stage_outputs_jax(cfg, full, bounds):
    models = [JMoEStageModel(cfg, s, e, use_pallas=False) for s, e in bounds]
    kvs = [m.new_kv_caches(8, PAGE, jnp.float32) for m in models]
    outs = []
    for b in _batches():
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = JBatch(
                token_ids=jnp.asarray(b["token_ids"]) if m.is_first else None,
                hidden_states=hidden,
                **{k: jnp.asarray(b[k]) for k in _KEYS},
            )
            hidden, kvs[i] = m(_stage(full, s, e), kvs[i], inp)
        outs.append(np.asarray(hidden))
    return outs


def _stage_outputs_port(cfg, full, bounds):
    models = [create_stage_model(cfg, s, e) for s, e in bounds]
    kvs = [m.new_kv_caches(8, PAGE, torch.float32, "cpu") for m in models]
    outs = []
    for b in _batches():
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = BatchInputs(
                token_ids=torch.from_numpy(b["token_ids"]) if m.is_first
                else None,
                hidden_states=hidden,
                **{k: torch.from_numpy(np.asarray(b[k])) for k in _KEYS},
            )
            with torch.no_grad():
                hidden, kvs[i] = m(_stage(full, s, e), kvs[i], inp)
        outs.append(hidden.numpy())
    return outs


@pytest.mark.parametrize("bounds", [[(0, 4)], [(0, 2), (2, 4)]],
                         ids=["1-stage", "2-stage"])
@pytest.mark.parametrize("name", sorted(RAWS))
def test_stage_logits_match_jax(name, bounds):
    jcfg, full_j, full_np = _weights(name)
    tcfg = normalize_config(RAWS[name])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [tcfg.is_moe_layer(i) for i in range(N_LAYERS)] == (
        [True, False, True, True] if name == "qwen3-moe"
        else [False, True, False, True])
    ref = _stage_outputs_jax(jcfg, full_j, bounds)
    got = _stage_outputs_port(tcfg, params_from_numpy(full_np, "cpu"), bounds)
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (2, tcfg.vocab_size)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


# -- engine streams ---------------------------------------------------------

ENGINE = dict(page_size=8, num_pages=96, max_model_len=256,
              max_num_tokens_per_batch=64, prefill_chunk_size=16,
              max_batch_size=3, kv_dtype="float32")
N_NEW = 6
TOL = 5e-3


def _prompts():
    rng = np.random.default_rng(11)
    prefix = [int(x) for x in rng.integers(1, 198, size=16)]   # 2 pages
    rand = [[int(x) for x in rng.integers(1, 198, size=n)] for n in (29, 35)]
    # r0 donates the prefix; r3 waits for a batch slot (3 max) and is
    # admitted after a release, so it must hit the prefix cache.
    return [prefix + [5, 6, 7]] + rand + [prefix + [9, 10]]


def _serve(pipe, req_cls, samp_cls):
    reqs = [req_cls(f"r{i}", prompt_ids=list(p),
                    sampling_params=samp_cls(temperature=0.0,
                                             max_new_tokens=N_NEW))
            for i, p in enumerate(_prompts())]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def _reference_logits(cfg, full, ctx):
    """JAX MoEStageModel logits at every position of ``ctx``."""
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = JMoEStageModel(cfg, 0, N_LAYERS, use_pallas=False)
    npages = (n + PAGE - 1) // PAGE
    kv = model.new_kv_caches(npages + 1, PAGE, jnp.float32)
    tok = np.zeros(t, np.int32)
    tok[:n] = ctx
    pos = np.zeros(t, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(t, -1, np.int32)
    slots[:n] = np.arange(n) + PAGE
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray([n], jnp.int32),
        page_indices=jnp.asarray(np.arange(1, npages + 1)[None], jnp.int32),
        cu_q_lens=jnp.asarray([0, n], jnp.int32),
        num_seqs=jnp.asarray([1], jnp.int32), slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32),
    )
    logits, _ = model(full, kv, inp)
    return np.asarray(logits)[:n]


@pytest.mark.parametrize("name,bounds", [
    ("qwen3-moe", [(0, 4)]),
    ("qwen3-moe", [(0, 2), (2, 4)]),
    ("qwen2-moe-shared", [(0, 4)]),
], ids=["qwen3-moe-1-stage", "qwen3-moe-2-stage", "qwen2-moe-1-stage"])
def test_engine_streams_match_jax(name, bounds):
    cfg, full, full_np = _weights(name)
    tcfg = normalize_config(RAWS[name])
    tfull = params_from_numpy(full_np, "cpu")
    engines = [StageEngine(create_stage_model(tcfg, s, e), _stage(tfull, s, e),
                           EngineConfig(**ENGINE), device="cpu")
               for s, e in bounds]
    port = _serve(InProcessPipeline(engines), Request, SamplingParams)
    jeng = [JStageEngine(JMoEStageModel(cfg, s, e, use_pallas=False),
                         _stage(full, s, e),
                         JEngineConfig(**ENGINE, decode_lookahead=1,
                                       overlap_steps=False))
            for s, e in bounds]
    ref = _serve(JPipeline(jeng), JRequest, JSampling)
    for pr, jr in zip(port, ref):
        assert pr.status.value == "finished_length"
        assert len(pr.output_ids) == N_NEW
        logits = _reference_logits(cfg, full, pr.prompt_ids
                                   + pr.output_ids[:-1])
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


# -- params, registry, presets ----------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("s,e", [(0, 4), (1, 3)])
def test_init_params_shapes_match_jax(s, e):
    jcfg = j_normalize(QWEN3_MOE)
    ref = JMoEStageModel(jcfg, s, e, use_pallas=False).init_params(
        jax.random.key(0), dtype=jnp.float32)
    cfg = normalize_config(QWEN3_MOE)
    model = create_stage_model(cfg, s, e)
    gen = torch.Generator().manual_seed(0)
    got = model.init_params(gen, torch.bfloat16, "cpu")
    assert _shapes(got) == _shapes(ref)
    moe_li = [li for li in range(e - s) if cfg.is_moe_layer(s + li)]
    assert [("experts" in got["layers"][li]["mlp"])
            for li in range(e - s)] == [li in moe_li for li in range(e - s)]
    ex = got["layers"][moe_li[0]]["mlp"]["experts"]
    assert ex["gate_proj"].dtype == torch.bfloat16
    # N(0, 1) * in_dim**-0.5: the spread of a 64 x 128 slice is near 128**-0.5.
    std = float(ex["gate_proj"].float().std())
    assert abs(std - 128 ** -0.5) < 0.01
    # The same seed gives the same weights.
    again = model.init_params(torch.Generator().manual_seed(0),
                              torch.bfloat16, "cpu")
    assert torch.equal(
        again["layers"][moe_li[0]]["mlp"]["experts"]["down_proj"],
        ex["down_proj"])


def test_finalize_params_stacks_experts_like_jax():
    rng = np.random.default_rng(0)
    e, i, h = 3, 4, 6
    per = {str(j): {proj: {"weight": rng.standard_normal(shape).astype(
        np.float32)} for proj, shape in (("gate_proj", (i, h)),
                                         ("up_proj", (i, h)),
                                         ("down_proj", (h, i)))}
           for j in range(e)}

    def tree(conv):
        return {"layers": [
            {"mlp": {"gate": {"weight": conv(np.ones((e, h), np.float32))},
                     "experts": jax.tree.map(conv, per)}},
            {"mlp": {"gate_proj": {"weight": conv(np.ones((i, h),
                                                          np.float32))}}},
        ]}

    jcfg = j_normalize(QWEN3_MOE)
    ref = JMoEStageModel(jcfg, 0, 4, use_pallas=False).finalize_params(
        tree(jnp.asarray))
    got = create_stage_model(normalize_config(QWEN3_MOE), 0, 4) \
        .finalize_params(tree(torch.from_numpy))
    for proj in ("gate_proj", "up_proj", "down_proj"):
        np.testing.assert_array_equal(
            got["layers"][0]["mlp"]["experts"][proj].numpy(),
            np.asarray(ref["layers"][0]["mlp"]["experts"][proj]))
    assert "gate_proj" in got["layers"][1]["mlp"]


def test_registry_runs_both_moe_families_only():
    for raw in (QWEN3_MOE, QWEN2_MOE):
        cfg = normalize_config(raw)
        assert unported_features(cfg) == []
        assert type(create_stage_model(cfg, 0, 4)) is MoEStageModel
    # A dense architecture's block does not run experts.
    cfg = normalize_config(dict(QWEN3_MOE, architectures=["Qwen3ForCausalLM"]))
    assert unported_features(cfg) == ["MoE"]
    with pytest.raises(NotImplementedError, match="MoE"):
        create_stage_model(cfg, 0, 4)
    assert type(create_stage_model(
        normalize_config(dict(QWEN3_MOE, architectures=["Qwen3ForCausalLM"],
                              num_experts=0)), 0, 4)) is StageModel


def test_presets_match_jax():
    names = sorted(J_PRESETS) + sorted(J_MODEL_DB)
    for name in names:
        assert dataclasses.asdict(get_preset(name)) == dataclasses.asdict(
            j_get_preset(name)), name
    cfg = get_preset("Qwen/Qwen3-30B-A3B")
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.moe.num_experts,
            cfg.moe.num_experts_per_tok, cfg.moe.moe_intermediate_size) == (
        48, 2048, 128, 8, 768)
    assert all(cfg.is_moe_layer(i) for i in range(48))
    assert unported_features(cfg) == []
