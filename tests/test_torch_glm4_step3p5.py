"""The port's GLM-4 (dense and MoE) and Step-3.5 stage models against
parallax_tpu's on the same weights (float32, CPU), and an HF-named
checkpoint of each family (Qwen3-Next's too) through both loaders.

Checked:
- stage logits of a ragged prefill and a decode step, one stage and two:
  within 1e-4 (GLM-4's interleaved partial rotary at factor 0.5 and its
  sandwich norms; GLM-4-MoE's sigmoid routing with the correction bias and
  expert groups beside a shared expert; Step-3.5's per-head qk norms,
  alternating sliding windows and head-wise gate, with and without MoE);
- engine greedy streams against the JAX engine (tie-tolerant, as
  tests/test_engine_e2e.py);
- ``finalize_params``: GLM's fused ``gate_up_proj`` split and
  ``shared_experts`` rename, Step-3.5's ``share_expert`` rename; Step-3.5's
  config quirks;
- a checkpoint under HF names, loaded by both loaders into the same tree
  as the JAX ``init_params``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.registry import create_stage_model as j_create
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    Glm4MoeStageModel,
    Glm4StageModel,
    Step3p5StageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from tests.test_torch_loader import _assert_same_tree, _hf_tensors, _write

GLM4 = dict(
    architectures=["Glm4ForCausalLM"], hidden_size=64, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    intermediate_size=96, partial_rotary_factor=0.5, vocab_size=199,
    max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=10000.0,
    tie_word_embeddings=False, attention_bias=True,
)
GLM4_MOE = dict(
    architectures=["Glm4MoeForCausalLM"], hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=128, moe_intermediate_size=32,
    n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
    n_group=2, topk_group=1, scoring_func="sigmoid", norm_topk_prob=True,
    routed_scaling_factor=1.0, first_k_dense_replace=1,
    partial_rotary_factor=0.5, use_qk_norm=True, vocab_size=199,
    max_position_embeddings=512, tie_word_embeddings=False,
)
STEP3P5 = dict(
    architectures=["Step3p5ForCausalLM"], hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_attention_groups=2,
    head_dim=16, intermediate_size=64, moe_num_experts=4, moe_top_k=2,
    sliding_window=6,
    layer_types=["full_attention", "sliding_attention",
                 "full_attention", "sliding_attention"],
    vocab_size=199, max_position_embeddings=512, tie_word_embeddings=False,
)
STEP3P5_DENSE = {k: v for k, v in STEP3P5.items()
                 if k not in ("moe_num_experts", "moe_top_k")}
RAWS = {"glm4": GLM4, "glm4-moe": GLM4_MOE, "step3p5": STEP3P5,
        "step3p5-dense": STEP3P5_DENSE}
CLS = {"glm4": Glm4StageModel, "glm4-moe": Glm4MoeStageModel,
       "step3p5": Step3p5StageModel, "step3p5-dense": Step3p5StageModel}
PAGE = 8
N_LAYERS = 4
_WEIGHTS: dict = {}


def _weights(name):
    """(JAX config, JAX params, numpy params), with non-trivial norms,
    biases and router biases so a dropped one shows."""
    if name not in _WEIGHTS:
        cfg = j_normalize(RAWS[name])
        full = j_create(cfg, 0, N_LAYERS, use_pallas=False).init_params(
            jax.random.key(1), dtype=jnp.float32)
        full_np = jax.tree.map(np.asarray, full)
        rng = np.random.default_rng(5)

        def jitter(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    jitter(v)
                elif k in ("bias", "e_score_correction_bias") or (
                        k == "weight" and v.ndim == 1):
                    tree[k] = (v + rng.standard_normal(v.shape) * 0.1
                               ).astype(np.float32)

        for layer in full_np["layers"]:
            jitter(layer)
        _WEIGHTS[name] = (cfg, jax.tree.map(jnp.asarray, full_np), full_np)
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
    bucket: the 12-token row crosses Step-3.5's 6-token window), then one
    decode token each."""
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


def _outputs(make, batch_cls, to_t, from_t, kv_fn, bounds, full):
    models = [make(s, e) for s, e in bounds]
    kvs = [kv_fn(m) for m in models]
    outs = []
    for b in _batches():
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = batch_cls(
                token_ids=to_t(b["token_ids"]) if m.is_first else None,
                hidden_states=hidden, **{k: to_t(b[k]) for k in _KEYS})
            with torch.no_grad():
                hidden, kvs[i] = m(_stage(full, s, e), kvs[i], inp)
        outs.append(from_t(hidden))
    return outs


@pytest.mark.parametrize("bounds", [[(0, 4)], [(0, 2), (2, 4)]],
                         ids=["1-stage", "2-stage"])
@pytest.mark.parametrize("name", sorted(RAWS))
def test_stage_logits_match_jax(name, bounds):
    jcfg, full_j, full_np = _weights(name)
    tcfg = normalize_config(RAWS[name])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert type(create_stage_model(tcfg, 0, N_LAYERS)) is CLS[name]
    ref = _outputs(lambda s, e: j_create(jcfg, s, e, use_pallas=False),
                   JBatch, jnp.asarray, np.asarray,
                   lambda m: m.new_kv_caches(8, PAGE, jnp.float32),
                   bounds, full_j)
    got = _outputs(lambda s, e: create_stage_model(tcfg, s, e), BatchInputs,
                   lambda a: torch.from_numpy(np.asarray(a)),
                   lambda t: t.numpy(),
                   lambda m: m.new_kv_caches(8, PAGE, torch.float32, "cpu"),
                   bounds, params_from_numpy(full_np, "cpu"))
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (2, tcfg.vocab_size)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


def test_glm4_partial_interleaved_rope():
    """GLM-4's rotary: the first half of each head rotates in adjacent
    pairs, the second half passes through (partial_rotary_factor 0.5)."""
    from parallax_tpu.ops.rope import apply_rope_interleaved as j_rope
    from parallax_tpu.ops.rope import rope_frequencies as j_freq
    from parallax_tpu.ops.rope import rope_table as j_table
    from parallax_tpu_torch.ops.rope import (
        apply_rope_interleaved,
        rope_frequencies,
        rope_table,
    )

    x = np.random.default_rng(2).standard_normal((5, 3, 16)).astype(
        np.float32)
    pos = np.array([0, 3, 9, 100, 511], np.int32)
    jc, js = j_table(j_freq(16, 10000.0, None, 0.5), 512, 1.0)
    ref = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), jc, js))
    c, s = rope_table(rope_frequencies(16, 10000.0, None, 0.5), 512, 1.0)
    got = apply_rope_interleaved(torch.from_numpy(x), torch.from_numpy(pos),
                                 c, s).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[..., 8:], x[..., 8:])
    assert Glm4StageModel.rope_fn is not Step3p5StageModel.rope_fn


# -- engine streams ---------------------------------------------------------

ENGINE = dict(page_size=PAGE, num_pages=96, max_model_len=256,
              max_num_tokens_per_batch=64, prefill_chunk_size=16,
              max_batch_size=3, kv_dtype="float32")
TOL = 5e-3
N_NEW = 6


def _reference_logits(name, ctx):
    cfg, full, _ = _weights(name)
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = j_create(cfg, 0, N_LAYERS, use_pallas=False)
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
        logits_indices=jnp.arange(t, dtype=jnp.int32))
    logits, _ = model(full, kv, inp)
    return np.asarray(logits)[:n]


def _serve(pipe, req_cls, samp_cls):
    rng = np.random.default_rng(11)
    prompts = [[int(x) for x in rng.integers(1, 198, size=n)]
               for n in (5, 19, 27)]
    reqs = [req_cls(f"r{i}", prompt_ids=p,
                    sampling_params=samp_cls(temperature=0.0,
                                             max_new_tokens=N_NEW))
            for i, p in enumerate(prompts)]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


@pytest.mark.parametrize("name", ["glm4", "glm4-moe", "step3p5"])
def test_engine_streams_match_jax(name):
    cfg, full, full_np = _weights(name)
    tcfg = normalize_config(RAWS[name])
    tfull = params_from_numpy(full_np, "cpu")
    port = _serve(InProcessPipeline([StageEngine(
        create_stage_model(tcfg, 0, N_LAYERS), tfull,
        EngineConfig(**ENGINE), device="cpu")]), Request, SamplingParams)
    ref = _serve(JPipeline([JStageEngine(
        j_create(cfg, 0, N_LAYERS, use_pallas=False), full,
        JEngineConfig(**ENGINE))]), JRequest, JSampling)
    for pr, jr in zip(port, ref):
        assert pr.status.value == "finished_length"
        logits = _reference_logits(name, pr.prompt_ids + pr.output_ids[:-1])
        p0 = len(pr.prompt_ids) - 1
        for i, tok in enumerate(pr.output_ids):
            row = logits[p0 + i]
            assert float(row.max() - row[tok]) < TOL, (name, i)
        same = 0
        while same < N_NEW and pr.output_ids[same] == jr.output_ids[same]:
            same += 1
        if same < N_NEW:
            row = logits[p0 + same]
            assert abs(float(row[pr.output_ids[same]]
                             - row[jr.output_ids[same]])) < TOL


# -- checkpoint hooks and config quirks --------------------------------------


def test_step3p5_config_quirks():
    cfg = normalize_config(STEP3P5)
    assert cfg.num_key_value_heads == 2            # num_attention_groups
    assert cfg.moe is not None and cfg.moe.num_experts == 4
    assert cfg.moe.num_experts_per_tok == 2        # moe_top_k
    assert cfg.layer_types[1] == "sliding_attention"
    assert cfg.layer_type(0) != cfg.layer_type(1)
    dense = normalize_config(STEP3P5_DENSE)
    assert dense.moe is None
    m = create_stage_model(dense, 0, 2)
    assert type(m) is Step3p5StageModel
    p = m.init_params(torch.Generator().manual_seed(0), torch.float32, "cpu")
    attn = p["layers"][0]["self_attn"]
    assert attn["g_proj"]["weight"].shape == (4, 64)
    assert "q_norm" in attn and "experts" not in p["layers"][0]["mlp"]


def test_finalize_params_renames_and_splits():
    glm = create_stage_model(normalize_config(GLM4), 0, 1)
    w = torch.randn(2 * 96, 64)
    out = glm.finalize_params(
        {"layers": [{"mlp": {"gate_up_proj": {"weight": w},
                             "down_proj": {"weight": torch.zeros(64, 96)}}}]})
    mlp = out["layers"][0]["mlp"]
    assert torch.equal(mlp["gate_proj"]["weight"], w[:96])
    assert torch.equal(mlp["up_proj"]["weight"], w[96:])
    assert "gate_up_proj" not in mlp

    moe = create_stage_model(normalize_config(GLM4_MOE), 0, 2)
    se = {"gate_proj": {"weight": torch.zeros(32, 64)}}
    out = moe.finalize_params({"layers": [{"mlp": {"shared_experts": se}}]})
    assert out["layers"][0]["mlp"]["shared_expert"] is se

    step = create_stage_model(normalize_config(STEP3P5), 0, 2)
    out = step.finalize_params({"layers": [{"mlp": {"share_expert": se}}]})
    assert out["layers"][0]["mlp"] == {"shared_expert": se}


def _hf_layout(name, tree):
    """The tree under the family's checkpoint names: GLM-4's fused
    ``gate_up_proj``, ``shared_experts``, Step-3.5's ``share_expert``,
    Qwen3-Next's 3-D conv taps."""
    tree = jax.tree.map(lambda a: np.array(a), tree)
    for layer in tree["layers"]:
        mlp = layer["mlp"]
        if name == "glm4":
            mlp["gate_up_proj"] = {"weight": np.concatenate(
                [mlp.pop("gate_proj")["weight"],
                 mlp.pop("up_proj")["weight"]])}
        if "shared_expert" in mlp:
            mlp["shared_experts" if name == "glm4-moe"
                else "share_expert"] = mlp.pop("shared_expert")
        lin = layer.get("linear_attn")
        if lin is not None:
            lin["conv1d"]["weight"] = lin["conv1d"]["weight"][:, None, :]
    return tree


def _next_weights():
    from tests.test_torch_qwen3_next import TINY, _weights as next_weights

    return TINY, next_weights()[2]


@pytest.mark.parametrize("name", ["glm4", "glm4-moe", "step3p5", "qwen3-next"])
def test_hf_checkpoint_loads_match_jax(tmp_path, name):
    from parallax_tpu.models import loader as jloader
    from parallax_tpu_torch.models import loader

    if name == "qwen3-next":
        raw, full_np = _next_weights()
    else:
        raw, full_np = RAWS[name], _weights(name)[2]
    if name == "step3p5":
        # A shared expert on the MoE layers, under Step-3.5's name.
        rng = np.random.default_rng(9)
        full_np = jax.tree.map(lambda a: a, full_np)
        for layer in full_np["layers"]:
            if "experts" in layer["mlp"]:
                layer["mlp"]["shared_expert"] = {
                    p: {"weight": rng.standard_normal(s).astype(np.float32)}
                    for p, s in (("gate_proj", (16, 64)),
                                 ("up_proj", (16, 64)),
                                 ("down_proj", (64, 16)))}
    tensors = _hf_tensors(_hf_layout(name, full_np))
    _write(tmp_path, tensors, raw, "f32")
    port = loader.load_stage_params(
        create_stage_model(normalize_config(raw), 0, N_LAYERS),
        str(tmp_path), dtype=torch.float32, device="cpu")
    jtree = jloader.load_stage_params(
        j_create(j_normalize(raw), 0, N_LAYERS, use_pallas=False),
        str(tmp_path), dtype=jnp.float32)
    _assert_same_tree(port, params_from_numpy(
        jax.tree.map(np.asarray, jtree), "cpu"))
    _assert_same_tree(port, params_from_numpy(full_np, "cpu"))
