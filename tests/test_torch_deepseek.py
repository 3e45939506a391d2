"""The port's DeepSeek-V3 (MLA) and DeepSeek-V3.2 (MLA + DSA) stage models
against parallax_tpu's on the same weights (float32, CPU).

The JAX ``init_params`` trees are carried across with ``params_from_numpy``
(with a random correction bias, so the router's bias path matters). The
tiny V3 config is ``tests/test_deepseek_mla.py``'s (3 layers: one dense,
two MoE, q_lora_rank 48), plus a ``q_lora_rank=0`` variant; the tiny V3.2
adds an indexer with ``index_topk`` 8, so contexts past 8 tokens take the
sparse top-k path. Checked:
- stage logits of a ragged prefill and a decode step, one stage and two,
  the decode step on each route (ragged, split decode, fused decode):
  within 1e-4 (f32 summation order through 3 layers);
- ``init_params`` shapes, ``finalize_params``, the registry and the DSA
  shard rule.
The engines are held against each other in
``tests/test_torch_deepseek_engine.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.deepseek_v3 import DeepseekStageModel as JV3
from parallax_tpu.models.deepseek_v32 import DeepseekV32StageModel as JV32
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    DeepseekStageModel,
    DeepseekV32StageModel,
    MiniMaxM3StageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.registry import unported_features

TINY_V3 = dict(
    architectures=["DeepseekV3ForCausalLM"], hidden_size=64,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
    kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
    moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
    n_shared_experts=1, n_group=2, topk_group=1, routed_scaling_factor=1.0,
    norm_topk_prob=True, scoring_func="sigmoid", first_k_dense_replace=1,
    moe_layer_freq=1, vocab_size=199, max_position_embeddings=512,
    rms_norm_eps=1e-6, rope_theta=10000.0, rope_interleave=True,
    tie_word_embeddings=False, attention_bias=False,
)
TINY_V32 = dict(TINY_V3, architectures=["DeepseekV32ForCausalLM"],
                index_n_heads=4, index_head_dim=32, index_topk=8)
RAWS = {
    "v3": TINY_V3,
    "v3-no-q-lora": dict(TINY_V3, q_lora_rank=0),
    "v3.2": TINY_V32,
}
JCLS = {"v3": JV3, "v3-no-q-lora": JV3, "v3.2": JV32}
N_LAYERS = 3
PAGE = 8
_WEIGHTS: dict = {}


def _weights(name):
    """(JAX config, JAX params, the same params as numpy) for ``name``."""
    if name not in _WEIGHTS:
        cfg = j_normalize(RAWS[name])
        full = JCLS[name](cfg, 0, N_LAYERS, use_pallas=False).init_params(
            jax.random.key(0), dtype=jnp.float32)
        full_np = jax.tree.map(np.asarray, full)
        rng = np.random.default_rng(7)
        for layer in full_np["layers"]:
            if "experts" in layer["mlp"]:
                layer["mlp"]["gate"]["e_score_correction_bias"] = (
                    rng.normal(size=8) * 0.1).astype(np.float32)
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
    bucket), then one decode token for each."""
    rng = np.random.default_rng(0)
    pages = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    tok = rng.integers(1, 190, size=19).astype(np.int32)
    t = 32
    pre = dict(token_ids=np.zeros(t, np.int32), positions=np.zeros(t, np.int32),
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
_FLAGS = {"ragged": {}, "split": dict(decode_only=True),
          "fused": dict(decode_only=True, decode_fused=True)}


def _run_stages(models, params, bounds, batch_cls, to_dev, kvs, route):
    outs = []
    for step, b in enumerate(_batches()):
        flags = _FLAGS[route] if step else {}
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = batch_cls(
                token_ids=to_dev(b["token_ids"]) if m.is_first else None,
                hidden_states=hidden,
                **{k: to_dev(np.asarray(b[k])) for k in _KEYS}, **flags,
            )
            hidden, kvs[i] = m(_stage(params, s, e), kvs[i], inp)
        outs.append(np.asarray(hidden))
    return outs


@pytest.mark.parametrize("bounds,route", [
    ([(0, 3)], "ragged"), ([(0, 3)], "split"), ([(0, 3)], "fused"),
    ([(0, 1), (1, 3)], "ragged"),
], ids=["1-stage", "1-stage-split", "1-stage-fused", "2-stage"])
@pytest.mark.parametrize("name", sorted(RAWS))
def test_stage_logits_match_jax(name, bounds, route):
    jcfg, full_j, full_np = _weights(name)
    tcfg = normalize_config(RAWS[name])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jmodels = [JCLS[name](jcfg, s, e, use_pallas=False) for s, e in bounds]
    ref = _run_stages(jmodels, full_j, bounds, JBatch, jnp.asarray,
                      [m.new_kv_caches(8, PAGE, jnp.float32) for m in jmodels],
                      route)
    models = [create_stage_model(tcfg, s, e) for s, e in bounds]
    with torch.no_grad():
        got = _run_stages(
            models, params_from_numpy(full_np, "cpu"), bounds, BatchInputs,
            lambda a: torch.from_numpy(np.asarray(a)),
            [m.new_kv_caches(8, PAGE, torch.float32, "cpu") for m in models],
            route)
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (2, tcfg.vocab_size)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


# -- params, registry, shards -----------------------------------------------


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", sorted(RAWS))
def test_init_params_shapes_match_jax(name):
    jcfg = j_normalize(RAWS[name])
    ref = JCLS[name](jcfg, 1, 3, use_pallas=False).init_params(
        jax.random.key(0), dtype=jnp.float32)
    model = create_stage_model(normalize_config(RAWS[name]), 1, 3)
    got = model.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                            "cpu")
    assert _shapes(got) == _shapes(ref)
    gate = got["layers"][0]["mlp"]["gate"]
    assert gate["e_score_correction_bias"].dtype == torch.float32
    assert not gate["e_score_correction_bias"].any()
    again = model.init_params(torch.Generator().manual_seed(0),
                              torch.bfloat16, "cpu")
    assert torch.equal(again["layers"][1]["self_attn"]["kv_b_proj"]["weight"],
                       got["layers"][1]["self_attn"]["kv_b_proj"]["weight"])


def test_finalize_params_renames_shared_experts():
    rng = np.random.default_rng(0)
    e, i, h = 3, 4, 6
    per = {str(j): {proj: {"weight": rng.standard_normal(shape).astype(
        np.float32)} for proj, shape in (("gate_proj", (i, h)),
                                         ("up_proj", (i, h)),
                                         ("down_proj", (h, i)))}
           for j in range(e)}
    shared = {p: {"weight": np.ones((2, 2), np.float32)}
              for p in ("gate_proj", "up_proj", "down_proj")}

    def tree(conv):
        return {"layers": [{"mlp": {
            "gate": {"weight": conv(np.ones((e, h), np.float32))},
            "experts": jax.tree.map(conv, per),
            "shared_experts": jax.tree.map(conv, shared)}}]}

    ref = JV3(j_normalize(TINY_V3), 0, 3, use_pallas=False).finalize_params(
        tree(jnp.asarray))
    got = create_stage_model(normalize_config(TINY_V3), 0, 3) \
        .finalize_params(tree(torch.from_numpy))
    assert set(got["layers"][0]["mlp"]) == set(ref["layers"][0]["mlp"])
    assert "shared_expert" in got["layers"][0]["mlp"]
    for proj in ("gate_proj", "up_proj", "down_proj"):
        np.testing.assert_array_equal(
            got["layers"][0]["mlp"]["experts"][proj].numpy(),
            np.asarray(ref["layers"][0]["mlp"]["experts"][proj]))


def test_registry_builds_deepseek_families_and_refuses_the_rest():
    for arch, cls, raw in (
        ("DeepseekV2ForCausalLM", DeepseekStageModel, TINY_V3),
        ("DeepseekV3ForCausalLM", DeepseekStageModel, TINY_V3),
        ("KimiK2ForCausalLM", DeepseekStageModel, TINY_V3),
        ("DeepseekV32ForCausalLM", DeepseekV32StageModel, TINY_V32),
        ("GlmMoeDsaForCausalLM", DeepseekV32StageModel, TINY_V32),
        ("Glm4MoeDsaForCausalLM", DeepseekV32StageModel, TINY_V32),
    ):
        cfg = normalize_config(dict(raw, architectures=[arch]))
        assert unported_features(cfg) == []
        assert type(create_stage_model(cfg, 0, 3)) is cls
    # V3's class does not run the DSA indexer; a dense block runs no MLA.
    dsa_on_v3 = normalize_config(dict(TINY_V32,
                                      architectures=["DeepseekV3ForCausalLM"]))
    assert unported_features(dsa_on_v3) == ["DSA"]
    mla_on_qwen = normalize_config(dict(TINY_V3, n_routed_experts=0,
                                        architectures=["Qwen3ForCausalLM"]))
    assert unported_features(mla_on_qwen) == ["MLA"]
    # Sinks run in the base block now (gpt-oss) and MSA in MiniMax-M3's;
    # still refused: linear attention, and MSA on a class without it.
    dense = dict(architectures=["Qwen3ForCausalLM"], hidden_size=32,
                 num_hidden_layers=1, num_attention_heads=2,
                 num_key_value_heads=1, intermediate_size=64, vocab_size=50)
    sinks = normalize_config(dict(dense, attention_sinks=True))
    assert sinks.use_attention_sinks and unported_features(sinks) == []
    with pytest.raises(NotImplementedError, match="hybrid linear attention"):
        create_stage_model(normalize_config(dict(
            dense, linear_conv_kernel_dim=4)), 0, 1)
    msa = normalize_config(dict(dense, architectures=["MiniMaxM3ForCausalLM"],
                                index_n_heads=2, index_head_dim=16,
                                num_local_experts=4, num_experts_per_tok=2))
    assert msa.msa is not None and unported_features(msa) == []
    assert type(create_stage_model(msa, 0, 1)) is MiniMaxM3StageModel
    assert unported_features(msa, DeepseekV32StageModel) == ["MSA"]


def test_dsa_shard_rule_and_shared_layers():
    raw = dict(TINY_V32, index_topk_freq=2)
    cfg = normalize_config(raw)
    assert cfg.dsa.indexer_types == j_normalize(raw).dsa.indexer_types
    assert cfg.dsa.indexer_types == ("full", "shared", "full")
    with pytest.raises(ValueError, match="full indexer layer"):
        create_stage_model(cfg, 1, 3)
    model = create_stage_model(cfg, 0, 3)
    kv = model.new_kv_caches(8, PAGE, torch.float32, "cpu")
    assert [idx is None for _, idx in kv] == [False, True, False]
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
    assert ["indexer" in lp["self_attn"] for lp in params["layers"]] == [
        True, False, True]
    b = _batches()[0]
    with torch.no_grad():
        out, _ = model(params, kv, BatchInputs(
            token_ids=torch.from_numpy(b["token_ids"]), hidden_states=None,
            **{k: torch.from_numpy(np.asarray(b[k])) for k in _KEYS}))
    assert out.shape == (2, cfg.vocab_size) and torch.isfinite(out).all()
