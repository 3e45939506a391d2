"""The port's StageModel against parallax_tpu's on the same weights.

JAX ``StageModel.init_params`` (f32) is carried across with
``params_from_numpy``; a ragged prefill step and then a decode step over the
resulting paged cache run through both packages, as one stage and as a
3-stage split, and the stage outputs must agree (atol 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    MiniMaxM3StageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models.base import BatchInputs

QWEN2 = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=199, max_position_embeddings=512, attention_bias=True,
    tie_word_embeddings=False, torch_dtype="float32",
)
# Non-power-of-two group (Hq = 6, Hkv = 2), qk-norm, tied embeddings.
QWEN3_G3 = dict(
    architectures=["Qwen3ForCausalLM"], hidden_size=48, num_hidden_layers=3,
    num_attention_heads=6, num_key_value_heads=2, head_dim=16,
    intermediate_size=96, vocab_size=151, max_position_embeddings=512,
    tie_word_embeddings=True, rope_theta=1e6, torch_dtype="float32",
)
PAGE = 8


def _stage_params(full: dict, s: int, e: int, n_layers: int, tied: bool):
    p = {"layers": full["layers"][s:e]}
    if s == 0 or (e == n_layers and tied):
        p["embed_tokens"] = full["embed_tokens"]
    if e == n_layers:
        p["norm"] = full["norm"]
        if "lm_head" in full:
            p["lm_head"] = full["lm_head"]
    return p


def _batches():
    """A ragged prefill of two sequences (7 and 12 tokens, padded to a
    32-token bucket), then one decode token for each."""
    rng = np.random.default_rng(0)
    pages = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    lens = [7, 12]
    out = []
    tok = rng.integers(1, 140, size=sum(lens)).astype(np.int32)
    t = 32
    b = dict(token_ids=np.zeros(t, np.int32), positions=np.zeros(t, np.int32),
             slot_mapping=np.full(t, -1, np.int32))
    b["token_ids"][:19] = tok
    pos = np.concatenate([np.arange(7), np.arange(12)])
    b["positions"][:19] = pos
    seq = np.array([0] * 7 + [1] * 12)
    b["slot_mapping"][:19] = pages[seq, pos // PAGE] * PAGE + pos % PAGE
    b.update(kv_lens=np.array(lens, np.int32), page_indices=pages,
             cu_q_lens=np.array([0, 7, 19], np.int32),
             num_seqs=np.array([2], np.int32),
             logits_indices=np.array([6, 18], np.int32))
    out.append(b)
    d = dict(token_ids=np.array([5, 9], np.int32),
             positions=np.array([7, 12], np.int32),
             kv_lens=np.array([8, 13], np.int32), page_indices=pages,
             cu_q_lens=np.array([0, 1, 2], np.int32),
             num_seqs=np.array([2], np.int32),
             slot_mapping=np.array([1 * PAGE + 7, 5 * PAGE + 4], np.int32),
             logits_indices=np.array([0, 1], np.int32))
    out.append(d)
    return out


def _run_jax(cfg, full, bounds, batch_list):
    models = [JStageModel(cfg, s, e, use_pallas=False) for s, e in bounds]
    kvs = [m.new_kv_caches(8, PAGE, jnp.float32) for m in models]
    outs = []
    for b in batch_list:
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = JBatch(
                token_ids=jnp.asarray(b["token_ids"]) if m.is_first else None,
                hidden_states=hidden,
                **{k: jnp.asarray(b[k]) for k in (
                    "positions", "kv_lens", "page_indices", "cu_q_lens",
                    "num_seqs", "slot_mapping", "logits_indices")},
            )
            p = _stage_params(full, s, e, cfg.num_hidden_layers,
                              cfg.tie_word_embeddings)
            hidden, kvs[i] = m(p, kvs[i], inp)
        outs.append(np.asarray(hidden))
    return outs


def _run_port(cfg, full, bounds, batch_list):
    models = [create_stage_model(cfg, s, e) for s, e in bounds]
    kvs = [m.new_kv_caches(8, PAGE, torch.float32, "cpu") for m in models]
    outs = []
    for b in batch_list:
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = BatchInputs(
                token_ids=torch.from_numpy(b["token_ids"]) if m.is_first
                else None,
                hidden_states=hidden,
                **{k: torch.from_numpy(np.asarray(b[k])) for k in (
                    "positions", "kv_lens", "page_indices", "cu_q_lens",
                    "num_seqs", "slot_mapping", "logits_indices")},
            )
            p = _stage_params(full, s, e, cfg.num_hidden_layers,
                              cfg.tie_word_embeddings)
            with torch.no_grad():
                hidden, kvs[i] = m(p, kvs[i], inp)
        outs.append(hidden.numpy())
    return outs


@pytest.mark.parametrize("raw", [QWEN2, QWEN3_G3], ids=["qwen2", "qwen3-g3"])
@pytest.mark.parametrize("bounds", [[(0, 3)], [(0, 1), (1, 2), (2, 3)]],
                         ids=["1-stage", "3-stage"])
def test_stage_logits_match_jax(raw, bounds):
    jcfg = j_normalize(raw)
    tcfg = normalize_config(raw)
    # The config copy is exact.
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    full_j = JStageModel(jcfg, 0, jcfg.num_hidden_layers).init_params(
        jax.random.key(1), dtype=jnp.float32
    )
    full_np = jax.tree.map(np.asarray, full_j)
    full_t = params_from_numpy(full_np, "cpu")
    batches = _batches()
    ref = _run_jax(jcfg, full_j, bounds, batches)
    got = _run_port(tcfg, full_t, bounds, batches)
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (2, tcfg.vocab_size)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


def test_params_from_numpy_bf16_bits_and_unported_models():
    import ml_dtypes

    a = np.array([[1.5, -2.25], [3e-3, 65504.0]], np.float32)
    tree = {"layers": [{"w": a.astype(ml_dtypes.bfloat16)}], "b": a}
    out = params_from_numpy(tree, "cpu")
    w = out["layers"][0]["w"]
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.view(torch.int16).numpy(),
                          tree["layers"][0]["w"].view(np.int16))
    assert out["b"].dtype == torch.float32
    assert params_from_numpy(tree, "cpu", torch.float32)["layers"][0][
        "w"].dtype == torch.float32
    # gpt-oss (attention sinks, alternating windows) and MiniMax-M3 (MSA)
    # build; hybrid linear attention is not ported yet.
    raw = dict(
        architectures=["GptOssForCausalLM"], hidden_size=32,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=16, intermediate_size=64, vocab_size=50,
        num_local_experts=4, num_experts_per_tok=2, sliding_window=8,
    )
    assert create_stage_model(normalize_config(raw), 0, 2).runs_moe
    msa = normalize_config(dict(raw, architectures=["MiniMaxM3ForCausalLM"],
                                index_n_heads=2, index_head_dim=16))
    model = create_stage_model(msa, 0, 2)
    assert type(model) is MiniMaxM3StageModel and model.runs_msa
    with pytest.raises(NotImplementedError, match="not ported yet"):
        create_stage_model(normalize_config(dict(
            raw, linear_conv_kernel_dim=4)), 0, 2)
