"""The port's MiniMax family against parallax_tpu's on the same numpy
inputs, ops and stages (tests/_torch_msa.py has the suite's configs and
helpers): the MSA ops (top-k block positions, sparse positions, sparse
GQA attention, the store-and-positions routes, ``swiglu_oai`` and the
full-projection norm), M2 and M3 stage logits on every decode route, the
cache layout, ``finalize_params`` on HF names, the registry and an
HF-named checkpoint loaded by both loaders."""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models import layers as JL
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.minimax_m3 import swiglu_oai as j_swiglu_oai
from parallax_tpu.ops import ragged as j_ragged
from parallax_tpu.ops.dsa import store_index_cache as j_store
from parallax_tpu.ops.msa import msa_store_and_positions as j_store_and_pos
from parallax_tpu.ops.msa import topk_block_positions as j_topk_blocks
from parallax_tpu.ops.msa import (
    msa_sparse_positions_xla,
    paged_sparse_gqa_attention_xla,
)
from parallax_tpu.ops.msa_pallas import msa_token_scores_decode_pallas
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models import (
    MiniMaxM2StageModel,
    MiniMaxM3StageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.minimax_m3 import swiglu_oai
from parallax_tpu_torch.models.registry import MODEL_REGISTRY
from parallax_tpu_torch.ops import ragged
from parallax_tpu_torch.ops.msa import (
    msa_sparse_positions_plain,
    msa_store_and_positions,
    paged_sparse_gqa_attention_plain,
    topk_block_positions,
)
from tests.test_torch_loader import (
    _assert_same_tree,
    _hf_tensors,
    _write,
)
from tests._torch_msa import (
    ATOL,
    JCLS,
    N_LAYERS,
    PAGE,
    RAWS,
    TINY_M2,
    TINY_M3,
    _ROUTES,
    _decode_case,
    _hf_layout,
    _index_case,
    _kv_case,
    _layout,
    _run_stages,
    _shapes,
    _weights,
    t,
)


@pytest.mark.parametrize("kv_cap", [48, 6], ids=["sparse", "kb-lt-topk"])
def test_topk_block_positions_match_jax(kv_cap):
    """Rows: random scores; every score equal (init / local / the rest
    tie); two tied runs; a decode row at the first block; a padding row
    (q_pos -1, nothing causal). With kv_cap 6 and blocks of 4 there are
    fewer blocks (2) than the top-k budget (3)."""
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(5, kv_cap)).astype(np.float32)
    scores[1] = 1.0
    scores[2, :kv_cap // 2] = 2.0
    scores[2, kv_cap // 2:] = -np.inf
    q_pos = np.array([kv_cap - 1, kv_cap - 2, kv_cap // 2, 2, -1], np.int64)
    kw = dict(block_size=4, topk_blocks=3, init_blocks=1, local_blocks=1)
    ref = np.asarray(j_topk_blocks(jnp.asarray(scores),
                                   jnp.asarray(q_pos, jnp.int32), **kw))
    got = topk_block_positions(t(scores), t(q_pos), **kw)
    assert got.dtype == torch.int32 and got.shape == (5, 12)
    assert np.array_equal(got.numpy(), ref)
    assert (ref[4] == -1).all()                     # padding row: nothing


@pytest.mark.parametrize("chunk_rows", [2048, 512, 64],
                         ids=["one-chunk", "3-chunks", "18-chunks"])
def test_sparse_positions_plain_match_xla(chunk_rows, monkeypatch):
    c = _index_case(3)
    kw = dict(block_size=64, topk_blocks=4, init_blocks=1, local_blocks=2,
              sm_scale=0.25)
    keys = ("q", "cache", "lens", "pages", "cu")
    monkeypatch.setattr(j_ragged, "KV_CHUNK_ROWS", chunk_rows)
    monkeypatch.setattr(ragged, "KV_CHUNK_ROWS", chunk_rows)
    ref = np.asarray(msa_sparse_positions_xla.__wrapped__(
        *(jnp.asarray(c[k]) for k in keys), **kw))
    got = msa_sparse_positions_plain(*(t(c[k]) for k in keys), **kw).numpy()
    assert np.array_equal(got[:31], ref[:31])
    # The prefill rows past 4 blocks select 4 of their blocks.
    assert ((got[0] >= 0).sum() == 4 * 64) and (got[30] >= 0).sum() == 256


@pytest.mark.parametrize("rows", [512, 2], ids=["one-pass", "row-passes"])
@pytest.mark.parametrize("k", [64, 600], ids=["single", "chunked"])
def test_sparse_gqa_attention_matches_xla(k, rows, monkeypatch):
    c = _kv_case(5, k)
    keys = ("q", "kv", "lens", "pages", "cu", "pos")
    ref = np.asarray(paged_sparse_gqa_attention_xla(
        *(jnp.asarray(c[x]) for x in keys), sm_scale=0.3))
    monkeypatch.setattr(ragged, "QUERY_ROWS", rows)
    got = paged_sparse_gqa_attention_plain(*(t(c[x]) for x in keys),
                                           sm_scale=0.3).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("route", ["fused", "split-kernel", "plain"])
def test_store_and_positions_routes_match_jax(route):
    c = _decode_case(6)
    kw = dict(block_size=4, topk_blocks=3, init_blocks=1, local_blocks=1,
              sm_scale=0.25)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    if route == "split-kernel":
        # The JAX split-kernel route (msa_sparse_positions with Pallas),
        # the K8 kernel in interpret mode.
        ref_cache = j_store(j["cache"], j["k"], j["slot"])
        scores = msa_token_scores_decode_pallas(
            j["q"], ref_cache, j["lens"], j["pages"],
            sm_scale=kw["sm_scale"], interpret=True)
        ref_pos = j_topk_blocks(scores, j["lens"] - 1,
                                **{k: v for k, v in kw.items()
                                   if k != "sm_scale"})
    else:
        ref_pos, ref_cache = j_store_and_pos(
            j["q"], j["k"], j["cache"], j["lens"], j["pages"], j["cu"],
            j["slot"], decode_only=True, use_pallas=False,
            decode_fused=route == "fused", **kw)
    cache = t(c["cache"].copy())
    pos, out_cache = msa_store_and_positions(
        t(c["q"]), t(c["k"]), cache, t(c["lens"]), t(c["pages"]),
        t(c["cu"]), t(c["slot"]), decode_only=True,
        use_kernels=route == "split-kernel", decode_fused=route == "fused",
        **kw)
    assert out_cache is cache
    assert np.array_equal(cache.numpy(), np.asarray(ref_cache))
    assert np.array_equal(pos.numpy(), np.asarray(ref_pos))
    assert (pos[3] == -1).all()                     # kv_len 0 row


def test_swiglu_oai_and_full_proj_norm_match_jax():
    rng = np.random.default_rng(8)
    g = (rng.normal(size=(6, 32)) * 6).astype(np.float32)   # past the clamp
    u = (rng.normal(size=(6, 32)) * 6).astype(np.float32)
    ref = np.asarray(j_swiglu_oai(1.702, 7.0, 1.0)(jnp.asarray(g),
                                                   jnp.asarray(u)))
    got = swiglu_oai(1.702, 7.0, 1.0)(t(g), t(u)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    ref = np.asarray(JL.full_proj_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                           1e-6))
    got = L.full_proj_rms_norm(t(x), t(w), 1e-6).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bounds,route", [
    ([(0, 3)], "ragged"), ([(0, 3)], "split"), ([(0, 3)], "split-kernel"),
    ([(0, 3)], "fused"), ([(0, 1), (1, 3)], "ragged"),
    ([(0, 2), (2, 3)], "split-kernel"),
], ids=["1-stage", "1-stage-split", "1-stage-split-kernel", "1-stage-fused",
        "2-stage", "2-stage-split-kernel"])
@pytest.mark.parametrize("name", sorted(RAWS))
def test_stage_logits_match_jax(name, bounds, route):
    jcfg, full_j, full_np = _weights(name)
    tcfg = normalize_config(RAWS[name])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    flags, use_kernels = _ROUTES[route]
    jmodels = [JCLS[name](jcfg, s, e, use_pallas=False) for s, e in bounds]
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


@pytest.mark.parametrize("s,e", [(0, 3), (1, 3)])
@pytest.mark.parametrize("name", sorted(RAWS))
def test_cache_layout_and_init_shapes_match_jax(name, s, e):
    jcfg = j_normalize(RAWS[name])
    jmodel = JCLS[name](jcfg, s, e, use_pallas=False)
    model = create_stage_model(normalize_config(RAWS[name]), s, e)
    assert (_layout(model.new_kv_caches(8, PAGE, torch.float32, "cpu"))
            == _layout(jmodel.new_kv_caches(8, PAGE, jnp.float32)))
    ref = jmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    got = model.init_params(torch.Generator().manual_seed(0), torch.bfloat16,
                            "cpu")
    assert _shapes(got) == _shapes(ref)
    # The same zero-or-one norms and zero f32 routing bias as JAX's init.
    for lg, lr in zip(got["layers"], ref["layers"]):
        for key in ("input_layernorm", "post_attention_layernorm"):
            assert np.array_equal(lg[key]["weight"].float().numpy(),
                                  np.asarray(lr[key]["weight"]))
        for key in ("q_norm", "k_norm", "index_q_norm"):
            if key in lr["self_attn"]:
                assert np.array_equal(
                    lg["self_attn"][key]["weight"].float().numpy(),
                    np.asarray(lr["self_attn"][key]["weight"]))
        bias = lr["mlp"].get("gate", {}).get("e_score_correction_bias")
        if bias is not None:
            gb = lg["mlp"]["gate"]["e_score_correction_bias"]
            assert gb.dtype == torch.float32 and not gb.any()


@pytest.mark.parametrize("name", sorted(RAWS))
def test_finalize_params_on_hf_names_matches_jax(name):
    _, _, full_np = _weights(name)
    per_expert = jax.tree.map(np.asarray, _hf_layout(full_np))
    for layer in per_expert["layers"]:
        moe = layer.get("block_sparse_moe")
        if moe is not None:
            ex = moe["experts"]
            moe["experts"] = {str(i): {p: {"weight": ex[p][i]} for p in ex}
                              for i in range(ex["gate_proj"].shape[0])}
    jcfg = j_normalize(RAWS[name])
    ref = JCLS[name](jcfg, 0, N_LAYERS, use_pallas=False).finalize_params(
        jax.tree.map(jnp.asarray, per_expert))
    got = create_stage_model(normalize_config(RAWS[name]), 0, N_LAYERS) \
        .finalize_params(params_from_numpy(per_expert, "cpu"))
    _assert_same_tree(got, params_from_numpy(
        jax.tree.map(np.asarray, ref), "cpu"))
    _assert_same_tree(got, params_from_numpy(full_np, "cpu"))


def test_registry_builds_minimax_and_keeps_text01_out():
    m3 = normalize_config(TINY_M3)
    assert m3.msa is not None and m3.msa.sparse_layer_mask == (False, True,
                                                               True)
    for arch, cls, raw in (
        ("MiniMaxM3SparseForCausalLM", MiniMaxM3StageModel, TINY_M3),
        ("MiniMaxM3ForCausalLM", MiniMaxM3StageModel, TINY_M3),
        ("MiniMaxM2ForCausalLM", MiniMaxM2StageModel, TINY_M2),
    ):
        model = create_stage_model(
            normalize_config(dict(raw, architectures=[arch])), 0, 3)
        assert type(model) is cls
    assert MiniMaxM3StageModel.runs_msa and MiniMaxM3StageModel.runs_moe
    assert not MiniMaxM2StageModel.runs_msa
    # MiniMax-Text-01 (lightning-attention hybrid) is another family.
    assert "MiniMaxForCausalLM" not in MODEL_REGISTRY
    no_gemma = create_stage_model(
        normalize_config(dict(TINY_M3, use_gemma_norm=False)), 0, 3)
    assert no_gemma.norm_offset == 0.0 and MiniMaxM3StageModel.norm_offset == 1


@pytest.mark.parametrize("name", sorted(RAWS))
def test_hf_checkpoint_loads_match_jax(tmp_path, name):
    """An HF-named checkpoint (``block_sparse_moe.experts.{i}``,
    ``shared_experts``, the bias beside the gate), written here and loaded
    by both loaders: the same tree, bit for bit, and the written values."""
    from parallax_tpu.models import loader as jloader
    from parallax_tpu_torch.models import loader

    raw = RAWS[name]
    _, _, full_np = _weights(name)
    tensors = _hf_tensors(_hf_layout(full_np))
    assert any(".block_sparse_moe.experts.0." in k for k in tensors)
    _write(tmp_path, tensors, raw, "f32")
    port = loader.load_stage_params(
        create_stage_model(normalize_config(raw), 0, N_LAYERS),
        str(tmp_path), dtype=torch.float32, device="cpu")
    jtree = jloader.load_stage_params(
        JCLS[name](j_normalize(raw), 0, N_LAYERS, use_pallas=False),
        str(tmp_path), dtype=jnp.float32)
    _assert_same_tree(port, params_from_numpy(
        jax.tree.map(np.asarray, jtree), "cpu"))
    _assert_same_tree(port, params_from_numpy(full_np, "cpu"))
