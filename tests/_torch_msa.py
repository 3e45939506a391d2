"""The port's MiniMax family against parallax_tpu's on the same numpy inputs
(float32, CPU; the Pallas kernels in interpret mode where the JAX function
reaches them).

Ops (``parallax_tpu_torch/ops/msa.py``):
- ``topk_block_positions``: equal positions, forced-score ties, kv_len 0
  padding rows and fewer blocks than the top-k budget included;
- ``msa_sparse_positions_plain`` against ``msa_sparse_positions_xla`` on a
  ragged prefill + decode batch, the page scan in one chunk and chunked;
- ``paged_sparse_gqa_attention_plain`` against the XLA function on its
  one-pass (K 64) and chunked (K 600) branches, within 1e-5, also with the
  query rows split into several passes;
- ``msa_store_and_positions`` on the fused (A7), split-kernel (A8) and plain
  routes against the JAX routes: index cache bitwise, positions equal;
- ``swiglu_oai`` and ``full_proj_rms_norm`` within 1e-6.

Models: tiny MiniMax-M3 (``tests/test_msa.py``'s config: a dense
full-attention layer, then two MSA + MoE layers; block 4 x top-2 blocks,
so any context past 8 tokens is sparse) and a tiny MiniMax-M2, one JAX
``init_params`` tree carried across with ``params_from_numpy`` (norms and
routing biases randomized so that the norm offset and the bias matter):
- stage logits of a ragged prefill past the top-k budget and two decode
  steps, on every decode route, one stage and two, within 1e-4;
- the cache list's layout, ``init_params`` shapes, ``finalize_params`` on
  HF names, the registry;
- engine greedy streams against the JAX engine under the tie-tolerant rule
  (every token within 5e-3 of the JAX model's argmax), with a prefix hit;
- the K = 8 overlapped window bit-identical to K = 1 sync, greedy and
  seeded; fused, split-kernel and plain streams identical, each route
  reaching its wrappers once per layer and decode step; a 2-stage pipeline
  equal to the single stage;
- an HF-named checkpoint written here, loaded by both loaders to the same
  tree bitwise.

The suite's configs, weights, op cases, stage runners and engines; its
cases are in tests/test_torch_msa*.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models import layers as JL
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.minimax_m2 import MiniMaxM2StageModel as JM2
from parallax_tpu.models.minimax_m3 import MiniMaxM3StageModel as JM3
from parallax_tpu.models.minimax_m3 import swiglu_oai as j_swiglu_oai
from parallax_tpu.ops import ragged as j_ragged
from parallax_tpu.ops.dsa import store_index_cache as j_store
from parallax_tpu.ops.msa import msa_sparse_positions_xla
from parallax_tpu.ops.msa import msa_store_and_positions as j_store_and_pos
from parallax_tpu.ops.msa import paged_sparse_gqa_attention_xla
from parallax_tpu.ops.msa import topk_block_positions as j_topk_blocks
from parallax_tpu.ops.msa_pallas import msa_token_scores_decode_pallas
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    MiniMaxM2StageModel,
    MiniMaxM3StageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models import layers as L
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
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from tests.test_torch_deepseek_engine import ENGINE, _prompts
from tests.test_torch_loader import _assert_same_tree

TINY_M3 = dict(
    architectures=["MiniMaxM3SparseForCausalLM"],
    model_type="minimax_m3",
    hidden_size=64,
    intermediate_size=64,          # expert size
    dense_intermediate_size=128,
    shared_intermediate_size=64,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=16,
    num_hidden_layers=3,
    rms_norm_eps=1e-6,
    rope_theta=5000000,
    partial_rotary_factor=0.5,
    max_position_embeddings=1024,
    vocab_size=199,
    use_qk_norm=True,
    use_gemma_norm=True,
    num_local_experts=4,
    num_experts_per_tok=2,
    n_shared_experts=1,
    scoring_func="sigmoid",
    use_routing_bias=True,
    routed_scaling_factor=2.0,
    mlp_layer_types=["dense", "sparse", "sparse"],
    layer_types=["full_attention", "minimax_m3_sparse", "minimax_m3_sparse"],
    index_n_heads=2,
    index_head_dim=16,
    index_block_size=4,
    index_topk_blocks=2,
    index_local_blocks=1,
    swiglu_alpha=1.702,
    swiglu_limit=7.0,
    swiglu_beta=1.0,
    tie_word_embeddings=False,
)
TINY_M2 = dict(
    architectures=["MiniMaxM2ForCausalLM"], hidden_size=64,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=64, num_local_experts=4,
    num_experts_per_tok=2, scoring_func="sigmoid", use_qk_norm=True,
    rotary_dim=8, partial_rotary_factor=0.5, vocab_size=199,
    max_position_embeddings=1024, rms_norm_eps=1e-6, rope_theta=5000000,
    tie_word_embeddings=False,
)
RAWS = {"m3": TINY_M3, "m2": TINY_M2}
JCLS = {"m3": JM3, "m2": JM2}
N_LAYERS = 3
PAGE = 8
ATOL = 1e-5
_WEIGHTS: dict = {}


def t(a):
    return torch.from_numpy(np.asarray(a))


# -- ops -----------------------------------------------------------------------


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


def _index_case(seed, hi=2, d=16):
    """Two sequences over 16-token pages: a 30-token prefill continuing to
    1,100 and a decode token at 600 (31 rows of a 32-row bucket)."""
    rng = np.random.default_rng(seed)
    page, pps = 16, 70
    ctx = [1100, 600]
    pages = np.zeros((2, pps), np.int32)
    used = 1
    for i, n in enumerate(ctx):
        npg = -(-n // page)
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    f = np.float32
    return dict(q=rng.normal(size=(32, hi, d)).astype(f),
                cache=rng.normal(size=(used, page, 1, d)).astype(f),
                lens=np.array(ctx, np.int32), pages=pages,
                cu=np.array([0, 30, 31], np.int32))


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


def _kv_case(seed, k):
    """Three query rows of two 800-token sequences over 8-token pages: a
    decode row, then two prefill rows at 798 / 799 of the other; sorted
    picks inside the context, one past row 1's causal position, and -1
    padding at the end of row 2."""
    rng = np.random.default_rng(seed)
    ctx, hq, hkv, d = 800, 4, 2, 16
    npg = ctx // PAGE
    pages = np.stack([np.arange(1, npg + 1),
                      np.arange(npg + 1, 2 * npg + 1)]).astype(np.int32)
    kv = rng.normal(size=(2 * npg + 1, PAGE, 2 * hkv, d)).astype(np.float32)
    pos = np.stack([np.sort(rng.choice(ctx, size=k, replace=False))
                    for _ in range(3)]).astype(np.int32)
    pos[1, -1] = 799                   # past row 1's position 798: masked
    pos[2, -min(25, k // 2):] = -1
    return dict(q=rng.normal(size=(3, hq, d)).astype(np.float32), kv=kv,
                lens=np.array([ctx, ctx], np.int32), pages=pages,
                cu=np.array([0, 1, 3], np.int32), pos=pos)


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


def _decode_case(seed, hi=4, d=16, page=8, pps=6):
    """Six decode rows: contexts 5-48 over 8-token pages, a kv_len 0 row
    and a frozen row (slot -1)."""
    rng = np.random.default_rng(seed)
    lens = np.array([5, 17, 48, 0, 9, 16], np.int32)
    s = len(lens)
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(lens):
        npg = (int(n) + page - 1) // page
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    slot = np.full((s,), -1, np.int32)
    for i, n in enumerate(lens):
        if n > 0 and i != 4:
            slot[i] = pages[i, (n - 1) // page] * page + (n - 1) % page
    f = np.float32
    return dict(q=rng.normal(size=(s, hi, d)).astype(f),
                k=rng.normal(size=(s, d)).astype(f),
                cache=rng.normal(size=(used + 1, page, 1, d)).astype(f),
                lens=lens, pages=pages, slot=slot,
                cu=np.arange(s + 1, dtype=np.int32))


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


# -- stage models ---------------------------------------------------------------


def _weights(name):
    """(JAX config, JAX params, the same params as numpy) for ``name``: the
    JAX init with its norms (zero or one) and routing biases (zero)
    randomized."""
    if name not in _WEIGHTS:
        cfg = j_normalize(RAWS[name])
        full = JCLS[name](cfg, 0, N_LAYERS, use_pallas=False).init_params(
            jax.random.key(0), dtype=jnp.float32)
        full_np = jax.tree.map(np.asarray, full)
        rng = np.random.default_rng(7)
        full_np = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32)
            if a.ndim == 1 else a, full_np)
        for layer in full_np["layers"]:
            if "experts" in layer["mlp"]:
                layer["mlp"]["gate"]["e_score_correction_bias"] = (
                    rng.normal(size=4) * 0.1).astype(np.float32)
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
    """A ragged prefill of two sequences (13 and 21 tokens, past the top-k
    budget of 8, in a 64-token bucket), then two decode steps."""
    rng = np.random.default_rng(0)
    pages = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    n = [13, 21]
    tok = rng.integers(1, 190, size=sum(n)).astype(np.int32)
    t_pad = 64
    pre = dict(token_ids=np.zeros(t_pad, np.int32),
               positions=np.zeros(t_pad, np.int32),
               slot_mapping=np.full(t_pad, -1, np.int32))
    pos = np.concatenate([np.arange(n[0]), np.arange(n[1])])
    seq = np.array([0] * n[0] + [1] * n[1])
    pre["token_ids"][:sum(n)] = tok
    pre["positions"][:sum(n)] = pos
    pre["slot_mapping"][:sum(n)] = pages[seq, pos // PAGE] * PAGE + pos % PAGE
    pre.update(kv_lens=np.array(n, np.int32), page_indices=pages,
               cu_q_lens=np.array([0, n[0], sum(n)], np.int32),
               num_seqs=np.array([2], np.int32),
               logits_indices=np.array([n[0] - 1, sum(n) - 1], np.int32))
    out = [pre]
    for step, toks in enumerate(([5, 9], [17, 3])):
        p = np.array([n[0] + step, n[1] + step])
        out.append(dict(
            token_ids=np.array(toks, np.int32), positions=p.astype(np.int32),
            kv_lens=(p + 1).astype(np.int32), page_indices=pages,
            cu_q_lens=np.array([0, 1, 2], np.int32),
            num_seqs=np.array([2], np.int32),
            slot_mapping=(pages[[0, 1], p // PAGE] * PAGE
                          + p % PAGE).astype(np.int32),
            logits_indices=np.array([0, 1], np.int32)))
    return out


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


def _layout(caches):
    return [tuple(tuple(x.shape) for x in c) if isinstance(c, tuple)
            else tuple(c.shape) for c in caches]


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


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


def _hf_layout(tree):
    """A model tree under the MiniMax checkpoint's MoE names:
    ``block_sparse_moe`` with ``shared_experts`` and the routing bias beside
    the gate."""
    tree = jax.tree.map(lambda a: a, tree)
    for layer in tree["layers"]:
        mlp = layer["mlp"]
        if "experts" not in mlp:
            continue
        moe = layer.pop("mlp")
        if "shared_expert" in moe:
            moe["shared_experts"] = moe.pop("shared_expert")
        if "e_score_correction_bias" in moe["gate"]:
            moe["e_score_correction_bias"] = moe["gate"].pop(
                "e_score_correction_bias")
        layer["block_sparse_moe"] = moe
    return tree


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


# -- engines --------------------------------------------------------------------

N_NEW = 10


def _serve(pipe, req_cls, samp_cls, seeded=False):
    reqs = []
    for i, p in enumerate(_prompts()):
        sp = (samp_cls(temperature=0.8, top_k=5, seed=3 + i,
                       max_new_tokens=N_NEW)
              if seeded and i % 2 else
              samp_cls(temperature=0.0, max_new_tokens=N_NEW))
        reqs.append(req_cls(f"r{i}", prompt_ids=list(p), sampling_params=sp))
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def _reference_logits(name, ctxs):
    """The JAX model's logits at every position of each context, from one
    ragged forward over all of them."""
    cfg, full, _ = _weights(name)
    lens = [len(c) for c in ctxs]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n = int(cu[-1])
    t_pad = 1 << (n - 1).bit_length()
    model = JCLS[name](cfg, 0, N_LAYERS, use_pallas=False)
    pps = max((m + PAGE - 1) // PAGE for m in lens)
    pages = 1 + np.arange(len(ctxs) * pps, dtype=np.int32).reshape(-1, pps)
    kv = model.new_kv_caches(len(ctxs) * pps + 1, PAGE, jnp.float32)
    tok = np.zeros(t_pad, np.int32)
    pos = np.zeros(t_pad, np.int32)
    slots = np.full(t_pad, -1, np.int32)
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
        logits_indices=jnp.arange(t_pad, dtype=jnp.int32),
    )
    logits = np.asarray(model(full, kv, inp)[0])
    return [logits[cu[i]:cu[i + 1]] for i in range(len(ctxs))]


def _port_engines(name, bounds, use_kernels=None, **cfg):
    tcfg = normalize_config(RAWS[name])
    tfull = params_from_numpy(_weights(name)[2], "cpu")
    return [StageEngine(create_stage_model(tcfg, s, e,
                                           use_kernels=use_kernels),
                        _stage(tfull, s, e), EngineConfig(**{**ENGINE, **cfg}),
                        device="cpu")
            for s, e in bounds]
