"""Quantized models in the port against the JAX package (float32, CPU): one
JAX ``init_params`` tree, quantized by the JAX ``quantize_tree`` and
carried across with ``params_from_numpy``, served by both packages.

Models: a dense Qwen2 (int8) and Qwen3 (int4) and a Qwen3-MoE whose
experts are quantized stacks (int8; A11's path) here;
``test_torch_quant_zoo.py`` runs the same checks on a DeepSeek-V3.2 (its
indexer's ``wq_b`` / ``wk`` / ``weights_proj`` quantized; ``kv_b_proj``
dequantized once a call for the absorbed MLA) and a MiniMax-M3 (MSA's index
projections quantized). All at a group of 32.
- stage logits of a ragged prefill and a decode step, one stage and two:
  within 1e-4 of the JAX model's;
- engine greedy streams, the adaptive K = 8 window on the one-in-flight
  loop, under the tie-tolerant rule of ``tests/test_engine_e2e.py``
  (``assert_greedy_matches``: each token within 5e-3 of the JAX model's
  argmax), and inside the port the same bits as K1_SYNC and as a 2-stage
  pipeline.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.registry import (
    create_stage_model as j_create_stage_model,
)
from parallax_tpu.ops.quant import quantize_tree as j_quantize_tree
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.ops.quant import is_quantized
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from _torch_msa import TINY_M3
from test_engine_e2e import assert_greedy_matches
from test_torch_deepseek import TINY_V32
from test_torch_loader import DENSE
from test_torch_qwen3_moe import QWEN3_MOE

QWEN3 = dict(
    architectures=["Qwen3ForCausalLM"], hidden_size=64, num_hidden_layers=3,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    intermediate_size=128, vocab_size=199, max_position_embeddings=512,
    tie_word_embeddings=False,
)
# name -> (HF config, bits)
MODELS = {
    "qwen2-int8": (dict(DENSE, num_hidden_layers=3), 8),
    "qwen3-int4": (QWEN3, 4),
    "qwen3-moe-int8": (dict(QWEN3_MOE, num_hidden_layers=3), 8),
    # Cut to a dense and a sparse (MoE / MSA) layer each.
    "deepseek-v3.2-int8": (dict(TINY_V32, num_hidden_layers=2), 8),
    "minimax-m3-int4": (dict(TINY_M3, num_hidden_layers=2,
                             mlp_layer_types=TINY_M3["mlp_layer_types"][:2],
                             layer_types=TINY_M3["layer_types"][:2]), 4),
}
# This file's models; test_torch_quant_zoo.py has the others.
HERE = ("qwen2-int8", "qwen3-int4", "qwen3-moe-int8")
GROUP = 32
PAGE = 8
_TREES: dict = {}


def _trees(name):
    """(JAX config, the quantized JAX tree, the port's copy of it)."""
    if name not in _TREES:
        raw, bits = MODELS[name]
        cfg = j_normalize(raw)
        n = cfg.num_hidden_layers
        full = j_create_stage_model(cfg, 0, n, use_pallas=False).init_params(
            jax.random.key(1), dtype=jnp.float32)
        q = j_quantize_tree(full, bits=bits, group_size=GROUP,
                            dtype=jnp.float32)
        _TREES[name] = (cfg, q, params_from_numpy(
            jax.tree.map(np.asarray, q), "cpu"))
    return _TREES[name]


def _stage(tree, s, e, n):
    p = {"layers": tree["layers"][s:e]}
    if s == 0:
        p["embed_tokens"] = tree["embed_tokens"]
    if e == n:
        p["norm"] = tree["norm"]
        p["lm_head"] = tree["lm_head"]
    return p


def _batches():
    """A ragged prefill of two sequences (7 and 12 tokens in a 32-token
    bucket), then one decode token for each."""
    rng = np.random.default_rng(0)
    pages = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    t = 32
    pre = dict(token_ids=np.zeros(t, np.int32),
               positions=np.zeros(t, np.int32),
               slot_mapping=np.full(t, -1, np.int32))
    pre["token_ids"][:19] = rng.integers(1, 190, size=19)
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


def _run(models, tree, bounds, n, batch_cls, to_dev, kvs):
    outs = []
    for b in _batches():
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = batch_cls(
                token_ids=to_dev(b["token_ids"]) if m.is_first else None,
                hidden_states=hidden,
                **{k: to_dev(np.asarray(b[k])) for k in _KEYS})
            hidden, kvs[i] = m(_stage(tree, s, e, n), kvs[i], inp)
        outs.append(np.asarray(hidden))
    return outs


_JAX_LOGITS: dict = {}


def _jax_stage_logits(name):
    """The JAX model's outputs on ``_batches`` (one stage; both port
    layouts are held against it)."""
    if name not in _JAX_LOGITS:
        cfg, jtree, _ = _trees(name)
        n = cfg.num_hidden_layers
        m = j_create_stage_model(cfg, 0, n, use_pallas=False)
        _JAX_LOGITS[name] = _run([m], jtree, [(0, n)], n, JBatch,
                                 jnp.asarray,
                                 [m.new_kv_caches(8, PAGE, jnp.float32)])
    return _JAX_LOGITS[name]


def check_stage_logits(name, bounds):
    cfg, jtree, ttree = _trees(name)
    n = cfg.num_hidden_layers
    bounds = [(0, n)] if bounds == "1-stage" else [(0, 1), (1, n)]
    tcfg = normalize_config(MODELS[name][0])
    ref = _jax_stage_logits(name)
    models = [create_stage_model(tcfg, s, e) for s, e in bounds]
    with torch.no_grad():
        got = _run(models, ttree, bounds, n, BatchInputs,
                   lambda a: torch.from_numpy(np.asarray(a)),
                   [m.new_kv_caches(8, PAGE, torch.float32, "cpu")
                    for m in models])
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (2, tcfg.vocab_size)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)
    assert is_quantized(ttree["lm_head"])


ENGINE = dict(page_size=8, num_pages=96, max_model_len=256,
              max_num_tokens_per_batch=64, prefill_chunk_size=16,
              max_batch_size=3, kv_dtype="float32")
K1_SYNC = dict(decode_lookahead=1, overlap_steps=False)
N_NEW = 6


def _serve(tcfg, ttree, bounds, **engine_kw):
    n = tcfg.num_hidden_layers
    engines = [StageEngine(create_stage_model(tcfg, s, e),
                           _stage(ttree, s, e, n),
                           EngineConfig(**ENGINE, **engine_kw), device="cpu")
               for s, e in bounds]
    rng = np.random.default_rng(11)
    prefix = [int(x) for x in rng.integers(1, 198, size=16)]
    prompts = [prefix + [5, 6, 7]] + [
        [int(x) for x in rng.integers(1, 198, size=k)] for k in (13, 21)]
    reqs = [Request(f"r{i}", prompt_ids=p, sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=N_NEW)) for i, p in enumerate(prompts)]
    pipe = InProcessPipeline(engines)
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


class _JaxReference:
    """The JAX model's logits as ``assert_greedy_matches`` reads them
    (``model(ids).logits[0, -1]``): one causal forward over the whole
    context, each shorter context read at its last position. The forward
    takes the stage test's prefill shapes (a 32-token bucket, two rows of
    four pages), so the JAX functions it runs are traced once a model."""

    def __init__(self, cfg, tree, ctx):
        n = len(ctx)
        t = 32
        assert n <= t
        model = j_create_stage_model(cfg, 0, cfg.num_hidden_layers,
                                     use_pallas=False)
        pages = np.zeros((2, 4), np.int32)
        pages[0] = np.arange(1, 5)
        tok = np.zeros(t, np.int32)
        tok[:n] = ctx
        pos = np.zeros(t, np.int32)
        pos[:n] = np.arange(n)
        slots = np.full(t, -1, np.int32)
        slots[:n] = np.arange(n) + PAGE
        inp = JBatch(
            token_ids=jnp.asarray(tok), hidden_states=None,
            positions=jnp.asarray(pos),
            kv_lens=jnp.asarray([n, 0], jnp.int32),
            page_indices=jnp.asarray(pages),
            cu_q_lens=jnp.asarray([0, n, n], jnp.int32),
            num_seqs=jnp.asarray([1], jnp.int32),
            slot_mapping=jnp.asarray(slots),
            logits_indices=jnp.arange(t, dtype=jnp.int32))
        logits, _ = model(tree, model.new_kv_caches(8, PAGE, jnp.float32),
                          inp)
        self.logits = torch.from_numpy(np.asarray(logits)[:n].copy())
        self.ctx = list(ctx)

    def __call__(self, ids):
        ids = ids[0].tolist()
        assert ids == self.ctx[:len(ids)]
        return types.SimpleNamespace(logits=self.logits[None, :len(ids)])


def check_engine_streams(name):
    cfg, jtree, ttree = _trees(name)
    tcfg = normalize_config(MODELS[name][0])
    n = tcfg.num_hidden_layers
    window = _serve(tcfg, ttree, [(0, n)])           # K = 8, overlapped
    sync = _serve(tcfg, ttree, [(0, n)], **K1_SYNC)
    staged = _serve(tcfg, ttree, [(0, 1), (1, n)])
    for w, s, p in zip(window, sync, staged):
        assert w.status.value == "finished_length"
        assert w.output_ids == s.output_ids == p.output_ids, w.request_id
        ref = _JaxReference(cfg, jtree, w.prompt_ids + w.output_ids)
        assert_greedy_matches(ref, w.prompt_ids, w.output_ids, N_NEW)


@pytest.mark.parametrize("bounds", ["1-stage", "2-stage"])
@pytest.mark.parametrize("name", HERE)
def test_quantized_stage_logits_match_jax(name, bounds):
    check_stage_logits(name, bounds)


@pytest.mark.parametrize("name", HERE)
def test_quantized_engine_streams_match_jax(name):
    check_engine_streams(name)
