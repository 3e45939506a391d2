"""Sampling features in the port's engine: presence / frequency /
repetition penalties, logit_bias, logprobs and JSON-schema grammar masks,
on the host-synchronous single-step path and inside the K-step decode
window (the eager loop of the step the card replays from CUDA graphs).

Against the JAX engine on the same weights (``tests/test_constrained_window
.py``'s tiny Qwen2 over the byte vocabulary): greedy feature streams pass a
tie-tolerant rule on the JAX model's one-shot logits with each row's
features applied by the JAX package's ops, logprobs agree at 1e-4, the
grammar row decodes to schema-valid JSON. Inside the port: K = 8 feature
windows commit exactly the K = 1 host path's tokens and logprob bits,
greedy and seeded, sync and overlapped; the window ports of the JAX
package's adversarial grammar cases; the engine-level cases of
``tests/test_constrained.py``; a 2-stage pipeline whose tail samples with
penalties and logprobs.

The suite's shared model, weights, engines, request mixes and reference
logits; its cases are in tests/test_torch_features*.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.constrained import GrammarCompiler as JGrammarCompiler
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.ops.sampling import apply_penalties as j_apply_penalties
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams

BYTE_VOCAB = [bytes([i]) for i in range(256)] + [b"", b""]
EOS = 257
RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=258, max_position_embeddings=512,
)
J_CFG = j_normalize(RAW)
CFG = normalize_config(RAW)
SCHEMA = json.dumps({
    "type": "object",
    "properties": {"v": {"enum": ["x", "y"]}},
    "required": ["v"],
})
TOL = 5e-3
_J_MODEL = JStageModel(J_CFG, 0, 2, use_pallas=False)
_J_PARAMS = _J_MODEL.init_params(jax.random.key(0), dtype=jnp.float32)
_NP_PARAMS = jax.tree.map(np.asarray, _J_PARAMS)
_ENGINE = dict(page_size=8, num_pages=128, max_model_len=256,
               kv_dtype="float32")


def _engine(lookahead=None, overlap=True, start=0, end=2, vocab=True,
            **cfg_kw):
    p = params_from_numpy(_NP_PARAMS, "cpu")
    if (start, end) != (0, 2):
        full, p = p, {"layers": p["layers"][start:end]}
        if start == 0 or (end == 2 and "lm_head" not in full):
            p["embed_tokens"] = full["embed_tokens"]
        if end == 2:
            p["norm"] = full["norm"]
            if "lm_head" in full:
                p["lm_head"] = full["lm_head"]
    eng = StageEngine(create_stage_model(CFG, start, end), p, EngineConfig(
        decode_lookahead=lookahead, overlap_steps=overlap,
        **dict(_ENGINE, **cfg_kw)), device="cpu")
    if vocab and end == 2:
        eng.set_grammar_vocab(BYTE_VOCAB, EOS)
    return eng


def _feature_requests(temp, max_new=12, cls=Request, sp_cls=SamplingParams):
    """The feature mix of ``tests/test_constrained_window.py``: a grammar
    row, a penalised row, a biased row that wants logprobs and a clean
    control row."""
    seeded = temp > 0
    return [
        cls("gram", prompt_ids=[1, 2, 3], sampling_params=sp_cls(
            temperature=temp, max_new_tokens=3 * max_new,
            json_schema=SCHEMA, seed=5 if seeded else None)),
        cls("pen", prompt_ids=[9, 8, 7], sampling_params=sp_cls(
            temperature=temp, max_new_tokens=max_new, ignore_eos=True,
            repetition_penalty=1.3, presence_penalty=0.5,
            frequency_penalty=0.2, seed=7 if seeded else None)),
        cls("bias", prompt_ids=[4, 5, 6], sampling_params=sp_cls(
            temperature=temp, max_new_tokens=max_new, ignore_eos=True,
            logit_bias={11: 4.0, 23: -6.0}, logprobs=True,
            seed=11 if seeded else None)),
        cls("free", prompt_ids=[42, 43], sampling_params=sp_cls(
            temperature=temp, max_new_tokens=max_new, ignore_eos=True,
            seed=13 if seeded else None)),
    ]


def _drive(eng, reqs, overlap=False):
    for r in reqs:
        eng.submit(r)
    if overlap:
        pending, guard = None, 0
        while (eng.has_work() or pending is not None) and guard < 20000:
            _, pending = drive_step(eng, pending)
            guard += 1
        assert pending is None and not eng._inflight
    else:
        InProcessPipeline([eng]).run_until_complete()
    return reqs


def _json_of(req, vocab=256):
    return json.loads(bytes(t for t in req.output_ids if t < vocab))


def _reference_logits(ctx: list[int]) -> np.ndarray:
    """The JAX StageModel's logits at every position of ``ctx``, one
    forward."""
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    page = 8
    npages = (n + page - 1) // page
    kv = _J_MODEL.new_kv_caches(npages + 1, page, jnp.float32)
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
    logits, _ = _J_MODEL(_J_PARAMS, kv, inp)
    return np.asarray(logits)[:n]


def _feature_logits(req, logits, i, table):
    """Position ``i``'s reference logits with the row's features applied by
    the JAX package's ops: penalties from the tokens committed before it,
    the bias, then the grammar mask of the host DFA state."""
    sp = req.sampling_params
    out = req.output_ids[:i]
    row = jnp.asarray(logits[None])
    v = row.shape[1]
    if sp.presence_penalty or sp.frequency_penalty or (
            sp.repetition_penalty != 1.0):
        counts = np.zeros((1, v), np.int32)
        for t in out:
            counts[0, t] += 1
        row = j_apply_penalties(
            row, jnp.asarray(counts),
            jnp.asarray([sp.presence_penalty], jnp.float32),
            jnp.asarray([sp.frequency_penalty], jnp.float32),
            jnp.asarray([sp.repetition_penalty], jnp.float32))
    row = np.asarray(row[0], np.float32).copy()
    for tid, b in (sp.logit_bias or {}).items():
        row[int(tid)] += float(b)
    if table is not None:
        state = 0
        for t in out:
            state = table.advance(state, t)
        mask = np.zeros((v,), bool)
        m = np.asarray(table.allowed_mask(state))
        mask[: m.shape[0]] = m[:v]
        row = np.where(mask, row, np.float32(-1e10))
    return row


def _assert_feature_greedy(req, label):
    """Every committed token is within TOL of the argmax of the reference
    logits with the row's features applied (``assert_greedy_matches`` of
    ``tests/test_engine_e2e.py`` with features)."""
    sp = req.sampling_params
    table = (JGrammarCompiler(BYTE_VOCAB, EOS).compile(sp.json_schema)
             if sp.json_schema else None)
    logits = _reference_logits(req.prompt_ids + req.output_ids[:-1])
    p = len(req.prompt_ids)
    for i, tok in enumerate(req.output_ids):
        row = _feature_logits(req, logits[p - 1 + i], i, table)
        best = int(np.argmax(row))
        gap = float(row[best] - row[tok])
        assert tok == best or gap < TOL, (label, i, tok, best, gap)


# -- against the JAX engine ------------------------------------------------


@pytest.mark.parametrize("lookahead", [None, 1], ids=["window", "k1"])
def test_feature_streams_match_jax(lookahead):
    port = _drive(_engine(lookahead), _feature_requests(0.0),
                  overlap=True)
    jeng = JStageEngine(_J_MODEL, _J_PARAMS, JEngineConfig(
        decode_lookahead=lookahead, **_ENGINE))
    jeng.set_grammar_vocab(BYTE_VOCAB, EOS)
    jreqs = _feature_requests(0.0, cls=JRequest, sp_cls=JSampling)
    for r in jreqs:
        jeng.submit(r)
    JPipeline([jeng]).run_until_complete()
    for pr, jr in zip(port, jreqs):
        assert pr.status.value == jr.status.value, pr.request_id
        _assert_feature_greedy(pr, pr.request_id)
        _assert_feature_greedy(jr, "jax " + jr.request_id)
        same = 0
        while (same < min(len(pr.output_ids), len(jr.output_ids))
               and pr.output_ids[same] == jr.output_ids[same]):
            same += 1
        if pr.sampling_params.logprobs:
            assert len(pr.output_logprobs) == len(pr.output_ids)
            np.testing.assert_allclose(pr.output_logprobs[:same],
                                       jr.output_logprobs[:same], atol=1e-4)
            assert all(lp <= 0.0 for lp in pr.output_logprobs)
        else:
            assert pr.output_logprobs == []
    assert _json_of(port[0])["v"] in ("x", "y")


# -- the bit-identity matrix inside the port ---------------------------------


@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "seeded"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_feature_window_bit_identity(temp, overlap):
    """K = 8 feature windows commit exactly the K = 1 host-synchronous
    stream, logprob bits included."""
    base = _drive(_engine(1, overlap=overlap), _feature_requests(temp),
                  overlap=overlap)
    win = _drive(_engine(8, overlap=overlap), _feature_requests(temp),
                 overlap=overlap)
    for b, m in zip(base, win):
        assert m.output_ids == b.output_ids, (b.request_id, b.output_ids,
                                              m.output_ids)
        assert m.status == b.status
        assert m.output_logprobs == b.output_logprobs
    assert _json_of(win[0])["v"] in ("x", "y")


def test_feature_window_actually_fused():
    """The matrix above is vacuous if the feature batches fell back to
    K = 1: the feature sets really rode windows and the ledger saw
    in-window grammar rows."""
    eng = _engine(8)
    _drive(eng, _feature_requests(0.0))
    seen = set(eng.window_feature_counts)
    assert any("gram" in f for f in seen), seen
    assert any("pen" in f for f in seen)
    assert any("bias" in f and "lp" in f for f in seen)
    s = eng.constrained_summary()
    assert s is not None and s["window_rows"] > 0
    assert s["mask_steps"] > 0 and s["fallbacks"] == 0
    total = eng.kernel_dispatch_summary()["dispatch_total"]
    assert total["torch/multistep"] > total.get("torch/decode", 0)


# -- adversarial grammar cases in the window ----------------------------------


def _gram_req(rid="g", prompt=(1, 2, 3), max_new=36, **sp):
    return Request(rid, prompt_ids=list(prompt),
                   sampling_params=SamplingParams(
                       temperature=0.0, max_new_tokens=max_new,
                       json_schema=SCHEMA, **sp))
