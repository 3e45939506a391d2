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
penalties and logprobs."""

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
from parallax_tpu_torch.constrained import GrammarCompiler
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


def test_window_mask_overrides_argmax():
    """The grammar's opening state allows only whitespace or '{', and the
    free-running model's greedy pick is not in that set: the first
    committed token shows the in-window mask beat the raw argmax, and the
    stream is the sync sampler's."""
    allowed0 = np.asarray(
        GrammarCompiler(BYTE_VOCAB, EOS).compile(SCHEMA).allowed_mask(0))
    free = _drive(_engine(8), [Request(
        "f", prompt_ids=[1, 2, 3], sampling_params=SamplingParams(
            temperature=0.0, max_new_tokens=4, ignore_eos=True))])
    assert not allowed0[free[0].output_ids[0]]   # the adversarial premise
    gram = _drive(_engine(8), [_gram_req()])
    assert allowed0[gram[0].output_ids[0]]
    assert gram[0].output_ids[0] != free[0].output_ids[0]
    sync = _drive(_engine(1), [_gram_req()])
    assert gram[0].output_ids == sync[0].output_ids


def test_window_terminal_state_stops():
    """A +20 bias makes EOS the argmax wherever the grammar allows it, at
    accepting states only: the request finishes mid-window, under its
    budget, the moment the JSON object closes."""
    def mk():
        return [Request("g", prompt_ids=[3, 1], eos_token_ids=(EOS,),
                        sampling_params=SamplingParams(
                            temperature=0.0, max_new_tokens=64,
                            json_schema=SCHEMA, logit_bias={EOS: 20.0}))]
    win = _drive(_engine(8), mk())
    assert _json_of(win[0])["v"] in ("x", "y")
    assert len(win[0].output_ids) < 64
    assert win[0].status.name == "FINISHED_EOS"
    sync = _drive(_engine(1), mk())
    assert win[0].output_ids == sync[0].output_ids


def test_window_bias_penalty_grammar_stack():
    """All features on ONE seeded row: the window applies them in the host
    order (penalties -> bias -> mask -> sample -> logprob)."""
    def mk():
        return [Request("s", prompt_ids=[2, 4, 6],
                        sampling_params=SamplingParams(
                            temperature=0.8, seed=3, max_new_tokens=40,
                            json_schema=SCHEMA, logprobs=True,
                            repetition_penalty=1.2, presence_penalty=0.3,
                            logit_bias={ord("x"): 2.5}))]
    base = _drive(_engine(1), mk())
    win = _drive(_engine(8), mk())
    assert win[0].output_ids == base[0].output_ids
    assert win[0].output_logprobs == base[0].output_logprobs
    assert len(base[0].output_logprobs) == len(base[0].output_ids)
    _json_of(win[0])


def test_constrained_window_off_falls_back():
    """constrained_window=False: grammar batches decode host-synchronously
    (the ledger counts the fallback), with the window path's stream."""
    off = _engine(8, constrained_window=False)
    reqs = _drive(off, [_gram_req()])
    assert not any("gram" in f for f in off.window_feature_counts)
    s = off.constrained_summary()
    assert s["enabled"] is False and s["fallbacks"] >= 1
    on = _drive(_engine(8), [_gram_req()])
    assert reqs[0].output_ids == on[0].output_ids


def test_device_table_cache_reuse():
    """One table build per grammar per engine: the second request with the
    same schema reuses it."""
    eng = _engine(8)
    for i in range(2):
        _drive(eng, [_gram_req(f"g{i}", prompt=(1, 2, 3 + i))])
    s = eng.constrained_summary()
    assert s["table_builds"] == 1 and s["table_cache_hits"] >= 1
    assert len(eng._gram_combo_cache) == 1


# -- engine-level cases of tests/test_constrained.py --------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_engine_constrained_output_is_valid(temperature):
    eng = _engine()
    reqs = [Request(f"g{i}", prompt_ids=[1, 2, 3 + i],
                    sampling_params=SamplingParams(
                        temperature=temperature, max_new_tokens=40,
                        json_schema=SCHEMA,
                        seed=i if temperature else None))
            for i in range(3)]
    _drive(eng, reqs, overlap=True)
    for r in reqs:
        assert _json_of(r)["v"] in ("x", "y"), r.output_ids


def test_engine_mixed_constrained_and_free():
    """Constrained and free rows in one batch: masks apply only to their
    rows."""
    g = _gram_req(prompt=(5, 6), max_new=30)
    f = Request("f", prompt_ids=[5, 6], sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=8, ignore_eos=True))
    _drive(_engine(), [g, f], overlap=True)
    _json_of(g)
    assert len(f.output_ids) == 8
    alone = _drive(_engine(), [Request(
        "f", prompt_ids=[5, 6], sampling_params=SamplingParams(
            temperature=0.0, max_new_tokens=8, ignore_eos=True))])
    assert f.output_ids == alone[0].output_ids


@pytest.mark.parametrize("lookahead", [None, 1], ids=["window", "k1"])
def test_engine_without_vocab_aborts_constrained(lookahead):
    eng = _engine(lookahead, vocab=False)
    r = Request("g", prompt_ids=[1], sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=8, json_schema=SCHEMA))
    _drive(eng, [r], overlap=True)
    assert r.status.name.startswith("FINISHED_ABORT")
    assert "set_grammar_vocab" in r.abort_reason


def test_grammar_state_cleared_on_release():
    eng = _engine()
    r = Request("g", prompt_ids=[1], sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=30, json_schema=SCHEMA,
        logit_bias={5: 1.0}))
    _drive(eng, [r], overlap=True)
    assert "g" not in eng._grammar_states and "g" not in eng._bias_cache
    eng2 = _engine()
    r2 = Request("h", prompt_ids=[1, 2], sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=30, json_schema=SCHEMA,
        logit_bias={5: 1.0}))
    eng2.submit(r2)
    eng2.step()
    eng2.step()
    assert "h" in eng2._grammar_states
    eng2.release("h", abort=True)
    assert "h" not in eng2._grammar_states and "h" not in eng2._bias_cache


# -- a pipeline whose tail samples with features ------------------------------


@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "seeded"])
def test_pipeline_tail_samples_with_features(temp):
    """A 2-stage in-process pipeline: the tail's penalties read the
    mirror's generated ids, its logprobs travel in ``token_logprob``, its
    grammar mask runs on the tail's host DFA; the streams are the
    single-stage K = 1 engine's."""
    single = _drive(_engine(1, overlap=False), _feature_requests(temp))
    head, tail = _engine(start=0, end=1), _engine(start=1, end=2)
    pipe = InProcessPipeline([head, tail])
    reqs = _feature_requests(temp)
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    for a, b in zip(single, reqs):
        assert b.output_ids == a.output_ids, a.request_id
        assert b.output_logprobs == a.output_logprobs
        assert b.status == a.status
    assert _json_of(reqs[0])["v"] in ("x", "y")
    assert not tail._grammar_states and not tail._bias_cache
