"""Speculative decoding in the port, on the CPU, held to the JAX package.

The proposer and the accept rule against the JAX functions on seeded numpy
inputs; then the claims of ``tests/test_speculative.py`` inside the port:
the speculative K-step window (proposals staged into the window, the
verify forward over 1 + P positions a row, the accept rule and the
context rewind on the device) and the host-synchronous K = 1 fallback
commit exactly the spec-off stream — greedy and seeded, sync and overlap,
whatever the proposers emit; stops and budgets roll back; the draft
proposer (same weights accepts everything; a slow draft cannot stall the
batch); rows with sampling features ride the speculative window. Greedy
streams equal the JAX engine's under ``assert_greedy_matches``, and
``serve --draft-model-path`` serves a checkpoint the test writes. The
suite's model: 2 layers, hidden 64, vocab 199, f32."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.ops import sampling as ops
from parallax_tpu_torch.runtime.engine import (
    DraftProposer,
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from tests.test_torch_cli import checkpoint  # noqa: F401  (a fixture)

RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=128, vocab_size=199, max_position_embeddings=512,
    tie_word_embeddings=False,
)
CFG = normalize_config(RAW)
_MODEL = create_stage_model(CFG, 0, 2)
_PARAMS = _MODEL.init_params(torch.Generator().manual_seed(0),
                             torch.float32, "cpu")


def _engine(spec_tokens, params=None, draft=None, lookahead=None, **cfg_kw):
    defaults = dict(page_size=8, num_pages=256, max_model_len=256,
                    kv_dtype="float32")
    defaults.update(cfg_kw)
    return StageEngine(
        _MODEL, params if params is not None else _PARAMS,
        EngineConfig(speculative_tokens=spec_tokens,
                     decode_lookahead=lookahead, **defaults),
        device="cpu", draft=draft)


def _adversarialize(eng, fallback):
    """When n-gram lookup finds nothing, propose ``fallback`` garbage:
    exactness must hold for arbitrary proposals."""
    orig = eng._ngram_proposal
    eng._ngram_proposal = lambda toks, n, k: (
        orig(toks, n, k) or list(fallback)[:k])


def _run(spec_tokens, prompts, max_new=12, params=None, draft=None,
         lookahead=None, sp_kw=None, overlap=False, adversarial=None,
         eos=(), **cfg_kw):
    eng = _engine(spec_tokens, params=params, draft=draft,
                  lookahead=lookahead, overlap_steps=overlap, **cfg_kw)
    if adversarial is not None:
        _adversarialize(eng, adversarial)
    kws = sp_kw or [dict(temperature=0.0)] * len(prompts)
    reqs = []
    for i, (prompt, kw) in enumerate(zip(prompts, kws)):
        kw = dict(kw)
        kw.setdefault("ignore_eos", not eos)
        req = Request(f"r{i}", prompt_ids=list(prompt), eos_token_ids=eos,
                      sampling_params=SamplingParams(
                          max_new_tokens=max_new, **kw))
        reqs.append(req)
        eng.submit(req)
    pending = None
    guard = 0
    while (eng.has_work() or pending is not None) and guard < 20000:
        _, pending = drive_step(eng, pending)
        guard += 1
    assert not eng._inflight
    return reqs, eng


def _engaged(eng) -> bool:
    s = eng.spec_summary()
    return bool(s and s["proposals"] > 0)


def _spec_windows(eng) -> int:
    return eng.kernel_dispatch_summary()["dispatch_total"].get(
        "torch/spec", 0)


def _same(base, got, label=""):
    for b, g in zip(base, got):
        assert g.output_ids == b.output_ids, (label, b.output_ids,
                                              g.output_ids)
        assert g.status == b.status, label


# -- proposer and accept rule against the JAX functions -------------------


def test_ngram_proposal_equals_jax():
    from parallax_tpu.runtime.engine import StageEngine as JStageEngine

    cases = [([1, 2, 3, 9, 9, 1, 2, 3], 3, 4), ([1, 2, 3, 4], 3, 4),
             ([5, 5], 3, 4), ([9, 1, 2, 1, 2, 1, 2], 2, 6), ([4] * 6, 3, 5),
             ([1, 2, 3, 7, 8, 1, 2, 3], 3, 8),
             ([1, 2, 3, 7, 8, 4, 4, 1, 2, 3], 3, 3),
             ([7, 7, 7, 9] + [1, 2] * (StageEngine._SPEC_LOOKBACK // 2 + 8)
              + [7, 7, 7], 3, 4)]
    rng = np.random.default_rng(7)
    for _ in range(80):
        cases.append((
            [int(x) for x in rng.integers(0, 6, size=rng.integers(0, 900))],
            int(rng.integers(1, 5)), int(rng.integers(0, 12))))
    assert StageEngine._SPEC_LOOKBACK == JStageEngine._SPEC_LOOKBACK
    for toks, n, k in cases:
        got = StageEngine._ngram_proposal(toks, n, k)
        assert got == JStageEngine._ngram_proposal(toks, n, k), (toks, n, k)
        assert len(got) <= max(0, k)
    assert StageEngine._ngram_proposal([9, 1, 2, 1, 2, 1, 2], 2, 6) == [
        1, 2, 1, 2, 1, 2]


@pytest.mark.parametrize("seed", range(4))
def test_speculative_accept_equals_jax(seed):
    import jax.numpy as jnp

    from parallax_tpu.ops.sampling import speculative_accept as j_accept

    rng = np.random.default_rng(seed)
    s, p, j = 16, int(rng.integers(1, 7)), 4
    targets = rng.integers(0, 6, size=(s, p + 1)).astype(np.int32)
    # Proposals agree with the targets for a random prefix, then not.
    props = targets[:, :p].copy()
    cut = rng.integers(0, p + 1, size=s)
    for i in range(s):
        props[i, cut[i]:] = rng.integers(-1, 6, size=p - cut[i])
    stop = np.full((s, j), -1, np.int32)
    stop[:, 0] = rng.integers(0, 6, size=s)
    produced = rng.integers(0, 5, size=s).astype(np.int32)
    min_req = rng.integers(0, 6, size=s).astype(np.int32)
    limit = rng.integers(1, 9, size=s).astype(np.int32)
    stopped = rng.random(s) < 0.2
    args = (targets, props, produced, stop, min_req, limit, stopped)
    c, froze = ops.speculative_accept(*map(torch.from_numpy, args))
    jc, jfroze = j_accept(*map(jnp.asarray, args))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(froze.numpy(), np.asarray(jfroze))
    assert c.dtype == torch.int32


def test_token_in_mask_equals_jax():
    import jax.numpy as jnp

    from parallax_tpu.ops.sampling import token_in_mask as j_in_mask

    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2 ** 32, size=(9, 4), dtype=np.uint64).astype(
        np.uint32)
    toks = rng.integers(-2, 140, size=9).astype(np.int32)
    got = ops.token_in_mask(torch.from_numpy(bits.view(np.int32)),
                            torch.from_numpy(toks))
    want = j_in_mask(jnp.asarray(bits), jnp.asarray(toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the speculative window -------------------------------------------------


def test_window_speculation_matches_plain_greedy():
    prompts = [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9],
               [3, 14, 15, 3, 14, 15, 3, 14]]
    base, _ = _run(0, prompts, max_new=24, lookahead=1)
    spec, eng = _run(6, prompts, max_new=24, lookahead=8,
                     adversarial=[1, 2, 3])
    assert _spec_windows(eng) > 0 and _engaged(eng)
    _same(base, spec)
    for s in spec:
        assert s.num_computed_tokens == s.total_len - 1


@pytest.mark.parametrize("kind", ["greedy", "seeded"])
def test_window_bit_identity_matrix(kind):
    """Greedy and seeded x sync / overlap x K = 1 / K = 8: every
    speculative stream is the spec-off stream, with speculation engaged
    (overlapped K = 1 rows are device-fed: the host cannot propose for
    them, by design)."""
    prompts = [[5, 6, 5, 6, 5, 6], [7, 8, 9, 10, 7, 8, 9, 10, 7, 8]]
    kws = {"greedy": [dict(temperature=0.0)] * 2,
           "seeded": [dict(temperature=0.7, seed=123),
                      dict(temperature=0.4, seed=7)]}[kind]
    base, _ = _run(0, prompts, max_new=20, lookahead=1, sp_kw=kws)
    for overlap in (False, True):
        for k in (1, 8):
            spec, eng = _run(4, prompts, max_new=20, lookahead=k,
                             sp_kw=kws, overlap=overlap,
                             adversarial=[1, 2, 3])
            label = (kind, overlap, k)
            if not (overlap and k == 1):
                assert _engaged(eng), label
            if k > 1:
                assert _spec_windows(eng) > 0, label
            _same(base, spec, label)


def test_window_mid_stream_stop_token_rolls_back_exactly():
    """A stop token landing mid-window freezes the row on the device: the
    frozen tail and every rejected proposal roll back before commit, so
    nothing phantom reaches the stream, the computed count or the radix
    tree's digests (prefix donation)."""
    prompt = [5, 6, 7, 8, 9, 10, 11, 12]
    (probe,), _ = _run(0, [prompt], max_new=9, lookahead=1)
    stop_idx = next(i for i in range(2, 7)
                    if probe.output_ids[i] not in probe.output_ids[:i])
    stop = (probe.output_ids[stop_idx],)

    def run(spec, lookahead):
        eng = _engine(spec, lookahead=lookahead, cache_digests=True)
        if spec:
            _adversarialize(eng, [1, 2, 3])
        req = Request("s", prompt_ids=list(prompt),
                      sampling_params=SamplingParams(
                          temperature=0.0, max_new_tokens=9,
                          stop_token_ids=stop))
        eng.submit(req)
        InProcessPipeline([eng]).run_until_complete()
        return req, eng

    base, beng = run(0, 1)
    multi, meng = run(4, 8)
    assert multi.output_ids == base.output_ids
    assert multi.status.value == "finished_stop"
    assert len(multi.output_ids) == stop_idx + 1
    assert multi.num_computed_tokens == multi.total_len - 1
    bp = beng.cache_digest_payload(full=True)
    mp = meng.cache_digest_payload(full=True)
    assert bp is not None and sorted(bp["full"]) == sorted(mp["full"])


def test_window_respects_max_tokens_and_min_new():
    prompts = [[9] * 8]
    base, _ = _run(0, prompts, max_new=5, lookahead=1)
    spec, _ = _run(8, prompts, max_new=5, lookahead=8, adversarial=[9, 9, 9])
    _same(base, spec)
    assert len(spec[0].output_ids) == 5
    assert spec[0].num_computed_tokens == spec[0].total_len - 1
    eos = (base[0].output_ids[1],)
    kw = [dict(temperature=0.0, min_new_tokens=6)]
    b, _ = _run(0, prompts, max_new=12, lookahead=1, sp_kw=kw, eos=eos)
    s, _ = _run(4, prompts, max_new=12, lookahead=8, sp_kw=kw, eos=eos,
                adversarial=[1, 2, 3])
    _same(b, s)


def test_window_page_budget_downshifts_gracefully():
    """A speculative window the planner cannot page retries plain, then
    K = 1: never an abort, streams unchanged."""
    prompts = [[3, 14, 15, 92, 65], [7, 21, 108]]
    base, _ = _run(0, prompts, max_new=12, lookahead=1)
    spec, _ = _run(4, prompts, max_new=12, lookahead=8, num_pages=14,
                   adversarial=[1, 2, 3])
    _same(base, spec)


def test_spec_rows_ride_adaptive_windows():
    prompts = [[5, 6, 5, 6, 5, 6]]
    base, _ = _run(0, prompts, max_new=20, lookahead=1)
    spec, eng = _run(4, prompts, max_new=20, adversarial=[1, 2, 3])
    assert _spec_windows(eng) > 0
    _same(base, spec)


def test_speculative_windows_compress_host_rounds():
    eng = _engine(6)
    _adversarialize(eng, [1, 2, 3])
    pipe = InProcessPipeline([eng])
    req = Request("r", prompt_ids=[5, 6, 5, 6, 5, 6],
                  sampling_params=SamplingParams(temperature=0.0,
                                                 max_new_tokens=24))
    pipe.submit(req)
    steps = 0
    while pipe.has_work() and steps < 200:
        pipe.step_round()
        steps += 1
    base, _ = _run(0, [[5, 6, 5, 6, 5, 6]], max_new=24, lookahead=1)
    assert base[0].output_ids == req.output_ids
    assert _engaged(eng) and steps < 12, steps


# -- the host-synchronous fallback (K = 1) ----------------------------------


def test_sync_fallback_matches_plain_greedy():
    prompts = [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9],
               [3, 14, 15, 3, 14, 15, 3, 14]]
    base, _ = _run(0, prompts, lookahead=1)
    spec, eng = _run(6, prompts, lookahead=1)
    assert _engaged(eng) and _spec_windows(eng) == 0
    assert eng.kernel_dispatch_summary()["dispatch_total"][
        "torch/spec_verify"] > 0
    _same(base, spec)


def test_sync_fallback_random_prompts_exact():
    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(1, 198, size=18)]
               for _ in range(3)]
    base, _ = _run(0, prompts, lookahead=1)
    spec, _ = _run(6, prompts, lookahead=1, adversarial=[4, 4, 4])
    _same(base, spec)


@pytest.mark.parametrize("k", [1, 8])
def test_sampled_seeded_speculation_is_exact(k):
    prompts = [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9],
               [3, 14, 15, 3, 14, 15, 3, 14]]
    kws = [dict(temperature=0.7, seed=123), dict(temperature=0.4, seed=7)]
    base, _ = _run(0, prompts, max_new=14, lookahead=1, sp_kw=kws)
    spec, eng = _run(6, prompts, max_new=14, lookahead=k, sp_kw=kws,
                     adversarial=[1, 2, 3])
    assert _engaged(eng)
    _same(base, spec)


@pytest.mark.parametrize("k", [1, 8])
def test_mixed_greedy_and_seeded_batch_speculates_exactly(k):
    prompts = [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8], [5, 6, 5, 6, 5, 6, 5]]
    kws = [dict(temperature=0.0), dict(temperature=0.6, seed=5,
                                       top_k=20, top_p=0.9)]
    base, _ = _run(0, prompts, max_new=14, lookahead=1, sp_kw=kws)
    spec, eng = _run(6, prompts, max_new=14, lookahead=k,
                     adversarial=[4, 4, 4], sp_kw=kws)
    assert _engaged(eng)
    _same(base, spec)


def test_unseeded_sampled_speculation_smoke():
    for k in (1, 8):
        got, eng = _run(6, [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8]], max_new=14,
                        lookahead=k, sp_kw=[dict(temperature=0.8)],
                        adversarial=[9, 10, 7])
        assert _engaged(eng), k
        assert len(got[0].output_ids) == 14


# -- sampling features inside the speculative window -----------------------


def test_host_state_rows_ride_the_spec_window():
    """A penalised seeded row speculates inside the window (the "pen"
    variant) with its stream unchanged; the K = 1 fallback has no feature
    state, so there it decodes one token a step."""
    prompts = [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8, 9]]
    kws = [dict(temperature=1.0, seed=3, repetition_penalty=1.3)]
    base, _ = _run(0, prompts, max_new=12, lookahead=1, sp_kw=kws)
    spec, eng = _run(4, prompts, max_new=12, lookahead=8, sp_kw=kws,
                     adversarial=[1, 2, 3])
    assert eng.window_feature_counts.get(("pen",), 0) > 0
    assert _spec_windows(eng) > 0
    _same(base, spec)
    sync, seng = _run(4, prompts, max_new=12, lookahead=1, sp_kw=kws)
    assert not _engaged(seng)
    _same(base, sync)


def test_feature_rows_ride_the_spec_window_with_logprob_bits():
    """Penalties, logit_bias, logprobs and a JSON-schema grammar in one
    speculative window: tokens and logprob bits equal the K = 1 engine's,
    and the grammar-mask rejections are counted."""
    vocab = [bytes([i]) for i in range(256)] + [b"", b""]
    schema = {"type": "object", "properties": {"a": {"type": "integer"}},
              "required": ["a"]}
    prompts = [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8], [5, 6, 5, 6, 5, 6],
               [40, 41, 42, 40, 41, 42], [3, 4, 5]]
    kws = [dict(temperature=0.0, presence_penalty=0.5, logprobs=True),
           dict(temperature=0.8, seed=4, logit_bias={"5": 3.0, "9": -2.0}),
           dict(temperature=0.0, logprobs=True),
           dict(temperature=0.0, json_schema=json.dumps(schema))]
    cfg = normalize_config(dict(RAW, vocab_size=258))
    model = create_stage_model(cfg, 0, 2)
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.float32, "cpu")

    def run(spec, k):
        eng = StageEngine(model, params, EngineConfig(
            page_size=8, num_pages=256, max_model_len=256,
            kv_dtype="float32", speculative_tokens=spec,
            decode_lookahead=k, overlap_steps=False), device="cpu")
        eng.set_grammar_vocab(vocab, 257)
        if spec:
            _adversarialize(eng, [123, 34, 97])
        reqs = []
        for i, (p, kw) in enumerate(zip(prompts, kws)):
            r = Request(f"f{i}", prompt_ids=p, eos_token_ids=(257,),
                        sampling_params=SamplingParams(max_new_tokens=12,
                                                       **kw))
            eng.submit(r)
            reqs.append(r)
        pending = None
        while eng.has_work() or pending is not None:
            _, pending = drive_step(eng, pending)
        return reqs, eng

    base, _ = run(0, 1)
    spec, eng = run(4, 8)
    assert _spec_windows(eng) > 0
    assert any(len(f) >= 3 for f in eng.window_feature_counts)
    for b, s in zip(base, spec):
        assert s.output_ids == b.output_ids, (b.request_id, b.output_ids,
                                              s.output_ids)
        assert s.status == b.status
        if b.sampling_params.logprobs:
            assert np.array_equal(
                np.asarray(s.output_logprobs, np.float32),
                np.asarray(b.output_logprobs, np.float32))
    summary = eng.constrained_summary()
    assert summary["spec_mask_rejections"] > 0


# -- the draft proposer -----------------------------------------------------


def _draft(params=None, seed=0):
    p = params if params is not None else _MODEL.init_params(
        torch.Generator().manual_seed(seed), torch.float32, "cpu")
    return DraftProposer(StageEngine(_MODEL, p, EngineConfig(
        page_size=8, num_pages=256, max_model_len=256, kv_dtype="float32",
        decode_lookahead=4), device="cpu"))


@pytest.mark.parametrize("k", [1, 8])
def test_draft_model_same_weights_accepts_everything(k):
    prompts = [[3, 14, 15, 92, 65], [7, 21, 108]]
    base, _ = _run(0, prompts, max_new=12, lookahead=1)
    got, eng = _run(4, prompts, max_new=12, lookahead=k, draft=_draft(
        _PARAMS))
    s = eng.spec_summary()
    assert s["by_source"].keys() == {"draft"}
    # The draft decodes on the one-token path and the target verifies on
    # the multi-token one: a near-tie of this random model may part them.
    assert s["acceptance_rate"] >= 0.7, s
    _same(base, got, k)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_draft_shares_the_targets_tensors():
    """A same-weights draft costs no second copy of the weights."""
    draft = _draft(_PARAMS)
    eng = _engine(4, draft=draft)
    assert [t.data_ptr() for t in _leaves(eng.params)] == [
        t.data_ptr() for t in _leaves(draft.engine.params)]


@pytest.mark.parametrize("k", [1, 8])
def test_draft_model_different_weights_is_still_exact(k):
    prompts = [[5, 6, 7, 8], [42] * 6]
    base, _ = _run(0, prompts, max_new=10, lookahead=1)
    got, _ = _run(4, prompts, max_new=10, lookahead=k, draft=_draft(seed=99))
    _same(base, got, k)


def test_sampled_seeded_speculation_is_exact_draft_model():
    prompts = [[7, 8, 9, 10, 7, 8], [42] * 6]
    kws = [dict(temperature=0.5, seed=11), dict(temperature=0.9, seed=99)]
    base, _ = _run(0, prompts, max_new=14, lookahead=1, sp_kw=kws)
    spec, eng = _run(4, prompts, max_new=14, lookahead=1, sp_kw=kws,
                     draft=_draft(_PARAMS))
    assert _engaged(eng)
    _same(base, spec)


def test_draft_proposer_budget_properties():
    draft = _draft()
    rng = np.random.default_rng(13)
    for _ in range(6):
        n_rows = int(rng.integers(1, 5))
        contexts = [[int(x) for x in rng.integers(1, 198, size=rng.integers(
            2, 40))] for _ in range(n_rows)]
        budgets = [int(b) for b in rng.integers(0, 9, size=n_rows)]
        props = draft.propose_batch(contexts, budgets)
        assert len(props) == n_rows
        for prop, budget, ctx in zip(props, budgets, contexts):
            assert len(prop) <= max(0, budget)
            assert len(ctx) + len(prop) < 256
        assert draft.engine.scheduler.num_requests() == 0
    props = draft.propose_batch([[1] * 300, [1, 2, 3]], [4, 4])
    assert props[0] == [] and len(props[1]) <= 4
    assert draft.engine.scheduler.num_requests() == 0
    assert draft.rounds == 7 and draft.propose_s > 0


def test_slow_draft_cannot_stall_the_batch():
    draft = _draft()
    draft.propose_batch([[1, 2, 3, 4, 5]] * 4, [6] * 4)
    draft.max_propose_ms = 1.0
    real_step = draft.engine.step

    def slow_step():
        time.sleep(0.05)
        return real_step()

    draft.engine.step = slow_step
    t0 = time.perf_counter()
    props = draft.propose_batch([[1, 2, 3, 4, 5]] * 4, [6] * 4)
    assert (time.perf_counter() - t0) * 1000.0 < 1000.0
    assert len(props) == 4
    assert draft.engine.scheduler.num_requests() == 0
    draft.engine.step = real_step
    base, _ = _run(0, [[5, 6, 7, 8]], max_new=8, lookahead=1)
    got, _ = _run(4, [[5, 6, 7, 8]], max_new=8, lookahead=1, draft=draft)
    _same(base, got)


def test_spec_summary_has_the_jax_payload():
    from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig

    assert JEngineConfig().speculative_ngram == EngineConfig(
        ).speculative_ngram
    _, eng = _run(4, [[5, 6, 5, 6, 5, 6]], max_new=8, lookahead=1,
                  adversarial=[1, 2, 3])
    s = eng.spec_summary()
    assert set(s) == {"enabled", "width", "proposals", "accepted",
                      "rejected", "acceptance_rate",
                      "accepted_tokens_per_chip_second", "by_source"}
    assert s["width"] == 4 and s["proposals"] > 0
    assert _engine(0).spec_summary() is None
    with pytest.raises(ValueError):
        _engine(-1)


# -- against the JAX engine -------------------------------------------------


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**{
        k: v for k, v in dict(RAW, num_hidden_layers=4,
                              rms_norm_eps=1e-6).items()
        if k != "architectures"}))
    model.eval()
    return model


@pytest.mark.parametrize("k", [1, 8])
def test_spec_streams_match_jax_spec_streams(hf_model, k):
    """The port and the JAX engine, both speculating (n-gram, width 4) on
    the same HF weights: both greedy streams pass ``assert_greedy_matches``
    against HF, and where they part they part at a near-tie."""
    import jax
    import jax.numpy as jnp

    from parallax_tpu.config import normalize_config as j_normalize
    from parallax_tpu.models.base import StageModel as JStageModel
    from parallax_tpu.models.loader import params_from_torch_state_dict
    from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
    from parallax_tpu.runtime.engine import StageEngine as JStageEngine
    from parallax_tpu.runtime.engine import drive_step as j_drive_step
    from parallax_tpu.runtime.request import Request as JRequest
    from parallax_tpu.runtime.request import SamplingParams as JSampling
    from parallax_tpu_torch.models.registry import params_from_numpy
    from tests.test_engine_e2e import assert_greedy_matches

    raw = dict(RAW, num_hidden_layers=4, rms_norm_eps=1e-6)
    jmodel = JStageModel(j_normalize(raw), 0, 4, use_pallas=False)
    jparams = params_from_torch_state_dict(jmodel, hf_model.state_dict(),
                                           dtype=jnp.float32)
    ecfg = dict(page_size=8, num_pages=128, max_model_len=256,
                kv_dtype="float32", decode_lookahead=k,
                speculative_tokens=4, overlap_steps=False)
    prompts = [[7, 8, 9, 10, 7, 8, 9, 10, 7, 8], [5, 6, 5, 6, 5, 6],
               [3, 14, 15, 92, 65]]
    n_new = 12

    def drive(eng, req_cls, sp_cls, step_fn):
        reqs = [req_cls(f"r{i}", prompt_ids=list(p),
                        sampling_params=sp_cls(temperature=0.0,
                                               max_new_tokens=n_new,
                                               ignore_eos=True))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        pending = None
        while eng.has_work() or pending is not None:
            _, pending = step_fn(eng, pending)
        return reqs

    jeng = JStageEngine(jmodel, jparams, JEngineConfig(**ecfg))
    j_reqs = drive(jeng, JRequest, JSampling, j_drive_step)
    port = StageEngine(create_stage_model(normalize_config(raw), 0, 4),
                       params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"),
                       EngineConfig(**ecfg), device="cpu")
    p_reqs = drive(port, Request, SamplingParams, drive_step)
    assert _engaged(port) and jeng.spec_summary()["proposals"] > 0
    for pr, jr in zip(p_reqs, j_reqs):
        assert len(pr.output_ids) == len(jr.output_ids) == n_new
        assert_greedy_matches(hf_model, pr.prompt_ids, pr.output_ids, n_new)
        assert_greedy_matches(hf_model, jr.prompt_ids, jr.output_ids, n_new)
        same = 0
        while same < n_new and pr.output_ids[same] == jr.output_ids[same]:
            same += 1
        if same < n_new:
            with torch.no_grad():
                logits = hf_model(torch.tensor(
                    [pr.prompt_ids + pr.output_ids[:same]])).logits[0, -1]
            gap = abs(float(logits[pr.output_ids[same]]
                            - logits[jr.output_ids[same]]))
            assert gap < 5e-3, (pr.request_id, same, gap)


# -- the front door ----------------------------------------------------------


def test_serve_with_a_draft_model_path(checkpoint):
    """``serve --draft-model-path`` on a checkpoint the test writes (the
    draft is the served checkpoint itself): the server answers, the
    engine speculates from the draft, and the CLI no longer refuses the
    flags."""
    from parallax_tpu_torch import cli
    from parallax_tpu_torch.backend import serve as serve_mod
    ckpt = checkpoint
    args = cli.build_parser().parse_args([
        "serve", "--model-path", ckpt, "--device", "cpu",
        "--host", "127.0.0.1", "--port", "0", "--page-size", "8",
        "--max-batch-size", "4", "--max-model-len", "256",
        "--kv-dtype", "float32", "--draft-model-path", ckpt,
        "--decode-lookahead", "1",
    ])
    assert cli.unported_flags(args) == []
    started = threading.Event()
    box = {}

    def on_start(fe, runner):
        box["fe"], box["runner"] = fe, runner
        started.set()

    t = threading.Thread(target=serve_mod.serve_main, args=(args, on_start),
                         daemon=True)
    t.start()
    assert started.wait(120)
    fe, runner = box["fe"], box["runner"]
    try:
        body = json.dumps({"prompt": "ab ab ab ab ab", "max_tokens": 8,
                           "temperature": 0.0}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["choices"][0]["text"] is not None
        eng = runner.pipeline.head
        assert eng.draft is not None and eng.cfg.speculative_tokens == 4
        s = eng.spec_summary()
        assert s["by_source"].keys() == {"draft"} and s["accepted"] > 0
    finally:
        fe.shutdown()
        t.join(30)
