"""Pipeline speculation in the port, on the CPU: the cases of
``tests/test_pp_speculative.py`` on 2- and 3-stage in-process pipelines
(the head extends eligible decode rows with proposals, every stage
forwards the whole 1 + k run in one dispatch, the last stage verifies every
fed position and rings the accepted run back in one packet, mirrors drop
rejected tokens at the next packet), the ``spec_len`` / ``spec_accepted``
frames across ``parallax_tpu.p2p.proto`` both ways, and two workers over
TCP speculating across the hop. Committed streams equal the spec-off
pipeline's, token for token."""

import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import (
    IntermediateRequest,
    Request,
    SamplingParams,
)

RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=128, vocab_size=199, max_position_embeddings=512,
    tie_word_embeddings=False,
)
CFG = normalize_config(RAW)
_FULL = create_stage_model(CFG, 0, 4).init_params(
    torch.Generator().manual_seed(0), torch.float32, "cpu")
REP = [7, 8, 9, 10] * 6   # repetitive: n-gram proposals fire


def _stage_params(s, e):
    p = {"layers": _FULL["layers"][s:e]}
    if s == 0:
        p["embed_tokens"] = _FULL["embed_tokens"]
    if e == 4:
        p["norm"], p["lm_head"] = _FULL["norm"], _FULL["lm_head"]
    return p


def _build(stages, spec_tokens, fallback=None):
    bounds = {2: [(0, 2), (2, 4)], 3: [(0, 2), (2, 3), (3, 4)]}[stages]
    engines = [StageEngine(create_stage_model(CFG, s, e), _stage_params(s, e),
                           EngineConfig(page_size=8, num_pages=128,
                                        max_model_len=256, kv_dtype="float32",
                                        speculative_tokens=spec_tokens),
                           device="cpu")
               for s, e in bounds]
    if fallback is not None:
        # Adversarial proposals where n-gram lookup finds nothing: they
        # cost acceptance, never tokens.
        head = engines[0]
        orig = head._ngram_proposal
        head._ngram_proposal = lambda toks, n, k: (
            orig(toks, n, k) or list(fallback)[:k])
    return InProcessPipeline(engines)


def _serve(pipe, specs, max_new=14, ignore_eos=True, eos=()):
    reqs = []
    for i, (prompt, temp, seed, extra) in enumerate(specs):
        req = Request(f"r{i}", prompt_ids=list(prompt), eos_token_ids=eos,
                      sampling_params=SamplingParams(
                          temperature=temp, seed=seed, max_new_tokens=max_new,
                          ignore_eos=ignore_eos, **extra))
        reqs.append(req)
        pipe.submit(req)
    pipe.run_until_complete()
    return reqs


def _same(base, got):
    for b, g in zip(base, got):
        assert g.output_ids == b.output_ids, (b.request_id, b.output_ids,
                                              g.output_ids)
        assert g.status == b.status


@pytest.mark.parametrize("stages", [2, 3])
def test_pp_spec_exact_and_multitoken(stages):
    specs = [(REP, 0.0, None, {}), ([3, 1, 4, 1, 5, 9, 2, 6], 0.0, None, {})]
    base = _serve(_build(stages, 0), specs)
    pipe = _build(stages, 3, fallback=[1, 2, 3])
    got = _serve(pipe, specs)
    _same(base, got)
    last = pipe.engines[-1]
    assert last.pp_spec_rounds > 0
    # More than one token a verify round on average: the ring moved
    # multi-token runs.
    assert last.pp_spec_tokens > last.pp_spec_rounds
    totals = last.kernel_dispatch_summary()["dispatch_total"]
    assert totals["torch/prefill"] > 0
    for eng in pipe.engines:
        assert eng.scheduler.num_requests() == 0


def test_pp_spec_eos_and_max_tokens():
    probe = _serve(_build(2, 0), [(REP, 0.0, None, {})], max_new=10)
    eos = (probe[0].output_ids[4],)
    base = _serve(_build(2, 0), [(REP, 0.0, None, {})], max_new=10,
                  ignore_eos=False, eos=eos)
    got = _serve(_build(2, 4, fallback=[1, 2]), [(REP, 0.0, None, {})],
                 max_new=10, ignore_eos=False, eos=eos)
    _same(base, got)
    base7 = _serve(_build(2, 0), [(REP, 0.0, None, {})], max_new=7)
    got7 = _serve(_build(2, 3, fallback=[1, 2]), [(REP, 0.0, None, {})],
                  max_new=7)
    _same(base7, got7)
    assert len(got7[0].output_ids) == 7


def test_pp_spec_mixed_batch_ineligible_rows_untouched():
    """A penalised row keeps the per-token path while greedy and seeded
    rows speculate in the same batch."""
    specs = [(REP, 0.0, None, {}), ([11, 12, 13], 0.7, 21, {}),
             ([14, 15, 16, 17], 0.0, None, {"repetition_penalty": 1.25})]
    base = _serve(_build(2, 0), specs)
    pipe = _build(2, 4, fallback=[4, 4])
    got = _serve(pipe, specs)
    _same(base, got)
    assert pipe.engines[-1].pp_spec_rounds > 0


def test_pp_spec_prefix_donation_consistent():
    """After rejected runs the computed-token accounting still lets prefix
    donation serve a follow-up correctly."""
    pipe = _build(2, 4, fallback=[1, 2, 3])
    first = _serve(pipe, [(REP, 0.0, None, {})], max_new=9)
    assert first[0].num_computed_tokens == first[0].total_len - 1
    follow = Request("follow",
                     prompt_ids=list(REP) + first[0].output_ids[:2] + [100],
                     sampling_params=SamplingParams(
                         temperature=0.0, max_new_tokens=4, ignore_eos=True))
    pipe.submit(follow)
    pipe.run_until_complete()
    assert follow.num_cached_tokens > 0
    fresh = _serve(_build(2, 0), [(follow.prompt_ids, 0.0, None, {})],
                   max_new=4)
    assert follow.output_ids == fresh[0].output_ids


@pytest.mark.parametrize("mixed", [False, True], ids=["seeded", "mixed"])
def test_pp_spec_sampled_seeded_exact(mixed):
    """Seeded rows speculate across stages: the last stage verifies in
    lockstep, so the stream is the one without pipeline speculation."""
    specs = ([([7, 8, 9, 10, 7, 8, 9, 10, 7, 8], 0.0, None, {}),
              ([3, 14, 15, 3, 14, 15, 3, 14], 0.6, 42, {})] if mixed else
             [([7, 8, 9, 10, 7, 8, 9, 10, 7, 8], 0.7, 123, {}),
              ([5, 6, 5, 6, 5, 6, 5], 0.4, 9, {"top_k": 20})])
    base = _serve(_build(2, 0), specs)
    pipe = _build(2, 4, fallback=[1, 2, 3])
    got = _serve(pipe, specs)
    assert pipe.engines[-1].pp_spec_rounds > 0
    _same(base, got)


def test_spec_wire_fields_cross_the_packages_both_ways():
    from parallax_tpu.p2p import proto as jproto
    from parallax_tpu.runtime.request import (
        IntermediateRequest as JIntermediateRequest,
    )

    down = IntermediateRequest(
        request_id="x", routing_table=["a", "b"], context_len=30,
        num_new_tokens=5, token_ids=[1, 2, 3, 4, 5], spec_len=4)
    ring = IntermediateRequest(
        request_id="x", routing_table=["a", "b"], context_len=28,
        num_new_tokens=3, spec_accepted=[9, 8, 7])
    for ireq in (down, ring):
        frame = proto.encode_frame(proto.FORWARD, {"reqs": [
            proto.ireq_to_wire(ireq)]})
        back = jproto.ireq_from_wire(jproto.decode_frame(frame)["p"]
                                     ["reqs"][0])
        assert (back.spec_len, back.spec_accepted) == (
            ireq.spec_len, ireq.spec_accepted)
        jframe = jproto.encode_frame(jproto.FORWARD, {"reqs": [
            jproto.ireq_to_wire(JIntermediateRequest(
                request_id="x", routing_table=["a", "b"],
                context_len=ireq.context_len,
                num_new_tokens=ireq.num_new_tokens,
                token_ids=ireq.token_ids, spec_len=ireq.spec_len,
                spec_accepted=ireq.spec_accepted))]})
        port = proto.ireq_from_wire(proto.decode_frame(jframe)["p"]
                                    ["reqs"][0])
        assert (port.spec_len, port.spec_accepted) == (
            ireq.spec_len, ireq.spec_accepted)


def test_worker_swarm_speculates_across_the_hop(monkeypatch):
    """Two port workers over TCP with ``speculative_tokens``: the head's
    FORWARDs carry ``spec_len``, the tail's verified runs come back as
    ``spec_accepted``, and the streams equal the spec-off in-process
    pipeline's."""
    from tests import test_torch_swarm as sw

    orig = StageEngine._ngram_proposal.__func__
    monkeypatch.setattr(StageEngine, "_ngram_proposal", classmethod(
        lambda cls, toks, n, k: orig(cls, toks, n, k) or [1, 2, 3][:k]))
    engine = dict(sw.ENGINE, speculative_tokens=3)
    with sw.swarm(engine=engine) as (head, tail):
        got = sw._serve(head, sw._requests(Request, SamplingParams))
        assert sw._wait(lambda: tail.engine.scheduler.num_requests() == 0)
        rounds = tail.engine.pp_spec_rounds
        tokens = tail.engine.pp_spec_tokens
    monkeypatch.undo()
    ref = sw._in_process()
    assert [r.output_ids for r in got] == [r.output_ids for r in ref]
    assert rounds > 0 and tokens >= rounds
    assert np.all([len(r.output_ids) == sw.N_NEW for r in got])
