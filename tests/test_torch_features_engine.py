"""Grammar-constrained and featured requests at the engine level
(tests/_torch_features.py has the suite's model and helpers): the cases of
tests/test_constrained.py (valid JSON greedy and seeded, constrained and
free rows together, no vocabulary aborts, state cleared on release) and a
2-stage pipeline whose tail samples with penalties and logprobs."""

import pytest

from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests._torch_features import (
    SCHEMA,
    _drive,
    _engine,
    _feature_requests,
    _gram_req,
    _json_of,
)


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
