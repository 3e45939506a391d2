"""Sampling features in the port's engine (tests/_torch_features.py has the
suite's model and helpers): greedy feature streams against the JAX engine
on the same weights, with the window and at K = 1, and the synchronous
half of the K = 8 feature windows' bit identity with K = 1."""

import numpy as np
import pytest

from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from tests._torch_features import (
    BYTE_VOCAB,
    EOS,
    _ENGINE,
    _J_MODEL,
    _J_PARAMS,
    _assert_feature_greedy,
    _drive,
    _engine,
    _feature_requests,
    _json_of,
)


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


@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "seeded"])
@pytest.mark.parametrize("overlap", [False], ids=["sync"])
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
