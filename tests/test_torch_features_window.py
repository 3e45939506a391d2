"""Sampling features inside the port's K-step decode window
(tests/_torch_features.py has the suite's model and helpers): the
overlapped half of the K = 8 feature windows' bit identity with K = 1,
the windows actually fused, and a grammar mask that overrides the
argmax."""

import numpy as np
import pytest

from parallax_tpu_torch.constrained import GrammarCompiler
from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests._torch_features import (
    BYTE_VOCAB,
    EOS,
    SCHEMA,
    _drive,
    _engine,
    _feature_requests,
    _gram_req,
    _json_of,
)


@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "seeded"])
@pytest.mark.parametrize("overlap", [True], ids=["overlap"])
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
