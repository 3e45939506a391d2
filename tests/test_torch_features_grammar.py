"""Grammar masks inside the port's K-step decode window
(tests/_torch_features.py has the suite's model and helpers): the ports
of the JAX package's adversarial window cases — a terminal state that
stops, bias, penalties and grammar stacked, the window off falling back,
the device table cache reused."""

from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests._torch_features import (
    EOS,
    SCHEMA,
    _drive,
    _engine,
    _gram_req,
    _json_of,
)


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
