"""The port's overlapped two-phase step (dispatch / resolve, one step in
flight) on the CPU: bit-exact parity with the synchronous engine, greedy and
seeded, at K = 1 and in the adaptive K-step window, plus the invariants the
overlap loop relies on (one-in-flight enforcement, mid-stream abort,
dispatch- and resolve-failure consistency, timing fields). The matrix of
``tests/test_overlap_decode.py`` without the sampling features the port does
not run yet (penalties, logit_bias, grammar)."""

import pytest
import torch

from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.request import Request, SamplingParams

CFG = normalize_config(dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=128, vocab_size=258, max_position_embeddings=512,
    tie_word_embeddings=False,
))
PROMPTS = [[3, 14, 15, 92, 65], [7, 21, 108], [42] * 9]
# K = 1 runs the overlap loop's device feed step by step; None the adaptive
# window (K = 8) on the same loop.
LOOKAHEADS = pytest.mark.parametrize("lookahead", [1, None],
                                     ids=["k1", "adaptive"])


@pytest.fixture(scope="module")
def model_and_params():
    model = create_stage_model(CFG, 0, 2)
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
    return model, params


def _engine(model_and_params, overlap, lookahead=None):
    model, params = model_and_params
    return StageEngine(model, params, EngineConfig(
        page_size=8, num_pages=128, max_model_len=256, kv_dtype="float32",
        overlap_steps=overlap, decode_lookahead=lookahead,
    ), device="cpu")


def _drive(eng, max_iters=500):
    """The one-in-flight loop every serving loop runs; returns the outputs."""
    outs_all = []
    pending = None
    iters = 0
    while (eng.has_work() or pending is not None) and iters < max_iters:
        iters += 1
        outs, pending = drive_step(eng, pending)
        outs_all.extend(outs)
    assert pending is None and not eng._inflight
    return outs_all


def _run(model_and_params, overlap, make_params, lookahead=None,
         prompts=PROMPTS, eos=()):
    eng = _engine(model_and_params, overlap, lookahead)
    reqs = []
    for i, prompt in enumerate(prompts):
        req = Request(f"r{i}", prompt_ids=list(prompt),
                      sampling_params=make_params(i), eos_token_ids=eos)
        reqs.append(req)
        eng.submit(req)
    outs = _drive(eng)
    return reqs, eng, outs


def _assert_equal_streams(base, over):
    for b, m in zip(base, over):
        assert m.output_ids == b.output_ids, (b.output_ids, m.output_ids)
        assert m.status == b.status, (b.status, m.status)


# -- sync-vs-overlap bit-exactness -------------------------------------------


@LOOKAHEADS
def test_overlap_matches_sync_greedy(model_and_params, lookahead):
    def mk(i):
        return SamplingParams(temperature=0.0, max_new_tokens=11,
                              ignore_eos=True)
    base, _, _ = _run(model_and_params, False, mk, lookahead)
    over, eng, outs = _run(model_and_params, True, mk, lookahead)
    _assert_equal_streams(base, over)
    # The overlap engaged (steps resolved after a later dispatch) and
    # cleaned up after itself.
    assert any(o.overlapped for o in outs)
    assert len(eng._free_token_slots) == eng.cfg.max_batch_size
    assert not eng._token_slots


@LOOKAHEADS
def test_overlap_matches_sync_seeded_sampling(model_and_params, lookahead):
    def mk(i):
        return SamplingParams(temperature=0.8, seed=1000 + i,
                              max_new_tokens=9, ignore_eos=True)
    base, _, _ = _run(model_and_params, False, mk, lookahead)
    over, _, outs = _run(model_and_params, True, mk, lookahead)
    _assert_equal_streams(base, over)
    assert any(o.overlapped for o in outs)


@LOOKAHEADS
def test_overlap_matches_sync_eos_mid_stream(model_and_params, lookahead):
    """A row finishing on EOS mid-overlap: the surplus in-flight step's
    token is discarded, never committed."""
    def greedy(i):
        return SamplingParams(temperature=0.0, max_new_tokens=9,
                              ignore_eos=True)
    probe, _, _ = _run(model_and_params, False, greedy, lookahead=1)
    eos = (probe[0].output_ids[3],)

    def mk(i):
        return SamplingParams(temperature=0.0, max_new_tokens=9)
    base, _, _ = _run(model_and_params, False, mk, lookahead, eos=eos)
    over, eng, _ = _run(model_and_params, True, mk, lookahead, eos=eos)
    _assert_equal_streams(base, over)
    assert over[0].status.value == "finished_eos"
    assert len(over[0].output_ids) <= 4
    assert len(eng._free_token_slots) == eng.cfg.max_batch_size


# -- overlap-loop safety invariants ------------------------------------------


@LOOKAHEADS
def test_one_in_flight_enforced(model_and_params, lookahead):
    eng = _engine(model_and_params, True, lookahead)
    req = Request("r", prompt_ids=[5, 6, 7],
                  sampling_params=SamplingParams(
                      temperature=0.0, max_new_tokens=8, ignore_eos=True))
    eng.submit(req)
    t1 = eng.dispatch()          # prefill + sampler enqueued
    t2 = eng.dispatch()          # the device-fed decode: one in flight
    assert t2.plan.seqs[0].device_token
    with pytest.raises(RuntimeError, match="in flight"):
        eng.dispatch()
    assert eng.is_inflight(t1) and eng.is_inflight(t2)
    eng.resolve(t1)
    eng.resolve(t2)
    assert not eng.is_inflight(t2)
    _drive(eng)
    assert req.status.is_finished
    assert len(req.output_ids) == 8
    base, _, _ = _run(model_and_params, False,
                      lambda i: SamplingParams(temperature=0.0,
                                               max_new_tokens=8,
                                               ignore_eos=True),
                      lookahead=1, prompts=[[5, 6, 7]])
    assert req.output_ids == base[0].output_ids


@LOOKAHEADS
def test_overlap_survives_mid_stream_abort(model_and_params, lookahead):
    eng = _engine(model_and_params, True, lookahead)
    reqs = []
    for i, prompt in enumerate(PROMPTS):
        req = Request(f"r{i}", prompt_ids=list(prompt),
                      sampling_params=SamplingParams(
                          temperature=0.0, max_new_tokens=20,
                          ignore_eos=True))
        reqs.append(req)
        eng.submit(req)
    pending = None
    iters = 0
    while (eng.has_work() or pending is not None) and iters < 200:
        iters += 1
        _, pending = drive_step(eng, pending)
        if iters == 4:
            # Abort one request mid-stream (in flight at K = 1).
            eng.release("r1", abort=True)
    assert reqs[1].status.value == "finished_abort"
    for r in (reqs[0], reqs[2]):
        assert len(r.output_ids) == 20
    # Slots and in-flight state fully reclaimed; the engine still serves.
    assert len(eng._free_token_slots) == eng.cfg.max_batch_size
    follow = Request("f", prompt_ids=[9, 8, 7],
                     sampling_params=SamplingParams(
                         temperature=0.0, max_new_tokens=4,
                         ignore_eos=True))
    eng.submit(follow)
    _drive(eng)
    assert len(follow.output_ids) == 4


def test_dispatch_exception_leaves_scheduler_consistent(model_and_params):
    eng = _engine(model_and_params, True)
    req = Request("r", prompt_ids=[5, 6, 7],
                  sampling_params=SamplingParams(
                      temperature=0.0, max_new_tokens=6, ignore_eos=True))
    eng.submit(req)
    real = eng._forward
    calls = {"n": 0}

    def boom(inputs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected dispatch failure")
        return real(inputs)

    eng._forward = boom
    with pytest.raises(RuntimeError, match="injected"):
        eng.dispatch()
    # No bookkeeping advanced, nothing in flight: the same work is
    # re-schedulable and the run completes normally.
    assert not eng._inflight
    assert req.num_computed_tokens == 0
    _drive(eng)
    assert req.status.is_finished
    assert len(req.output_ids) == 6
    base, _, _ = _run(
        model_and_params, False,
        lambda i: SamplingParams(temperature=0.0, max_new_tokens=6,
                                 ignore_eos=True),
        prompts=[[5, 6, 7]],
    )
    assert req.output_ids == base[0].output_ids


@LOOKAHEADS
def test_resolve_failure_does_not_wedge_dispatch(model_and_params,
                                                 lookahead):
    """A resolve() failure mid-loop must not orphan the just-dispatched
    ticket in the in-flight list: that would wedge every later dispatch on
    the one-in-flight invariant."""
    eng = _engine(model_and_params, True, lookahead)
    req = Request("r", prompt_ids=[5, 6, 7],
                  sampling_params=SamplingParams(
                      temperature=0.0, max_new_tokens=12,
                      ignore_eos=True))
    eng.submit(req)
    _, pending = drive_step(eng, None)
    assert pending is not None
    real = eng._emit_tokens

    def boom(*a, **kw):
        eng._emit_tokens = real
        raise RuntimeError("injected resolve failure")

    eng._emit_tokens = boom
    with pytest.raises(RuntimeError, match="injected"):
        drive_step(eng, pending)
    # Both tickets are out of flight; the failed step's rows were aborted,
    # and the engine serves fresh work.
    assert not eng._inflight
    assert req.status.value == "finished_abort"
    follow = Request("f2", prompt_ids=[9, 8],
                     sampling_params=SamplingParams(
                         temperature=0.0, max_new_tokens=5,
                         ignore_eos=True))
    eng.submit(follow)
    _drive(eng)
    assert len(follow.output_ids) == 5


@LOOKAHEADS
def test_step_outputs_timing_fields(model_and_params, lookahead):
    _, eng, outs = _run(
        model_and_params, True,
        lambda i: SamplingParams(temperature=0.0, max_new_tokens=6,
                                 ignore_eos=True), lookahead,
    )
    real = [o for o in outs if o.num_tokens]
    assert real and all(o.host_ms > 0.0 for o in real)
    assert all(o.device_ms >= 0.0 for o in real)
    assert all(o.step_time_ms >= o.device_ms for o in real)
    assert any(o.overlapped for o in real)
    # Sync engines never overlap.
    _, _, sync_outs = _run(
        model_and_params, False,
        lambda i: SamplingParams(temperature=0.0, max_new_tokens=6,
                                 ignore_eos=True), lookahead,
    )
    assert not any(o.overlapped for o in sync_outs)


def test_overlap_device_feed_marks_rows(model_and_params):
    """At K = 1 the overlap loop parks each sampled token in the
    slot-indexed last-token array and the next dispatch feeds the row from
    it (a placeholder id on the host, the gathered token on the device)."""
    eng = _engine(model_and_params, True, lookahead=1)
    req = Request("r", prompt_ids=[5, 6, 7],
                  sampling_params=SamplingParams(
                      temperature=0.0, max_new_tokens=4, ignore_eos=True))
    eng.submit(req)
    t1 = eng.dispatch()
    assert req.device_feed_ready and "r" in eng._token_slots
    t2 = eng.dispatch()
    seg = t2.plan.seqs[0]
    assert seg.device_token and seg.token_ids == [0]
    # The fed row's context counts the in-flight token.
    assert seg.context_len == req.total_len + 1
    eng.resolve(t1)
    # The token was fed ahead: committing it does not re-arm the row.
    assert not req.ready_for_step
    assert int(t2.inputs.token_ids[0]) == req.output_ids[0]
    eng.resolve(t2)
    _drive(eng)
    assert len(req.output_ids) == 4
    assert not eng._token_slots
