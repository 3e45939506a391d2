"""The port's K-step decode window against the single-step engine
(tests/_torch_multistep.py has the suite's model and helpers): exact
parity greedy, seeded and with mixed rows, budgets and EOS, prefix-cache
donation, mixed arrivals, pipelined windows (mid-chain finishes, the
context room clamp) and the fallback near the context limit."""

from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests._torch_multistep import (
    GREEDY,
    _build_engine,
    _pipe_requests,
    _windows,
)


def test_multistep_matches_single_step_exactly():
    base = _pipe_requests(_build_engine(1), GREEDY)
    eng = _build_engine(4)
    multi = _pipe_requests(eng, GREEDY)
    for b, m in zip(base, multi):
        assert m.output_ids == b.output_ids, (b.output_ids, m.output_ids)
        assert m.status == b.status
    assert _windows(eng) > 0        # the window path actually ran
    assert eng._last_fused_steps == 4


def test_multistep_respects_max_tokens_and_eos():
    # max_new not a multiple of k: surplus window tokens are discarded.
    specs = [([5, 6, 7, 8], 0.0, None)]
    base = _pipe_requests(_build_engine(1), specs, max_new=7)
    multi = _pipe_requests(_build_engine(4), specs, max_new=7)
    assert multi[0].output_ids == base[0].output_ids
    assert len(multi[0].output_ids) == 7
    # EOS mid-window: greedy's 3rd token as EOS.
    eos = (base[0].output_ids[2],)
    base2 = _pipe_requests(_build_engine(1), specs, max_new=7,
                           ignore_eos=False, eos=eos)
    multi2 = _pipe_requests(_build_engine(4), specs, max_new=7,
                            ignore_eos=False, eos=eos)
    assert multi2[0].output_ids == base2[0].output_ids
    assert multi2[0].status == base2[0].status
    assert multi2[0].status.value == "finished_eos"


def test_multistep_prefix_cache_donation_consistent():
    """After a window run the donated prefix pages reflect only computed KV
    (the invariant release() relies on)."""
    eng = _build_engine(4)
    (req,) = _pipe_requests(eng, [([9, 8, 7, 6, 5, 4, 3], 0.0, None)],
                            max_new=9)
    # computed == len(all) - 1 at finish: the last token never ran.
    assert req.num_computed_tokens == req.total_len - 1
    # A request sharing the donated page (prompt + first generated token
    # completes the first full page) hits the cache.
    follow = Request(
        "f", prompt_ids=[9, 8, 7, 6, 5, 4, 3] + req.output_ids[:2] + [100],
        sampling_params=SamplingParams(temperature=0.0, max_new_tokens=4),
    )
    pipe = InProcessPipeline([eng])
    pipe.submit(follow)
    pipe.run_until_complete()
    assert follow.num_cached_tokens > 0
    assert len(follow.output_ids) == 4


def test_multistep_sampled_seeded_matches_single_step_exactly():
    """Seeded rows draw noise keyed by (seed, output step) on both paths,
    so the window reproduces per-step sampling token for token."""
    specs = [([3, 14, 15, 92], 0.9, 7), ([7, 21, 108], 1.3, 11)]
    base = _pipe_requests(_build_engine(1), specs, max_new=9)
    eng = _build_engine(4)
    multi = _pipe_requests(eng, specs, max_new=9)
    assert _windows(eng) > 0
    totals = eng.kernel_dispatch_summary()["dispatch_total"]
    assert totals["torch/sample"] >= totals["torch/multistep"]
    for b, m in zip(base, multi):
        assert m.output_ids == b.output_ids, (b.output_ids, m.output_ids)


def test_multistep_sampled_mixed_greedy_rows_stay_greedy():
    """A mixed batch takes the sampled window; its greedy rows equal the
    pure-greedy run and its seeded row its own single-step stream."""
    mixed = _pipe_requests(_build_engine(4), [([5, 6, 7, 8], 0.0, None),
                                              ([9, 10, 11], 1.0, 3)],
                           max_new=9)
    greedy_only = _pipe_requests(_build_engine(1),
                                 [([5, 6, 7, 8], 0.0, None)], max_new=9)
    seeded_only = _pipe_requests(_build_engine(1),
                                 [([9, 10, 11], 1.0, 3)], max_new=9)
    assert mixed[0].output_ids == greedy_only[0].output_ids
    assert mixed[1].output_ids == seeded_only[0].output_ids


def test_multistep_sampled_pipelined_windows_match():
    specs = [([42, 43, 44, 45], 1.1, 123)]
    base = _pipe_requests(_build_engine(1), specs, max_new=13)
    multi = _pipe_requests(_build_engine(3, pipeline=3), specs, max_new=13)
    assert multi[0].output_ids == base[0].output_ids


def test_multistep_mixed_arrivals():
    """A prefill arriving mid-stream forces a single step, then windows
    resume; outputs still match the single-step engine."""
    def run(lookahead):
        eng = _build_engine(lookahead)
        pipe = InProcessPipeline([eng])
        r1 = Request("a", prompt_ids=[3, 14, 15],
                     sampling_params=SamplingParams(temperature=0.0,
                                                    max_new_tokens=10))
        pipe.submit(r1)
        for _ in range(3):
            pipe.step_round()
        r2 = Request("b", prompt_ids=[99, 98, 97, 96],
                     sampling_params=SamplingParams(temperature=0.0,
                                                    max_new_tokens=6))
        pipe.submit(r2)
        pipe.run_until_complete()
        return r1.output_ids, r2.output_ids

    assert run(4) == run(1)


def test_pipelined_windows_match_single_step_exactly():
    """decode_pipeline chains windows off the device-resident carry; the
    stream is bitwise the single-step engine's."""
    base = _pipe_requests(_build_engine(1), GREEDY, max_new=25)
    eng = _build_engine(4, pipeline=3)
    piped = _pipe_requests(eng, GREEDY, max_new=25)
    for b, m in zip(base, piped):
        assert m.output_ids == b.output_ids, (b.output_ids, m.output_ids)
        assert m.status == b.status
    assert _windows(eng) > 0
    assert eng._last_fused_steps == 12   # 3 windows x k = 4 chained


def test_pipelined_windows_mid_chain_finishes():
    """max_new_tokens ending mid-window and mid-chain: surplus tokens of the
    remaining chained windows are discarded, not committed."""
    specs = [([5, 6, 7, 8], 0.0, None), ([9, 10, 11], 0.0, None)]
    base = _pipe_requests(_build_engine(1), specs, max_new=6)
    piped = _pipe_requests(_build_engine(4, pipeline=4), specs, max_new=6)
    for b, m in zip(base, piped):
        assert m.output_ids == b.output_ids
        assert len(m.output_ids) == 6
    # EOS inside the FIRST window of a chain: that row's later tokens are
    # discarded while the other row keeps decoding.
    probe = _pipe_requests(_build_engine(1), specs, max_new=12)
    eos = (probe[0].output_ids[1],)
    base2 = _pipe_requests(_build_engine(1), specs, max_new=12,
                           ignore_eos=False, eos=eos)
    piped2 = _pipe_requests(_build_engine(4, pipeline=3), specs, max_new=12,
                            ignore_eos=False, eos=eos)
    for b, m in zip(base2, piped2):
        assert m.output_ids == b.output_ids
        assert m.status == b.status


def test_pipelined_windows_clamp_to_context_room():
    """Near max_model_len the chain shortens to the windows that fit; the
    request finishes correctly through the fallback paths."""
    eng = _build_engine(4, pipeline=8, num_pages=64, max_model_len=64)
    (req,) = _pipe_requests(eng, [(list(range(1, 41)), 0.0, None)],
                            max_new=100, ignore_eos=False)
    assert req.status.value == "finished_length"
    assert req.total_len <= 64
    base = _pipe_requests(_build_engine(1, num_pages=64, max_model_len=64),
                          [(list(range(1, 41)), 0.0, None)], max_new=100,
                          ignore_eos=False)
    assert req.output_ids == base[0].output_ids
    assert _windows(eng) > 0


def test_multistep_near_context_limit_falls_back():
    """total_len + k past max_model_len falls back to single steps (never
    overrunning the page table) and still finishes correctly."""
    eng = _build_engine(8, num_pages=64, max_model_len=32)
    (req,) = _pipe_requests(eng, [(list(range(1, 25)), 0.0, None)],
                            max_new=100, ignore_eos=False)
    assert req.status.value == "finished_length"
    assert req.total_len <= 32
    totals = eng.kernel_dispatch_summary()["dispatch_total"]
    assert totals.get("torch/decode", 0) > 0
