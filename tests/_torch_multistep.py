"""The port's K-step decode window on the CPU (the eager loop of the same
window step the card replays from CUDA graphs): bit-exact parity with the
single-step engine, greedy and seeded, across K = 1 sync, K = 4 overlap,
K = 4 sync and pipelined windows; stops, budgets and context room inside
the window; no phantom commit or KV past a stop; fallback to K = 1 where
the window cannot run; and the port at K = 4 with overlap against the JAX
engine at K = 4 with overlap under ``assert_greedy_matches``. The matrix of
``tests/test_multistep_decode.py`` without the penalty, grammar,
logit-bias, hybrid and speculative cases, whose features wait for later
slices.

The suite's model, weights, engines and request mixes; its cases are in
tests/test_torch_multistep*.py."""

import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.runtime.batch import (
    BucketSpec,
    HostStaging,
    assemble,
    substitute_device_tokens,
)
from parallax_tpu_torch.runtime.engine import (
    ADAPTIVE_DECODE_LOOKAHEAD,
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.runtime.scheduler import BatchPlan, ScheduledSeq

RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=128, vocab_size=199, max_position_embeddings=512,
    tie_word_embeddings=False,
)
CFG = normalize_config(RAW)
PROMPTS = [[3, 14, 15, 92, 65], [7, 21, 108], [42] * 9]
_PARAMS: dict = {}


def _params(num_layers=2, seed=0, start=0):
    key = (num_layers, seed, start)
    if key not in _PARAMS:
        model = create_stage_model(CFG, start, start + num_layers)
        _PARAMS[key] = model.init_params(
            torch.Generator().manual_seed(seed), torch.float32, "cpu")
    return _PARAMS[key]


def _build_engine(lookahead, overlap=True, pipeline=1, **cfg_kw):
    defaults = dict(page_size=8, num_pages=128, max_model_len=256,
                    kv_dtype="float32")
    defaults.update(cfg_kw)
    return StageEngine(create_stage_model(CFG, 0, 2), _params(), EngineConfig(
        decode_lookahead=lookahead, overlap_steps=overlap,
        decode_pipeline=pipeline, **defaults,
    ), device="cpu")


def _drive(eng, max_iters=2000):
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


def _requests(specs, max_new, ignore_eos=True, eos=(), **sp):
    return [Request(f"r{i}", prompt_ids=list(prompt), eos_token_ids=eos,
                    sampling_params=SamplingParams(
                        temperature=temp, seed=seed, max_new_tokens=max_new,
                        ignore_eos=ignore_eos, **sp))
            for i, (prompt, temp, seed) in enumerate(specs)]


def _drive_requests(eng, specs, max_new=11, **kw):
    reqs = _requests(specs, max_new, **kw)
    for r in reqs:
        eng.submit(r)
    return reqs, _drive(eng)


def _pipe_requests(eng, specs, max_new=11, **kw):
    """The same through ``step()`` (InProcessPipeline.step_round)."""
    reqs = _requests(specs, max_new, **kw)
    pipe = InProcessPipeline([eng])
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def _windows(eng) -> int:
    return eng.kernel_dispatch_summary()["dispatch_total"].get(
        "torch/multistep", 0)


GREEDY = [(p, 0.0, None) for p in PROMPTS]
MIXED = [([3, 14, 15, 92], 0.0, None), ([7, 21, 108], 0.9, 7),
         ([42] * 5, 1.3, 11)]


# -- the bit-identity matrix -------------------------------------------------


@pytest.mark.parametrize("lookahead,overlap,pipeline", [
    (4, True, 1), (4, False, 1), (4, True, 2), (None, True, 1),
], ids=["k4-overlap", "k4-sync", "k4-pipeline2", "adaptive-overlap"])
@pytest.mark.parametrize("specs", [GREEDY, MIXED], ids=["greedy", "seeded"])
def test_window_streams_bitwise_equal_k1_sync(lookahead, overlap, pipeline,
                                              specs):
    """Greedy and seeded streams are bitwise the K = 1 synchronous
    engine's, whatever K, the overlap or the chaining."""
    base, _ = _drive_requests(_build_engine(1, overlap=False), specs,
                              max_new=13)
    eng = _build_engine(lookahead, overlap=overlap, pipeline=pipeline)
    multi, _ = _drive_requests(eng, specs, max_new=13)
    for b, m in zip(base, multi):
        assert m.output_ids == b.output_ids, (b.output_ids, m.output_ids)
        assert m.status == b.status
    assert _windows(eng) > 0
    summary = eng.kernel_dispatch_summary()
    assert summary["cuda_graphs"] is False and "graphs" not in summary


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


def test_window_rides_overlap_loop_bit_identical():
    """The window is dispatched (resolve reads the tokens and produced
    counts back in one pass), rides the one-in-flight loop and matches the
    synchronous K = 1 engine bit for bit, greedy and seeded rows alike."""
    base, _ = _drive_requests(_build_engine(1, overlap=False), MIXED,
                              max_new=13)
    over, outs = _drive_requests(_build_engine(4), MIXED, max_new=13)
    for b, m in zip(base, over):
        assert m.output_ids == b.output_ids, (b.output_ids, m.output_ids)
        assert m.status == b.status
    # Window visits happened (one resolve committing a k x batch block),
    # and a window resolved after a later dispatch was enqueued.
    window_outs = [o for o in outs if o.num_tokens >= 4 * len(MIXED)]
    assert window_outs, [o.num_tokens for o in outs]
    assert any(o.overlapped for o in window_outs)


def test_two_stage_pipeline_window_inert_and_identical():
    """Windows need a local ring (one full stage); on a two-stage pipeline
    the path stays inert and streams equal the K = 1 run exactly."""
    def run(lookahead):
        ecfg = dict(page_size=8, num_pages=128, max_model_len=256,
                    kv_dtype="float32", decode_lookahead=lookahead)
        engines = [
            StageEngine(create_stage_model(CFG, 0, 1), _params(1, 0, 0),
                        EngineConfig(**ecfg), device="cpu"),
            StageEngine(create_stage_model(CFG, 1, 2), _params(1, 1, 1),
                        EngineConfig(**ecfg), device="cpu"),
        ]
        pipe = InProcessPipeline(engines)
        reqs = []
        for i, prompt in enumerate([[3, 14, 15], [9, 8, 7, 6]]):
            r = Request(f"p{i}", prompt_ids=prompt,
                        sampling_params=SamplingParams(
                            temperature=0.0, max_new_tokens=8,
                            ignore_eos=True))
            reqs.append(r)
            pipe.submit(r)
        pipe.run_until_complete()
        return reqs, engines

    base, _ = run(1)
    multi, engines = run(4)
    for b, m in zip(base, multi):
        assert m.output_ids == b.output_ids
    for eng in engines:
        assert _windows(eng) == 0
        assert eng._last_fused_steps == 0


def test_stop_token_mid_window_no_phantom_commits():
    """A stop token landing mid-window freezes the row on the device and
    the host commits no further token: nothing past the stop reaches the
    request, the computed-KV count or the prefix cache's donation."""
    prompt = [5, 6, 7, 8, 9, 10, 11, 12]
    (p,), _ = _drive_requests(_build_engine(1, overlap=False),
                              [(prompt, 0.0, None)], max_new=9)
    # A token whose first occurrence lies mid-window (index >= 2).
    stop_idx = next(i for i in range(2, 7)
                    if p.output_ids[i] not in p.output_ids[:i])
    stop = (p.output_ids[stop_idx],)

    def run(lookahead):
        eng = _build_engine(lookahead)
        (req,), _ = _drive_requests(eng, [(prompt, 0.0, None)], max_new=9,
                                    ignore_eos=False, stop_token_ids=stop)
        return req, eng

    base, beng = run(1)
    multi, meng = run(4)
    assert multi.output_ids == base.output_ids
    assert multi.status.value == "finished_stop"
    assert len(multi.output_ids) == stop_idx + 1
    # The stop token itself was never fed.
    assert multi.num_computed_tokens == multi.total_len - 1
    # The donated prefix is the K = 1 run's: a phantom commit would donate
    # more pages.
    full = prompt + p.output_ids
    for eng in (beng, meng):
        assert eng.cache.prefix_cache.num_cached_pages == (
            beng.cache.prefix_cache.num_cached_pages)
    assert (len(meng.cache.prefix_cache.match_prefix(full)[0])
            == len(beng.cache.prefix_cache.match_prefix(full)[0]))


def test_window_fallback_under_page_pressure():
    """When the allocator cannot guarantee a window's KV for every row,
    window planning returns 0 and decode falls back to single steps:
    streams stay bitwise equal and every request finishes."""
    specs = [(list(range(1 + 7 * i, 9 + 7 * i)), 0.0, None) for i in range(4)]
    base, _ = _drive_requests(_build_engine(1, num_pages=128), specs,
                              max_new=13)
    # 4 rows end at 21 tokens (3 pages of 8): 12 pages and the null page
    # hold K = 1, but a second 8-step window would need a 4th page a row.
    eng = _build_engine(None, num_pages=13, max_model_len=128,
                        enable_prefix_cache=False)
    tight, _ = _drive_requests(eng, specs, max_new=13)
    for b, t in zip(base, tight):
        assert t.status.value == "finished_length", t.abort_reason
        assert t.output_ids == b.output_ids, (b.output_ids, t.output_ids)
    assert eng.cache.stats.kv_oom_aborts == 0
    totals = eng.kernel_dispatch_summary()["dispatch_total"]
    assert totals["torch/multistep"] > 0
    assert totals.get("torch/decode", 0) > 0      # fallbacks happened


def test_adaptive_lookahead_default_and_resumes_after_prefill():
    """decode_lookahead=None (the default) runs the adaptive window; a
    request joining mid-stream takes its prefill step, then windows
    resume. Streams match the pinned K = 1 engine."""
    assert EngineConfig().decode_lookahead is None
    assert EngineConfig().overlap_steps is True

    def run(lookahead):
        eng = _build_engine(lookahead)
        sizes = []
        orig = eng._dispatch_multistep

        def spy(plan, t0):
            ticket = orig(plan, t0)
            if ticket is not None:
                sizes.append(eng._last_fused_steps)
            return ticket

        eng._dispatch_multistep = spy
        clean = Request("c", prompt_ids=[3, 14, 15],
                        sampling_params=SamplingParams(
                            temperature=0.0, max_new_tokens=24,
                            ignore_eos=True))
        eng.submit(clean)
        late = Request("p", prompt_ids=[9, 8, 7],
                       sampling_params=SamplingParams(
                           temperature=0.0, max_new_tokens=4,
                           ignore_eos=True))
        pending = None
        submitted = False
        while eng.has_work() or pending is not None:
            if not submitted and len(clean.output_ids) >= 9:
                eng.submit(late)
                submitted = True
            _, pending = drive_step(eng, pending)
        return clean, late, sizes

    clean_a, late_a, sizes = run(None)
    clean_b, late_b, _ = run(1)
    assert clean_a.output_ids == clean_b.output_ids
    assert late_a.output_ids == late_b.output_ids
    assert sizes and max(sizes) == ADAPTIVE_DECODE_LOOKAHEAD


def test_window_respects_min_new_tokens():
    """min_new_tokens suppresses EOS inside the device stop mask exactly as
    commit_token does on the host."""
    prompt = [5, 6, 7, 8]
    (probe,), _ = _drive_requests(_build_engine(1, overlap=False),
                                  [(prompt, 0.0, None)], max_new=10)
    eos = (probe.output_ids[1],)       # the 2nd greedy token is EOS

    def run(lookahead, min_new):
        eng = _build_engine(lookahead)
        (req,), _ = _drive_requests(eng, [(prompt, 0.0, None)], max_new=10,
                                    ignore_eos=False, eos=eos,
                                    min_new_tokens=min_new)
        return req

    for min_new in (0, 5):
        base = run(1, min_new)
        multi = run(4, min_new)
        assert multi.output_ids == base.output_ids, min_new
        assert multi.status == base.status


def test_cuda_graphs_switch_on_the_cpu():
    """``cuda_graphs`` follows decode_fused's rule: None is off on a CPU
    device (the eager loop), True raises there."""
    eng = _build_engine(4)
    assert eng.kernel_dispatch_summary()["cuda_graphs"] is False
    with pytest.raises(ValueError, match="cuda_graphs"):
        StageEngine(create_stage_model(CFG, 0, 2), _params(),
                    EngineConfig(page_size=8, num_pages=16,
                                 kv_dtype="float32"),
                    device="cpu", cuda_graphs=True)


# -- scheduler and batch pieces ----------------------------------------------


def _decoding(rid, prompt, outputs, pages, max_new=20):
    req = Request(rid, prompt_ids=list(prompt),
                  sampling_params=SamplingParams(max_new_tokens=max_new))
    req.output_ids = list(outputs)
    req.num_computed_tokens = len(prompt) + len(outputs) - 1
    req.page_ids = list(pages)
    return req


@pytest.mark.parametrize("free,want", [(64, 3), (3, 2), (2, 2), (1, 0)])
def test_plan_decode_window_sizes_chain_to_free_pages(free, want):
    """The chain is sized against the pages free now and its pages are
    reserved for every row; with too few pages for one window it returns 0
    (the caller then decodes one step)."""
    eng = _build_engine(4, num_pages=1 + 2 + free)
    sched = eng.scheduler
    a = _decoding("a", range(6), [1], sched.cache.allocator.alloc(1))
    b = _decoding("b", range(7), [], sched.cache.allocator.alloc(1))
    assert sched.cache.num_free_pages == free
    plan = BatchPlan([
        ScheduledSeq(a, 1, [a.all_token_ids[-1]], a.total_len),
        ScheduledSeq(b, 1, [b.all_token_ids[-1]], b.total_len),
    ])
    # Two rows at 7 tokens: one or two windows need one more page a row,
    # three need two.
    m = sched.plan_decode_window(plan, 4, max_windows=3, max_model_len=256)
    assert m == want
    if m:
        assert len(a.page_ids) * 8 >= a.total_len + m * 4
        assert len(b.page_ids) * 8 >= b.total_len + m * 4


def test_plan_decode_window_clamps_to_room_and_budget():
    eng = _build_engine(4)
    sched = eng.scheduler
    near = _decoding("n", range(20), [1], sched.cache.allocator.alloc(3))
    plan = BatchPlan([ScheduledSeq(near, 1, [1], near.total_len)])
    # Context room: (32 - 21) // 4 = 2 windows.
    assert sched.plan_decode_window(plan, 4, 8, max_model_len=32) == 2
    assert sched.plan_decode_window(plan, 4, 8, max_model_len=24) == 0
    # Budget: 20 - 1 generated = 19 tokens left -> 5 windows of 4.
    assert sched.plan_decode_window(plan, 4, 8, max_model_len=256) == 5
    # A device-fed row counts its in-flight token.
    fed = ScheduledSeq(near, 1, [0], near.total_len + 1, device_token=True)
    assert sched.plan_decode_window(BatchPlan([fed]), 6, 8,
                                    max_model_len=256) == 3


def test_fed_ahead_commit_does_not_rearm_the_row():
    eng = _build_engine(1)
    req = _decoding("r", range(5), [7], [])
    req.status = req.status.DECODING
    req.num_computed_tokens = req.total_len        # the token was fed
    eng.scheduler.on_token_committed(req)
    assert not req.ready_for_step
    req.num_computed_tokens = req.total_len - 1    # host-fed next
    req.device_feed_ready = True
    eng.scheduler.on_token_committed(req)
    assert req.ready_for_step and not req.device_feed_ready


def test_substitute_device_tokens_gathers_fed_rows():
    spec = BucketSpec.build(64, 8, 256, 8)
    a = _decoding("a", range(6), [3], [1])
    b = _decoding("b", range(9), [4], [2, 3])
    plan = BatchPlan([
        ScheduledSeq(a, 1, [0], a.total_len + 1, device_token=True),
        ScheduledSeq(b, 1, [4], b.total_len),
    ])
    staging = HostStaging("cpu")
    staging.begin()
    inputs = assemble(plan, spec, 8, "cpu", decode_only=True,
                      staging=staging)
    last = torch.tensor([11, 22, 33, 44], dtype=torch.int32)
    slots = torch.full((inputs.token_ids.shape[0],), -1, dtype=torch.int32)
    slots[0] = 2
    out = substitute_device_tokens(inputs, last, slots)
    assert out.token_ids[:2].tolist() == [33, 4]
    assert torch.equal(out.positions, inputs.positions)


# -- against the JAX engine --------------------------------------------------


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Qwen2Config(**{
        k: v for k, v in dict(RAW, num_hidden_layers=4,
                              rms_norm_eps=1e-6).items()
        if k != "architectures"})
    model = transformers.Qwen2ForCausalLM(cfg)
    model.eval()
    return model
