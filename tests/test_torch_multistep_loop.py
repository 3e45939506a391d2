"""The port's K-step decode window in the serving loop
(tests/_torch_multistep.py has the suite's model and helpers): the window
on the overlapped loop, inert on a two-stage pipeline, a stop token mid
window with no phantom commit, the fallback under page pressure, the
adaptive default, ``min_new_tokens``, and the port at K = 4 with overlap
against the JAX engine at K = 4 with overlap."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.runtime.engine import (
    ADAPTIVE_DECODE_LOOKAHEAD,
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests._torch_multistep import (
    CFG,
    MIXED,
    RAW,
    _build_engine,
    _drive_requests,
    _params,
    _windows,
    hf_model,
)


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


def test_k4_overlap_streams_match_jax_k4_overlap(hf_model):
    """The port at K = 4 with overlap on against parallax_tpu's engine at
    K = 4 with overlap on, on the same (HF) weights: both engines' greedy
    streams pass ``assert_greedy_matches`` against the HF model, and
    where the two part they part at a near-tie."""
    from parallax_tpu.config import normalize_config as j_normalize
    from parallax_tpu.models.base import StageModel as JStageModel
    from parallax_tpu.models.loader import params_from_torch_state_dict
    from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
    from parallax_tpu.runtime.engine import StageEngine as JStageEngine
    from parallax_tpu.runtime.engine import drive_step as j_drive_step
    from parallax_tpu.runtime.request import Request as JRequest
    from parallax_tpu.runtime.request import SamplingParams as JSampling
    from tests.test_engine_e2e import assert_greedy_matches

    raw = dict(RAW, num_hidden_layers=4, rms_norm_eps=1e-6)
    jmodel = JStageModel(j_normalize(raw), 0, 4, use_pallas=False)
    jparams = params_from_torch_state_dict(jmodel, hf_model.state_dict(),
                                           dtype=jnp.float32)
    ecfg = dict(page_size=8, num_pages=128, max_model_len=256,
                kv_dtype="float32", decode_lookahead=4, overlap_steps=True)
    prompts = [[3, 14, 15, 92, 65], [7, 21, 108], [42] * 9, [1, 2, 3, 4]]
    n_new = 10

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

    j_reqs = drive(JStageEngine(jmodel, jparams, JEngineConfig(**ecfg)),
                   JRequest, JSampling, j_drive_step)
    port = StageEngine(create_stage_model(normalize_config(raw), 0, 4),
                       params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"),
                       EngineConfig(**ecfg), device="cpu")
    p_reqs = drive(port, Request, SamplingParams, drive_step)
    assert port.kernel_dispatch_summary()["dispatch_total"][
        "torch/multistep"] > 0
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
