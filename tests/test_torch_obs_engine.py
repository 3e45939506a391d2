"""The engine's observability hooks against the JAX engine's, on the CPU
with the tiny Qwen2 model and the same weights (``test_torch_engine``):

- goodput buckets equal to the JAX ledger's exactly on four paths: plain
  decode, a K = 8 window with a mid-window stop, a replay restore and
  n-gram speculation (each run's delta of the process ledger);
- the registry families an engine run creates (names, kinds, label sets)
  equal the JAX run's, each package on a fresh registry;
- a traced request's span names equal, in order;
- streams under the tie-tolerant greedy check against the JAX model;
- with tracing and the watchdog off the streams repeat exactly and no
  watchdog series or thread exists.
"""

import dataclasses
import itertools
import threading

import pytest

from parallax_tpu.obs import device as j_device
from parallax_tpu.obs import goodput as j_goodput
from parallax_tpu.obs import registry as j_registry
from parallax_tpu.obs.trace import get_trace_store as j_trace_store
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.runtime import checkpoint as j_checkpoint
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.engine import drive_step as j_drive_step
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.obs import device as p_device
from parallax_tpu_torch.obs import goodput as p_goodput
from parallax_tpu_torch.obs import registry as p_registry
from parallax_tpu_torch.obs.flight import get_flight
from parallax_tpu_torch.obs.trace import get_trace_store
from parallax_tpu_torch.runtime import checkpoint as p_checkpoint
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    _tensor_leaves,
    drive_step,
)
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from tests.test_torch_engine import (
    TINY_QWEN2,
    _assert_tie_tolerant,
    _reference_logits,
    _weights,
)

ENGINE = dict(page_size=8, num_pages=128, max_model_len=256,
              kv_dtype="float32")
PORT = dict(engine=lambda **c: StageEngine(
    create_stage_model(normalize_config(TINY_QWEN2), 0, 4),
    params_from_numpy(_weights(TINY_QWEN2)[2], "cpu"),
    EngineConfig(**dict(ENGINE, **c)), device="cpu"),
    req=Request, sp=SamplingParams, step=drive_step, goodput=p_goodput,
    checkpoint=p_checkpoint, traces=get_trace_store)
JAX = dict(engine=lambda **c: JStageEngine(
    JStageModel(_weights(TINY_QWEN2)[0], 0, 4, use_pallas=False),
    _weights(TINY_QWEN2)[1], JEngineConfig(**dict(ENGINE, **c))),
    req=JRequest, sp=JSampling, step=j_drive_step, goodput=j_goodput,
    checkpoint=j_checkpoint, traces=j_trace_store)


def _serve(pkg, reqs, **cfg):
    eng = pkg["engine"](**cfg)
    for r in reqs:
        assert eng.submit(r)
    pending, guard = None, 0
    while (eng.has_work() or pending is not None) and guard < 2000:
        guard += 1
        _outs, pending = pkg["step"](eng, pending)
    assert guard < 2000
    return eng


def _delta(pkg, fn):
    """Run ``fn`` and return the process goodput ledger's token delta."""
    led = pkg["goodput"].get_goodput()
    before = led.snapshot()["tokens"]
    out = fn()
    after = led.snapshot()["tokens"]
    return {k: after[k] - before[k] for k in after}, out


def _greedy(pkg, rid, prompt, n):
    return pkg["req"](rid, prompt_ids=list(prompt), sampling_params=pkg[
        "sp"](temperature=0.0, max_new_tokens=n))


def _check_stream(req):
    jcfg, full, _ = _weights(TINY_QWEN2)
    ctx = list(req.prompt_ids) + list(req.output_ids)
    logits = _reference_logits(jcfg, full, ctx)
    _assert_tie_tolerant(logits, len(req.prompt_ids), req.output_ids,
                         req.request_id)


def _plain(pkg):
    reqs = [_greedy(pkg, f"gp-plain-{i}", p, 6)
            for i, p in enumerate(([3, 14, 15, 92], [7, 21, 108]))]
    delta, _ = _delta(pkg, lambda: _serve(pkg, reqs, decode_lookahead=1))
    return delta, reqs


def _window_stop(pkg):
    probe = _greedy(pkg, "gp-probe", [5, 6, 7, 8], 7)
    _serve(pkg, [probe], decode_lookahead=1)
    out = probe.output_ids
    # The first token from the third on that the stream had not produced
    # before: as EOS it stops the row there, mid-window.
    stop = next(i for i in range(2, len(out)) if out[i] not in out[:i])
    req = _greedy(pkg, "gp-ms", [5, 6, 7, 8], 7)
    req.eos_token_ids = (out[stop],)
    delta, _ = _delta(pkg, lambda: _serve(pkg, [req], decode_lookahead=8))
    assert req.output_ids == out[:stop + 1]
    return delta, [probe, req]


def _replay(pkg):
    base = _greedy(pkg, "gp-src", [9, 8, 7, 6, 5], 8)
    _serve(pkg, [base], decode_lookahead=1)
    src = _greedy(pkg, "gp-replay", [9, 8, 7, 6, 5], 8)
    for t in base.output_ids[:4]:
        src.commit_token(t)
    ck = pkg["checkpoint"]
    resumed = ck.build_resumed_request(ck.checkpoint_from_request(src),
                                       replay=True)
    delta, _ = _delta(pkg, lambda: _serve(pkg, [resumed],
                                          decode_lookahead=1))
    assert resumed.full_output_ids == base.output_ids
    return delta, [base]


def _ngram(pkg):
    reqs = [_greedy(pkg, f"gp-spec-{i}", p, 12) for i, p in enumerate((
        [3, 5, 7, 9] * 4, [11, 12, 13, 11, 12, 13, 11, 12]))]
    delta, _ = _delta(pkg, lambda: _serve(pkg, reqs, speculative_tokens=3))
    return delta, reqs


@pytest.mark.parametrize("path", [_plain, _window_stop, _replay, _ngram],
                         ids=["plain", "k8-mid-window-stop", "replay",
                              "ngram-spec"])
def test_goodput_buckets_equal_jax(path):
    want, jreqs = path(JAX)
    got, preqs = path(PORT)
    assert got == want
    assert sum(got.values()) > 0
    for jr, pr in zip(jreqs, preqs):
        _check_stream(pr)
        assert pr.status.value == jr.status.value
    if path is _window_stop:
        assert got["frozen_tail"] > 0
    if path is _replay:
        assert got["replayed"] == 4 and got["preempted_rework"] == 5
    if path is _ngram:
        assert got["committed"] == 24


def _families(reg) -> dict:
    return {f.name: (f.kind, tuple(f.labelnames))
            for f in reg._families.values()}


def test_registry_families_equal_jax(monkeypatch):
    """A fresh registry, goodput ledger and device plane per package: the
    families an engine run (windows, speculation, a traced request)
    creates are the JAX run's, names, kinds and label sets."""
    regs = {}
    for name, pkg, reg_mod, gp_mod, dev_mod in (
        ("jax", JAX, j_registry, j_goodput, j_device),
        ("port", PORT, p_registry, p_goodput, p_device),
    ):
        reg = reg_mod.MetricsRegistry()
        monkeypatch.setattr(reg_mod, "_REGISTRY", reg)
        monkeypatch.setattr(gp_mod, "_LEDGER", gp_mod.GoodputLedger())
        monkeypatch.setattr(dev_mod, "_PLANE", dev_mod.DevicePlane())
        reqs = [_greedy(pkg, f"fam-{name}-{i}", p, 9) for i, p in
                enumerate(([3, 5, 7, 9] * 3, [2, 4, 6]))]
        _serve(pkg, reqs, speculative_tokens=2, trace_sample_rate=1.0)
        reg.render()
        regs[name] = _families(reg)
    missing = set(regs["jax"]) - set(regs["port"])
    extra = set(regs["port"]) - set(regs["jax"])
    assert not missing and not extra, (missing, extra)
    assert regs["port"] == regs["jax"]


def _spans(pkg, rid):
    store = pkg["traces"]()
    names = [s["name"] for s in store.spans(rid)]
    # Decode steps coalesce into epochs by wall-clock gaps: compare the
    # sequence of span kinds.
    return [k for k, _ in itertools.groupby(names)]


def test_trace_span_names_equal_jax():
    out = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        req = _greedy(pkg, f"span-{name}", [3, 14, 15, 92], 6)
        eng = _serve(pkg, [req], trace_sample_rate=1.0)
        assert req.traced and not eng._traced
        out[name] = _spans(pkg, req.request_id)
    assert out["port"] == out["jax"]
    assert out["port"][0] == "queue_wait" and out["port"][-1] == "finish"
    assert "prefill" in out["port"] and "decode" in out["port"]
    # The head's finish lands in the flight recorder with its trace id.
    rec = [r for r in get_flight().snapshot()["requests"]
           if r["request_id"] == "span-port"]
    assert rec and rec[-1]["trace_id"] == "span-port"
    chrome = get_trace_store().export_chrome("span-port")
    assert {e["name"] for e in chrome["traceEvents"]} >= {"prefill",
                                                          "decode"}


def test_inert_when_tracing_and_watchdog_off(monkeypatch):
    """Defaults: tracing off, no watchdog. The ledger counts, the streams
    repeat exactly, nothing is traced and the runs create no watchdog
    series (on a fresh registry: other tests of this process may build
    watchdogs on the shared one) and no watchdog thread."""
    monkeypatch.setattr(p_registry, "_REGISTRY", p_registry.MetricsRegistry())
    threads = {t.name for t in threading.enumerate()}
    prompts = ([3, 14, 15, 92, 65], [7, 21, 108])

    def run_once(tag):
        reqs = [_greedy(PORT, f"inert-{tag}-{i}", p, 9)
                for i, p in enumerate(prompts)]
        eng = _serve(PORT, reqs)
        assert not eng._traced
        assert all(not r.traced for r in reqs)
        assert all(not get_trace_store().has(r.request_id) for r in reqs)
        return [list(r.output_ids) for r in reqs]

    assert run_once("a") == run_once("b")
    text = p_registry.get_registry().render()
    assert "parallax_step_host_ms" in text
    assert "parallax_health_state" not in text
    new = {t.name for t in threading.enumerate()} - threads
    assert "stall-watchdog" not in new


def test_step_timing_and_device_time_on_cpu():
    """On the CPU the device time of a program is the host + readback
    wall time of its resolves (the JAX proxy), and the step-timing EWMA
    counts host visits."""
    plane = p_device.get_device_plane()
    before = dict(plane.time.snapshot()["seconds"])
    req = _greedy(PORT, "dt-cpu", [3, 14, 15, 92], 10)
    eng = _serve(PORT, [req], decode_lookahead=4)
    after = plane.time.snapshot()["seconds"]
    for prog in ("prefill", "decode_window"):
        assert after.get(prog, 0.0) > before.get(prog, 0.0), prog
    summary = eng.step_timing.summary()
    assert summary["host_visits"] >= 2 and summary["tokens"] >= 10
    # The HBM ledger's classes: the parameter and KV bytes, exactly.
    eng.obs_tick(force=True)
    classes = plane.hbm.snapshot()["classes"]
    assert classes["weights_float32"] >= sum(
        t.nbytes for t in _tensor_leaves(eng.params))
    assert classes["kv_pages"] >= sum(t.nbytes for t in eng.kv)
    stats = eng.cache_stats()
    assert stats["page_occupancy"] >= 0.0 and "prefix_hit_rate" in stats


def test_draft_rows_stay_out_of_the_ledger():
    """A draft engine's __draft rows commit nothing into the goodput
    ledger (the target's accept / reject accounting prices them), and the
    draft leaves its bytes to the target's ``spec_draft`` class."""
    from parallax_tpu_torch.runtime.engine import DraftProposer

    draft = DraftProposer(PORT["engine"](decode_lookahead=4),
                          max_propose_ms=60_000.0)
    assert draft.engine._obs_draft
    led = p_goodput.get_goodput()
    before = led.snapshot()["tokens"]
    (prop,) = draft.propose_batch([[3, 5, 7, 9] * 2], [3])
    assert len(prop) == 3
    assert led.snapshot()["tokens"] == before
    eng = StageEngine(
        create_stage_model(normalize_config(TINY_QWEN2), 0, 4),
        params_from_numpy(_weights(TINY_QWEN2)[2], "cpu"),
        EngineConfig(**dict(ENGINE, speculative_tokens=2)), device="cpu",
        draft=draft)
    eng.obs_tick(force=True)
    classes = p_device.get_device_plane().hbm.snapshot()["classes"]
    assert classes["spec_draft"] > 0
    assert dataclasses.asdict(draft.engine.cache.stats)["tokens_admitted"] > 0
