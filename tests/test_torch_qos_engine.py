"""The port's QoS plane in the engine, against the JAX engine, on the CPU.

The mixed flood-then-interactive workload of tests/test_qos.py on the
tiny Qwen2 model, the same weights in both packages:

- QoS on against off, streams bit-identical (greedy and seeded rows) and
  no aborts: synchronous K = 1, overlapped K = 1 and K = 4 in both
  packages, and in the port also the K = 8 window;
- the pressure case: a page budget the flood fills, interactive rows
  whose deadline is due trip the queue-pressure trigger, batch decodes
  park to the host tier and resume on release. The port's streams equal
  its QoS-off streams bit for bit at every loop setting, K = 8 included;
  its shed, park and transition counts equal the JAX engine's on the same
  trace, and so do its greedy streams. The JAX suite's own timing-driven
  spec runs on the port too;
- on the native cache manager (no preempt path) shedding only holds
  admissions, with one warning.
"""

import pytest

from tests._torch_qos import (
    PKGS,
    QOS_SPEC,
    assert_all_finished,
    engine,
    run_mixed,
)

LOOPS = [(False, 1), (True, 1), (True, 4), (True, 8)]
LOOP_IDS = ["sync-k1", "overlap-k1", "overlap-k4", "overlap-k8"]

# Queue pressure alone drives the shed (shed_burn out of reach); ticks on
# every admission and no minimum hold make the trace independent of the
# host's speed once the interactive deadlines are due.
DUE_SPEC = ("interactive_ms=200,tick_interval_s=0,min_shed_s=0,"
            "burn_window_s=1.0,starvation_s=60,shed_burn=1000")
PRESSURE_PAGES = 4 * 15 + 9


@pytest.mark.parametrize("pkg,overlap,lookahead", [
    (pkg, o, k) for pkg in ("jax", "port") for o, k in LOOPS
    if pkg == "port" or k < 8
], ids=[f"{pkg}-{i}" for pkg in ("jax", "port")
        for (o, k), i in zip(LOOPS, LOOP_IDS) if pkg == "port" or k < 8])
def test_streams_bit_identical_qos_on_vs_off(pkg, overlap, lookahead):
    """QoS changes when rows run, never what they compute; the off-mode
    engine wires no policy at all."""
    p = PKGS[pkg]
    off_eng = engine(p, None, overlap, lookahead, 4 * 6 + 3, 1 << 24)
    assert off_eng.scheduler.qos is None
    off, off_reqs = run_mixed(p, off_eng)
    eng = engine(p, QOS_SPEC, overlap, lookahead, 4 * 6 + 3, 1 << 24)
    on, on_reqs = run_mixed(p, eng)
    assert_all_finished(p, off_reqs)
    assert_all_finished(p, on_reqs)
    assert on == off
    assert eng.scheduler.qos.counters["admitted"]["interactive"] == 2


@pytest.mark.parametrize("overlap,lookahead", LOOPS, ids=LOOP_IDS)
def test_pressure_parks_and_resumes_bit_identically(overlap, lookahead):
    """Due interactive deadlines under a full page budget: every batch
    decode parks (never aborts), the interactive rows run, the release
    resumes the parks, and each stream equals the QoS-off run's, at every
    loop setting of the port (the K = 8 window's graphs included: a park
    changes a window's rows, and seeded noise is keyed by the row's own
    step)."""
    p = PKGS["port"]
    off, _ = run_mixed(p, engine(p, None, overlap, lookahead,
                                 PRESSURE_PAGES, 1 << 24),
                       flood_gen=96, due=True)
    eng = engine(p, DUE_SPEC, overlap, lookahead, PRESSURE_PAGES, 1 << 24)
    on, reqs = run_mixed(p, eng, flood_gen=96, due=True)
    assert_all_finished(p, reqs)
    pol = eng.scheduler.qos
    assert pol.counters["parked"] == {"batch": 4}
    assert pol.controller.transitions == {"sheds": 1, "releases": 1}
    assert eng.cache_stats()["resumes"] >= 4
    assert on == off


def test_pressure_counts_and_greedy_streams_equal_the_jax_engine():
    """The same due-deadline trace on both engines (overlapped, K = 1):
    the same admissions, sheds, parks and transitions, the same
    preemptions, and the same greedy streams (seeded noise is Philox in
    the port, so seeded rows are held against the port's own QoS-off
    run above)."""
    out = {}
    for name in ("jax", "port"):
        p = PKGS[name]
        eng = engine(p, DUE_SPEC, True, 1, PRESSURE_PAGES, 1 << 24)
        streams, reqs = run_mixed(p, eng, flood_gen=96, due=True)
        assert_all_finished(p, reqs)
        pol = eng.scheduler.qos
        out[name] = (
            pol.counters, dict(pol.controller.transitions),
            eng.cache_stats()["preemptions"],
            {rid: s for rid, s in streams.items()
             if reqs[rid].sampling_params.temperature == 0.0},
        )
    assert out["port"] == out["jax"]
    assert sum(out["port"][0]["parked"].values()) > 0


def test_pressure_with_the_jax_suite_spec():
    """tests/test_qos.py's own pressure spec (the interactive budget, not a
    due deadline, makes the wait pressing) on the port: parks and sheds
    happen, the controller sheds and releases, streams are the QoS-off
    streams."""
    p = PKGS["port"]
    spec = ("interactive_ms=60,tick_interval_s=0.005,min_shed_s=0.02,"
            "burn_window_s=0.5,starvation_s=60,shed_burn=1000")
    off, _ = run_mixed(p, engine(p, None, True, 1, PRESSURE_PAGES,
                                 1 << 24), flood_gen=96)
    eng = engine(p, spec, True, 1, PRESSURE_PAGES, 1 << 24)
    on, reqs = run_mixed(p, eng, flood_gen=96)
    assert_all_finished(p, reqs)
    pol = eng.scheduler.qos
    assert sum(pol.counters["parked"].values()) > 0
    assert sum(pol.counters["shed_held"].values()) > 0
    assert pol.controller.transitions["sheds"] >= 1
    assert pol.controller.transitions["releases"] >= 1
    assert on == off


def test_native_manager_only_holds_admissions_and_warns_once(monkeypatch):
    """The native manager has no preempt path: the shed holds batch
    admissions, nothing parks, the warning fires once, and the streams are
    the QoS-off streams."""
    from parallax_tpu_torch.native import NativeCacheManager

    p = PKGS["port"]
    off, _ = run_mixed(p, engine(p, None, True, 8, PRESSURE_PAGES, 0,
                                 use_native=True), flood_gen=96, due=True)
    eng = engine(p, DUE_SPEC, True, 8, PRESSURE_PAGES, 0, use_native=True)
    assert isinstance(eng.cache, NativeCacheManager)
    import parallax_tpu_torch.qos.admission as admission

    warned = []
    real = admission.logger.warning
    monkeypatch.setattr(admission.logger, "warning",
                        lambda msg, *a: warned.append(msg) or real(msg, *a))
    on, reqs = run_mixed(p, eng, flood_gen=96, due=True)
    assert_all_finished(p, reqs)
    pol = eng.scheduler.qos
    assert pol.counters["parked"] == {}
    assert pol.controller.transitions["sheds"] == 1
    assert pol._warned_no_tier
    assert sum("park enforcement disabled" in m for m in warned) == 1
    assert on == off
