"""Unit parity of the observability modules: ``parallax_tpu_torch.obs``
and ``utils/request_metrics.py`` against ``parallax_tpu.obs`` on the same
inputs, clocks and fake devices. Every scenario runs once per package;
the test asserts the scenario's own expectations on both and that the two
results are equal (Prometheus exposition byte for byte, snapshots,
merges, SLO evaluations and burn rates, device payloads)."""

import importlib
import json
import types

import pytest

_MODS = ("names", "registry", "flight", "trace", "goodput", "device",
         "watchdog", "slo", "timeline")


def _bundle(pkg: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(pkg=pkg)
    for name in _MODS:
        setattr(ns, name, importlib.import_module(f"{pkg}.obs.{name}"))
    ns.request_metrics = importlib.import_module(
        f"{pkg}.utils.request_metrics")
    return ns


JAX = _bundle("parallax_tpu")
PORT = _bundle("parallax_tpu_torch")
BOTH = pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])


def _same(scenario):
    """Run ``scenario`` on both packages; the results must be equal."""
    a, b = scenario(JAX), scenario(PORT)
    assert a == b
    return b


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeDevice:
    def __init__(self, limit, in_use):
        self._stats = {"bytes_limit": limit, "bytes_in_use": in_use}

    def memory_stats(self):
        return self._stats


# -- names -------------------------------------------------------------------


def test_metric_names_are_the_jax_names():
    """The name table is the JAX one: every constant, every HELP text."""
    def public(mod):
        return {k: v for k, v in vars(mod).items()
                if k.isupper() and isinstance(v, str)}

    assert public(PORT.names) == public(JAX.names)
    assert PORT.names.HELP == JAX.names.HELP


# -- registry ----------------------------------------------------------------


def _exposition(m):
    reg = m.registry.MetricsRegistry()
    c = reg.counter("obs_requests_total", "Requests accepted")
    c.inc(3)
    g = reg.gauge("obs_depth", "Queue depth", labelnames=("stage",))
    g.labels(stage='a"b\\c\nd').set(7)
    h = reg.histogram("obs_lat_ms", "Latency", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    ev = reg.counter("evil_total",
                     'help with "quotes"\nand a newline \\ slash',
                     labelnames=("peer",))
    ev.labels(peer='10.0.0.1:42\n"evil\\peer"').inc(3)
    d = reg.histogram("obs_default_ms", "default lattice")
    for v in (0.02, 3.3, 77.0, 1234.5, 99999.0):
        d.observe(v)
    return reg.render()


@BOTH
def test_exposition_help_type_and_escaping(m):
    lines = _exposition(m).splitlines()
    assert "# HELP obs_requests_total Requests accepted" in lines
    assert "# TYPE obs_requests_total counter" in lines
    assert "obs_requests_total 3" in lines
    assert 'obs_depth{stage="a\\"b\\\\c\\nd"} 7' in lines
    assert 'obs_lat_ms_bucket{le="+Inf"} 4' in lines
    assert 'evil_total{peer="10.0.0.1:42\\n\\"evil\\\\peer\\""} 3' in lines
    for ln in lines:
        assert ln.startswith("#") or ln.count(" ") >= 1


def test_exposition_byte_for_byte():
    assert _exposition(PORT).encode() == _exposition(JAX).encode()
    assert (PORT.registry.EXPOSITION_CONTENT_TYPE
            == JAX.registry.EXPOSITION_CONTENT_TYPE)


def _monotone(m):
    import random as _r

    reg = m.registry.MetricsRegistry()
    h = reg.histogram("obs_mono_ms", "m")
    rng = _r.Random(7)
    for _ in range(500):
        h.observe(rng.uniform(0.01, 200_000.0))
    return [int(line.rsplit(" ", 1)[1])
            for line in reg.render().splitlines()
            if line.startswith("obs_mono_ms_bucket")]


def test_histogram_buckets_cumulative_and_equal():
    cums = _same(_monotone)
    assert cums == sorted(cums) and cums[-1] == 500


@BOTH
def test_registry_get_or_create_and_type_collision(m):
    reg = m.registry.MetricsRegistry()
    a = reg.counter("obs_x_total", "x")
    assert reg.counter("obs_x_total", "x") is a
    with pytest.raises(ValueError):
        reg.gauge("obs_x_total", "x")
    with pytest.raises(ValueError):
        reg.counter("obs_x_total", "x", labelnames=("other",))


def _merge(m):
    r = m.registry
    reg1, reg2 = r.MetricsRegistry(), r.MetricsRegistry()
    for reg, vals in ((reg1, [1.0] * 50), (reg2, [1000.0] * 50)):
        h = reg.histogram("obs_merge_ms", "m", labelnames=("stage",))
        for v in vals:
            h.labels(stage='0-"2"').observe(v)
    merged = r.merge_histogram_snapshots([
        reg1.histogram_snapshots(), reg2.histogram_snapshots(),
    ])
    (key,) = merged["obs_merge_ms"]
    snap = merged["obs_merge_ms"][key]
    return {
        "key": key,
        "merged": merged,
        "p50": r.snapshot_quantile(snap, 0.5),
        "p99": r.snapshot_quantile(snap, 0.99),
        "summary": r.summarize_snapshots(merged),
    }


def test_snapshot_merge_and_percentiles_equal():
    out = _same(_merge)
    assert out["key"] == '{stage="0-\\"2\\""}'
    snap = out["merged"]["obs_merge_ms"][out["key"]]
    assert snap["count"] == 100
    assert out["p50"] < 10.0 < 500.0 < out["p99"]
    assert set(out["summary"]["obs_merge_ms"][out["key"]]) >= {
        "p50", "p95", "p99", "sum", "count"}


def _mismatched(m):
    a = {"m": {"": {"bounds": [1.0, 2.0], "counts": [5, 5, 0],
                    "sum": 10.0, "count": 10}}}
    b = {"m": {"": {"bounds": [1.0, 3.0], "counts": [1, 1, 0],
                    "sum": 4.0, "count": 2}}}
    c = {"m": {"": {"bounds": "junk", "counts": None,
                    "sum": 6.0, "count": 3}}}
    same = {"m": {"": {"bounds": [1.0], "counts": [2, 1],
                       "sum": 3.0, "count": 3}}}
    merge = m.registry.merge_histogram_snapshots
    merged = merge([a, b])
    return {
        "merged": merged,
        "summary": m.registry.summarize_snapshots(merged),
        "broken": merge([c, b]),
        "same": merge([same, same]),
    }


def test_merge_fallback_equal():
    out = _same(_mismatched)
    child = out["merged"]["m"][""]
    assert child["count"] == 12 and child["counts"] == [5, 5, 0]
    assert child["mixed_bounds"] == 1
    assert out["broken"]["m"][""]["count"] == 5
    assert out["same"]["m"][""]["counts"] == [4, 2]
    assert "mixed_bounds" not in out["same"]["m"][""]


# -- flight recorder and traces ----------------------------------------------


def _flight(m):
    fl = m.flight.FlightRecorder(event_capacity=4)
    fl.event("mine", node="n0")
    fl.event("theirs", node="n1")
    fl.event("untagged")
    events, cursor = fl.events_since(0, node="n0")
    again, cursor2 = fl.events_since(cursor, node="n0")
    for i in range(4):
        fl.event(f"e{i}", node="n0")
    fl.record_request("r-fast", status="finished_length", e2e_ms=5.0,
                      ttft_ms=1.0, prompt_tokens=3, output_tokens=4,
                      slow_threshold_ms=100.0)
    fl.record_request("r-slow", status="finished_length", e2e_ms=500.0,
                      ttft_ms=1.0, prompt_tokens=3, output_tokens=4,
                      slow_threshold_ms=100.0, trace_id="r-slow",
                      breakdown={"decode": 1.0})
    snap = fl.snapshot()
    strip = ("time", "wall", "t", "ts")
    return {
        "kinds": [e["kind"] for e in events],
        "again": again, "same_cursor": cursor2 == cursor,
        "oldest": fl.oldest_seq(),
        "events": [{k: v for k, v in e.items() if k not in strip}
                   for e in snap["events"]],
        "slow": [r["request_id"] for r in snap["slow"]],
        "requests": [r["request_id"] for r in snap["requests"]],
        "trace_ids": [r.get("trace_id") for r in snap["requests"]],
    }


def test_flight_recorder_equal():
    out = _same(_flight)
    assert out["kinds"] == ["mine", "untagged"] and out["again"] == []
    assert out["slow"] == ["r-slow"]
    assert out["trace_ids"] == [None, "r-slow"]


def _trace(m):
    store = m.trace.TraceStore(capacity=2, max_spans=8)
    store.begin("r1")
    store.add("r1", "0-2", "queue_wait", t0=1.0, dur=0.5)
    for i in range(5):
        store.add("r1", "0-2", "decode", t0=2.0 + 0.01 * i, dur=0.005,
                  args={"tokens": 1}, merge=True)
    store.counter("r1", "0-2", "device", t0=2.1,
                  values={"hbm_headroom_mb": 1.5})
    store.add("r1", "2-4", "prefill", t0=1.6, dur=0.2)
    store.begin("r2")
    store.begin("r3")            # evicts r1
    kept = store.has("r1")
    store.begin("a")
    store.add("a", "0-2", "decode", t0=0.0, dur=0.1)
    spans = store.spans("a")
    store.adopt("b", [dict(s) for s in spans] + [{"bad": 1}, "junk"])
    return {"kept": kept, "chrome": store.export_chrome("a"),
            "adopted": store.export_chrome("b"),
            "breakdown": store.breakdown("a"),
            "missing": store.export_chrome("nope")}


def test_trace_store_equal():
    out = _same(_trace)
    assert out["kept"] is False and out["missing"] is None
    assert out["adopted"] is not None
    json.dumps(out["chrome"])


def _trace_epochs(m):
    store = m.trace.TraceStore()
    store.begin("r")
    store.add("r", "0-2", "queue_wait", t0=1.0, dur=0.5)
    for i in range(50):
        store.add("r", "0-2", "decode", t0=2.0 + 0.01 * i, dur=0.005,
                  merge=True)
    store.add("r", "0-2", "decode", t0=9.0, dur=0.005, merge=True)
    store.add("r", "0-2", "finish", t0=9.1, dur=0.0)
    return [(s["name"], s.get("args")) for s in store.spans("r")], \
        store.breakdown("r")


def test_decode_spans_coalesce_equal():
    spans, breakdown = _same(_trace_epochs)
    assert [n for n, _ in spans] == ["queue_wait", "decode", "decode",
                                     "finish"]
    assert "decode" in breakdown


# -- goodput -------------------------------------------------------------------


def _goodput(m):
    clk = FakeClock()
    led = m.goodput.GoodputLedger(registry=m.registry.MetricsRegistry(),
                                  clock=clk)
    led.bind_registry(m.registry.MetricsRegistry())
    led.count("committed", 7)
    led.count("frozen_tail", 3)
    led.count("replayed", 2)
    led.count("committed", 0)
    led.count("frozen_tail", -1)
    led.add_time("serve", 1.5)
    led.add_time("compile", 0.5)
    led.count_request("finished_length")
    led.count_request("finished_abort")
    clk.t += 10.0
    a = led.payload(chips=4)
    b = m.goodput.GoodputLedger(clock=clk)
    b.count("committed", 50)
    b.count("replayed", 50)
    b.count("speculative_rejected", 5)
    merged = m.goodput.merge_goodput(
        [a, b.payload(chips=1), None, {"bad": 1}])
    return {"total": led.total_tokens(), "frac": led.goodput_fraction(),
            "payload": a, "merged": merged,
            "empty": m.goodput.merge_goodput([]),
            "kinds": m.goodput.TOKEN_KINDS}


def test_goodput_ledger_units_equal():
    out = _same(_goodput)
    assert out["total"] == 12 and out["frac"] == round(7 / 12, 6)
    p = out["payload"]
    assert p["tokens_useful"] + p["tokens_wasted"] == p["tokens_total"]
    assert p["time_s"]["serve"] == 1.5 and p["time_s"]["idle"] >= 0.0
    assert out["merged"]["nodes"] == 2 and out["empty"] is None


@BOTH
def test_zero_valued_goodput_families(m):
    reg = m.registry.MetricsRegistry()
    m.goodput.GoodputLedger().bind_registry(reg)
    text = reg.render()
    for kind in m.goodput.TOKEN_KINDS:
        assert f'parallax_goodput_tokens_total{{kind="{kind}"}}' in text
    assert "parallax_goodput_fraction" in text


# -- watchdog --------------------------------------------------------------------


def _watchdog(m):
    clk = [100.0]
    fl = m.flight.FlightRecorder()
    wd = m.watchdog.StallWatchdog(
        node_id="n0", degraded_after_s=5.0, stalled_after_s=15.0,
        registry=m.registry.MetricsRegistry(), clock=lambda: clk[0],
        flight=fl,
    )
    state = {"pending": 0.0, "progress": 0.0}
    wd.register("step_loop", lambda: (state["pending"], state["progress"],
                                      "q"))
    out = []
    for t, pending, progress in ((100, 0, 0), (110, 0, 0), (140, 0, 0),
                                 (200, 3, 0), (204, 3, 0), (206, 3, 0),
                                 (216, 3, 0), (217, 3, 1)):
        clk[0] = float(t)
        state.update(pending=float(pending), progress=float(progress))
        out.append([(tr["component"], tr["from"], tr["to"])
                    for tr in wd.poll_once()])
    summary = wd.summary()
    return {"transitions": out, "status": summary["status"],
            "healthy": wd.is_healthy(),
            "events": [e["kind"] for e in fl.snapshot()["events"]]}


def test_watchdog_state_machine_equal():
    out = _same(_watchdog)
    flat = [t for step in out["transitions"] for t in step]
    assert flat == [("step_loop", "ok", "degraded"),
                    ("step_loop", "degraded", "stalled"),
                    ("step_loop", "stalled", "ok")]
    assert out["status"] == "ok" and out["healthy"]
    assert len(out["events"]) == 3


def _beats(m):
    clk = [0.0]
    wd = m.watchdog.StallWatchdog(
        node_id="n0", degraded_after_s=1.0, stalled_after_s=2.0,
        registry=m.registry.MetricsRegistry(), clock=lambda: clk[0],
        flight=m.flight.FlightRecorder(),
    )
    wd.register_beat("loop", lambda: 1.0)

    def bad():
        raise RuntimeError("probe broke")

    wd.register("broken", bad)
    steps = [[(tr["component"], tr["to"]) for tr in wd.poll_once()]]
    clk[0] = 3.0
    steps.append([(tr["component"], tr["to"]) for tr in wd.poll_once()])
    wd.beat("loop")
    clk[0] = 3.5
    steps.append([(tr["component"], tr["to"]) for tr in wd.poll_once()])
    return {"steps": steps,
            "broken": wd.summary()["components"]["broken"]["state"],
            "worst": m.watchdog.worst_status(["ok", "degraded", "x"])}


def test_watchdog_beats_and_probe_errors_equal():
    out = _same(_beats)
    assert out["steps"] == [[], [("loop", "stalled")], [("loop", "ok")]]
    assert out["broken"] == "ok" and out["worst"] == "degraded"


# -- timeline ------------------------------------------------------------------


def _timeline(m):
    tl = m.timeline.ClusterTimeline(registry=m.registry.MetricsRegistry())
    batch = {"epoch": "e1", "batch": [
        {"seq": 1, "kind": "a", "time": 10.0},
        {"seq": 2, "kind": "b", "time": 11.0},
    ]}
    tl.ingest("n0", batch)
    tl.ingest("n0", batch)
    tl.ingest("n0", {"epoch": "e1", "batch": [
        {"seq": 5, "kind": "c", "time": 12.0}]})
    tl.ingest("n0", None)
    tl.ingest("n0", {"batch": "nope"})
    tl.ingest("n0", {"epoch": "e1", "batch": [7, {"kind": "x"}]})
    tl.ingest("n1", {"epoch": "boot1", "batch": [
        {"seq": i, "kind": "old", "time": float(i)} for i in (1, 2, 3)]})
    tl.ingest("n1", {"epoch": "boot2", "batch": [
        {"seq": 1, "kind": "new", "time": 10.5}]})
    tl.ingest("b", {"epoch": "e", "batch": [
        {"seq": 1, "kind": "mig_in", "time": 20.0}]})
    tl.ingest("a", {"epoch": "e", "batch": [
        {"seq": 1, "kind": "park", "time": 19.0},
        {"seq": 2, "kind": "mig_out", "time": 19.5}]})
    tl.record("node_leave", node="dead", displaced=1)
    snap = tl.snapshot()
    chrome = tl.export_chrome()
    cursors = tl.export_cursors()
    tl2 = m.timeline.ClusterTimeline(registry=m.registry.MetricsRegistry())
    tl2.adopt_cursors(cursors)
    tl2.ingest("n0", batch)
    strip = ("recv", "ts", "time_recv")
    return {
        "counts": (tl.ingested, tl.gaps, tl.resets),
        "kinds": [e["kind"] for e in snap["events"]],
        "nodes": {n: d.get("epoch") for n, d in snap["nodes"].items()},
        "lanes": sorted({e["tid"] for e in chrome["traceEvents"]}),
        "phases": {e["ph"] for e in chrome["traceEvents"]},
        "adopted_dedupe": tl2.ingested,
        "events": [{k: v for k, v in e.items() if k not in strip}
                   for e in snap["events"] if e.get("node") != "dead"],
    }


def test_timeline_merge_equal():
    out = _same(_timeline)
    assert out["counts"] == (11, 2, 1)
    assert out["kinds"][-1] == "node_leave"
    assert {"a", "b", "dead"} <= set(out["lanes"])
    assert out["phases"] == {"i"} and out["adopted_dedupe"] == 0


def _local_timeline(m):
    fl = m.flight.FlightRecorder()
    fl.event("preempt", request_id="r1")
    fl.event("kv_oom", request_id="r2")
    lt = m.timeline.LocalTimeline(node_id="solo", flight=fl)
    first = [e["kind"] for e in lt.snapshot()["events"]]
    fl.event("abort_path", peer="p")
    return first, len(lt.snapshot()["events"]), len(
        lt.snapshot()["events"])


def test_local_timeline_equal():
    first, n1, n2 = _same(_local_timeline)
    assert first == ["preempt", "kv_oom"] and n1 == n2 == 3


# -- SLO -------------------------------------------------------------------------


def _hist_snap(counts, bounds=(10.0, 100.0), total=None):
    return {"bounds": list(bounds), "counts": list(counts), "sum": 1.0,
            "count": total if total is not None else sum(counts)}


def _slo_parse(m):
    cfg = m.slo.parse_slo_spec(
        "ttft_p95_ms=500, tpot_p99_ms=50,availability=0.999")
    bad = []
    for spec in ("", "ttft_p95_ms", "e2e_p95_ms=-3", "junk=1",
                 "availability=1.5", "ttft_p95_ms=abc"):
        try:
            m.slo.parse_slo_spec(spec)
        except ValueError:
            bad.append(spec)
    snap = _hist_snap([8, 2, 0])
    fb = m.slo.fraction_below
    return {
        "objectives": [(o.kind, o.target, o.metric, o.threshold_ms)
                       for o in cfg.objectives],
        "bad": bad,
        "fractions": [fb(snap, 100.0), fb(snap, 55.0), fb(snap, 1e9),
                      fb(_hist_snap([8, 0, 2]), 1e9), fb({"x": 1}, 10.0)],
    }


def test_slo_parse_and_fraction_equal():
    out = _same(_slo_parse)
    assert [o[:2] for o in out["objectives"]] == [
        ("latency", 0.95), ("latency", 0.99), ("availability", 0.999)]
    assert len(out["bad"]) == 6
    assert out["fractions"][0] == (10.0, 10)


def _slo_burn(m):
    clk = [0.0]
    cfg = m.slo.parse_slo_spec("ttft_p95_ms=55,availability=0.9",
                               window_s=300.0, long_window_factor=12.0)
    reg = m.registry.MetricsRegistry()
    tr = m.slo.SLOTracker(cfg, registry=reg, clock=lambda: clk[0])
    tr.observe({"hists": {"parallax_ttft_ms": {"": _hist_snap([0, 0, 0])}},
                "finished": 0, "aborted": 0})
    clk[0] = 300.0
    first = tr.observe_and_evaluate({
        "hists": {"parallax_ttft_ms": {"": _hist_snap([8, 2, 0])}},
        "finished": 10, "aborted": 2})
    clk[0] = 400.0
    tr.observe({"hists": {"parallax_ttft_ms": {"": _hist_snap([80, 20, 0])}},
                "finished": 100, "aborted": 2})
    clk[0] = 500.0
    reset = tr.observe_and_evaluate({
        "hists": {"parallax_ttft_ms": {"": _hist_snap([8, 2, 0])}},
        "finished": 10, "aborted": 2})
    clk[0] = 600.0
    after = tr.observe_and_evaluate({
        "hists": {"parallax_ttft_ms": {"": _hist_snap([16, 4, 0])}},
        "finished": 20, "aborted": 2})
    quiet = m.slo.SLOTracker(m.slo.parse_slo_spec("tpot_p95_ms=50"),
                             registry=m.registry.MetricsRegistry(),
                             clock=lambda: clk[0])
    quiet.observe({"hists": {}, "finished": 0, "aborted": 0})
    clk[0] = 1200.0
    idle = quiet.observe_and_evaluate({"hists": {}, "finished": 0,
                                       "aborted": 0})
    return {"first": first, "reset": reset, "after": after, "idle": idle,
            "exposition": reg.render()}


def test_slo_burn_rates_equal():
    out = _same(_slo_burn)
    lat = out["first"]["objectives"]["ttft_p95_ms=55"]["windows"]["300s"]
    assert lat["samples"] == 10 and abs(lat["attainment"] - 0.9) < 1e-6
    assert abs(lat["burn_rate"] - 2.0) < 1e-3
    avail = out["first"]["objectives"]["availability=0.9"]["windows"]["300s"]
    assert abs(avail["attainment"] - 0.8) < 1e-6
    assert out["reset"]["resets"] == 1
    w = out["after"]["objectives"]["ttft_p95_ms=55"]["windows"]["300s"]
    assert w["samples"] == 10
    idle = out["idle"]["objectives"]["tpot_p95_ms=50"]
    assert idle["met"] and idle["windows"]["300s"]["burn_rate"] == 0.0


# -- device plane ----------------------------------------------------------------


def _hbm(m):
    clk = FakeClock()
    fl = m.flight.FlightRecorder()
    led = m.device.HbmLedger(clock=clk, untracked_threshold=0.10)
    reg = m.registry.MetricsRegistry()
    led.bind_registry(reg)
    out = {}
    led.set_class("weights_bfloat16", 600, owner="0-2")
    led.set_class("weights_bfloat16", 400, owner="2-4")
    led.set_class("kv_pages", 200, owner="0-2")
    led.add_class("kv_pages", 50, owner="0-2")
    led.add_class("kv_pages", -1000, owner="2-4")
    out["owners"] = led.snapshot()
    out["cpu"] = led.refresh_from_device(FakeDevice(0, 0))
    led.set_capacity(2000)
    out["capacity"] = led.snapshot()
    # The untracked excursion emits one flight event per excursion.
    import unittest.mock as mock

    with mock.patch.object(
            m.flight, "get_flight", lambda: fl):
        out["device"] = led.refresh_from_device(FakeDevice(4000, 1600))
        led.refresh_from_device(FakeDevice(4000, 1700))
        led.refresh_from_device(FakeDevice(4000, 1300))
        led.refresh_from_device(FakeDevice(4000, 1800))
    out["after"] = led.snapshot()
    out["events"] = [e["kind"] for e in fl.snapshot()["events"]]
    out["exposition"] = reg.render()
    return out


def test_hbm_ledger_equal():
    out = _same(_hbm)
    assert out["owners"]["classes"] == {"weights_bfloat16": 1000,
                                        "kv_pages": 250}
    assert out["cpu"] is False
    assert out["capacity"]["headroom_bytes"] == 750
    assert out["device"] is True
    assert out["after"]["capacity_source"] == "device"
    assert out["events"] == ["hbm_untracked", "hbm_untracked"]
    assert 'parallax_hbm_bytes{class="kv_pages"} 250' in out["exposition"]


def test_torch_device_memory_stats_on_cpu():
    """A CPU ``torch.device`` reports no stats: the ledger keeps its
    tracked sum and says so."""
    import torch

    assert PORT.device.torch_memory_stats(torch.device("cpu")) == {}
    led = PORT.device.HbmLedger()
    led.set_class("kv_pages", 10)
    assert led.refresh_from_device(torch.device("cpu")) is False
    assert led.refresh_from_device(None) is False
    assert led.snapshot()["invariant_ok"]


def _compile(m):
    clk = FakeClock()
    fl = m.flight.FlightRecorder()
    obs = m.device.CompileObservatory(clock=clk, storm_window_s=30.0,
                                      storm_threshold=3)
    reg = m.registry.MetricsRegistry()
    obs.bind_registry(reg)
    causes = [
        obs.note_program("decode_window", {"rows": 8, "k": 8}),
        obs.note_program("decode_window", {"rows": 16, "k": 8}),
        obs.note_program("decode_window", {"rows": 16, "k": 4}),
        obs.note_program("decode_window", {"rows": 16, "k": 4,
                                           "feats": ("gram",)}),
        obs.note_program("decode_window", {"rows": 16, "k": 4,
                                           "feats": ("gram",),
                                           "spec": 2}),
        obs.note_program("decode_window", {"rows": 16, "k": 4,
                                           "feats": ("gram",), "spec": 2,
                                           "zzz": 1}),
        obs.note_program("decode_window", {"rows": 16, "k": 4,
                                           "feats": ("gram",), "spec": 2,
                                           "zzz": 1}),
    ]
    import unittest.mock as mock

    with mock.patch.object(m.flight, "get_flight", lambda: fl):
        obs.note_program("prefill", {"tokens": 64})
        obs.on_compile(0.25)
        obs.on_compile(0.5)               # LIFO: decode_window's note
        clk.t += 200.0                    # the rest go stale
        obs.on_compile(0.125)             # unknown
        for i in range(4):
            obs.note_program("spec_window", {"rows": i})
            obs.on_compile(0.01)
        probe1 = obs.probe()
        clk.t += 100.0
        probe2 = obs.probe()
    obs.set_live_executables("spec_window", 4)
    return {"causes": causes, "snap": obs.snapshot(), "probe": (probe1,
            probe2), "events": [e["kind"] for e in fl.snapshot()["events"]],
            "exposition": reg.render()}


def test_compile_observatory_equal():
    out = _same(_compile)
    assert out["causes"] == ["first", "new_shape_bucket", "k_change",
                             "sampling_feature", "spec_toggle", "other",
                             "other"]
    snap = out["snap"]
    assert snap["unexplained_compiles"] == 1
    assert snap["storms_total"] == 1 and out["events"] == ["recompile_storm"]
    assert snap["programs"]["spec_window"]["live_executables"] == 4


class _Owner:
    """A storm-rule owner (the observatory holds owners weakly)."""


def test_storm_rule_counts_a_capture_against_its_own_engine():
    """Two engines capturing the same window keys raise no storm (each
    counts its own captures, and a key its engine saw counts once); one
    engine capturing five new keys inside 30 s still storms."""
    clk = FakeClock()
    obs = PORT.device.CompileObservatory(clock=clk)
    owners = {name: _Owner() for name in "abc"}
    keys = [(8, 0, True, False, (), (r,)) for r in (1, 2, 4, 8)]
    for owner in ("a", "b"):
        for key in keys:
            obs.note_program("decode_window", {"rows": key[-1]})
            obs.on_compile(0.01, owner=owners[owner], key=key)
            clk.t += 1.0
    # A key an engine already captured (its graph rebuilt) adds nothing.
    obs.note_program("decode_window", {"rows": 1})
    obs.on_compile(0.01, owner=owners["a"], key=keys[0])
    assert obs.snapshot()["storms_total"] == 0
    assert obs.probe()[2] == ""
    for r in (16, 32, 64, 128, 256):
        obs.note_program("decode_window", {"rows": r})
        obs.on_compile(0.01, owner=owners["c"],
                       key=(8, 0, True, False, (), (r,)))
        clk.t += 1.0
    assert obs.snapshot()["storms_total"] == 1
    assert obs.probe()[2] == "storming: decode_window"
    clk.t += 60.0
    assert obs.probe()[2] == ""


def test_storm_rule_across_two_engines_in_one_process():
    """Two tiny engines in one process capture the same K = 8 window keys
    (through ``_on_graph_capture``) on the process's one device plane:
    no storm."""
    from parallax_tpu_torch.obs.device import get_device_plane
    from tests._torch_qos import PKGS, engine

    plane = get_device_plane()
    before = plane.compile.snapshot()["storms_total"]
    p = PKGS["port"]
    for _ in range(2):
        eng = engine(p, None, True, 8, 64, 0)
        for shape in ((1,), (2,), (4,), (8,)):
            eng._on_graph_capture((8, 0, True, False, (), shape), 0.01)
    assert plane.compile.snapshot()["storms_total"] == before


def test_storm_rule_forgets_a_freed_engine():
    """An engine's storm windows go when it is freed, so an engine built
    after it starts with none: its captures of the same keys count, and
    five of them inside 30 s storm."""
    import gc

    from tests._torch_qos import PKGS, engine

    obs = PORT.device.CompileObservatory(clock=FakeClock())
    keys = [(8, 0, True, False, (), (r,)) for r in (1, 2, 4, 8, 16)]
    eng = engine(PKGS["port"], None, True, 8, 64, 0)
    eng._compile_obs = obs
    for key in keys[:4]:
        eng._on_graph_capture(key, 0.01)
    assert len(obs._windows) == 1
    del eng
    gc.collect()
    assert len(obs._windows) == 0
    eng = engine(PKGS["port"], None, True, 8, 64, 0)
    eng._compile_obs = obs
    for key in keys[:4]:
        eng._on_graph_capture(key, 0.01)
    assert obs.snapshot()["storms_total"] == 0
    eng._on_graph_capture(keys[4], 0.01)
    assert obs.snapshot()["storms_total"] == 1
    assert obs.probe()[2] == "storming: decode_window"


def _device_time(m):
    t = m.device.DeviceTimeAttributor()
    reg = m.registry.MetricsRegistry()
    t.bind_registry(reg)
    empty = t.snapshot()
    t.add("decode_window", 0.75)
    t.add("prefill", 0.25)
    t.add("prefill", 0.0)
    t.add("swap_gather", -1.0)
    return {"empty": empty, "snap": t.snapshot(), "exposition": reg.render()}


def test_device_time_equal():
    out = _same(_device_time)
    assert out["empty"]["share"] == {}
    assert out["snap"]["share"] == {"decode_window": 0.75, "prefill": 0.25}


def _node_payload(m, classes, programs, compiles):
    plane = m.device.DevicePlane(registry=m.registry.MetricsRegistry())
    for cls, nb in classes.items():
        plane.hbm.set_class(cls, nb)
    plane.hbm.set_capacity(10_000)
    for prog, s in programs.items():
        plane.time.add(prog, s)
    for fam, n in compiles.items():
        for i in range(n):
            plane.compile.note_program(fam, {"rows": i})
            plane.compile.on_compile(0.001)
    return plane.payload()


def _merge_device(m):
    a = _node_payload(m, {"weights_bfloat16": 4000, "kv_pages": 1000},
                      {"decode_window": 2.0, "prefill": 1.0},
                      {"decode_window": 2})
    b = _node_payload(m, {"weights_bfloat16": 4000, "spec_draft": 500},
                      {"spec_window": 1.0}, {"spec_window": 1})
    reg = m.registry.MetricsRegistry()
    merged = m.device.merge_device([a, b, None, {"junk": 1}], registry=reg)
    bad = dict(a, hbm=dict(a["hbm"], invariant_ok=False))
    strip = lambda p: {k: v for k, v in p.items() if k != "compile"}  # noqa: E731
    return {"merged": merged, "payload_keys": sorted(a),
            "poisoned": m.device.merge_device([a, bad])["hbm"]
            ["invariant_ok"],
            "none": m.device.merge_device([None], registry=reg),
            "a": strip(a), "exposition": reg.render()}


def test_merge_device_equal():
    out = _same(_merge_device)
    merged = out["merged"]
    assert merged["nodes"] == 2 and merged["nodes_skipped"] == 2
    assert merged["hbm"]["classes"] == {"weights_bfloat16": 8000,
                                        "kv_pages": 1000, "spec_draft": 500}
    assert set(merged["programs"]["seconds"]) == {
        "decode_window", "prefill", "spec_window"}
    assert out["poisoned"] is False and out["none"] is None
    assert out["payload_keys"] == ["compile", "hbm", "programs"]


# -- request metrics -------------------------------------------------------------


def _step_timing(m):
    reg = m.registry.MetricsRegistry()
    h = reg.histogram("host_ms", "h")
    agg = m.request_metrics.StepTimingAggregator(host_hist=h)
    empty = agg.summary()
    for host, dev, ov, tok in ((10.0, 2.0, False, 1), (20.0, 4.0, True, 8),
                               (5.0, 1.0, True, 0)):
        agg.update(host, dev, ov, tokens=tok)
    usage = 'data: {"usage": {"completion_tokens": 10, "prompt_tokens": 4}}'
    return {"empty": empty, "summary": agg.summary(),
            "render": reg.render(),
            "usage": m.request_metrics.parse_usage_chunk(usage),
            "done": m.request_metrics.parse_usage_chunk("data: [DONE]"),
            "metrics": m.request_metrics.request_metrics(usage, 1.0, 1.5,
                                                         3.5)}


def test_step_timing_and_request_metrics_equal():
    out = _same(_step_timing)
    assert out["empty"] is None
    assert out["summary"]["host_visits"] == 3
    assert out["summary"]["tokens"] == 9
    assert out["metrics"] == (5.0, 500, 4, 10)


def _cache_summary(m):
    class Tier:
        num_host_pages = 3
        capacity_pages = 10
        pages_demoted = 4
        pages_swapped_in = 2
        host_evictions = 1

    stats = m.request_metrics.CacheStats()
    stats.tokens_admitted = 100
    stats.tokens_hit_device = 30
    stats.tokens_hit_host = 10
    stats.preemptions = 2
    cache = types.SimpleNamespace(
        stats=stats, num_pages=64, num_free_pages=16,
        prefix_cache=types.SimpleNamespace(num_cached_pages=5),
        host_tier=Tier())
    return (m.request_metrics.cache_stats_summary(cache),
            m.request_metrics.cache_stats_summary(object()))


def test_cache_stats_summary_equal():
    summary, none = _same(_cache_summary)
    assert summary["prefix_hit_rate"] == 0.4 and none is None
    assert summary["page_occupancy"] == 0.75
    assert summary["host_pages"] == 3
