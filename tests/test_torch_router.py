"""The port's load balancer (``parallax_tpu_torch/router/lb.py``, on the
standard library) against ``parallax_tpu/router/lb.py``, on the CPU.

- tests/test_benchmark_and_router.py's ``TestRouterStrategies`` and
  ``TestSessionAffinity`` on both packages' strategies: the same picks
  and the same affinity keys.
- A live proxy in front of two of the port's ``serve`` frontends (tiny
  engines on the CPU, ``--qos on``): replies and SSE streams pass through
  unchanged, the QoS headers reach the replica (a bad deadline is its
  400), a session key stays on its replica, ``/router/status`` shows both
  replicas' EMAs, and once one replica is killed the probe marks it down
  and every request goes to the other with no 5xx.
"""

import http.client
import json
import threading
import time

import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

import parallax_tpu.router.lb as j_lb
import parallax_tpu_torch.router.lb as p_lb

LBS = {"jax": j_lb, "port": p_lb}


@pytest.fixture(params=["jax", "port"])
def lb(request):
    return LBS[request.param]


class TestRouterStrategies:
    def make_eps(self, lb):
        fast = lb.Endpoint(url="http://fast", healthy=True)
        fast.ema_ttft_s, fast.ema_tpot_s = 0.05, 0.01
        slow = lb.Endpoint(url="http://slow", healthy=True)
        slow.ema_ttft_s, slow.ema_tpot_s = 2.0, 0.2
        return [fast, slow]

    def test_performance_prefers_fast(self, lb):
        eps = self.make_eps(lb)
        strat = lb.Performance(top_k=1, explore_ratio=0.0)
        assert {strat.pick(eps).url for _ in range(10)} == {"http://fast"}

    def test_error_penalty_flips_choice(self, lb):
        eps = self.make_eps(lb)
        eps[0].error_count = 10
        strat = lb.Performance(top_k=1, explore_ratio=0.0)
        assert strat.pick(eps).url == "http://slow"

    def test_round_robin_cycles(self, lb):
        rr = lb.RoundRobin()
        eps = self.make_eps(lb)
        assert [rr.pick(eps).url for _ in range(4)] == [
            "http://slow", "http://fast", "http://slow", "http://fast"]

    def test_ema_update_and_score_equal(self):
        out = []
        for lb in LBS.values():
            ep = lb.Endpoint(url="x")
            ep.observe(1.0, 0.1)
            ep.observe(0.0, 0.0)
            ep.inflight, ep.error_count = 3, 2
            out.append((ep.ema_ttft_s, ep.ema_tpot_s, ep.score(),
                        ep.to_dict()))
        assert out[0] == out[1]
        assert 0.0 < out[1][0] < 1.0


class TestSessionAffinity:
    def make_eps(self, lb, n=3):
        return [lb.Endpoint(url=f"http://ep{i}", healthy=True)
                for i in range(n)]

    def test_same_key_pins_the_same_endpoint_in_both(self):
        picks = {}
        for name, lb in LBS.items():
            eps = self.make_eps(lb)
            strat = lb.SessionAffinity()
            picks[name] = [strat.pick(eps, key=f"user-{i}").url
                           for i in range(64)]
            assert len({strat.pick(eps, key="session-42").url
                        for _ in range(10)}) == 1
        assert picks["port"] == picks["jax"]
        assert set(picks["port"]) == {f"http://ep{i}" for i in range(3)}

    def test_unhealthy_pin_falls_back_to_performance(self, lb):
        eps = self.make_eps(lb)
        strat = lb.SessionAffinity()
        strat._fallback.explore_ratio = 0.0
        strat._fallback.top_k = 1
        pinned = strat.pick(eps, key="sticky")
        pinned.healthy = False
        healthy = [e for e in eps if e.healthy]
        best = healthy[0]
        best.ema_ttft_s, best.ema_tpot_s = 0.01, 0.001
        got = strat.pick(healthy, key="sticky", all_endpoints=eps)
        assert got is not pinned and got is best

    def test_flapping_other_endpoint_keeps_pin(self, lb):
        eps = self.make_eps(lb)
        strat = lb.SessionAffinity()
        pinned = strat.pick(eps, key="stable")
        other = next(e for e in eps if e is not pinned)
        other.healthy = False
        healthy = [e for e in eps if e.healthy]
        assert strat.pick(healthy, key="stable", all_endpoints=eps) is pinned

    def test_no_key_uses_performance(self, lb):
        eps = self.make_eps(lb)
        eps[1].ema_ttft_s, eps[1].ema_tpot_s = 0.01, 0.001
        strat = lb.SessionAffinity()
        strat._fallback.explore_ratio = 0.0
        strat._fallback.top_k = 1
        assert strat.pick(eps, key=None) is eps[1]

    def test_affinity_keys_equal(self):
        class FakeReq:
            def __init__(self, headers):
                self.headers = headers

        msgs = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hello"}]
        cases = [({"x-session-id": "s1"}, {}), ({"x-user-id": "u1"}, {}),
                 ({}, {"user": "u9"}), ({}, {"session_id": "s7"}),
                 ({}, {"messages": msgs}),
                 ({}, {"messages": msgs + [{"role": "assistant",
                                            "content": "hi"}]}),
                 ({}, {"prompt": "x" * 400}), ({}, {})]
        keys = {name: [lb.Router._affinity_key(FakeReq(h), b)
                       for h, b in cases] for name, lb in LBS.items()}
        assert keys["port"] == keys["jax"]
        assert keys["port"][4] == keys["port"][5]


# -- a live proxy over two of the port's serve frontends ---------------------


def _replica(qos: bool):
    """A tiny engine behind the port's serve frontend on a loopback port."""
    import jax
    import jax.numpy as jnp

    from parallax_tpu.config import normalize_config as j_normalize
    from parallax_tpu.models.base import StageModel as JStageModel
    from parallax_tpu_torch.backend.serve import build_local_frontend
    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.models import (
        create_stage_model,
        params_from_numpy,
    )
    from parallax_tpu_torch.qos import parse_qos_spec
    from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
    from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer
    from tests.test_torch_http import ENGINE, TINY

    jparams = JStageModel(j_normalize(TINY), 0, 2, use_pallas=False
                          ).init_params(jax.random.key(0),
                                        dtype=jnp.float32)
    engine = StageEngine(
        create_stage_model(normalize_config(TINY), 0, 2),
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        EngineConfig(**ENGINE, qos="on" if qos else None), device="cpu")
    fe, runner = build_local_frontend(
        [engine], SimpleTokenizer(), model_name="tiny",
        qos_config=parse_qos_spec("on") if qos else None)
    started = threading.Event()
    thread = threading.Thread(
        target=fe.run, daemon=True,
        kwargs=dict(host="127.0.0.1", port=0,
                    on_start=lambda _fe: started.set()))
    thread.start()
    assert started.wait(10)
    return fe, runner, thread


def _call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers=hdrs)
        resp = conn.getresponse()
        text = resp.read().decode()
        if resp.getheader("Content-Type", "").startswith(
                "application/json"):
            return resp.status, json.loads(text)
        return resp.status, text
    finally:
        conn.close()


def _stable(reply):
    """A completion body without its per-request id and timings."""
    if isinstance(reply, str):
        return [json.loads(line[6:])["choices"] for line in
                reply.splitlines()
                if line.startswith("data: ") and line != "data: [DONE]"]
    return reply["choices"], reply["usage"]["completion_tokens"]


@pytest.fixture(scope="module")
def fleet():
    replicas = [_replica(qos=True) for _ in range(2)]
    urls = [f"http://127.0.0.1:{fe.port}" for fe, _r, _t in replicas]
    router = p_lb.Router(urls, strategy="session_affinity",
                         probe_interval_s=0.2)
    port = router.start(host="127.0.0.1", port=0)
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline and not all(
            e.healthy for e in router.endpoints):
        time.sleep(0.05)
    assert all(e.healthy for e in router.endpoints)
    yield router, port, replicas
    router.stop()
    for fe, runner, thread in replicas:
        fe.shutdown()
        thread.join(10)
        runner.stop()


BODY = {"prompt": "The quick brown fox", "max_tokens": 8, "temperature": 0,
        "ignore_eos": True}


def test_proxy_passes_replies_and_streams_through(fleet):
    router, port, replicas = fleet
    direct = _call(replicas[0][0].port, "POST", "/v1/completions", BODY)
    via = _call(port, "POST", "/v1/completions", BODY)
    assert direct[0] == via[0] == 200
    assert _stable(via[1]) == _stable(direct[1])
    stream = dict(BODY, stream=True)
    d_status, d_text = _call(replicas[0][0].port, "POST",
                             "/v1/completions", stream)
    v_status, v_text = _call(port, "POST", "/v1/completions", stream)
    assert d_status == v_status == 200
    assert _stable(v_text) == _stable(d_text)
    assert v_text.rstrip().endswith("data: [DONE]")
    status, models = _call(port, "GET", "/v1/models")
    assert status == 200 and models["data"][0]["id"] == "tiny"


def test_qos_headers_reach_the_replica(fleet):
    _router, port, replicas = fleet
    status, body = _call(port, "POST", "/v1/completions", BODY,
                         {"x-parallax-deadline-ms": "soon"})
    assert status == 400 and "invalid QoS parameter" in json.dumps(body)
    status, _ = _call(port, "POST", "/v1/completions", BODY,
                      {"x-parallax-qos-class": "batch",
                       "x-parallax-tenant": "acme"})
    assert status == 200
    admitted = [fe.status_fn()["qos"]["counters"]["admitted"]
                for fe, _r, _t in replicas]
    assert sum(a.get("batch", 0) for a in admitted) == 1


def test_session_key_stays_on_its_replica_and_status_shows_emas(fleet):
    router, port, _replicas = fleet
    before = {e.url: e.total_requests for e in router.endpoints}
    for _ in range(4):
        assert _call(port, "POST", "/v1/completions", BODY,
                     {"x-session-id": "alice"})[0] == 200
    moved = {e.url: e.total_requests - before[e.url]
             for e in router.endpoints}
    assert sorted(moved.values()) == [0, 4]
    for key in ("bob", "carol", "dave", "erin", "frank", "grace"):
        assert _call(port, "POST", "/v1/completions", BODY,
                     {"x-session-id": key})[0] == 200
    status, st = _call(port, "GET", "/router/status")
    assert status == 200 and st["strategy"] == "session_affinity"
    assert len(st["endpoints"]) == 2
    assert all(e["ema_tpot_s"] is not None and e["total_requests"] > 0
               for e in st["endpoints"]), st
    status, tp = _call(port, "GET", "/router/throughput")
    assert status == 200 and sum(tp["tokens_per_minute"]) > 0


def test_killed_replica_falls_over_with_no_5xx(fleet):
    router, port, replicas = fleet
    fe, runner, thread = replicas[1]
    dead = f"http://127.0.0.1:{fe.port}"
    fe.shutdown()
    thread.join(10)
    fe.server.server_close()
    deadline = time.monotonic() + 10.0
    ep = next(e for e in router.endpoints if e.url == dead)
    while time.monotonic() < deadline and ep.healthy:
        time.sleep(0.05)
    assert not ep.healthy
    codes = [_call(port, "POST", "/v1/completions", BODY,
                   {"x-session-id": f"user-{i}"})[0] for i in range(8)]
    assert codes == [200] * 8
    stream = _call(port, "POST", "/v1/completions", dict(BODY, stream=True),
                   {"x-session-id": "user-3"})
    assert stream[0] == 200 and "[DONE]" in stream[1]


def test_router_control_apis():
    router = p_lb.Router(["http://127.0.0.1:9"], strategy="round_robin",
                         probe_interval_s=60.0)
    port = router.start(host="127.0.0.1", port=0)
    try:
        assert _call(port, "POST", "/v1/completions", BODY)[0] == 503
        assert _call(port, "POST", "/v1/completions", None)[0] == 400
        assert _call(port, "POST", "/router/endpoints",
                     {"url": "http://127.0.0.1:10/"})[1] == {
            "endpoints": ["http://127.0.0.1:9", "http://127.0.0.1:10"]}
        assert _call(port, "DELETE", "/router/endpoints",
                     {"url": "http://127.0.0.1:9"})[1] == {
            "endpoints": ["http://127.0.0.1:10"]}
        assert _call(port, "POST", "/router/strategy",
                     {"strategy": "nope"})[0] == 400
        assert _call(port, "POST", "/router/strategy",
                     {"strategy": "performance"})[1] == {
            "strategy": "performance"}
        assert _call(port, "GET", "/health")[1] == {"status": "ok"}
        assert _call(port, "GET", "/nowhere")[0] == 404
    finally:
        router.stop()
