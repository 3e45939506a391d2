"""The port's OpenAI HTTP plane (``parallax_tpu_torch/backend/http_server.py``
on the standard library, behind ``backend/serve.py::build_local_frontend``
on a real loopback socket) against the JAX frontend
(``parallax_tpu.backend.serve.build_local_frontend``, aiohttp test client)
serving the same tiny Qwen2 (float32, 2 layers, vocabulary 266, so the byte
tokenizer's text is meaningful), carried across with ``params_from_numpy``.

- Greedy chat and completions give equal text, finish reason and usage
  token counts; ``n`` choices; streaming (joined deltas equal the
  non-stream text, ``data: [DONE]``); the 400s; ``/health`` and
  ``/v1/models``.
- Stop strings (trimmed; held back while streaming) and whole UTF-8
  characters only, on the JAX tests' scripted backend, equal to the JAX
  frontend's output.
- Sampling features (penalties, ``logit_bias``, ``logprobs``,
  ``response_format``) answer 200 with the JAX frontend's replies, streamed
  and not; an unsupported schema answers 400 as in JAX.
- LoRA, which the engine still refuses at ``submit``, answers 501 with the
  refusal's text, and so do the endpoints of later slices; a client that
  disconnects stops its request.
- ``StageEngine.stop_request`` inside a K = 4 decode window already in
  flight does what the JAX engine does.
"""

import http.client
import json
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parallax_tpu.backend.http_server import OpenAIFrontend as JFrontend
from parallax_tpu.backend.serve import build_local_frontend as j_build
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.backend.http_server import (
    OpenAIFrontend,
    SimpleTokenizer,
)
from parallax_tpu_torch.backend.serve import build_local_frontend
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from test_http_serving import JoinTokenizer, ScriptedBackend, with_client

TINY = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=266, max_position_embeddings=512, torch_dtype="float32",
)
ENGINE = dict(page_size=8, num_pages=128, max_model_len=256,
              kv_dtype="float32")
CHAT = {"messages": [{"role": "user", "content": "hello there"}],
        "max_tokens": 10, "temperature": 0, "ignore_eos": True}
COMPLETION = {"prompt": "The quick brown fox", "max_tokens": 10,
              "temperature": 0, "ignore_eos": True}
BAD_BODIES = [
    ("/v1/completions", {"prompt": "", "max_tokens": 4}),
    ("/v1/completions", {"prompt": "p", "max_tokens": 4,
                         "seed": "not-a-number"}),
    ("/v1/completions", {"prompt": "p", "temperature": "hot"}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "x"}], "n": 0}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "x"}], "n": 9}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "x"}], "n": "two"}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "x"}],
                              "n": 2, "stream": True}),
    ("/v1/completions", {"prompt": "p", "response_format":
                         {"type": "xml"}}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "x"}],
                              "response_format": {
                                  "type": "json_schema",
                                  "json_schema": {"schema": {"type": "wat"}}}}),
    ("/v1/completions", {"prompt": "p", "response_format": {
        "type": "json_schema", "json_schema": {"name": "x",
                                               "strict": True}}}),
]
# Bodies with sampling features (once refused with 501): each answers 200
# with the JAX frontend's reply.
FEATURES = {
    "presence": {"presence_penalty": 0.5},
    "repetition": {"repetition_penalty": 1.2},
    "logit_bias": {"logit_bias": {"90": 5.0}},
    "logprobs": {"logprobs": True},
    "json_object": {"response_format": {"type": "json_object"},
                    "ignore_eos": False, "max_tokens": 24},
}


def _jax_params():
    cfg = j_normalize(TINY)
    params = JStageModel(cfg, 0, 2, use_pallas=False).init_params(
        jax.random.key(0), dtype=jnp.float32)
    return cfg, params


def _sse(raw: str) -> list[dict]:
    return [json.loads(line[6:]) for line in raw.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def _delta_text(chunks, chat: bool) -> str:
    if chat:
        return "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks)
    return "".join(c["choices"][0].get("text", "") for c in chunks)


# -- the two servers -----------------------------------------------------------


class PortServer:
    """The port's frontend served on a loopback port from a thread (the
    production ``OpenAIFrontend.run``), with a small http.client."""

    def __init__(self, frontend: OpenAIFrontend):
        self.fe = frontend
        started = threading.Event()
        self.thread = threading.Thread(
            target=frontend.run, daemon=True,
            kwargs=dict(host="127.0.0.1", port=0,
                        on_start=lambda fe: started.set()))
        self.thread.start()
        assert started.wait(10)
        self.port = frontend.port

    def request(self, method, path, body=None, raw_body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            data = raw_body if raw_body is not None else (
                None if body is None else json.dumps(body).encode())
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            text = resp.read().decode()
            ctype = resp.getheader("Content-Type", "")
            out = json.loads(text) if ctype.startswith(
                "application/json") else text
            return resp.status, out
        finally:
            conn.close()

    def close(self):
        self.fe.shutdown()
        self.thread.join(10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def port_server():
    _, jparams = _jax_params()
    model = create_stage_model(normalize_config(TINY), 0, 2)
    engine = StageEngine(
        model, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        EngineConfig(**ENGINE), device="cpu")
    fe, runner = build_local_frontend([engine], SimpleTokenizer(),
                                      model_name="tiny")
    server = PortServer(fe)
    server.runner = runner
    yield server
    server.close()
    runner.stop()


@pytest.fixture(scope="module")
def jax_replies():
    """Every reply the comparisons need from the JAX frontend, taken on one
    event loop (its app binds to the first loop it sees)."""
    cfg, params = _jax_params()
    engine = JStageEngine(JStageModel(cfg, 0, 2, use_pallas=False), params,
                          JEngineConfig(**ENGINE))
    fe, runner = j_build([engine], SimpleTokenizer(), model_name="tiny")

    async def fn(client):
        out = {}
        for name, path, body in (
            ("chat", "/v1/chat/completions", CHAT),
            ("completion", "/v1/completions", COMPLETION),
            ("n3", "/v1/chat/completions", {**CHAT, "n": 3}),
        ):
            resp = await client.post(path, json=body)
            out[name] = (resp.status, await resp.json())
        for name, path, body in (
            ("chat_stream", "/v1/chat/completions", CHAT),
            ("completion_stream", "/v1/completions", COMPLETION),
        ):
            resp = await client.post(path, json={**body, "stream": True})
            out[name] = (resp.status, await resp.text())
        for name, field in FEATURES.items():
            for kind, path, body in (
                ("chat", "/v1/chat/completions", CHAT),
                ("completion", "/v1/completions", COMPLETION),
            ):
                resp = await client.post(path, json={**body, **field})
                out[f"{name}_{kind}"] = (resp.status, await resp.json())
                resp = await client.post(
                    path, json={**body, **field, "stream": True})
                out[f"{name}_{kind}_stream"] = (resp.status,
                                                await resp.text())
        out["bad"] = []
        for path, body in BAD_BODIES:
            resp = await client.post(path, json=body)
            out["bad"].append(resp.status)
        resp = await client.post("/v1/completions", data=b"{not json")
        out["bad"].append(resp.status)
        for path in ("/health", "/v1/models"):
            resp = await client.get(path)
            out[path] = (resp.status, await resp.json())
        return out

    try:
        return with_client(fe.app, fn)
    finally:
        runner.stop()


# -- parity with the JAX frontend ----------------------------------------------


@pytest.mark.parametrize("kind", ["chat", "completion"])
def test_greedy_replies_match_jax(port_server, jax_replies, kind):
    path, body = (("/v1/chat/completions", CHAT) if kind == "chat"
                  else ("/v1/completions", COMPLETION))
    status, got = port_server.request("POST", path, body)
    want_status, want = jax_replies[kind]
    assert status == want_status == 200, got
    assert got["object"] == want["object"]
    gc, wc = got["choices"][0], want["choices"][0]
    if kind == "chat":
        assert gc["message"] == wc["message"]
        assert gc["message"]["role"] == "assistant"
    else:
        assert gc["text"] == wc["text"]
    assert gc["text" if kind != "chat" else "message"]
    assert gc["finish_reason"] == wc["finish_reason"] == "length"
    for key in ("prompt_tokens", "completion_tokens", "total_tokens"):
        assert got["usage"][key] == want["usage"][key], key
    assert got["model"] == "tiny" and got["id"].startswith("chatcmpl-")


def test_n_choices(port_server, jax_replies):
    status, got = port_server.request("POST", "/v1/chat/completions",
                                      {**CHAT, "n": 3})
    want = jax_replies["n3"][1]
    assert status == 200, got
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    # Greedy choices all equal the single greedy reply, as in JAX.
    assert got["choices"] == want["choices"]
    for key in ("prompt_tokens", "completion_tokens", "total_tokens"):
        assert got["usage"][key] == want["usage"][key], key
    assert got["usage"]["completion_tokens"] == 30
    # Seeded sampled choices: seed + i each, all answered.
    status, got = port_server.request(
        "POST", "/v1/completions",
        {**COMPLETION, "temperature": 0.9, "seed": 7, "n": 3})
    assert status == 200
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    assert got["usage"]["completion_tokens"] == 30


@pytest.mark.parametrize("kind", ["chat", "completion"])
def test_streaming_matches_non_stream_and_jax(port_server, jax_replies,
                                              kind):
    chat = kind == "chat"
    path, body = (("/v1/chat/completions", CHAT) if chat
                  else ("/v1/completions", COMPLETION))
    status, raw = port_server.request("POST", path, {**body, "stream": True})
    assert status == 200
    assert raw.strip().endswith("data: [DONE]")
    chunks = _sse(raw)
    want_chunks = _sse(jax_replies[f"{kind}_stream"][1])
    text = _delta_text(chunks, chat)
    # Joined deltas equal the non-stream reply and the JAX stream.
    want_text = jax_replies[kind][1]["choices"][0]
    want_text = want_text["message"]["content"] if chat else want_text["text"]
    assert text == want_text == _delta_text(want_chunks, chat)
    last = chunks[-1]
    assert last["object"] == want_chunks[-1]["object"]
    assert last["choices"][0]["finish_reason"] == "length"
    assert last["usage"]["completion_tokens"] == 10
    assert last["usage"]["ttft_ms"] > 0
    assert {c["id"] for c in chunks} == {last["id"]}


def test_bad_requests_answer_400_as_jax(port_server, jax_replies):
    got = [port_server.request("POST", path, body)[0]
           for path, body in BAD_BODIES]
    got.append(port_server.request("POST", "/v1/completions",
                                   raw_body=b"{not json")[0])
    assert got == jax_replies["bad"] == [400] * len(got)
    status, body = port_server.request("POST", "/v1/completions",
                                       {"prompt": ""})
    assert body == {"error": {"message": "empty prompt",
                              "type": "invalid_request_error"}}


def test_health_and_models_match_jax(port_server, jax_replies):
    for path in ("/health", "/v1/models"):
        assert port_server.request("GET", path) == jax_replies[path]


# -- refusals --------------------------------------------------------------------


def _logprob_entries(choice, chat):
    """(token texts, logprobs) of one choice's ``logprobs`` payload."""
    lp = choice.get("logprobs")
    if not lp:
        return [], []
    if chat:
        return ([e["token"] for e in lp["content"]],
                [e["logprob"] for e in lp["content"]])
    return lp["tokens"], lp["token_logprobs"]


@pytest.mark.parametrize("kind", ["chat", "completion"])
@pytest.mark.parametrize("name", list(FEATURES))
def test_feature_bodies_answer_200_as_jax(port_server, jax_replies, name,
                                          kind):
    """The bodies that once answered 501 answer 200 with the JAX
    frontend's text, finish reason, usage and logprob entries, streamed
    and not; a JSON-mode reply parses as JSON."""
    chat = kind == "chat"
    path, body = (("/v1/chat/completions", CHAT) if chat
                  else ("/v1/completions", COMPLETION))
    body = {**body, **FEATURES[name]}
    status, got = port_server.request("POST", path, body)
    want_status, want = jax_replies[f"{name}_{kind}"]
    assert status == want_status == 200, got
    gc, wc = got["choices"][0], want["choices"][0]
    text = gc["message"]["content"] if chat else gc["text"]
    want_text = wc["message"]["content"] if chat else wc["text"]
    assert text == want_text
    assert gc["finish_reason"] == wc["finish_reason"]
    for key in ("prompt_tokens", "completion_tokens", "total_tokens"):
        assert got["usage"][key] == want["usage"][key], key
    toks, lps = _logprob_entries(gc, chat)
    want_toks, want_lps = _logprob_entries(wc, chat)
    assert toks == want_toks
    np.testing.assert_allclose(lps, want_lps, atol=1e-4)
    if name == "logprobs":
        assert len(lps) == got["usage"]["completion_tokens"]
        assert all(lp <= 0.0 for lp in lps)
    if name == "json_object":
        json.loads(text)
    status, raw = port_server.request("POST", path, {**body, "stream": True})
    assert status == 200
    chunks = _sse(raw)
    want_chunks = _sse(jax_replies[f"{name}_{kind}_stream"][1])
    assert _delta_text(chunks, chat) == text == _delta_text(want_chunks,
                                                            chat)
    s_toks, s_lps = [], []
    for c in chunks:
        t, lp = _logprob_entries(c["choices"][0], chat)
        s_toks += t
        s_lps += lp
    assert s_toks == toks and s_lps == lps
    assert not port_server.runner.pipeline.has_work()


def test_response_format_parsing_and_400():
    """``_schema_from_body`` against the JAX frontend's on every form of
    ``response_format``: the same schema strings, and a ValueError (400)
    where JAX raises one."""
    from parallax_tpu.backend.http_server import _schema_from_body as j_fn
    from parallax_tpu_torch.backend.http_server import _schema_from_body

    bodies = [
        {}, {"response_format": {"type": "text"}},
        {"response_format": {"type": "json_object"}},
        {"response_format": {"type": "json_schema", "json_schema": {
            "name": "t", "schema": {"type": "boolean"}}}},
        {"response_format": {"type": "json_schema",
                             "json_schema": {"type": "boolean"}}},
    ]
    for body in bodies:
        assert _schema_from_body(body) == j_fn(body), body
    assert _schema_from_body(bodies[2]) == "{}"
    assert json.loads(_schema_from_body(bodies[3])) == {"type": "boolean"}
    for body in (
        {"response_format": {"type": "json_schema",
                             "json_schema": {"name": "x", "strict": True}}},
        {"response_format": {"type": "grammar"}},
        {"response_format": {"type": "json_schema", "json_schema": {
            "schema": {"type": "frobnicate"}}}},
        {"response_format": {"type": "json_schema", "json_schema": {
            "schema": {"type": "object", "required": ["ghost"]}}}},
    ):
        with pytest.raises(ValueError):
            j_fn(body)
        with pytest.raises(ValueError):
            _schema_from_body(body)


@pytest.mark.parametrize("field,feature", [
    ({"model": "tiny:adapter-a"}, "LoRA"),
    ({"lora": "adapter-a"}, "LoRA"),
])
def test_refused_features_answer_501(port_server, field, feature):
    for stream, n in ((False, 1), (True, 1), (False, 2)):
        body = {**COMPLETION, **field, "n": n}
        if stream:
            body["stream"] = True
        status, reply = port_server.request("POST", "/v1/completions", body)
        assert status == 501, reply
        message = reply["error"]["message"]
        assert feature in message and "not ported yet" in message
        assert reply["error"]["type"] == "invalid_request_error"
    # Nothing is left running.
    assert not port_server.runner.pipeline.has_work()


@pytest.mark.parametrize("method,path,item", [
    ("GET", "/metrics", 9), ("GET", "/healthz", 9),
    ("GET", "/debug/flight", 9), ("GET", "/debug/trace/r1", 9),
    ("GET", "/cluster/status", 9), ("GET", "/cluster/status_json", 9),
    ("POST", "/profile/start", 9), ("POST", "/weight/refit", 12),
])
def test_later_endpoints_answer_501(port_server, tmp_path, method, path,
                                    item):
    """Weight refit (item 12) still answers 501. The item-9 endpoints, the
    observability plane, are served now: each answers as the JAX
    frontend's does."""
    if item != 9:
        status, reply = port_server.request(method, path, {})
        assert status == 501
        assert f"item {item})" in reply["error"]["message"]
        assert "not ported yet" in reply["error"]["message"]
        return
    if path == "/cluster/status":
        # An ndjson stream: its first record is the serve status.
        conn = http.client.HTTPConnection("127.0.0.1", port_server.port,
                                          timeout=60)
        try:
            conn.request("GET", path + "?interval=0.25")
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.getheader("Content-Type") == "application/x-ndjson"
            assert json.loads(resp.readline())["mode"] == "single-host"
        finally:
            conn.close()
        return
    if path == "/profile/start":
        status, reply = port_server.request(
            method, path, {"dir": str(tmp_path), "max_seconds": 60})
        assert status == 200 and reply["profiling"] is True
        status, again = port_server.request(method, path, {})
        assert status == 409
        status, stop = port_server.request("POST", "/profile/stop", {})
        assert status == 200 and stop["profiling"] is False
        assert os.path.dirname(stop["trace"]) == str(tmp_path)
        return
    status, reply = port_server.request(method, path)
    if path == "/debug/trace/r1":
        assert status == 404 and "no trace recorded" in (
            reply["error"]["message"])
    elif path == "/metrics":
        assert status == 200
        assert "# TYPE parallax_goodput_tokens_total counter" in reply
    elif path == "/healthz":
        assert status == 200 and reply == {
            "status": "ok", "components": {}, "causes": []}
    elif path == "/debug/flight":
        assert status == 200 and {"requests", "slow", "events"} <= set(reply)
    else:
        assert status == 200 and reply["mode"] == "single-host"


def test_unknown_route_and_method(port_server):
    assert port_server.request("GET", "/v2/nothing")[0] == 404
    assert port_server.request("GET", "/v1/chat/completions")[0] == 405


# -- stop strings, UTF-8 and disconnects on the scripted backend --------------


def _scripted(tokens, tokenizer=None, interval_s=0.004, poll=0.002):
    """(port server, JAX frontend, port backend, JAX backend) over the JAX
    tests' scripted backend, which sets statuses both packages read."""
    tokenizer = tokenizer or JoinTokenizer()
    pb = ScriptedBackend(tokens, interval_s=interval_s)
    jb = ScriptedBackend(tokens, interval_s=interval_s)
    port = PortServer(OpenAIFrontend(tokenizer, submit_fn=pb.submit,
                                     model_name="scripted",
                                     stream_poll_s=poll, stop_fn=pb.stop))
    jfe = JFrontend(tokenizer, submit_fn=jb.submit, model_name="scripted",
                    stream_poll_s=poll, stop_fn=jb.stop)
    return port, jfe, pb, jb


def _jax_post(jfe, path, body, stream):
    async def fn(client):
        resp = await client.post(path, json=body)
        return resp.status, (await resp.text() if stream
                             else await resp.json())

    return with_client(jfe.app, fn)


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "stream"])
@pytest.mark.parametrize("stops", [["13"], ["15-16"], ["13", "12-1"], ["99"]])
def test_stop_strings_match_jax(stream, stops):
    port, jfe, pb, jb = _scripted(list(range(10, 30)))
    body = {"prompt": "p", "max_tokens": 50, "stop": stops,
            "stream": stream}
    try:
        status, got = port.request("POST", "/v1/completions", body)
    finally:
        port.close()
    want_status, want = _jax_post(jfe, "/v1/completions", body, stream)
    assert status == want_status == 200
    if stream:
        got, want = _sse(got), _sse(want)
        text = _delta_text(got, chat=False)
        assert text == _delta_text(want, chat=False)
        # Held back while a stop could still match: no delta ever sent
        # text past the stop (chunk boundaries follow the polls).
        sent = ""
        for c in got:
            sent += c["choices"][0]["text"]
            assert text.startswith(sent)
        got, want = got[-1], want[-1]
    gc, wc = got["choices"][0], want["choices"][0]
    assert gc["finish_reason"] == wc["finish_reason"]
    if not stream:
        assert gc["text"] == wc["text"]
        text = gc["text"]
    assert text == {"13": "10-11-12-", "15-16": "10-11-12-13-14-",
                    "12-1": "10-11-", "99": "-".join(
                        str(i) for i in range(10, 30))}[stops[-1]]
    matched = stops != ["99"]
    assert gc["finish_reason"] == ("stop" if matched else "length")
    assert bool(pb.stopped) == bool(jb.stopped) == matched


def test_streaming_never_emits_partial_utf8():
    # "é" = bytes C3 A9 split across two tokens: a poll landing between
    # them must not emit U+FFFD; the final text is the real character.
    port, _, _, _ = _scripted([0xC3, 0xA9, 0x41], SimpleTokenizer(),
                              interval_s=0.02)
    try:
        status, raw = port.request("POST", "/v1/completions",
                                   {"prompt": "p", "max_tokens": 50,
                                    "stream": True})
    finally:
        port.close()
    assert status == 200
    deltas = [c["choices"][0]["text"] for c in _sse(raw)]
    assert all("�" not in d for d in deltas), deltas
    assert "".join(deltas) == "éA"


@pytest.mark.parametrize("stream", [False, True], ids=["whole", "stream"])
def test_client_disconnect_stops_its_request(stream):
    port, _, pb, _ = _scripted(list(range(500)), interval_s=0.01)
    try:
        sock = socket.create_connection(("127.0.0.1", port.port), timeout=10)
        body = json.dumps({"prompt": "p", "max_tokens": 600,
                           "stream": stream}).encode()
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        deadline = time.monotonic() + 10
        while not pb.requests and time.monotonic() < deadline:
            time.sleep(0.01)
        if stream:
            assert sock.recv(15).startswith(b"HTTP/1.1 200")
        sock.close()
        while not pb.stopped and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        port.close()
    (req,) = pb.requests.values()
    assert pb.stopped == [req.request_id]
    assert req.status.value == "finished_stop"
    assert len(req.output_ids) < 500


# -- stop_request inside a decode window ----------------------------------------


def _stop_in_window(engine, request, sampling):
    """Submit, run the prefill step, dispatch a K = 4 window, stop the
    request while the window is in flight, resolve it; then one more step.
    Returns what each phase left."""
    engine.submit(request)
    engine.step()
    assert len(request.output_ids) == 1
    ticket = engine.dispatch()
    engine.stop_request(request.request_id)
    out = engine.resolve(ticket)
    seen = [r.request_id for r in out.finished]
    after = (list(request.output_ids), request.status.value,
             request.num_computed_tokens, engine.cache.num_free_pages)
    engine.stop_request("no-such-request")
    return seen, after, engine.has_work()


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_stop_request_inside_a_window_matches_jax(seeded):
    cfg, jparams = _jax_params()
    prompt = [int(x) for x in np.random.default_rng(2).integers(1, 250, 21)]
    kw = dict(ENGINE, decode_lookahead=4, overlap_steps=False)
    sp = dict(temperature=0.8, top_k=5, seed=3) if seeded else dict(
        temperature=0.0)
    jengine = JStageEngine(JStageModel(cfg, 0, 2, use_pallas=False), jparams,
                           JEngineConfig(**kw))
    jseen, jafter, jwork = _stop_in_window(
        jengine, JRequest("r", prompt_ids=list(prompt),
                          sampling_params=JSampling(max_new_tokens=12, **sp)),
        sp)
    engine = StageEngine(
        create_stage_model(normalize_config(TINY), 0, 2),
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        EngineConfig(**kw), device="cpu")
    seen, after, work = _stop_in_window(
        engine, Request("r", prompt_ids=list(prompt),
                        sampling_params=SamplingParams(max_new_tokens=12,
                                                       **sp)), sp)
    assert engine.kernel_dispatch_summary()["dispatch_total"].get(
        "torch/multistep") == 4
    # The stopped row commits none of the window's tokens, is collected
    # by the resolve and gives its pages back, as in JAX.
    assert seen == jseen == ["r"]
    assert after[1] == jafter[1] == "finished_stop"
    if not seeded:
        assert after[0] == jafter[0]
    assert len(after[0]) == len(jafter[0]) == 1
    assert after[2:] == jafter[2:]
    assert work is jwork is False


def test_keep_alive_connection_survives_refused_posts(port_server):
    """One HTTP/1.1 connection: a POST answered 501 or 404 before its body
    was needed leaves no bytes behind for the next request."""
    conn = http.client.HTTPConnection("127.0.0.1", port_server.port,
                                      timeout=60)
    try:
        for method, path, want in (
            ("POST", "/weight/refit", 501), ("POST", "/nowhere", 404),
            ("POST", "/v1/completions", 200), ("GET", "/health", 200),
        ):
            conn.request(method, path, body=json.dumps(
                {**COMPLETION, "max_tokens": 2}).encode())
            resp = conn.getresponse()
            resp.read()
            assert resp.status == want, (method, path)
    finally:
        conn.close()


# -- the run frontend's cluster status and routing ------------------------------

def _cluster_pair():
    """A port and a JAX GlobalScheduler after the same events: two
    Qwen2.5-7B-shaped nodes joined, beaten ready, one request routed."""
    from parallax_tpu.scheduling.request_routing import RequestMeta as JMeta
    from parallax_tpu.scheduling.scheduler import GlobalScheduler as JSched
    from parallax_tpu.utils.hw import HardwareInfo as JHW
    from parallax_tpu_torch.scheduling.request_routing import RequestMeta
    from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
    from parallax_tpu_torch.utils.hw import HardwareInfo

    raw = dict(architectures=["Qwen2ForCausalLM"], hidden_size=3584,
               num_hidden_layers=28, num_attention_heads=28,
               num_key_value_heads=4, intermediate_size=18944,
               vocab_size=152064)
    out = []
    for sched_cls, hw_cls, meta_cls, norm in (
            (JSched, JHW, JMeta, j_normalize),
            (GlobalScheduler, HardwareInfo, RequestMeta, normalize_config)):
        sched = sched_cls(norm(raw), min_nodes_bootstrapping=2,
                          routing="cache_aware")
        for nid in ("n0", "n1"):
            sched.enqueue_join(nid, hw_cls("v5e", 1, 197.0, 16.0, 819.0,
                                           186.0))
        sched.drain_events()
        for nid in ("n0", "n1"):
            sched.enqueue_update(nid, is_ready=True, load=0,
                                 cache_stats={"tokens_admitted": 3})
        sched.drain_events()
        sched.receive_request("r", meta=meta_cls("r", prompt_ids=[1] * 40))
        sched.dispatch_once()
        out.append(sched)
    return out


def test_cluster_status_json_keys_match_jax_scheduler():
    """``/cluster/status_json`` on a frontend with a status_fn serves the
    port scheduler's core cluster_status: its pipelines, node entries and
    routing section carry the JAX scheduler's keys (and values) for the
    same events; ``/cluster/status`` streams it as ndjson."""
    jsched, psched = _cluster_pair()
    server = PortServer(OpenAIFrontend(
        SimpleTokenizer(), submit_fn=None, model_name="tiny",
        status_fn=psched.cluster_status))
    try:
        status, got = server.request("GET", "/cluster/status_json")
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        conn.request("GET", "/cluster/status?interval=0.3")
        resp = conn.getresponse()
        ctype = resp.getheader("Content-Type")
        first = json.loads(resp.readline())
        conn.close()
    finally:
        server.close()
    assert status == 200 and ctype == "application/x-ndjson"
    want = json.loads(json.dumps(jsched.cluster_status()))
    for doc in (got, first):
        assert set(doc["routing"]) == set(want["routing"])
        assert doc["routing"] == want["routing"]
        assert len(doc["pipelines"]) == len(want["pipelines"]) == 1
        assert set(doc["pipelines"][0]) == set(want["pipelines"][0])
        for node, jnode in zip(doc["pipelines"][0]["nodes"],
                               want["pipelines"][0]["nodes"]):
            assert set(node) == set(jnode)
            assert {k: node[k] for k in ("node_id", "layers", "load", "ready",
                                         "role", "suspect", "cache_stats",
                                         "cache_index")} == \
                {k: jnode[k] for k in ("node_id", "layers", "load", "ready",
                                       "role", "suspect", "cache_stats",
                                       "cache_index")}
        for key in ("num_nodes", "num_active", "num_pipelines",
                    "bootstrapped", "max_concurrent_requests"):
            assert doc[key] == want[key], key


def test_route_fn_gets_the_prompt_ids():
    """The route_fn gets the request's prompt ids (its
    RequestMeta, for cache-aware routing) and ``lora_id``; a
    NotImplementedError from it answers 501; None answers 503."""
    seen = []

    def route(rid, prompt_ids=None, lora_id=None, **kw):
        seen.append((rid, prompt_ids, lora_id))
        if lora_id is not None:
            raise NotImplementedError("LoRA requests: not ported yet")
        return None

    tok = SimpleTokenizer()
    server = PortServer(OpenAIFrontend(tok, submit_fn=None, route_fn=route,
                                       model_name="tiny"))
    try:
        status, _ = server.request("POST", "/v1/completions",
                                   {"prompt": "abc", "max_tokens": 2})
        status_lora, reply = server.request(
            "POST", "/v1/completions",
            {"prompt": "abc", "max_tokens": 2, "lora": "a"})
    finally:
        server.close()
    assert status == 503 and status_lora == 501
    assert "not ported yet" in reply["error"]["message"]
    assert seen[0][1] == tok.encode("abc") and seen[1][2] == "a"


def test_chat_repl_streams_a_turn(capsys):
    """``chat`` (the JAX CLI's chat_main, on the standard library): one
    streamed turn against the HTTP API, its token count line, /clear and
    /quit."""
    from parallax_tpu_torch import cli

    port, _jfe, pb, _jb = _scripted(list(range(10, 16)))
    lines = iter(["hello", "/clear", "again", "/quit"])
    try:
        args = cli.build_parser().parse_args(
            ["chat", "--base-url", f"http://127.0.0.1:{port.port}",
             "--max-tokens", "6"])
        assert cli.unported_flags(args) == []
        assert cli.chat_main(args, input_fn=lambda _p: next(lines)) == 0
    finally:
        port.close()
    out = capsys.readouterr().out
    assert out.count("[6 tokens") == 2, out
    assert "error" not in out
