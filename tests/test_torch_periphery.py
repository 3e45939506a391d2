"""The port's periphery of the control plane on the CPU: ``/scheduler/init``
with a live model switch, and the web UI.

- ``POST /scheduler/init`` on the port's frontend answers as
  tests/test_periphery.py::test_scheduler_init_endpoint_switches_model
  does on the JAX one (200 with ``num_layers``, 400 for a missing field
  or an unknown model, ``/v1/models`` following the switch), 500 when the
  hook fails and 501 on a frontend without one.
- ``make_scheduler_init_fn`` swaps a fresh scheduler into the running
  service, keeping the routing strategy and its tuning.
- The web UI: the page and the chat page are the JAX package's bytes, the
  inline script passes tests/test_periphery.py's lexical check, the routes
  answer, and the model catalog equals the JAX one on every field but the
  chip estimate, whose formula at 16 GiB a device gives the JAX
  ``min_chips_16g``.
- A scheduled CPU swarm switched from a tiny Qwen2 config to a tiny Qwen3
  one (q / k norms) by ``/scheduler/init``: the workers rejoin, resolve
  and reload once each; the post-switch greedy and seeded streams equal
  the port's in-process pipeline on the same weights bit for bit, and the
  greedy ones the JAX engine's on the carried weights under the
  tie-tolerant rule. A switch whose resolve fails keeps the old name and
  retries on later heartbeats until it succeeds.
"""

import contextlib
import http.client
import json
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.backend import webui
from parallax_tpu_torch.backend.http_server import OpenAIFrontend
from parallax_tpu_torch.backend.run import (
    SwarmClient,
    build_swarm_frontend,
    make_scheduler_init_fn,
)
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.models.presets import get_preset
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import LoopbackTransport, TcpTransport
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from parallax_tpu_torch.utils.tokenizer import SimpleTokenizer
from tests.test_torch_sched_swarm import two_layer_capacity  # noqa: F401
from tests.test_torch_swarm import DEADLINE_S, ENGINE, RAW, _wait


def _request(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=DEADLINE_S)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data
    finally:
        conn.close()


@contextlib.contextmanager
def serving(frontend: OpenAIFrontend):
    """``frontend`` on a free port; yields the port."""
    started = threading.Event()
    thread = threading.Thread(
        target=frontend.run, daemon=True,
        kwargs=dict(host="127.0.0.1", port=0,
                    on_start=lambda _fe: started.set()))
    thread.start()
    assert started.wait(DEADLINE_S)
    try:
        yield frontend.port
    finally:
        frontend.shutdown()
        thread.join(DEADLINE_S)


def _json(port, method, path, body=None):
    status, _h, data = _request(port, method, path, body)
    return status, json.loads(data)


# -- /scheduler/init -----------------------------------------------------------


def test_scheduler_init_endpoint_switches_model():
    calls = []

    def init_fn(model_name, n):
        if model_name == "bogus":
            raise ValueError("unknown model bogus")
        if model_name == "broken":
            raise RuntimeError("the scheduler would not start")
        calls.append((model_name, n))
        return {"num_layers": 4}

    fe = OpenAIFrontend(SimpleTokenizer(), submit_fn=lambda r: None,
                        model_name="old-model", scheduler_init_fn=init_fn)
    with serving(fe) as port:
        status, body = _json(port, "POST", "/scheduler/init", {
            "model_name": "qwen2.5-0.5b", "init_nodes_num": 2})
        assert status == 200, body
        assert body["type"] == "scheduler_init"
        assert body["data"] == {"model_name": "qwen2.5-0.5b",
                                "init_nodes_num": 2, "num_layers": 4}
        assert _json(port, "POST", "/scheduler/init", {})[0] == 400
        assert _json(port, "POST", "/scheduler/init",
                     {"model_name": "x"})[0] == 400
        status, body = _json(port, "POST", "/scheduler/init", {
            "model_name": "bogus", "init_nodes_num": 1})
        assert status == 400 and "bogus" in body["error"]
        status, body = _json(port, "POST", "/scheduler/init", {
            "model_name": "broken", "init_nodes_num": 1})
        assert status == 500 and "would not start" in body["error"]
        _, models = _json(port, "GET", "/v1/models")
        assert models["data"][0]["id"] == "qwen2.5-0.5b"
    assert calls == [("qwen2.5-0.5b", 2)]


def test_scheduler_init_without_a_hook_answers_501():
    fe = OpenAIFrontend(SimpleTokenizer(), submit_fn=lambda r: None)
    with serving(fe) as port:
        status, body = _json(port, "POST", "/scheduler/init", {
            "model_name": "qwen3-8b", "init_nodes_num": 1})
        assert status == 501
        assert body["error"] == "model switch unavailable in this mode"


def test_swarm_scheduler_swap_rebootstraps():
    old_model = get_preset("qwen2.5-0.5b")
    sched = GlobalScheduler(old_model, min_nodes_bootstrapping=1,
                            routing="cache_aware",
                            routing_kwargs={"alpha": 2.0})
    service = SchedulerService(sched, LoopbackTransport("sched", {}))
    sched.start()
    try:
        init = make_scheduler_init_fn(service, get_preset)
        assert init("qwen3-8b", 1) == {"num_layers": 36}
        assert service.scheduler is not sched
        assert service.scheduler.model.num_hidden_layers == 36
        assert service.scheduler.routing_name == "cache_aware"
        assert service.scheduler.routing_kwargs == {"alpha": 2.0}
        with pytest.raises(ValueError):
            init("not-a-model", 1)
    finally:
        service.scheduler.stop()


# -- the web UI ----------------------------------------------------------------


def test_webui_pages_are_the_jax_bytes():
    from parallax_tpu.backend import http_server as jhttp
    from parallax_tpu.backend import webui as jwebui

    assert webui.PAGE == jwebui.PAGE
    assert webui.CHAT_PAGE == jhttp._CHAT_HTML


def test_webui_inline_script_is_lexically_valid():
    """The page ships one inline script from a Python string; a cooked
    escape (a raw newline inside a JS string literal) kills the whole
    dashboard at parse time. The lexer of tests/test_periphery.py."""
    script = re.search(r"<script>(.*)</script>", webui.PAGE, re.S).group(1)
    state = None
    esc = False
    depth = {"(": 0, "[": 0, "{": 0}
    close = {")": "(", "]": "[", "}": "{"}
    in_comment = None
    prev = ""
    errors = []
    line = 1
    for ch in script:
        if ch == "\n":
            line += 1
        if in_comment == "//":
            if ch == "\n":
                in_comment = None
            prev = ch
            continue
        if in_comment == "/*":
            if prev == "*" and ch == "/":
                in_comment = None
            prev = ch
            continue
        if state is None:
            if ch == "/" and prev == "/":
                in_comment = "//"
            elif ch == "*" and prev == "/":
                in_comment = "/*"
            elif ch in "'\"`":
                state = ch
            elif ch in depth:
                depth[ch] += 1
            elif ch in close:
                depth[close[ch]] -= 1
        else:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == state:
                state = None
            elif ch == "\n" and state in "'\"":
                errors.append(f"line {line}: raw newline in {state} string")
                state = None
        prev = ch
    assert state is None, "unterminated string literal"
    assert not errors, errors
    assert depth == {"(": 0, "[": 0, "{": 0}, depth


def test_webui_model_catalog_matches_the_jax_one():
    from parallax_tpu.backend.webui import _model_catalog as j_catalog

    want = j_catalog()
    got = webui._model_catalog(16 * 2**30)
    assert [m["name"] for m in got] == [m["name"] for m in want]
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        # At 16 GiB a device the port's formula is the JAX chip estimate.
        assert g.pop("min_devices") == w.pop("min_chips_16g"), g["name"]
        assert g == w
    by_name = {m["name"]: m for m in webui._model_catalog(80 * 2**30)}
    assert by_name["Qwen/Qwen2.5-7B-Instruct"]["min_devices"] == 1
    assert by_name["Qwen/Qwen3-235B-A22B"]["min_devices"] > 1
    assert all(m["min_devices"] is None for m in webui._model_catalog(None))


def test_webui_routes_answer():
    fe = OpenAIFrontend(SimpleTokenizer(), submit_fn=lambda r: None,
                        model_name="tiny", device_memory_bytes=80 * 2**30)
    with serving(fe) as port:
        status, headers, data = _request(port, "GET", "/ui")
        assert status == 200 and data.decode() == webui.PAGE
        assert headers["Content-Type"].startswith("text/html")
        status, _h, data = _request(port, "GET", "/chat")
        assert status == 200 and data.decode() == webui.CHAT_PAGE
        status, headers, _ = _request(port, "GET", "/")
        assert status == 302 and headers["Location"] == "/ui"
        status, meta = _json(port, "GET", "/ui/meta")
        assert status == 200 and meta["models"][0] == "tiny"
        assert "qwen3-8b" in meta["models"] and meta["scheduler_addr"] == ""
        status, cat = _json(port, "GET", "/ui/models")
        assert status == 200 and cat["device_memory_bytes"] == 80 * 2**30
        assert len(cat["models"]) >= 60
        assert {m["min_devices"] for m in cat["models"]} - {None} >= {1}


# -- a live model switch on a scheduled swarm ----------------------------------

RAW_B = dict(architectures=["Qwen3ForCausalLM"], hidden_size=64,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=270, max_position_embeddings=256,
             tie_word_embeddings=False, torch_dtype="float32")
RAWS = {"tiny-a": RAW, "tiny-b": RAW_B, "tiny-c": RAW_B}
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5, 4, 3, 2, 1, 10],
           [200, 17, 5, 99, 31]]
N_NEW = 8
TOL = 5e-3
_TREES: dict = {}


def _jtree(name: str, s: int, e: int):
    """Stage [s, e) of model ``name``: its JAX random tree and numpy twin."""
    key = (name, s, e)
    if key not in _TREES:
        tree = JStageModel(j_normalize(RAWS[name]), s, e,
                           use_pallas=False).init_params(
            jax.random.key(7 * s + e), dtype=jnp.float32)
        _TREES[key] = (tree, jax.tree.map(np.asarray, tree))
    return _TREES[key]


def _loader(name: str):
    return lambda model: params_from_numpy(
        _jtree(name, model.start_layer, model.end_layer)[1], "cpu")


def _requests(cls_req, cls_sp, seeded=True):
    out = []
    for i, p in enumerate(PROMPTS):
        kw = (dict(temperature=0.8, top_k=20, seed=11)
              if seeded and i == 2 else dict(temperature=0.0))
        out.append(cls_req(f"s{i}", prompt_ids=list(p),
                           sampling_params=cls_sp(max_new_tokens=N_NEW,
                                                  **kw)))
    return out


def _port_pipeline(name: str):
    cfg = normalize_config(RAWS[name], model_name=name)
    pipe = InProcessPipeline([
        StageEngine(create_stage_model(cfg, s, e),
                    _loader(name)(create_stage_model(cfg, s, e)),
                    EngineConfig(**ENGINE), device="cpu")
        for s, e in [(0, 2), (2, 4)]])
    reqs = _requests(Request, SamplingParams)
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def _jax_streams(name: str):
    jcfg = j_normalize(RAWS[name])
    pipe = JPipeline([
        JStageEngine(JStageModel(jcfg, s, e, use_pallas=False),
                     _jtree(name, s, e)[0], JEngineConfig(**ENGINE))
        for s, e in [(0, 2), (2, 4)]])
    reqs = _requests(JRequest, JSampling, seeded=False)
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return [r.output_ids for r in reqs]


def _jax_logits(name: str, ctx: list[int]) -> np.ndarray:
    """The JAX model's logits at every position of ``ctx``."""
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = JStageModel(j_normalize(RAWS[name]), 0, 4, use_pallas=False)
    s0, s1 = _jtree(name, 0, 2)[0], _jtree(name, 2, 4)[0]
    tree = {"embed_tokens": s0["embed_tokens"],
            "layers": list(s0["layers"]) + list(s1["layers"]),
            "norm": s1["norm"], "lm_head": s1["lm_head"]}
    page = 8
    npages = (n + page - 1) // page
    kv = model.new_kv_caches(npages + 1, page, jnp.float32)
    tok = np.zeros(t, np.int32)
    tok[:n] = ctx
    pos = np.zeros(t, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(t, -1, np.int32)
    slots[:n] = np.arange(n) + page
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray([n], jnp.int32),
        page_indices=jnp.asarray(np.arange(1, npages + 1)[None], jnp.int32),
        cu_q_lens=jnp.asarray([0, n], jnp.int32),
        num_seqs=jnp.asarray([1], jnp.int32), slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32))
    logits, _ = model(tree, kv, inp)
    return np.asarray(logits)[:n]


@contextlib.contextmanager
def switchable_swarm(worker_knows):
    """A port scheduler on tiny-a behind ``run``'s frontend (served on a
    free port) and two port workers whose ``resolve_model`` takes the
    names in ``worker_knows``; yields (port, service, workers, loads),
    ``loads`` a list of (node, model name) per stage load."""
    cfg_a = normalize_config(RAW, model_name="tiny-a")
    loads = []

    def frontend_resolve(name):
        if name not in RAWS:
            raise ValueError(f"unknown model {name}")
        return normalize_config(RAWS[name], model_name=name)

    def worker(i):
        t = TcpTransport("", "127.0.0.1")
        t.start()
        t.peer_id = t.address

        def resolve(name):
            if name not in worker_knows:
                raise RuntimeError(f"{name} is not on this worker")
            cfg = normalize_config(RAWS[name], model_name=name)
            load = _loader(name)
            return cfg, lambda m: (loads.append((i, name)), load(m))[1]

        return WorkerNode(t, sched_t.address, cfg_a, EngineConfig(**ENGINE),
                          load_params=lambda m: (loads.append((i, "tiny-a")),
                                                 _loader("tiny-a")(m))[1],
                          heartbeat_interval_s=0.2, device="cpu",
                          resolve_model=resolve)

    sched = GlobalScheduler(cfg_a, min_nodes_bootstrapping=2)
    sched_t = TcpTransport("scheduler", "127.0.0.1")
    frontend, service, _client = build_swarm_frontend(
        sched, sched_t, SimpleTokenizer(), "tiny-a",
        resolve_model=frontend_resolve,
        tokenizer_fn=lambda name: SimpleTokenizer())
    workers = []
    try:
        service.start()
        workers = [worker(i) for i in range(2)]
        starters = [threading.Thread(target=w.start) for w in workers]
        for s in starters:
            s.start()
        for s in starters:
            s.join(DEADLINE_S)
        assert _wait(lambda: _ready(service, "tiny-a"))
        with serving(frontend) as port:
            yield port, service, workers, loads
    finally:
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        service.stop()


def _ready(service, name: str) -> bool:
    sched = service.scheduler
    nodes = [n for p in sched.cluster_status()["pipelines"]
             for n in p["nodes"]]
    return (sched.model.model_name == name and len(nodes) == 2
            and all(n["ready"] for n in nodes))


def _serve(service, reqs):
    client = SwarmClient(service.transport, service)
    events = []
    for r in reqs:
        r.routing_table = client.route(r.request_id,
                                       prompt_ids=r.prompt_ids)
        events.append(client.submit(r))
    for r, ev in zip(reqs, events):
        assert ev.wait(DEADLINE_S), f"{r.request_id}: {r.status}"
        assert r.status.value == "finished_length", r.status
        assert len(r.output_ids) == N_NEW
    return reqs


def test_scheduled_swarm_switches_model_by_scheduler_init():
    with switchable_swarm({"tiny-b"}) as (port, service, workers, loads):
        assert sorted(loads) == [(0, "tiny-a"), (1, "tiny-a")]
        status, body = _json(port, "POST", "/scheduler/init", {
            "model_name": "tiny-b", "init_nodes_num": 2})
        assert status == 200 and body["data"]["num_layers"] == 4
        assert _wait(lambda: _ready(service, "tiny-b")
                     and all(w.engine is not None
                             and w._served_model_name == "tiny-b"
                             for w in workers))
        _, models = _json(port, "GET", "/v1/models")
        assert models["data"][0]["id"] == "tiny-b"
        # One stage load per worker per model, and a Qwen3 stage each.
        assert sorted(loads) == [(0, "tiny-a"), (0, "tiny-b"),
                                 (1, "tiny-a"), (1, "tiny-b")]
        assert all(w.model_config.architecture == "Qwen3ForCausalLM"
                   for w in workers)
        seeded = _serve(service, _requests(Request, SamplingParams))
        greedy = _serve(service, [
            Request(f"g{r.request_id}", prompt_ids=r.prompt_ids,
                    sampling_params=r.sampling_params)
            for r in _requests(Request, SamplingParams, seeded=False)])
    assert [r.output_ids for r in seeded] == [
        r.output_ids for r in _port_pipeline("tiny-b")]
    for r, want in zip(greedy, _jax_streams("tiny-b")):
        logits = _jax_logits("tiny-b", r.prompt_ids + r.output_ids[:-1])
        p0 = len(r.prompt_ids) - 1
        for i, tok in enumerate(r.output_ids):
            row = logits[p0 + i]
            assert float(row.max() - row[tok]) < TOL, (r.request_id, i)
        same = 0
        while same < N_NEW and r.output_ids[same] == want[same]:
            same += 1
        if same < N_NEW:
            row = logits[p0 + same]
            assert abs(float(row[r.output_ids[same]]
                             - row[want[same]])) < TOL


def test_failed_switch_keeps_the_old_name_and_retries():
    """The frontend knows tiny-c, the workers do not yet: each keeps the
    name it serves (tiny-a), retries the resolve on later heartbeats, and
    switches once its resolver takes the name."""
    knows = {"tiny-b"}
    attempts = []
    with switchable_swarm(knows) as (port, service, workers, loads):
        for w in workers:
            real = w.resolve_model

            def counting(name, real=real):
                attempts.append(name)
                return real(name)

            w.resolve_model = counting
        status, _ = _json(port, "POST", "/scheduler/init", {
            "model_name": "tiny-c", "init_nodes_num": 2})
        assert status == 200
        # Several failed resolves per worker, the old name kept.
        assert _wait(lambda: attempts.count("tiny-c") >= 4)
        assert all(w._served_model_name == "tiny-a" for w in workers)
        assert sorted(loads) == [(0, "tiny-a"), (1, "tiny-a")]
        knows.add("tiny-c")
        assert _wait(lambda: all(w._served_model_name == "tiny-c"
                                 and w.engine is not None
                                 and w.model_config.model_name == "tiny-c"
                                 for w in workers))
        assert sorted(loads) == [(0, "tiny-a"), (0, "tiny-c"),
                                 (1, "tiny-a"), (1, "tiny-c")]
        assert _wait(lambda: _ready(service, "tiny-c"))
        _serve(service, _requests(Request, SamplingParams, seeded=False))
