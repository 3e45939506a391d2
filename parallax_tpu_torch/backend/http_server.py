"""OpenAI-compatible HTTP frontend on the standard library (port of
``parallax_tpu/backend/http_server.py``).

The same routes, JSON bodies, SSE chunks, ``usage``, finish reasons and
error shape as the JAX frontend for ``/health``, ``/v1/models``,
``/v1/chat/completions`` and ``/v1/completions`` (streaming and not, ``n``
choices, stop strings with hold-back), served by
``http.server.ThreadingHTTPServer``: one thread per connection, no aiohttp.

Handler threads touch no CUDA tensor: they tokenize and detokenize on the
host and read each request's committed ids (a Python list), while the
backend's own thread steps the engine (whose CUDA-graph captures allow no
CUDA call from another thread). Sampling features ride the body as in the
JAX frontend: penalties, ``logit_bias``, ``response_format`` (its schema
compiled at admission, 400 if unsupported) and ``logprobs`` (chat
``content`` entries, completions ``tokens`` / ``token_logprobs``, streamed
and not). A request asking for a feature the engine's ``submit`` refuses
(a LoRA adapter) gets HTTP 501 with that refusal's text; the
endpoints of later slices (metrics, debug, profiling, weight refit) answer
501 "not ported yet". ``/cluster/status`` (an ndjson stream) and
``/cluster/status_json`` serve a ``status_fn`` where the frontend has one
(the ``run`` frontend: the scheduler's core ``cluster_status()``), and
answer 501 elsewhere (item 9).

``POST /scheduler/init`` (``{"model_name", "init_nodes_num"}``) switches
the served model through ``scheduler_init_fn`` (the ``run`` frontend's:
``backend/run.py::make_scheduler_init_fn``) and answers its
``num_layers``; 400 for a missing field or an unknown model, 500 when the
hook fails, 501 on a frontend without one, as the JAX frontend answers;
``/v1/models`` follows the switch. The web UI (``backend/webui.py``)
serves ``/ui``, ``/ui/meta``, ``/ui/models`` and ``/chat``; ``/``
redirects to ``/ui``.
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import select
import socket
import time
import uuid

from parallax_tpu_torch.backend.webui import register_ui, ui_model_names
from parallax_tpu_torch.constrained import validate_schema
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.utils import get_logger

# SimpleTokenizer / load_tokenizer live in utils.tokenizer; re-exported here
# as the JAX module does.
from parallax_tpu_torch.utils.tokenizer import (  # noqa: F401
    SimpleTokenizer,
    load_tokenizer,
)

logger = get_logger(__name__)

# Endpoints of the JAX frontend that wait for later slices: path (or path
# prefix, ending in "/") -> the ROADMAP queue 1 item that ports them.
UNPORTED_ENDPOINTS = {
    "/metrics": 9,
    "/healthz": 9,
    "/debug/": 9,
    "/cluster/status": 9,
    "/cluster/status_json": 9,
    "/profile/": 9,
    "/weight/refit": 12,
}
_POLL_DEADLINE_S = 600.0


def _unported_item(path: str) -> int | str | None:
    item = UNPORTED_ENDPOINTS.get(path)
    if item is not None:
        return item
    for prefix, item in UNPORTED_ENDPOINTS.items():
        if prefix.endswith("/") and prefix != "/" and path.startswith(prefix):
            return item
    return None


def _schema_from_body(body: dict) -> str | None:
    """OpenAI ``response_format`` -> schema string for constrained decoding.

    ``{"type": "json_object"}`` -> "{}" (any JSON); ``{"type":
    "json_schema", "json_schema": {"schema": {...}}}`` -> that schema.
    Raises ValueError (mapped to 400 by the caller) on unknown types and
    on schemas the grammar compiler does not support.
    """
    rf = body.get("response_format")
    if not rf:
        return None
    kind = rf.get("type") if isinstance(rf, dict) else None
    if kind in (None, "text"):
        return None
    if kind == "json_object":
        schema = "{}"
    elif kind == "json_schema":
        spec = rf.get("json_schema") or {}
        schema_keys = (
            "type", "enum", "const", "anyOf", "oneOf", "properties",
        )
        if "schema" in spec:
            inner = spec["schema"]
        elif any(k in spec for k in schema_keys):
            inner = spec          # schema passed inline, unwrapped
        else:
            raise ValueError(
                "response_format.json_schema needs a 'schema' object"
            )
        schema = json.dumps(inner)
    else:
        raise ValueError(f"unsupported response_format type: {kind!r}")
    # Compile-check (cached on the schema string) so an unsupported schema
    # answers 400 before any token runs.
    validate_schema(schema)
    return schema


def _sampling_from_body(body: dict, default_max: int = 512) -> SamplingParams:
    seed = body.get("seed")
    if seed is not None:
        seed = int(seed)  # ValueError -> 400 in the caller
    logit_bias = body.get("logit_bias") or None
    if logit_bias is not None:
        if not isinstance(logit_bias, dict):
            raise ValueError("logit_bias must be an object of "
                             "token_id -> bias")
        logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
    return SamplingParams(
        json_schema=_schema_from_body(body),
        logit_bias=logit_bias,
        temperature=float(body.get("temperature", 1.0)),
        top_p=float(body.get("top_p", 1.0)),
        top_k=int(body.get("top_k", -1)),
        min_p=float(body.get("min_p", 0.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        max_new_tokens=int(
            body.get("max_tokens")
            or body.get("max_completion_tokens")
            or default_max
        ),
        stop_strings=tuple(
            [body["stop"]] if isinstance(body.get("stop"), str)
            else body.get("stop") or ()
        ),
        ignore_eos=bool(body.get("ignore_eos", False)),
        seed=seed,
        logprobs=bool(body.get("logprobs", False)),
    )


class IncrementalDecoder:
    """Streaming detokenizer with bounded per-update work.

    BPE detokenization is context-dependent, so per-token-span decodes break
    leading spaces and multi-byte UTF-8. Decoding the whole output every
    poll is O(n^2). This uses the standard two-offset scheme: decode a short
    window ``ids[prefix_offset:n]``, emit only once the window doesn't end in
    a partial character (U+FFFD), then slide the window.
    """

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.prefix_offset = 0
        self.read_offset = 0
        self.text = ""  # decoded-and-stable text; grows append-only

    def update(self, ids: list[int]) -> str:
        """Feed the full token list; returns the stable decoded text."""
        n = len(ids)
        if n > self.read_offset:
            prefix = self.tok.decode(ids[self.prefix_offset:self.read_offset])
            window = self.tok.decode(ids[self.prefix_offset:n])
            if len(window) > len(prefix) and not window.endswith("�"):
                self.text += window[len(prefix):]
                self.prefix_offset = self.read_offset
                self.read_offset = n
        return self.text

    def finalize(self, ids: list[int]) -> str:
        """Flush everything, including a trailing partial character."""
        prefix = self.tok.decode(ids[self.prefix_offset:self.read_offset])
        window = self.tok.decode(ids[self.prefix_offset:])
        if len(window) > len(prefix):
            self.text += window[len(prefix):]
            self.prefix_offset = self.read_offset = len(ids)
        return self.text


def _stop_holdback(text: str, stops) -> int:
    """Chars to hold back: the longest text suffix that is a proper prefix
    of some stop string (it may complete into a match next poll)."""
    hold = 0
    for s in stops:
        for n in range(min(len(s) - 1, len(text)), 0, -1):
            if text.endswith(s[:n]):
                hold = max(hold, n)
                break
    return hold


class _GenFailed(Exception):
    """A request aborted or timed out before completing."""


class _ClientGone(Exception):
    """The client closed its connection while its request ran."""


class _Reply(Exception):
    """An error reply, raised out of the generation path."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class _StopScanner:
    """Stop-string search that only rescans text appended since last call
    (minus a max-stop-length overlap), keeping per-poll cost O(delta)."""

    def __init__(self, stops):
        self.stops = [s for s in stops if s]
        self._overlap = max((len(s) for s in self.stops), default=1) - 1
        self._pos = 0

    def find(self, text: str) -> int | None:
        if not self.stops:
            return None
        start = max(0, self._pos - self._overlap)
        best = None
        for s in self.stops:
            i = text.find(s, start)
            if i != -1 and (best is None or i < best):
                best = i
        self._pos = len(text)
        return best


class _Handler(http.server.BaseHTTPRequestHandler):
    """One connection's requests (HTTP/1.1 keep-alive); routes to the
    frontend set on the subclass :meth:`OpenAIFrontend.run` makes."""

    protocol_version = "HTTP/1.1"
    frontend: "OpenAIFrontend"
    # Whether this request's status line went out.
    replied = False

    def log_message(self, format, *args):  # noqa: A002 (base signature)
        logger.debug("%s %s", self.address_string(), format % args)

    def do_GET(self):
        self.replied = False
        self.body = b""
        self.frontend._dispatch(self, "GET")

    def do_POST(self):
        self.replied = False
        # Read the whole body first, whatever the route: bytes left unread
        # would be parsed as the connection's next request.
        try:
            n = int(self.headers.get("Content-Length") or 0)
            self.body = self.rfile.read(n) if n > 0 else b""
        except (ValueError, OSError):
            self.body = None
            self.close_connection = True
        self.frontend._dispatch(self, "POST")

    # -- replies -----------------------------------------------------------

    def send_json(self, obj, status: int = 200) -> None:
        self.send_body(json.dumps(obj).encode(),
                       "application/json; charset=utf-8", status)

    def send_body(self, data: bytes, content_type: str,
                  status: int = 200) -> None:
        self.replied = True
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def send_redirect(self, location: str) -> None:
        self.replied = True
        self.send_response(302)
        self.send_header("Location", location)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def start_stream(self, content_type: str = "text/event-stream") -> None:
        self.replied = True
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def write_chunk(self, data: bytes) -> None:
        """One chunk of a chunked body; an empty ``data`` ends the body.
        Raises _ClientGone when the peer has closed."""
        try:
            self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError) as e:
            raise _ClientGone(str(e)) from e

    def client_gone(self) -> bool:
        """True once the peer closed the connection: it is readable and a
        peek reads end-of-file (a pipelined next request reads data
        instead)."""
        try:
            readable, _, _ = select.select([self.connection], [], [], 0)
            if not readable:
                return False
            return self.connection.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True


class OpenAIFrontend:
    """HTTP app serving one local engine pipeline.

    ``submit_fn(request) -> threading.Event`` hands a request to the
    backend (the event is set when it finishes) and raises ValueError (400),
    NotImplementedError (501: a feature the engine refuses) or RuntimeError
    (429: queue full). ``route_fn(rid, prompt_ids=, lora_id=) -> list[str]
    | None``, where given, picks the request's routing table first from
    the request's prompt ids and ``lora_id`` (its ``RequestMeta``, for
    cache-aware routing; None: 503, no serviceable pipeline; a swarm's chat
    host probes its head there), and a NotImplementedError from it answers
    501. ``stop_fn(rid)`` asks the
    backend to gracefully finish a request early (stop-string match,
    client disconnect). ``status_fn() -> dict``, where given, serves
    ``/cluster/status_json`` and the ``/cluster/status`` stream.
    ``scheduler_init_fn(model_name, init_nodes_num) -> dict`` serves
    ``/scheduler/init`` (ValueError: 400). ``device_memory_bytes`` sizes
    the web UI's model catalog estimate (None leaves it empty)."""

    def __init__(
        self,
        tokenizer,
        submit_fn,
        route_fn=None,
        model_name: str = "parallax-tpu",
        stream_poll_s: float = 0.02,
        stop_fn=None,
        status_fn=None,
        scheduler_init_fn=None,
        device_memory_bytes: int | None = None,
    ):
        self.tokenizer = tokenizer
        self.submit_fn = submit_fn
        self.route_fn = route_fn
        self.stop_fn = stop_fn
        self.status_fn = status_fn
        self.scheduler_init_fn = scheduler_init_fn
        self.model_name = model_name
        self.stream_poll_s = stream_poll_s
        self.server: http.server.ThreadingHTTPServer | None = None
        self._routes = {
            ("GET", "/"): lambda h: h.send_redirect("/ui"),
            ("GET", "/health"): self.health,
            ("GET", "/v1/models"): self.models,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/scheduler/init"): self.scheduler_init,
        }
        if status_fn is not None:
            self._routes[("GET", "/cluster/status_json")] = (
                self.cluster_status_json)
            self._routes[("GET", "/cluster/status")] = (
                self.cluster_status_stream)
        register_ui(self, ui_model_names(model_name),
                    device_bytes=device_memory_bytes)

    def add_route(self, method: str, path: str, fn) -> None:
        """Serve ``fn(handler)`` at ``method path``."""
        self._routes[(method, path)] = fn

    # -- serving -------------------------------------------------------------

    def run(self, host: str = "0.0.0.0", port: int = 8000,
            on_start=None) -> None:
        """Serve until :meth:`shutdown`. ``on_start(frontend)`` runs once
        the socket is bound (port 0 picks a free port; the caller learns
        it there from :attr:`port`)."""
        handler = type("Handler", (_Handler,), {"frontend": self})
        self.server = http.server.ThreadingHTTPServer((host, port), handler)
        self.server.daemon_threads = True
        try:
            if on_start is not None:
                on_start(self)
            self.server.serve_forever(poll_interval=0.05)
        finally:
            self.server.server_close()

    def shutdown(self) -> None:
        """Stop :meth:`run` (from another thread)."""
        if self.server is not None:
            self.server.shutdown()

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def _dispatch(self, h: _Handler, method: str) -> None:
        path = h.path.split("?", 1)[0]
        try:
            route = self._routes.get((method, path))
            if route is not None:
                route(h)
                return
            item = _unported_item(path)
            if item is not None:
                raise _Reply(501, f"{method} {path}: not ported yet to "
                                  f"parallax_tpu_torch (ROADMAP queue 1 "
                                  f"item {item})")
            if any(p == path for _, p in self._routes):
                raise _Reply(405, f"method {method} not allowed on {path}")
            raise _Reply(404, f"no route {path}")
        except _Reply as e:
            self._error(h, e.status, e.message)
        except (_ClientGone, BrokenPipeError, ConnectionResetError):
            h.close_connection = True
        except Exception as e:
            # The boundary of one request: record it, answer 500 when no
            # reply has started, and keep serving.
            logger.exception("%s %s failed", method, path)
            h.close_connection = True
            if not h.replied:
                self._error(h, 500, f"internal error: {e}")

    # -- endpoints -----------------------------------------------------------

    def health(self, h: _Handler) -> None:
        h.send_json({"status": "ok"})

    def models(self, h: _Handler) -> None:
        h.send_json({
            "object": "list",
            "data": [{
                "id": self.model_name,
                "object": "model",
                "owned_by": "parallax-tpu",
            }],
        })

    def scheduler_init(self, h: _Handler) -> None:
        """Live model switch: stop the current global scheduler and
        bootstrap a fresh one for the new model; the workers rejoin on
        their next heartbeat and reload their stage."""

        def reply(status: int, error: str) -> None:
            h.send_json({"type": "scheduler_init", "error": error}, status)

        if self.scheduler_init_fn is None:
            reply(501, "model switch unavailable in this mode")
            return
        body = self._read_json(h)
        model_name = body.get("model_name")
        init_nodes_num = body.get("init_nodes_num")
        if model_name is None:
            reply(400, "model_name is required")
            return
        if init_nodes_num is None:
            reply(400, "init_nodes_num is required")
            return
        try:
            info = self.scheduler_init_fn(model_name, int(init_nodes_num))
        except ValueError as e:
            reply(400, str(e))
            return
        except Exception as e:
            logger.exception("scheduler init failed")
            reply(500, str(e))
            return
        self.model_name = model_name
        h.send_json({"type": "scheduler_init",
                     "data": {"model_name": model_name,
                              "init_nodes_num": init_nodes_num,
                              **(info or {})}})

    def cluster_status_json(self, h: _Handler) -> None:
        h.send_json(self.status_fn())

    def cluster_status_stream(self, h: _Handler) -> None:
        """NDJSON status stream until the client leaves. ``?interval=<s>``
        sets the cadence (default 2, floored at 0.25 s); a raising
        ``status_fn`` emits an ``{"error": ...}`` record and the stream
        goes on."""
        from urllib.parse import parse_qs, urlsplit

        query = parse_qs(urlsplit(h.path).query)
        try:
            interval = float((query.get("interval")
                              or query.get("interval_s") or ["2.0"])[0])
        except (TypeError, ValueError):
            interval = 2.0
        interval = max(0.25, interval)
        h.start_stream("application/x-ndjson")
        while True:
            try:
                status = self.status_fn()
            except Exception as e:
                logger.exception("status_fn failed")
                status = {"error": str(e)}
            try:
                payload = json.dumps(status)
            except (TypeError, ValueError) as e:
                payload = json.dumps({"error": f"unserializable status: {e}"})
            h.write_chunk((payload + "\n").encode())
            deadline = time.monotonic() + interval
            while time.monotonic() < deadline:
                if h.client_gone():
                    raise _ClientGone("status stream closed")
                time.sleep(min(0.05, interval))

    def _request_lora(self, body: dict) -> str | None:
        """Adapter selection: explicit ``"lora"`` field, or the
        ``<model>:<adapter>`` model-name convention."""
        lora = body.get("lora")
        if lora:
            return lora
        m = body.get("model") or ""
        prefix = f"{self.model_name}:"
        if m.startswith(prefix):
            return m[len(prefix):] or None
        return None

    @staticmethod
    def _read_json(h: _Handler) -> dict:
        try:
            body = json.loads(h.body) if h.body else None
        except ValueError:
            body = None
        if not isinstance(body, dict):
            raise _Reply(400, "invalid JSON body")
        return body

    def chat_completions(self, h: _Handler) -> None:
        body = self._read_json(h)
        messages = body.get("messages") or []
        try:
            prompt_text = self.tokenizer.apply_chat_template(messages)
        except Exception:
            prompt_text = "\n".join(m.get("content", "") for m in messages)
        self._generate(h, body, prompt_text, chat=True)

    def completions(self, h: _Handler) -> None:
        body = self._read_json(h)
        self._generate(h, body, body.get("prompt", ""), chat=False)

    # -- core generation -----------------------------------------------------

    def _generate(self, h: _Handler, body: dict, prompt_text: str,
                  chat: bool) -> None:
        rid = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        prompt_ids = self.tokenizer.encode(prompt_text)
        if not prompt_ids:
            raise _Reply(400, "empty prompt")
        try:
            sampling_params = _sampling_from_body(body)
        except (TypeError, ValueError) as e:
            raise _Reply(400, f"invalid sampling parameter: {e}") from e
        try:
            raw_n = body.get("n")
            n_choices = 1 if raw_n is None else int(raw_n)
        except (TypeError, ValueError) as e:
            raise _Reply(400, "n must be an integer") from e
        if not 1 <= n_choices <= 8:
            raise _Reply(400, "n must be between 1 and 8")
        if n_choices > 1 and body.get("stream"):
            raise _Reply(400, "streaming with n > 1 is not supported")
        routing_table: list[str] = []
        lora_id = self._request_lora(body)
        if self.route_fn is not None:
            try:
                path = self.route_fn(rid, prompt_ids=list(prompt_ids),
                                     lora_id=lora_id)
            except NotImplementedError as e:
                raise _Reply(501, str(e)) from e
            if path is None:
                raise _Reply(503, "no serviceable pipeline")
            routing_table = list(path)
        if n_choices > 1:
            self._generate_n(h, rid, body, prompt_ids, sampling_params,
                             routing_table, chat, n_choices)
            return

        req = Request(
            request_id=rid,
            prompt_ids=list(prompt_ids),
            sampling_params=sampling_params,
            routing_table=routing_table,
            eos_token_ids=tuple(self.tokenizer.eos_token_ids),
            lora_id=lora_id,
        )
        t_start = time.monotonic()
        done = self._submit(req)
        if body.get("stream"):
            h.start_stream()
            try:
                self._stream_body(h, req, chat, t_start)
            except _ClientGone:
                # The client went away mid-stream: stop the engine work
                # instead of generating to max_tokens with nobody reading.
                self._request_stop(req)
                raise
            return
        try:
            text, stop_matched = self._await_completion(h, req, done)
        except _GenFailed as e:
            raise _Reply(502, f"generation failed: {e}") from e
        except _ClientGone:
            self._request_stop(req)
            raise
        h.send_json(self._completion_body(
            req, text, chat, t_start,
            finish_override="stop" if stop_matched else None,
        ))

    def _submit(self, req: Request):
        try:
            return self.submit_fn(req)
        except NotImplementedError as e:
            # The engine refuses the feature until its slice: never a
            # silent 200 that ignores the field.
            raise _Reply(501, str(e)) from e
        except ValueError as e:
            raise _Reply(400, str(e)) from e
        except RuntimeError as e:
            raise _Reply(429, str(e)) from e

    def _generate_n(self, h, rid, body, prompt_ids, sampling_params,
                    routing_table, chat, n_choices) -> None:
        """OpenAI ``n`` > 1: n independent generations merged into one
        choices array. Seeded requests get seed+i per choice so the choices
        differ; greedy requests will legitimately all match."""
        reqs, dones = [], []
        try:
            for i in range(n_choices):
                sp = sampling_params
                if sp.seed is not None:
                    sp = dataclasses.replace(sp, seed=sp.seed + i)
                req = Request(
                    request_id=f"{rid}-{i}",
                    prompt_ids=list(prompt_ids),
                    sampling_params=sp,
                    routing_table=list(routing_table),
                    eos_token_ids=tuple(self.tokenizer.eos_token_ids),
                    lora_id=self._request_lora(body),
                )
                dones.append(self._submit(req))
                reqs.append(req)
            t_start = time.monotonic()
            results = []
            for req, done in zip(reqs, dones):
                try:
                    results.append(self._await_completion(h, req, done))
                except _GenFailed as e:
                    results.append(e)
        except (_Reply, _ClientGone):
            # Stop every already-running sibling.
            for r in reqs:
                self._request_stop(r)
            raise
        failures = [r for r in results if isinstance(r, Exception)]
        if failures:
            for req in reqs:
                self._request_stop(req)
            raise _Reply(502, f"generation failed: {failures[0]}")

        choices = []
        bodies = []
        for i, (req, (text, stop_matched)) in enumerate(zip(reqs, results)):
            body_i = self._completion_body(
                req, text, chat, t_start,
                finish_override="stop" if stop_matched else None,
            )
            bodies.append(body_i)
            c = body_i["choices"][0]
            c["index"] = i
            choices.append(c)
        # Compose the merged envelope from the per-choice bodies and sum
        # the usage numbers.
        merged = dict(bodies[0], id=rid, choices=choices)
        usage = dict(bodies[0]["usage"])
        for b in bodies[1:]:
            # Prompt tokens count once (OpenAI semantics: one prompt, n
            # choices); completions and throughput sum across choices.
            for key in ("completion_tokens", "tokens_per_second"):
                usage[key] = round(usage[key] + b["usage"][key], 2)
        usage["total_tokens"] = (
            usage["prompt_tokens"] + usage["completion_tokens"]
        )
        merged["usage"] = usage
        h.send_json(merged)

    def _check_client(self, h: _Handler) -> None:
        if h.client_gone():
            raise _ClientGone("client closed the connection")

    def _await_completion(self, h, req, done) -> tuple[str, bool]:
        """Wait for one request's generation; returns (text, stop_matched).
        Raises _GenFailed on abort/timeout and _ClientGone on a disconnect.
        Stop strings end generation early via the poll loop instead of
        silently running to EOS/max_tokens."""
        stops = req.sampling_params.stop_strings
        stop_idx = None
        dec = IncrementalDecoder(self.tokenizer)
        scanner = _StopScanner(stops)
        deadline = time.monotonic() + _POLL_DEADLINE_S
        if stops:
            checked = 0
            while not req.status.is_finished:
                if time.monotonic() > deadline:
                    req.abort("deadline exceeded")
                    break
                n = len(req.output_ids)
                if n > checked:
                    checked = n
                    text = dec.update(list(req.output_ids[:n]))
                    stop_idx = scanner.find(text)
                    if stop_idx is not None:
                        self._request_stop(req)
                        break
                self._check_client(h)
                time.sleep(self.stream_poll_s)
            ok = req.status.is_finished or stop_idx is not None
        else:
            while not done.wait(self.stream_poll_s):
                if time.monotonic() > deadline:
                    break
                self._check_client(h)
            ok = done.is_set()
        if not ok or req.status.value == "finished_abort":
            raise _GenFailed(req.abort_reason or "timeout")
        text = dec.finalize(list(req.output_ids))
        if stop_idx is None and stops:
            stop_idx = scanner.find(text)
        stop_matched = stop_idx is not None
        if stop_idx is not None:
            text = text[:stop_idx]
        return text, stop_matched

    def _request_stop(self, req) -> None:
        """Ask the backend to finish ``req`` early."""
        if self.stop_fn is not None:
            try:
                self.stop_fn(req.request_id)
            except Exception as e:
                logger.warning("stop_fn failed for %s: %s", req.request_id, e)

    def _stream_body(self, h, req, chat, t_start) -> None:
        # BPE detokenization is context-dependent: deltas come from an
        # incremental decoder (bounded per-poll work) and stop strings are
        # scanned over appended text only.
        stops = req.sampling_params.stop_strings
        dec = IncrementalDecoder(self.tokenizer)
        scanner = _StopScanner(stops)
        seen_tokens = 0
        emitted = ""
        lp_sent = 0
        ttft_ms = None
        stop_matched = False
        deadline = time.monotonic() + _POLL_DEADLINE_S
        while True:
            n = len(req.output_ids)
            if n > seen_tokens:
                if ttft_ms is None:
                    ttft_ms = (time.monotonic() - t_start) * 1e3
                seen_tokens = n
                full = dec.update(list(req.output_ids[:n]))
                idx = scanner.find(full) if stops else None
                lp_entries, lp_sent = self._stream_logprob_entries(
                    req, lp_sent)
                if idx is not None:
                    final = full[:idx]
                    if len(final) > len(emitted) or lp_entries:
                        h.write_chunk(self._sse_chunk(
                            req, final[len(emitted):], chat,
                            lp_entries=lp_entries))
                        emitted = final
                    stop_matched = True
                    self._request_stop(req)
                    break
                # Hold back any suffix that could become a stop match.
                safe = len(full) - (_stop_holdback(full, stops) if stops else 0)
                if safe > len(emitted) or lp_entries:
                    h.write_chunk(self._sse_chunk(
                        req, full[len(emitted):safe], chat,
                        lp_entries=lp_entries))
                    emitted = full[:safe]
            if req.status.is_finished:
                break
            if time.monotonic() > deadline:
                req.abort("stream deadline exceeded")
                break
            self._check_client(h)
            time.sleep(self.stream_poll_s)
        if not stop_matched:
            # Flush whatever was held back / arrived after the last poll.
            full = dec.finalize(list(req.output_ids))
            idx = scanner.find(full) if stops else None
            if idx is not None:
                full = full[:idx]
                stop_matched = True
            lp_entries, lp_sent = self._stream_logprob_entries(req, lp_sent)
            if len(full) > len(emitted) or lp_entries:
                h.write_chunk(self._sse_chunk(
                    req, full[len(emitted):], chat, lp_entries=lp_entries))
        usage = self._usage(req, t_start, ttft_ms)
        h.write_chunk(self._sse_chunk(
            req, "", chat, finish=True, usage=usage,
            finish_override="stop" if stop_matched else None,
        ))
        h.write_chunk(b"data: [DONE]\n\n")
        h.write_chunk(b"")

    def _sse_chunk(self, req, delta_text, chat, finish=False, usage=None,
                   finish_override=None, lp_entries=None) -> bytes:
        reason = (
            (finish_override or self._finish_reason(req)) if finish else None
        )
        if chat:
            choice = {
                "index": 0,
                "delta": {} if finish else {"content": delta_text},
                "finish_reason": reason,
            }
            obj = "chat.completion.chunk"
            if lp_entries:
                choice["logprobs"] = {"content": [
                    {"token": t, "logprob": lp} for t, lp in lp_entries
                ]}
        else:
            choice = {
                "index": 0,
                "text": delta_text,
                "finish_reason": reason,
            }
            obj = "text_completion"
            if lp_entries:
                choice["logprobs"] = {
                    "tokens": [t for t, _ in lp_entries],
                    "token_logprobs": [lp for _, lp in lp_entries],
                }
        payload = {
            "id": req.request_id,
            "object": obj,
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [choice],
        }
        if usage:
            payload["usage"] = usage
        return f"data: {json.dumps(payload)}\n\n".encode()

    def _stream_logprob_entries(self, req, lp_sent):
        """New (token_text, logprob) pairs since the last chunk."""
        if not req.sampling_params.logprobs:
            return None, lp_sent
        n = min(len(req.output_ids), len(req.output_logprobs))
        if n <= lp_sent:
            return None, lp_sent
        entries = [
            (self.tokenizer.decode([req.output_ids[i]]),
             req.output_logprobs[i])
            for i in range(lp_sent, n)
        ]
        return entries, n

    def _logprobs_payload(self, req, chat):
        """OpenAI-format logprobs for the committed tokens (chat: content
        entries; completions: parallel token / logprob arrays)."""
        if not req.sampling_params.logprobs or not req.output_logprobs:
            return None
        n = min(len(req.output_ids), len(req.output_logprobs))
        toks = [self.tokenizer.decode([t]) for t in req.output_ids[:n]]
        if chat:
            return {"content": [
                {"token": tok, "logprob": lp}
                for tok, lp in zip(toks, req.output_logprobs[:n])
            ]}
        return {"tokens": toks,
                "token_logprobs": list(req.output_logprobs[:n])}

    def _completion_body(self, req, text, chat, t_start, finish_override=None):
        reason = finish_override or self._finish_reason(req)
        lp = self._logprobs_payload(req, chat)
        if chat:
            choice = {
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": reason,
            }
            obj = "chat.completion"
        else:
            choice = {
                "index": 0,
                "text": text,
                "finish_reason": reason,
            }
            obj = "text_completion"
        if lp is not None:
            choice["logprobs"] = lp
        return {
            "id": req.request_id,
            "object": obj,
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [choice],
            "usage": self._usage(req, t_start, None),
        }

    def _usage(self, req, t_start, ttft_ms):
        elapsed = max(1e-6, time.monotonic() - t_start)
        usage = {
            "prompt_tokens": req.num_prompt_tokens,
            "completion_tokens": req.num_output_tokens,
            "total_tokens": req.total_len,
            "tokens_per_second": round(req.num_output_tokens / elapsed, 2),
        }
        if ttft_ms is not None:
            usage["ttft_ms"] = round(ttft_ms, 1)
        return usage

    @staticmethod
    def _finish_reason(req) -> str:
        return {
            "finished_eos": "stop",
            "finished_stop": "stop",
            "finished_length": "length",
            "finished_abort": "abort",
        }.get(req.status.value, "stop")

    @staticmethod
    def _error(h: _Handler, status: int, message: str) -> None:
        h.send_json(
            {"error": {"message": message, "type": "invalid_request_error"}},
            status=status,
        )
