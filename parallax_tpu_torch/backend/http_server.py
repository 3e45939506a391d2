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
gets HTTP 501 with that refusal's text. ``POST /weight/refit``
(``{"index_map": {...}}``) registers a new weight version through
``refit_fn`` and answers ``{"version": n}``; a frontend without one
answers 501 ``{"error": "refit unavailable"}``, as the JAX frontend does.
A request selects a LoRA adapter with the ``"lora"`` field or
the ``<model>:<adapter>`` model name; ``/v1/models`` lists one such
variant per adapter that ``adapters_fn`` names, and an adapter the engine
does not hold aborts the request (502, the engine's reason). ``/cluster/status`` (an ndjson stream) and
``/cluster/status_json`` serve the ``status_fn`` (``{}`` without one): the
``run`` frontend's scheduler ``cluster_status()``, ``serve``'s
single-host status. With a ``qos_config`` (``serve`` / ``run --qos``) each
request carries a QoS class, deadline and tenant from the
``x-parallax-qos-class`` / ``x-parallax-deadline-ms`` /
``x-parallax-tenant`` headers or their body fields (400 on a bad value).

The observability plane, as the JAX frontend serves it: ``/metrics`` (the
process registry in the Prometheus text format), ``/healthz`` (the stall
watchdog's summary, 503 when a component stalled), ``/debug/trace/<id>``
(a sampled request's Chrome trace), ``/debug/flight``, ``/debug/device``
(the device plane, or ``device_fn``'s cluster merge), ``/debug/timeline``
and ``POST /profile/start`` / ``/profile/stop`` (``torch.profiler``, 409
on a second start, an auto-stop deadline, a ``{"pipeline": ...}`` body
fanned out through ``profile_cluster_fn``). The profiler starts and stops
through ``step_call``, on the thread that steps the device; every other
endpoint reads host state and cached snapshots only.

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
import threading
import time
import uuid

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.backend.webui import register_ui, ui_model_names
from parallax_tpu_torch.constrained import validate_schema
from parallax_tpu_torch.obs import names as mnames
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.utils import get_logger

# SimpleTokenizer / load_tokenizer live in utils.tokenizer; re-exported here
# as the JAX module does.
from parallax_tpu_torch.utils.tokenizer import (  # noqa: F401
    SimpleTokenizer,
    load_tokenizer,
)

logger = get_logger(__name__)

_POLL_DEADLINE_S = 600.0


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
    (429: queue full). ``route_fn(rid, prompt_ids=, lora_id=, tenant_id=,
    qos_class=) -> list[str] | None``, where given, picks the request's
    routing table first from the request's prompt ids, ``lora_id``, tenant
    and class (its ``RequestMeta``, for cache-aware and fair routing; None: 503, no serviceable pipeline; a swarm's chat
    host probes its head there), and a NotImplementedError from it answers
    501. ``stop_fn(rid)`` asks the
    backend to gracefully finish a request early (stop-string match,
    client disconnect). ``status_fn() -> dict``, where given, serves
    ``/cluster/status_json`` and the ``/cluster/status`` stream.
    ``scheduler_init_fn(model_name, init_nodes_num) -> dict`` serves
    ``/scheduler/init`` (ValueError: 400). ``device_memory_bytes`` sizes
    the web UI's model catalog estimate (None leaves it empty).
    ``healthz_fn() -> dict`` (the watchdog's summary) backs ``/healthz``
    (a shallow ok without one), ``timeline_fn(fmt, limit)`` backs
    ``/debug/timeline`` (404 without one), ``device_fn()`` overrides the
    process's device plane at ``/debug/device``,
    ``profile_cluster_fn(action, pipeline, dir, max_seconds) -> manifest``
    fans a profile to a pipeline's stages, and ``step_call(fn)`` runs
    ``fn`` on the thread that steps the device and returns its result
    (None runs it on the handler thread: a frontend with no device).
    ``qos_config`` (a ``qos/classes.QoSConfig``) makes requests carry a
    class (header ``x-parallax-qos-class`` / body ``qos_class``), a
    deadline (``x-parallax-deadline-ms`` / ``deadline_ms``) and a tenant
    (``x-parallax-tenant`` / ``tenant``; the LoRA adapter by default); a
    bad value answers 400, and ``route_fn`` gets the tenant and class.
    None = QoS off: nothing is parsed, and ``route_fn`` gets None for
    both. ``adapters_fn() -> list[str]`` names the LoRA adapters that
    ``/v1/models`` lists as ``<model>:<adapter>`` variants.
    ``refit_fn(index_map) -> version`` serves ``POST /weight/refit``
    (the ``run`` frontend's: the scheduler's ``begin_refit``)."""

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
        healthz_fn=None,
        timeline_fn=None,
        device_fn=None,
        profile_cluster_fn=None,
        step_call=None,
        qos_config=None,
        adapters_fn=None,
        refit_fn=None,
    ):
        self.tokenizer = tokenizer
        self.refit_fn = refit_fn
        self.submit_fn = submit_fn
        self.route_fn = route_fn
        self.adapters_fn = adapters_fn
        self.qos_config = qos_config
        self.stop_fn = stop_fn
        self.status_fn = status_fn
        self.scheduler_init_fn = scheduler_init_fn
        self.healthz_fn = healthz_fn
        self.timeline_fn = timeline_fn
        self.device_fn = device_fn
        self.profile_cluster_fn = profile_cluster_fn
        self.step_call = step_call or (lambda fn: fn())
        self.model_name = model_name
        self.stream_poll_s = stream_poll_s
        self.server: http.server.ThreadingHTTPServer | None = None
        self._counters = {"requests": 0, "completion_tokens": 0,
                          "prompt_tokens": 0, "started_at": time.time()}
        # The HTTP counters are registry series: /metrics renders the whole
        # process (engine histograms, cache counters, transport links).
        from parallax_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        self._m_requests = reg.counter(
            mnames.HTTP_REQUESTS_TOTAL,
            "Generation requests accepted by the HTTP frontend",
        )
        self._m_prompt_tokens = reg.counter(
            mnames.HTTP_PROMPT_TOKENS_TOTAL,
            "Prompt tokens across accepted requests",
        )
        self._m_completion_tokens = reg.counter(
            mnames.HTTP_COMPLETION_TOKENS_TOTAL,
            "Completion tokens generated (counted at request end)",
        )
        self._m_uptime = reg.gauge(
            mnames.HTTP_UPTIME_SECONDS, "Frontend process uptime",
        )
        self._m_http_ttft = reg.histogram(
            mnames.HTTP_TTFT_MS,
            "Client-observed time to first streamed token, milliseconds",
        )
        self._m_http_e2e = reg.histogram(
            mnames.HTTP_E2E_MS,
            "Client-observed request latency, milliseconds",
        )
        # Strong ref on self: the registry holds only a weakref.
        self._obs_collector = lambda: self._m_uptime.set(
            time.time() - self._counters["started_at"]
        )
        reg.register_collector(self._obs_collector)
        self._profile_lock = make_lock("backend.http.profile")
        self._profiling = False
        self._profile_timer: threading.Timer | None = None
        self._routes = {
            ("GET", "/"): lambda h: h.send_redirect("/ui"),
            ("GET", "/health"): self.health,
            ("GET", "/healthz"): self.healthz,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/v1/models"): self.models,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/scheduler/init"): self.scheduler_init,
            ("POST", "/weight/refit"): self.weight_refit,
            ("GET", "/cluster/status_json"): self.cluster_status_json,
            ("GET", "/cluster/status"): self.cluster_status_stream,
            ("GET", "/debug/device"): self.debug_device,
            ("GET", "/debug/flight"): self.debug_flight,
            ("GET", "/debug/timeline"): self.debug_timeline,
            ("POST", "/profile/start"): self.profile_start,
            ("POST", "/profile/stop"): self.profile_stop,
        }
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
            if route is None and method == "GET" and path.startswith(
                    "/debug/trace/"):
                route = self.debug_trace
            if route is not None:
                route(h)
                return
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

    def healthz(self, h: _Handler) -> None:
        """Deep health: the stall watchdog's per-component state machine.
        503 when a component is stalled; a shallow ok without a watchdog."""
        if self.healthz_fn is None:
            h.send_json({"status": "ok", "components": {}, "causes": []})
            return
        try:
            summary = self.healthz_fn()
        except Exception as e:
            h.send_json({"status": "unknown", "error": str(e)}, 500)
            return
        h.send_json(summary, 503 if summary.get("status") == "stalled"
                    else 200)

    def metrics(self, h: _Handler) -> None:
        """Prometheus text exposition of the process registry."""
        from parallax_tpu_torch.obs.registry import (
            EXPOSITION_CONTENT_TYPE,
            get_registry,
        )

        h.send_body(get_registry().render().encode("utf-8"),
                    EXPOSITION_CONTENT_TYPE)

    def debug_trace(self, h: _Handler) -> None:
        """Chrome trace-event JSON of one sampled request; 404 for an
        unknown or unsampled id."""
        from urllib.parse import unquote

        from parallax_tpu_torch.obs.trace import get_trace_store

        rid = unquote(h.path.split("?", 1)[0][len("/debug/trace/"):])
        data = get_trace_store().export_chrome(rid)
        if data is None:
            raise _Reply(404, f"no trace recorded for {rid!r} (tracing is "
                              "sampled: set trace_sample_rate > 0)")
        h.send_json(data)

    def debug_device(self, h: _Handler) -> None:
        """The device plane: the HBM ledger, the compile observatory and
        the per-program device time (``device_fn``'s cluster merge on the
        scheduler frontend)."""
        if self.device_fn is not None:
            try:
                payload = self.device_fn() or {}
            except Exception as e:
                raise _Reply(500, f"device payload failed: {e}") from e
            h.send_json(payload)
            return
        from parallax_tpu_torch.obs.device import get_device_plane

        h.send_json(get_device_plane().payload())

    def debug_flight(self, h: _Handler) -> None:
        """The flight recorder: recent request timelines, the slow ring
        and notable events."""
        from parallax_tpu_torch.obs.flight import get_flight

        h.send_json(get_flight().snapshot())

    def debug_timeline(self, h: _Handler) -> None:
        """The event timeline; ``?format=chrome`` exports Chrome
        trace-event JSON, ``?limit=`` bounds the event list (1000)."""
        from urllib.parse import parse_qs, urlsplit

        if self.timeline_fn is None:
            raise _Reply(404, "no cluster timeline on this endpoint (serve "
                              "it from the scheduler frontend, or enable the "
                              "local timeline)")
        query = parse_qs(urlsplit(h.path).query)
        fmt = (query.get("format") or ["json"])[0]
        try:
            limit = max(1, int((query.get("limit") or ["1000"])[0]))
        except ValueError:
            limit = 1000
        try:
            data = self.timeline_fn(fmt, limit)
        except Exception as e:
            raise _Reply(500, f"timeline export failed: {e}") from e
        h.send_json(data)

    def profile_start(self, h: _Handler) -> None:
        """Start a ``torch.profiler`` device trace while serving.
        ``max_seconds`` (default 120) is an auto-stop deadline; a
        ``{"pipeline": <id>}`` body fans the start to every stage of that
        pipeline (``"all"``: every pipeline) and answers the per-node
        manifest."""
        from parallax_tpu_torch.obs import profiler

        body = self._read_optional_json(h)
        out_dir = body.get("dir") or profiler.DEFAULT_DIR
        try:
            max_seconds = float(body.get("max_seconds", 120.0))
        except (TypeError, ValueError) as e:
            raise _Reply(400, "max_seconds must be a number") from e
        if max_seconds <= 0:
            raise _Reply(400, "max_seconds must be > 0")
        if body.get("pipeline") is not None:
            self._profile_cluster(h, "start", body["pipeline"], out_dir,
                                  max_seconds)
            return
        with self._profile_lock:
            if self._profiling:
                raise _Reply(409, "profiler already running")
            try:
                self.step_call(lambda: profiler.start_trace(out_dir))
            except Exception as e:
                raise _Reply(500, f"profiler start failed: {e}") from e
            self._profiling = True
            self._profile_timer = threading.Timer(
                max_seconds, self._profile_deadline)
            self._profile_timer.daemon = True
            self._profile_timer.start()
        h.send_json({"profiling": True, "dir": out_dir,
                     "max_seconds": max_seconds})

    def _profile_deadline(self) -> None:
        """The auto-stop timer fired: end the trace."""
        from parallax_tpu_torch.obs import profiler

        with self._profile_lock:
            self._profile_timer = None
            if not self._profiling:
                return
            self._profiling = False
            logger.warning("profiler auto-stop: max_seconds deadline reached")
            try:
                self.step_call(profiler.stop_trace)
            except Exception:
                logger.exception("profiler auto-stop failed")

    def profile_stop(self, h: _Handler) -> None:
        from parallax_tpu_torch.obs import profiler

        body = self._read_optional_json(h)
        if body.get("pipeline") is not None:
            self._profile_cluster(h, "stop", body["pipeline"], None, 0.0)
            return
        with self._profile_lock:
            if not self._profiling:
                raise _Reply(409, "profiler not running")
            if self._profile_timer is not None:
                self._profile_timer.cancel()
                self._profile_timer = None
            try:
                path = self.step_call(profiler.stop_trace)
            finally:
                self._profiling = False
        h.send_json({"profiling": False, "trace": path})

    def _profile_cluster(self, h: _Handler, action, pipeline, out_dir,
                         max_seconds) -> None:
        """Fan a profiler action to a pipeline's stages; the reply is the
        per-node manifest ({node_id, profiling, dir} or {error} rows)."""
        if self.profile_cluster_fn is None:
            h.send_json({"error": "cluster-scope profiling unavailable in "
                                  "this mode (no swarm scheduler on this "
                                  "frontend)"}, 501)
            return
        try:
            manifest = self.profile_cluster_fn(action, pipeline, out_dir,
                                               max_seconds)
        except ValueError as e:
            raise _Reply(400, str(e)) from e
        except Exception as e:
            logger.exception("cluster profile %s failed", action)
            raise _Reply(500, f"cluster profile failed: {e}") from e
        h.send_json({"profiling": action == "start", "pipeline": pipeline,
                     "nodes": manifest})

    def _count_accept(self, req) -> None:
        """Count a request at accept time (a client that leaves mid-stream
        still shows in /metrics)."""
        self._counters["requests"] += 1
        self._counters["prompt_tokens"] += req.num_prompt_tokens
        self._m_requests.inc()
        self._m_prompt_tokens.inc(req.num_prompt_tokens)

    def _count_completion(self, req, t_start=None) -> None:
        """Count generated tokens (and, for a request timed to its end, its
        e2e latency)."""
        self._counters["completion_tokens"] += req.num_output_tokens
        self._m_completion_tokens.inc(req.num_output_tokens)
        if t_start is not None:
            self._m_http_e2e.observe((time.monotonic() - t_start) * 1e3)

    def models(self, h: _Handler) -> None:
        """The base model plus one ``<model>:<adapter>`` variant per
        adapter ``adapters_fn`` names (the multi-LoRA serving convention:
        a stock OpenAI client selects a tenant through the model field)."""
        names = [self.model_name]
        if self.adapters_fn is not None:
            names += [f"{self.model_name}:{a}" for a in self.adapters_fn()]
        h.send_json({
            "object": "list",
            "data": [{
                "id": name,
                "object": "model",
                "owned_by": "parallax-tpu",
            } for name in names],
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

    def weight_refit(self, h: _Handler) -> None:
        """Register a weight refit (``{"index_map": {name: uri or {"uri",
        "sha256"}}}``) and answer its version."""
        if self.refit_fn is None:
            h.send_json({"error": "refit unavailable"}, 501)
            return
        body = self._read_json(h)
        version = self.refit_fn(body.get("index_map") or {})
        h.send_json({"version": version})

    def cluster_status_json(self, h: _Handler) -> None:
        h.send_json(self.status_fn() if self.status_fn else {})

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
                status = self.status_fn() if self.status_fn else {}
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
    def _read_optional_json(h: _Handler) -> dict:
        """The body's JSON object, ``{}`` for an empty or unparsable one."""
        try:
            body = json.loads(h.body) if h.body else {}
        except ValueError:
            body = {}
        return body if isinstance(body, dict) else {}

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
        # Multi-tenant QoS: class / deadline / tenant from headers and
        # body. All None while QoS is off.
        qos = (None, None, None)
        if self.qos_config is not None:
            from parallax_tpu_torch.qos import qos_from_http

            try:
                qos_class, deadline_ms, tenant_id = qos_from_http(
                    h.headers, body, self.qos_config)
            except (TypeError, ValueError) as e:
                raise _Reply(400, f"invalid QoS parameter: {e}") from e
            qos = (qos_class, time.monotonic() + deadline_ms / 1e3,
                   tenant_id if tenant_id is not None else lora_id)
        if self.route_fn is not None:
            try:
                path = self.route_fn(rid, prompt_ids=list(prompt_ids),
                                     lora_id=lora_id, tenant_id=qos[2],
                                     qos_class=qos[0])
            except NotImplementedError as e:
                raise _Reply(501, str(e)) from e
            if path is None:
                raise _Reply(503, "no serviceable pipeline")
            routing_table = list(path)
        if n_choices > 1:
            self._generate_n(h, rid, body, prompt_ids, sampling_params,
                             routing_table, chat, n_choices, qos)
            return

        req = Request(
            request_id=rid,
            prompt_ids=list(prompt_ids),
            sampling_params=sampling_params,
            routing_table=routing_table,
            eos_token_ids=tuple(self.tokenizer.eos_token_ids),
            lora_id=lora_id,
            qos_class=qos[0],
            deadline=qos[1],
            tenant_id=qos[2],
        )
        t_start = time.monotonic()
        done = self._submit(req)
        # Counted at accept time: a client that leaves mid-stream still
        # shows in /metrics.
        self._count_accept(req)
        try:
            if body.get("stream"):
                h.start_stream()
                try:
                    self._stream_body(h, req, chat, t_start)
                except _ClientGone:
                    # The client went away mid-stream: stop the engine work
                    # instead of generating to max_tokens with nobody
                    # reading.
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
        finally:
            self._count_completion(req, t_start)

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
                    routing_table, chat, n_choices,
                    qos=(None, None, None)) -> None:
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
                    qos_class=qos[0],
                    deadline=qos[1],
                    tenant_id=qos[2],
                )
                dones.append(self._submit(req))
                self._count_accept(req)
                reqs.append(req)
            t_start = time.monotonic()
            results = []
            for req, done in zip(reqs, dones):
                try:
                    results.append(self._await_completion(h, req, done))
                except _GenFailed as e:
                    results.append(e)
        except (_Reply, _ClientGone):
            # Stop every already-running sibling and count its tokens.
            for r in reqs:
                self._request_stop(r)
                self._count_completion(r)
            raise
        # Tokens generated before a failure still reach /metrics.
        for req in reqs:
            self._count_completion(req, t_start)
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
                    self._m_http_ttft.observe(ttft_ms)
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
