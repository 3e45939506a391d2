"""Multi-cluster load balancer: endpoint registry, health, strategies (port
of ``parallax_tpu/router/lb.py``, on the standard library).

An endpoint registry with periodic health probes of
``/cluster/status_json``, EMA TTFT / TPOT and in-flight / error accounting
per endpoint, the ``round_robin`` / ``random`` / ``performance`` strategies
(scored EMA plus penalties, top-k with an exploration ratio) and
``session_affinity`` (rendezvous hashing on a stable session / user key,
else the leading prompt bytes, falling back to ``performance`` when the
pinned endpoint is unhealthy), SSE pass-through with metric finalization,
the ``/router/*`` runtime APIs and a throughput time series.

The JAX router runs on aiohttp; this one runs on ``ThreadingHTTPServer``
and ``http.client``, as the port's HTTP plane does (one thread a
connection, one upstream connection a proxied request)::

    python -m parallax_tpu_torch.router.lb --endpoints http://a:8000 \\
        http://b:8000 --strategy session_affinity --port 8080
"""

from __future__ import annotations

import dataclasses
import hashlib
import http.client
import http.server
import json
import random
import threading
import time
import urllib.parse
from collections import deque

from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)

EMA_ALPHA = 0.2
# A proxied request's upstream socket timeout (the JAX router's aiohttp
# total timeout): a long generation streams for minutes.
UPSTREAM_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class Endpoint:
    url: str
    healthy: bool = False
    inflight: int = 0
    error_count: int = 0
    total_requests: int = 0
    ema_ttft_s: float | None = None
    ema_tpot_s: float | None = None
    last_probe: float = 0.0
    status: dict = dataclasses.field(default_factory=dict)

    def observe(self, ttft_s: float | None, tpot_s: float | None) -> None:
        if ttft_s is not None:
            self.ema_ttft_s = (
                ttft_s if self.ema_ttft_s is None
                else (1 - EMA_ALPHA) * self.ema_ttft_s + EMA_ALPHA * ttft_s
            )
        if tpot_s is not None:
            self.ema_tpot_s = (
                tpot_s if self.ema_tpot_s is None
                else (1 - EMA_ALPHA) * self.ema_tpot_s + EMA_ALPHA * tpot_s
            )

    def score(self, tpot_weight: float = 10.0) -> float:
        """Lower is better."""
        ttft = self.ema_ttft_s if self.ema_ttft_s is not None else 1.0
        tpot = self.ema_tpot_s if self.ema_tpot_s is not None else 0.05
        return (
            ttft
            + tpot * tpot_weight
            + 0.05 * self.inflight
            + 0.5 * min(self.error_count, 10)
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("status", None)
        return d


class Strategy:
    def pick(self, endpoints: list[Endpoint],
             key: str | None = None) -> Endpoint | None:
        raise NotImplementedError


class RoundRobin(Strategy):
    def __init__(self):
        self._i = 0

    def pick(self, endpoints, key=None):
        if not endpoints:
            return None
        self._i = (self._i + 1) % len(endpoints)
        return endpoints[self._i]


class Random(Strategy):
    def pick(self, endpoints, key=None):
        return random.choice(endpoints) if endpoints else None


class Performance(Strategy):
    """Best-scored with exploration."""

    def __init__(self, top_k: int = 2, explore_ratio: float = 0.1):
        self.top_k = top_k
        self.explore_ratio = explore_ratio

    def pick(self, endpoints, key=None):
        if not endpoints:
            return None
        if random.random() < self.explore_ratio:
            return random.choice(endpoints)
        ranked = sorted(endpoints, key=lambda e: e.score())
        return random.choice(ranked[: max(1, self.top_k)])


class SessionAffinity(Strategy):
    """Consistent (rendezvous) hashing on a stable per-request key, so
    multi-turn chats keep returning to the swarm whose head holds the
    conversation's prefix cache. The pin is computed over ALL registered
    endpoints (healthy or not): endpoints flapping never remap sessions
    that were not pinned to them; when the pinned endpoint IS unhealthy,
    the request falls back to ``performance`` over the healthy set."""

    def __init__(self):
        self._fallback = Performance()

    @staticmethod
    def _weight(key: str, url: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(
                f"{key}\x00{url}".encode(), digest_size=8
            ).digest(),
            "little",
        )

    def pick(self, endpoints, key=None, all_endpoints=None):
        if not endpoints:
            return None
        if key is None:
            return self._fallback.pick(endpoints)
        pinned = max(
            all_endpoints or endpoints,
            key=lambda e: self._weight(key, e.url),
        )
        if pinned in endpoints:      # pinned endpoint is healthy
            return pinned
        return self._fallback.pick(endpoints)


STRATEGIES = {
    "round_robin": RoundRobin,
    "random": Random,
    "performance": Performance,
    "session_affinity": SessionAffinity,
}


def _connection(url: str, timeout: float) -> tuple:
    """An ``http.client`` connection to ``url``'s host and the URL's path
    prefix."""
    u = urllib.parse.urlsplit(url)
    cls = (http.client.HTTPSConnection if u.scheme == "https"
           else http.client.HTTPConnection)
    return cls(u.hostname, u.port, timeout=timeout), u.path.rstrip("/")


class _Handler(http.server.BaseHTTPRequestHandler):
    """One client connection; routes to the router set on the subclass
    :meth:`Router.start` makes."""

    protocol_version = "HTTP/1.1"
    router: "Router"

    def log_message(self, format, *args):  # noqa: A002 (base signature)
        logger.debug("%s %s", self.address_string(), format % args)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n > 0 else b""

    def do_GET(self):
        self.router._dispatch(self, "GET", b"")

    def do_POST(self):
        self.router._dispatch(self, "POST", self._read_body())

    def do_DELETE(self):
        self.router._dispatch(self, "DELETE", self._read_body())

    def send_json(self, obj, status: int = 200) -> None:
        self.send_body(json.dumps(obj).encode(), "application/json", status)

    def send_body(self, data: bytes, content_type: str,
                  status: int = 200) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class Router:
    """The load balancer. :meth:`start` binds the HTTP server and starts
    the health probe; :meth:`stop` ends both."""

    def __init__(self, endpoints: list[str], strategy: str = "performance",
                 probe_interval_s: float = 10.0):
        self.endpoints = [Endpoint(url=u.rstrip("/")) for u in endpoints]
        self.strategy: Strategy = STRATEGIES[strategy]()
        self.strategy_name = strategy
        self.probe_interval_s = probe_interval_s
        # (timestamp, output_tokens) events for the 1-hour throughput series.
        self._token_events: deque[tuple[float, int]] = deque(maxlen=100_000)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._probe_thread: threading.Thread | None = None
        self.server: http.server.ThreadingHTTPServer | None = None
        self._routes = {
            ("POST", "/v1/chat/completions"): self.proxy,
            ("POST", "/v1/completions"): self.proxy,
            ("GET", "/v1/models"): self.models,
            ("GET", "/router/status"): self.status,
            ("POST", "/router/endpoints"): self.add_endpoint,
            ("DELETE", "/router/endpoints"): self.remove_endpoint,
            ("POST", "/router/strategy"): self.set_strategy,
            ("GET", "/router/throughput"): self.throughput_series,
            ("GET", "/health"): lambda h, body: h.send_json(
                {"status": "ok"}),
        }

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        return self.server.server_address[1] if self.server else 0

    def start(self, host: str = "0.0.0.0", port: int = 8080) -> int:
        """Bind (``port`` 0: a free one), serve on a thread, probe once
        at once and then every ``probe_interval_s``. Returns the port."""
        handler = type("RouterHandler", (_Handler,), {"router": self})
        self.server = http.server.ThreadingHTTPServer((host, port), handler)
        self.server.daemon_threads = True
        threading.Thread(target=self.server.serve_forever, daemon=True,
                         name="router-http").start()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True, name="router-probe")
        self._probe_thread.start()
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=10.0)

    def run(self, host: str = "0.0.0.0", port: int = 8080) -> None:
        """Serve until interrupted."""
        self.start(host, port)
        try:
            while not self._stop.wait(1.0):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def probe_once(self) -> None:
        """One health pass: ``GET /cluster/status_json`` on every
        endpoint; a 200 marks it healthy and forgives one error."""
        for ep in list(self.endpoints):
            try:
                conn, prefix = _connection(ep.url, 5.0)
                try:
                    conn.request("GET", f"{prefix}/cluster/status_json")
                    resp = conn.getresponse()
                    data = resp.read()
                finally:
                    conn.close()
                ep.healthy = resp.status == 200
                if ep.healthy:
                    ep.status = json.loads(data)
                    ep.error_count = max(0, ep.error_count - 1)
            except Exception:
                ep.healthy = False
            ep.last_probe = time.time()

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self.probe_interval_s)

    def _dispatch(self, h: _Handler, method: str, body: bytes) -> None:
        path = urllib.parse.urlsplit(h.path).path
        fn = self._routes.get((method, path))
        try:
            if fn is None:
                h.send_json({"error": {"message": "not found"}}, 404)
                return
            fn(h, body)
        except (BrokenPipeError, ConnectionResetError):
            h.close_connection = True

    # -- proxy -------------------------------------------------------------

    @staticmethod
    def _affinity_key(request, payload: dict) -> str | None:
        """Stable per-session routing key: explicit session / user id
        (header or body), else the leading prompt bytes: a multi-turn
        chat's transcript grows append-only, so its head is stable."""
        for header in ("x-session-id", "x-user-id"):
            v = request.headers.get(header)
            if v:
                return v
        for field in ("session_id", "user"):
            v = payload.get(field)
            if isinstance(v, str) and v:
                return v
        messages = payload.get("messages")
        if isinstance(messages, list) and messages:
            # The first USER message, not messages[0]: chat apps share one
            # system prompt across every conversation.
            head = next(
                (m for m in messages
                 if isinstance(m, dict) and m.get("role") == "user"),
                messages[0],
            )
            return json.dumps(head, sort_keys=True)[:256]
        prompt = payload.get("prompt")
        if isinstance(prompt, str) and prompt:
            return prompt[:256]
        return None

    def _pick(self, h: _Handler, payload: dict) -> Endpoint | None:
        with self._lock:
            healthy = [e for e in self.endpoints if e.healthy]
            if isinstance(self.strategy, SessionAffinity):
                return self.strategy.pick(
                    healthy, key=self._affinity_key(h, payload),
                    all_endpoints=list(self.endpoints),
                )
            return self.strategy.pick(healthy)

    def proxy(self, h: _Handler, body: bytes) -> None:
        try:
            payload = json.loads(body)
        except Exception:
            h.send_json({"error": {"message": "invalid JSON"}}, 400)
            return
        if not isinstance(payload, dict):
            h.send_json({"error": {"message": "invalid JSON"}}, 400)
            return
        ep = self._pick(h, payload)
        if ep is None:
            h.send_json({"error": {"message": "no healthy endpoints"}}, 503)
            return
        with self._lock:
            ep.inflight += 1
            ep.total_requests += 1
        t0 = time.perf_counter()
        # Headers the upstream reads (the QoS class, deadline and tenant,
        # the session key) pass through; hop-by-hop ones do not.
        fwd = {k: v for k, v in h.headers.items()
               if k.lower().startswith("x-")}
        fwd["Content-Type"] = "application/json"
        conn, prefix = _connection(ep.url, UPSTREAM_TIMEOUT_S)
        started = False
        try:
            conn.request("POST", prefix + urllib.parse.urlsplit(h.path).path,
                         body=body, headers=fwd)
            upstream = conn.getresponse()
            if payload.get("stream") and upstream.status == 200:
                started = True
                self._proxy_stream(h, upstream, ep, t0)
                return
            data = upstream.read()
            if upstream.status == 200:
                self._finalize_json_metrics(ep, data, t0)
            else:
                with self._lock:
                    ep.error_count += 1
            h.send_body(data, upstream.getheader("Content-Type")
                        or "application/json", upstream.status)
        except (BrokenPipeError, ConnectionResetError) as e:
            if started:
                raise   # the client left mid-stream
            with self._lock:
                ep.error_count += 1
            h.send_json({"error": {"message": f"upstream failed: {e}"}},
                        502)
        except Exception as e:
            with self._lock:
                ep.error_count += 1
            if not started:
                h.send_json(
                    {"error": {"message": f"upstream failed: {e}"}}, 502)
            else:
                h.close_connection = True
        finally:
            conn.close()
            with self._lock:
                ep.inflight -= 1

    def _proxy_stream(self, h: _Handler, upstream, ep: Endpoint,
                      t0: float) -> None:
        """SSE pass-through: each upstream line goes out as it arrives
        (chunked), and the final ``usage`` record finalizes the EMAs."""
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()
        ttft = None
        usage = None
        while True:
            line = upstream.readline()
            if not line:
                break
            if ttft is None and line.strip():
                ttft = time.perf_counter() - t0
            text = line.decode(errors="ignore")
            if text.startswith("data: ") and '"usage"' in text:
                try:
                    usage = json.loads(text[6:]).get("usage") or usage
                except Exception:
                    pass
            h.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
            h.wfile.flush()
        h.wfile.write(b"0\r\n\r\n")
        h.wfile.flush()
        elapsed = time.perf_counter() - t0
        n_tokens = usage.get("completion_tokens", 0) if usage else 0
        tpot = (
            (elapsed - (ttft or 0.0)) / (n_tokens - 1) if n_tokens > 1
            else None
        )
        with self._lock:
            ep.observe(ttft, tpot)
        if n_tokens:
            self._token_events.append((time.time(), n_tokens))

    def _finalize_json_metrics(self, ep: Endpoint, data: bytes,
                               t0: float) -> None:
        """Non-stream responses carry usage: tokens a second, and the
        TTFT where the server reports it."""
        elapsed = time.perf_counter() - t0
        try:
            usage = json.loads(data).get("usage") or {}
        except Exception:
            return
        n = usage.get("completion_tokens", 0)
        ttft = usage.get("ttft_ms")
        with self._lock:
            ep.observe(
                ttft / 1e3 if ttft else None,
                (elapsed / n) if n else None,
            )
        if n:
            self._token_events.append((time.time(), n))

    # -- control APIs ------------------------------------------------------

    def models(self, h: _Handler, _body: bytes) -> None:
        for ep in list(self.endpoints):
            if not ep.healthy:
                continue
            try:
                conn, prefix = _connection(ep.url, 10.0)
                try:
                    conn.request("GET", f"{prefix}/v1/models")
                    data = conn.getresponse().read()
                finally:
                    conn.close()
                h.send_json(json.loads(data))
                return
            except Exception:
                continue
        h.send_json({"object": "list", "data": []})

    def status(self, h: _Handler, _body: bytes) -> None:
        with self._lock:
            out = {
                "strategy": self.strategy_name,
                "endpoints": [e.to_dict() for e in self.endpoints],
            }
        h.send_json(out)

    def add_endpoint(self, h: _Handler, body: bytes) -> None:
        url = json.loads(body)["url"].rstrip("/")
        with self._lock:
            if url not in [e.url for e in self.endpoints]:
                self.endpoints.append(Endpoint(url=url))
            urls = [e.url for e in self.endpoints]
        h.send_json({"endpoints": urls})

    def remove_endpoint(self, h: _Handler, body: bytes) -> None:
        url = json.loads(body)["url"].rstrip("/")
        with self._lock:
            self.endpoints = [e for e in self.endpoints if e.url != url]
            urls = [e.url for e in self.endpoints]
        h.send_json({"endpoints": urls})

    def set_strategy(self, h: _Handler, body: bytes) -> None:
        name = json.loads(body)["strategy"]
        if name not in STRATEGIES:
            h.send_json({"error": {"message": f"unknown strategy {name}"}},
                        400)
            return
        with self._lock:
            self.strategy = STRATEGIES[name]()
            self.strategy_name = name
        h.send_json({"strategy": name})

    def throughput_series(self, h: _Handler, _body: bytes) -> None:
        """Tokens a minute over the last hour."""
        now = time.time()
        buckets = [0] * 60
        for ts, n in list(self._token_events):
            age_min = int((now - ts) // 60)
            if 0 <= age_min < 60:
                buckets[59 - age_min] += n
        h.send_json({"tokens_per_minute": buckets})


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("parallax-tpu-torch router")
    ap.add_argument("--endpoints", nargs="+", required=True)
    ap.add_argument("--strategy", default="performance",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)
    Router(args.endpoints, args.strategy).run(args.host, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
