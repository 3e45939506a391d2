"""Swarm serving from a chat host (port of ``parallax_tpu/backend/run.py``'s
``SwarmClient`` and ``chat-host``).

    python -m parallax_tpu_torch chat-host --head 10.0.0.1:7000 --port 8000

A chat host runs the OpenAI HTTP plane on a machine that is not a worker,
hands each request to a scheduler-less swarm's head worker over RPC with
an empty routing table (the head routes it from its gossip), and polls the
head for the tokens the frontend streams. It touches no CUDA tensor.

Not ported yet: ``run`` with its global scheduler, the scheduler's
routing, the migration-following and re-routing rungs of the poll loop
(they ask a scheduler where a request went), the HA failover and the web
UI (ROADMAP queue 1 item 4b).
"""

from __future__ import annotations

import random
import threading
import time

from parallax_tpu_torch.backend.http_server import (
    OpenAIFrontend,
    load_tokenizer,
)
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.p2p.transport import TcpTransport, Transport
from parallax_tpu_torch.runtime.request import Request, RequestStatus
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


class SwarmClient:
    """Submits requests to a head node over the transport and mirrors
    token progress back into the local Request (the HTTP frontend streams
    from it). The scheduler-less form only: the JAX client's ``service``
    (a scheduler to route through) waits for ROADMAP queue 1 item 4b."""

    def __init__(self, transport: Transport, poll_interval_s: float = 0.02,
                 default_head: str | None = None):
        self.transport = transport
        self.poll_interval_s = poll_interval_s
        self.default_head = default_head
        # rid -> head node id, for stop-string early finish.
        self._heads: dict[str, str] = {}

    def route(self, request_id: str) -> list[str] | None:
        """Probe the head's readiness: ``[]`` (the head routes) when it
        can serve, None (the frontend's retryable 503) while the swarm is
        still loading or has no route."""
        if self.default_head is None:
            return None
        try:
            r = self.transport.call(
                self.default_head, proto.CHAT_READY, None, timeout=5.0
            )
        except Exception:
            return None
        return [] if isinstance(r, dict) and r.get("ready") else None

    def submit(self, request: Request) -> threading.Event:
        if request.routing_table:
            head = request.routing_table[0]
        elif self.default_head is not None:
            head = self.default_head
        else:
            raise RuntimeError("request has no routing table")
        payload = {
            "rid": request.request_id,
            "prompt_ids": request.prompt_ids,
            "sampling_params": request.sampling_params.to_dict(),
            "routing_table": request.routing_table,
            "eos_token_ids": list(request.eos_token_ids),
            "lora_id": request.lora_id,
        }
        try:
            self.transport.call(head, proto.CHAT_SUBMIT, payload,
                                timeout=30.0)
        except Exception:
            raise RuntimeError(f"head node {head} unreachable")
        ev = threading.Event()
        self._heads[request.request_id] = head
        t = threading.Thread(
            target=self._poll_loop, args=(request, head, ev), daemon=True
        )
        t.start()
        return ev

    def stop(self, request_id: str) -> None:
        """Ask the head node to finish a request early (stop-string match);
        best-effort."""
        head = self._heads.get(request_id)
        if head is None:
            return
        try:
            self.transport.call(
                head, proto.CHAT_STOP, {"rid": request_id}, timeout=10.0
            )
        except Exception as e:
            logger.warning("chat_stop failed for %s: %s", request_id, e)

    def _poll_loop(self, request: Request, head: str, ev: threading.Event):
        try:
            self._poll_until_done(request, head, ev)
        finally:
            self._heads.pop(request.request_id, None)

    def _poll_until_done(self, request: Request, head: str,
                         ev: threading.Event):
        rid = request.request_id
        failures = 0
        while True:
            try:
                r = self.transport.call(
                    head, proto.CHAT_POLL, {"rid": rid}, timeout=10.0
                )
                failures = 0
            except Exception as e:
                failures += 1
                if failures > 10:
                    request.abort(f"head node unreachable: {e}")
                    ev.set()
                    return
                # Jittered exponential backoff between failed polls (full
                # jitter, base 0.25 s, cap 2 s, as the JAX client's).
                time.sleep(random.uniform(
                    0.0, min(2.0, 0.25 * 2 ** (failures - 1))))
                continue
            if "error" in r:
                request.abort(r["error"])
                ev.set()
                return
            ids = r["output_ids"]
            if len(ids) > len(request.output_ids):
                request.output_ids[:] = ids
                lps = r.get("output_logprobs")
                if lps:
                    request.output_logprobs[:] = lps
            if r["finished"]:
                request.set_status(RequestStatus(r["status"]),
                                   "client-finish")
                ev.set()
                return
            time.sleep(self.poll_interval_s)


def build_chat_host_frontend(
    head_addr: str,
    tokenizer,
    model_name: str,
    transport: TcpTransport | None = None,
) -> tuple[OpenAIFrontend, SwarmClient]:
    """Standalone chat host on a non-worker machine (reference
    ``node_chat_http_server.py`` + ``launch_chat.py``): the OpenAI API
    proxying to one scheduler-less head worker, which fills in its own
    gossip routing table for the empty table this host submits."""
    if transport is None:
        transport = TcpTransport("", "127.0.0.1")
        transport.start()
        transport.peer_id = transport.address
    client = SwarmClient(transport, default_head=head_addr)
    frontend = OpenAIFrontend(
        tokenizer,
        submit_fn=client.submit,
        route_fn=client.route,
        model_name=model_name,
        stop_fn=client.stop,
    )
    return frontend, client


def chat_host_main(args, on_start=None) -> int:
    """CLI ``chat-host``: serve the OpenAI API, proxying to a swarm head
    worker, until the frontend shuts down (SIGINT / SIGTERM).
    ``on_start(frontend)`` runs once the socket is bound."""
    import signal

    tokenizer = load_tokenizer(args.model_path)
    frontend, client = build_chat_host_frontend(
        args.head, tokenizer, args.model_name or "parallax-tpu",
    )

    def started(fe: OpenAIFrontend) -> None:
        logger.info("chat host on :%d -> head %s", fe.port, args.head)
        if on_start is not None:
            on_start(fe)

    if threading.current_thread() is threading.main_thread():
        # shutdown() blocks until serve_forever returns: call it off the
        # serving thread.
        def shutdown(*_):
            threading.Thread(target=frontend.shutdown, daemon=True).start()

        signal.signal(signal.SIGINT, shutdown)
        signal.signal(signal.SIGTERM, shutdown)
    try:
        frontend.run(host=args.host, port=args.port, on_start=started)
    finally:
        client.transport.stop()
    return 0
