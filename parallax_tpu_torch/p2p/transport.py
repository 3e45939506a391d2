"""Pluggable transport with the Lattica-equivalent RPC surface (port of
``parallax_tpu/p2p/transport.py``).

Two backends:

- :class:`LoopbackTransport` — in-process peer registry (tests,
  single-host multi-stage).
- :class:`TcpTransport` — asyncio TCP with 4-byte length-prefixed msgpack
  frames. Connections are dialed lazily, kept alive, and redialed on
  failure.

Both expose the same synchronous facade (the engine loop is a thread):
``call(peer, method, payload)`` for request/response RPCs and
``send(peer, method, payload)`` for fire-and-forget data-plane frames.
:class:`AsyncSender` takes serialization and socket I/O off the step
thread: one bounded FIFO and drain thread per peer.

The frames are the JAX package's, so a port node and a JAX node talk to
each other, through a relay too. NAT traversal is the **relay mode**, as
in the JAX transport: a worker that accepts no inbound dials keeps one
outbound connection to a relay (normally the scheduler's transport),
registers its identity over it (:meth:`TcpTransport.register_at_relay`,
with the swarm's ``relay_token`` where the relay sets one) and goes by
the address ``relay:<id>@<relay host:port>``. A peer sending to such an
address wraps its frame in a ``__relay__`` envelope to the relay, which
passes it down the worker's reverse connection as ``__relayed__`` (or
delivers it itself, or dials a plain ``host:port`` addressee out);
replies ride the same path back. The relay never decodes the inner
frame. :meth:`TcpTransport.transport_stats` counts the envelopes and
bytes it routed, its registrations, and the dials and inbound
connections of the transport. Not ported: the conformance sanitizer's
frame hooks (item 14). The transport's threads touch no CUDA tensor:
frames carry CPU tensors only.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.p2p.proto import decode_frame, encode_frame
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)

Handler = Callable[[str, Any], Any]  # (from_peer, payload) -> reply or None


class TransportError(Exception):
    pass


# Marker for "this build has no handler registered for that method" —
# callers (wire-caps negotiation) classify it as a definitive answer
# rather than a transient failure, so the wording is a contract.
NO_HANDLER_MARK = "no handler for"


class Transport:
    """RPC surface shared by all backends."""

    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self._handlers: dict[str, Handler] = {}

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def _dispatch(self, method: str, from_peer: str, payload: Any) -> Any:
        handler = self._handlers.get(method)
        if handler is None:
            raise TransportError(
                f"{self.peer_id}: {NO_HANDLER_MARK} {method}"
            )
        return handler(from_peer, payload)

    # -- backend API -------------------------------------------------------

    def call(self, peer: str, method: str, payload: Any,
             timeout: float = 30.0) -> Any:
        raise NotImplementedError

    def send(self, peer: str, method: str, payload: Any) -> None:
        """Fire-and-forget; may raise on connection failure."""
        raise NotImplementedError

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


# ---------------------------------------------------------------------------


class LoopbackTransport(Transport):
    """In-process transport: peers share a registry dict."""

    def __init__(self, peer_id: str,
                 registry: dict[str, "LoopbackTransport"]):
        super().__init__(peer_id)
        self._registry = registry
        registry[peer_id] = self

    def call(self, peer: str, method: str, payload: Any,
             timeout: float = 30.0) -> Any:
        target = self._registry.get(peer)
        if target is None:
            raise TransportError(f"unknown peer {peer}")
        return target._dispatch(method, self.peer_id, payload)

    def send(self, peer: str, method: str, payload: Any) -> None:
        self.call(peer, method, payload)


# ---------------------------------------------------------------------------


class TcpTransport(Transport):
    """Asyncio TCP transport with a background event-loop thread.

    Peers are addressed as ``"host:port"`` strings, or
    ``"relay:<id>@<host:port>"`` for a worker behind a relay. Every frame is
    ``[u32 length][msgpack bytes]``; requests carry a msg id, replies echo
    it in ``re``. ``relay_token`` is the swarm's secret for relay
    registration: as the relay, every registration must present it; as a
    NAT'd worker, :meth:`register_at_relay` presents it. None disables
    the token check (the identity binding to the connection's
    ``__hello__`` still applies).
    """

    def __init__(self, peer_id: str, host: str = "127.0.0.1", port: int = 0,
                 relay_token: str | None = None):
        super().__init__(peer_id)
        self.host = host
        self.port = port
        self.relay_token = relay_token
        # Dedicated handler pool: a blocking handler must not starve
        # announcements or data frames.
        self._executor = ThreadPoolExecutor(
            max_workers=128, thread_name_prefix=f"rpc-{peer_id or 'node'}"
        )
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: dict[str, tuple] = {}  # peer -> (reader, writer, lock)
        # peer -> the lock its dial runs under (one connection per peer).
        self._dial_locks: dict[str, asyncio.Lock] = {}
        self._pending: dict[int, "asyncio.Future"] = {}
        # Dialed connection -> ids of the calls awaiting a reply on it: a
        # connection that closes fails them at once, so a call to a peer
        # that died mid-call does not wait out its timeout (a scheduler
        # failover rotates on that failure).
        self._conn_calls: dict[int, set[int]] = {}
        self._msg_id = 0
        self._started = threading.Event()
        self._stopped = False
        self._stop_lock = make_lock("transport.stop")
        # Writers of inbound connections, so stop() can close them and let
        # their read loops exit instead of being destroyed mid-await.
        self._server_writers: set[asyncio.StreamWriter] = set()
        # Relay role: relay-registered worker id -> reverse-connection
        # writer.
        self._relay_routes: dict[str, asyncio.StreamWriter] = {}
        # Relayed one-way frames this transport delivers to itself run in
        # arrival order under this lock (a connection's own lock otherwise).
        self._self_order: asyncio.Lock | None = None
        self._local_ips: set[str] | None = None
        # Telemetry (transport_stats): dials per peer, inbound connections,
        # and as the relay, envelopes and inner bytes routed per addressee
        # plus the registrations taken and refused.
        self._stats_lock = make_lock("transport.stats")
        self._dials: dict[str, int] = {}
        self._accepted = 0
        self._relay_routed: dict[str, list[int]] = {}
        self._relay_registrations = 0
        self._relay_rejected = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started.is_set():
            return  # idempotent: callers may pre-start to learn the port
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True, name=f"tcp-{self.peer_id}"
        )
        self._thread.start()
        if not self._started.wait(10.0):
            raise TransportError("transport failed to start")

    def _run_loop(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
            self._loop.run_forever()
        except Exception:
            logger.exception("transport %s failed to serve", self.peer_id)
        finally:
            self._loop.close()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        with self._stop_lock:
            if self._loop is None or self._stopped:
                return
            self._stopped = True

        async def _shutdown():
            if self._server is not None:
                # close() only stops accepting; wait_closed() must come
                # AFTER the handler tasks are cancelled (on 3.12+ it waits
                # for every connection handler to finish).
                self._server.close()
            for _reader, writer, _lock in list(self._conns.values()):
                writer.close()
            self._conns.clear()
            self._dial_locks.clear()
            for writer in list(self._server_writers):
                writer.close()
            self._server_writers.clear()
            self._relay_routes.clear()
            current = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not current]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if self._server is not None:
                await self._server.wait_closed()

        try:
            if self._loop.is_running():
                asyncio.run_coroutine_threadsafe(
                    _shutdown(), self._loop
                ).result(5.0)
        except Exception as e:  # loop already closed / a task outlived it
            logger.warning("transport %s teardown incomplete: %r",
                           self.peer_id, e)
        finally:
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError:  # loop already closed
                pass
        if self._thread:
            self._thread.join(timeout=2.0)
        self._executor.shutdown(wait=False, cancel_futures=True)

    # -- framing -----------------------------------------------------------

    @staticmethod
    async def _read_frame(reader: asyncio.StreamReader) -> dict | None:
        try:
            header = await reader.readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        (length,) = struct.unpack(">I", header)
        try:
            data = await reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None
        return decode_frame(data)

    @staticmethod
    def _write_frame(writer: asyncio.StreamWriter, data: bytes) -> None:
        writer.write(struct.pack(">I", len(data)) + data)

    # -- server side -------------------------------------------------------

    async def _on_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer_name = "?"
        self._server_writers.add(writer)
        with self._stats_lock:
            self._accepted += 1
        in_order = asyncio.Lock()
        try:
            while True:
                frame = await self._read_frame(reader)
                if frame is None:
                    break
                if frame["t"] == "__hello__":
                    peer_name = frame["p"]
                    continue
                if self._handle_relay_frame(frame, peer_name, writer,
                                            in_order):
                    continue
                if frame.get("re") is not None:
                    fut = self._pending.pop(frame["re"], None)
                    if fut is not None and not fut.done():
                        fut.set_result(frame["p"])
                    continue
                asyncio.ensure_future(
                    self._handle_request(frame, peer_name, writer, in_order)
                )
        finally:
            # Runs even when a malformed frame ends the read loop: a dead
            # reverse route would black-hole relayed frames until the
            # worker's next registration, and churning workers would grow
            # the map.
            for rid, w in list(self._relay_routes.items()):
                if w is writer:
                    self._relay_routes.pop(rid, None)
            self._server_writers.discard(writer)
            writer.close()

    # -- relay protocol ----------------------------------------------------

    def _handle_relay_frame(self, frame, peer_name, writer,
                            in_order: asyncio.Lock) -> bool:
        """Transport-level relay frames; True when consumed."""
        t = frame["t"]
        if t == "__relay_register__":
            self._register_route(frame["p"], peer_name, writer)
            return True
        if t == "__relay__":
            # Off the read loop: routing can wait on the addressee's
            # backpressure or a dial-out, which must not stall the
            # sender's own frames.
            asyncio.ensure_future(self._route_envelope(frame["p"]))
            return True
        if t == "__relayed__":
            env = frame["p"]
            asyncio.ensure_future(self._deliver_relayed(
                env["from"], env["data"], writer, in_order))
            return True
        return False

    def _register_route(self, p, peer_name: str, writer) -> None:
        if isinstance(p, dict):
            rid, token = p.get("id"), p.get("token")
        else:   # a bare-id registration (older builds)
            rid, token = p, None
        # Identity binding: a registration may only claim the id its
        # connection introduced itself with (__hello__).
        if rid != peer_name:
            logger.warning("relay: REJECTED registration for %s from a "
                           "connection hello'd as %s (identity mismatch)",
                           rid, peer_name)
            with self._stats_lock:
                self._relay_rejected += 1
            return
        if self.relay_token is not None and token != self.relay_token:
            logger.warning("relay: REJECTED registration for %s (bad or "
                           "missing relay token)", rid)
            with self._stats_lock:
                self._relay_rejected += 1
            return
        prev = self._relay_routes.get(rid)
        if prev is not None and prev is not writer and not prev.is_closing():
            # A live route replaced by another connection: a reconnect whose
            # old socket died half-open (a NAT rebind the relay never saw a
            # FIN for) or, without a token, an id-faking hijack; the two
            # look the same here. Availability first: replace the route and
            # close the stale socket. --relay-token authenticates.
            logger.warning(
                "relay: reverse route for %s replaced by another live "
                "connection (%s)", rid,
                "authenticated reconnect" if self.relay_token is not None
                else "reconnect or HIJACK: set --relay-token to "
                     "authenticate registrations")
            prev.close()
        self._relay_routes[rid] = writer
        with self._stats_lock:
            self._relay_registrations += 1
        # Heartbeat refreshes are routine; only a new route is news.
        logger.log(20 if prev is None else 10,
                   "relay: registered reverse route for %s", rid)

    def _count_routed(self, to: str, env: dict, sign: int = 1) -> None:
        """Count one envelope routed to ``to`` (``sign=-1`` takes a count
        back for an envelope whose send failed)."""
        with self._stats_lock:
            c = self._relay_routed.setdefault(to, [0, 0])
            c[0] += sign
            c[1] += sign * len(env["data"])

    async def _route_envelope(self, env: dict) -> bool:
        """Pass one envelope on: to this transport itself, down a
        registered reverse route, or out to a plain ``host:port``
        addressee. False when there is no route (the envelope is
        dropped)."""
        to = env["to"]
        if to == self.peer_id:
            # Terminal hop: the relay is the addressee.
            self._count_routed(to, env)
            if self._self_order is None:
                self._self_order = asyncio.Lock()
            await self._deliver_relayed(env["from"], env["data"], None,
                                        self._self_order)
            return True
        route = self._relay_routes.get(to)
        if route is not None and not route.is_closing():
            self._count_routed(to, env)
            self._write_frame(route, encode_frame("__relayed__", env))
            try:
                await route.drain()
            except ConnectionError:
                self._relay_routes.pop(to, None)
            return True
        if ":" in to and not to.startswith("relay:"):
            # A dialable peer (a direct worker answering a NAT'd one).
            # Counted before the write, as the other routes are: the
            # addressee may act on the frame (and read these stats) before
            # the send returns here.
            self._count_routed(to, env)
            try:
                await self._send_async(to, encode_frame("__relayed__", env))
                return True
            except OSError as e:
                self._count_routed(to, env, sign=-1)
                logger.warning("relay: dial-out to %s failed: %s", to, e)
        logger.warning("relay: no route to %s", to)
        return False

    async def _deliver_relayed(self, from_peer: str, data: bytes,
                               reply_writer, in_order: asyncio.Lock) -> None:
        """A relayed end-to-end frame reached its addressee. One-way
        frames run in arrival order, as a direct connection's do."""
        inner = decode_frame(data)
        if inner.get("re") is not None:
            fut = self._pending.pop(inner["re"], None)
            if fut is not None and not fut.done():
                fut.set_result(inner["p"])
            return
        try:
            if inner["id"]:
                result = await self._loop.run_in_executor(
                    self._executor, self._dispatch, inner["t"], from_peer,
                    inner["p"])
            else:
                async with in_order:
                    result = await self._loop.run_in_executor(
                        self._executor, self._dispatch, inner["t"],
                        from_peer, inner["p"])
        except Exception as e:
            logger.exception("relayed handler %s failed", inner["t"])
            result = {"__error__": str(e)}
        if not inner["id"]:
            return
        reply = encode_frame("__reply__", result, reply_to=inner["id"])
        env = {"to": from_peer, "from": self.peer_id, "data": reply}
        if reply_writer is not None and not reply_writer.is_closing():
            # Back out the way the request came in.
            self._write_frame(reply_writer,
                              encode_frame("__relay__", env, msg_id=0))
            try:
                await reply_writer.drain()
            except ConnectionError:
                pass
        else:
            await self._route_envelope(env)

    async def _handle_request(self, frame, peer_name, writer,
                              in_order: asyncio.Lock) -> None:
        """Run a frame's handler on the pool. One-way frames (``send``:
        FORWARD, RELEASE, ABORT) of one connection run one at a time in
        arrival order, under the connection's ``in_order`` lock (tasks
        take it in creation order), so the sender's per-peer FIFO holds
        into the receiver's inbox: a prompt's chunks arrive in order and a
        RELEASE after its request's last FORWARD. Calls run concurrently.
        (The JAX transport runs every frame concurrently; ROADMAP queue
        3.)"""
        try:
            if frame["id"]:
                result = await self._loop.run_in_executor(
                    self._executor, self._dispatch, frame["t"], peer_name,
                    frame["p"],
                )
            else:
                async with in_order:
                    result = await self._loop.run_in_executor(
                        self._executor, self._dispatch, frame["t"],
                        peer_name, frame["p"],
                    )
        except Exception as e:  # reply with an error marker
            logger.exception("handler %s failed", frame["t"])
            result = {"__error__": str(e)}
        if frame["id"]:
            self._write_frame(
                writer, encode_frame("__reply__", result, reply_to=frame["id"])
            )
            try:
                await writer.drain()
            except ConnectionError:
                pass

    # -- client side -------------------------------------------------------

    async def _get_conn(self, peer: str):
        conn = self._conns.get(peer)
        if conn is not None and not conn[1].is_closing():
            return conn
        # One dial per peer at a time: concurrent first calls share the
        # connection. (The JAX transport dials once per caller; the
        # writers it then drops are closed when collected and the last
        # pump's EOF unmaps the live one, so every such call times out:
        # ROADMAP queue 3.)
        async with self._dial_locks.setdefault(peer, asyncio.Lock()):
            conn = self._conns.get(peer)
            if conn is not None and not conn[1].is_closing():
                return conn
            host, port_s = peer.rsplit(":", 1)
            reader, writer = await asyncio.open_connection(host, int(port_s))
            with self._stats_lock:
                self._dials[peer] = self._dials.get(peer, 0) + 1
            self._write_frame(writer, encode_frame("__hello__", self.peer_id))
            await writer.drain()
            conn = (reader, writer, asyncio.Lock())
            self._conns[peer] = conn
            asyncio.ensure_future(self._pump_replies(peer, conn))
            return conn

    async def _pump_replies(self, peer: str, conn: tuple):
        """Replies to our requests arrive on the connection we dialed."""
        reader, writer, _lock = conn
        in_order = asyncio.Lock()
        while True:
            frame = await self._read_frame(reader)
            if frame is None:
                if self._conns.get(peer) is conn:
                    self._conns.pop(peer, None)
                for mid in self._conn_calls.pop(id(conn), ()):
                    fut = self._pending.get(mid)
                    if fut is not None and not fut.done():
                        fut.set_exception(ConnectionResetError(
                            f"{peer} closed the connection mid-call"))
                return
            if self._handle_relay_frame(frame, peer, writer, in_order):
                continue
            if frame.get("re") is not None:
                fut = self._pending.pop(frame["re"], None)
                if fut is not None and not fut.done():
                    fut.set_result(frame["p"])
            else:
                # Peer-initiated frame on our client connection.
                asyncio.ensure_future(
                    self._handle_request(frame, peer, writer, in_order)
                )

    @staticmethod
    def _parse_relay_addr(peer: str) -> tuple[str, str] | None:
        """``relay:<id>@<host:port>`` -> (the full target id, the relay's
        address); None for a plain address."""
        if not peer.startswith("relay:") or "@" not in peer:
            return None
        return peer, peer.rsplit("@", 1)[1]

    def _is_self_addr(self, addr: str) -> bool:
        """Is ``addr`` one of this transport's own addresses? (The bind
        address is often 0.0.0.0, never what peers dialed.)"""
        host, _, port_s = addr.rpartition(":")
        try:
            if int(port_s) != self.port:
                return False
        except ValueError:
            return False
        if self.host not in ("0.0.0.0", "::"):
            return host == self.host
        if host in ("127.0.0.1", "localhost", "0.0.0.0"):
            return True
        if self._local_ips is None:
            try:
                self._local_ips = set(
                    socket.gethostbyname_ex(socket.gethostname())[2])
            except OSError:
                self._local_ips = set()
        return host in self._local_ips

    async def _relay_target(self, peer: str,
                            data: bytes) -> tuple[str, bytes] | None:
        """Where ``data`` for ``peer`` goes: (the address to dial, the
        bytes to write), the frame wrapped in a ``__relay__`` envelope for a
        relayed peer; None once this transport routed it itself (it is
        that peer's relay)."""
        relayed = self._parse_relay_addr(peer)
        if relayed is None:
            return peer, data
        target, relay_addr = relayed
        env = {"to": target, "from": self.peer_id, "data": data}
        if target in self._relay_routes or self._is_self_addr(relay_addr):
            if not await self._route_envelope(env):
                raise TransportError(f"relay: no route to {target}")
            return None
        return relay_addr, encode_frame("__relay__", env, msg_id=0)

    async def _send_async(self, peer: str, data: bytes) -> None:
        target = await self._relay_target(peer, data)
        if target is None:
            return
        reader, writer, lock = await self._get_conn(target[0])
        async with lock:
            self._write_frame(writer, target[1])
            await writer.drain()

    async def _call_async(self, peer: str, method: str, payload, timeout):
        self._msg_id += 1
        mid = self._msg_id
        fut = self._loop.create_future()
        self._pending[mid] = fut
        calls = None
        try:
            target = await self._relay_target(
                peer, encode_frame(method, payload, msg_id=mid))
            if target is not None:
                # A relayed call's reply comes back over the relay's
                # connection: its close fails the call too.
                conn = await self._get_conn(target[0])
                calls = self._conn_calls.setdefault(id(conn), set())
                calls.add(mid)
                _reader, writer, lock = conn
                async with lock:
                    self._write_frame(writer, target[1])
                    await writer.drain()
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(mid, None)
            if calls is not None:
                calls.discard(mid)

    # -- relay client --------------------------------------------------------

    def register_at_relay(self, relay_addr: str) -> None:
        """NAT'd worker: open or refresh the reverse route at
        ``relay_addr``. Idempotent: call it again (every heartbeat) to
        register anew after a dropped connection; the relay replaces the
        route and closes the stale socket. Without a relay token any peer
        can claim any id, so tokenless relay mode is for trusted networks
        only."""

        async def _register():
            _, writer, lock = await self._get_conn(relay_addr)
            async with lock:
                self._write_frame(writer, encode_frame(
                    "__relay_register__",
                    {"id": self.peer_id, "token": self.relay_token},
                    msg_id=0))
                await writer.drain()

        asyncio.run_coroutine_threadsafe(_register(), self._loop).result(10.0)

    def transport_stats(self) -> dict:
        """Dials per peer address, inbound connections accepted, and as a
        relay: envelopes and inner-frame bytes routed per addressee (and in
        all), reverse routes live, registrations taken and refused."""
        with self._stats_lock:
            routed = {to: {"envelopes": c[0], "bytes": c[1]}
                      for to, c in self._relay_routed.items()}
            return {
                "dials": dict(self._dials),
                "accepted": self._accepted,
                "relay": {
                    "routed": routed,
                    "envelopes": sum(c["envelopes"] for c in routed.values()),
                    "bytes": sum(c["bytes"] for c in routed.values()),
                    "routes": len(self._relay_routes),
                    "registrations": self._relay_registrations,
                    "rejected": self._relay_rejected,
                },
            }

    # -- public sync facade --------------------------------------------------

    def call(self, peer: str, method: str, payload: Any,
             timeout: float = 30.0) -> Any:
        fut = asyncio.run_coroutine_threadsafe(
            self._call_async(peer, method, payload, timeout), self._loop
        )
        result = fut.result(timeout + 5.0)
        if isinstance(result, dict) and "__error__" in result:
            raise TransportError(result["__error__"])
        return result

    def send(self, peer: str, method: str, payload: Any) -> None:
        data = encode_frame(method, payload, msg_id=0)
        fut = asyncio.run_coroutine_threadsafe(
            self._send_async(peer, data), self._loop
        )
        fut.result(30.0)

    def measure_rtt(self, peer: str, samples: int = 3) -> float:
        """Seconds of round trip to a peer (the best of ``samples``)."""
        best = float("inf")
        for _ in range(samples):
            t0 = time.perf_counter()
            self.call(peer, "__ping__", None, timeout=5.0)
            best = min(best, time.perf_counter() - t0)
        return best


def make_ping_handler() -> Handler:
    return lambda _peer, _payload: "pong"


# ---------------------------------------------------------------------------


class AsyncSender:
    """Per-peer sender pipeline over any :class:`Transport`.

    The engine's step thread must never block on serialization or socket
    I/O. ``send()`` therefore only enqueues: each peer gets a bounded FIFO
    queue drained by its own worker thread, which (lazily) serializes the
    payload and runs the blocking ``transport.send``. One worker per peer
    preserves per-peer in-order delivery; independent peers drain
    concurrently.

    Backpressure is a hard failure, not buffering: a full queue or a
    failed send drops the frame, drains whatever else is queued for that
    peer and fires ``on_failure(peer, reason)`` once per incident. Frames
    sent with ``best_effort=True`` (release broadcasts) never fire the
    failure callback but still count in the error telemetry, and a
    best-effort frame that overflows the queue is dropped alone.

    ``payload`` may be a zero-arg callable for lazy serialization (run on
    the worker); it returns either the payload or a ``(payload,
    raw_bytes, wire_bytes)`` tuple feeding the per-link telemetry.

    Links idle for ``idle_reap_s`` retire themselves; the next send to
    that peer recreates the link. The JAX sender also records its
    overflows in the flight recorder (ROADMAP queue 1 item 9).
    """

    _CLOSE = object()

    def __init__(
        self,
        transport: Transport,
        max_queue: int = 256,
        on_failure: Callable[[str, str], None] | None = None,
        idle_reap_s: float = 300.0,
        name: str = "",
    ):
        self.transport = transport
        self.max_queue = max_queue
        self.on_failure = on_failure
        self.idle_reap_s = idle_reap_s
        self.name = name
        self._links: dict[str, "_PeerLink"] = {}
        self._lock = make_lock("transport.sender")
        self._closed = False

    def send(
        self, peer: str, method: str, payload: Any,
        best_effort: bool = False,
    ) -> None:
        """Enqueue one frame for ``peer``; never blocks, never raises."""
        overflow = False
        with self._lock:
            if self._closed:
                return
            link = self._links.get(peer)
            if link is None:
                link = _PeerLink(peer, self)
                self._links[peer] = link
            # Enqueue under the lock: the idle-reap check runs under the
            # same lock, so a frame never lands in a retiring queue.
            try:
                link.queue.put_nowait((method, payload, best_effort))
            except _queue.Full:
                if best_effort:
                    # A courtesy frame that does not fit is dropped ALONE:
                    # what is queued is live traffic.
                    with link.stats_lock:
                        link.stats["drops"] += 1
                else:
                    # One incident: everything queued is stale once the
                    # abort path fires, so drain it all and report once.
                    dropped = 1 + link.drain()
                    with link.stats_lock:
                        link.stats["drops"] += dropped
                    overflow = True
            depth = link.queue.qsize()
            with link.stats_lock:
                if depth > link.stats["queue_peak"]:
                    link.stats["queue_peak"] = depth
        if overflow:
            self._fail(
                peer,
                f"send queue overflow (> {self.max_queue} frames queued)",
            )

    def _fail(self, peer: str, reason: str) -> None:
        logger.error("sender%s: link to %s failed: %s",
                     f"[{self.name}]" if self.name else "", peer, reason)
        if self.on_failure is not None:
            try:
                self.on_failure(peer, reason)
            except Exception:
                logger.exception("sender failure callback raised")

    def queue_depth(self, peer: str) -> int:
        """Frames currently queued for one peer (0 if no live link)."""
        with self._lock:
            link = self._links.get(peer)
        return link.queue.qsize() if link is not None else 0

    def stats(self) -> dict[str, dict]:
        """Per-link telemetry: bytes/frames out, serialize/send ms,
        queue depth + peak, drops/errors, achieved compression ratio."""
        out = {}
        with self._lock:
            links = list(self._links.items())
        for peer, link in links:
            with link.stats_lock:
                s = dict(link.stats)
            s["queue_depth"] = link.queue.qsize()
            raw, wire = s.pop("raw_bytes"), s["bytes_out"]
            s["compression_ratio"] = (
                round(raw / wire, 3) if raw and wire else 1.0
            )
            s["serialize_ms"] = round(s["serialize_ms"], 3)
            s["send_ms"] = round(s["send_ms"], 3)
            out[peer] = s
        return out

    def close(self, timeout: float = 2.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            links = list(self._links.values())
        for link in links:
            try:
                link.queue.put_nowait((None, self._CLOSE, True))
            except _queue.Full:
                # Queued frames are abandoned on close anyway: drain so the
                # sentinel fits and the worker exits.
                link.drain()
                try:
                    link.queue.put_nowait((None, self._CLOSE, True))
                except _queue.Full:
                    pass
        # One deadline across all workers (sentinels are already queued).
        deadline = time.monotonic() + timeout
        for link in links:
            link.thread.join(timeout=max(0.0, deadline - time.monotonic()))


class _PeerLink:
    """One peer's bounded in-order queue + drain thread."""

    def __init__(self, peer: str, sender: AsyncSender):
        self.peer = peer
        self.sender = sender
        self.queue: _queue.Queue = _queue.Queue(maxsize=sender.max_queue)
        # Counters are bumped from both the caller (send(): drops,
        # queue_peak) and the worker (frames/bytes/errors): every stats
        # mutation/snapshot takes this lock. send() acquires it while
        # holding the sender lock; the worker takes it alone.
        self.stats_lock = make_lock("transport.link_stats")
        self.stats = {
            "frames_out": 0,
            "bytes_out": 0,
            "raw_bytes": 0,
            "serialize_ms": 0.0,
            "send_ms": 0.0,
            "queue_peak": 0,
            "drops": 0,
            "errors": 0,
        }
        self.thread = threading.Thread(
            target=self._drain, daemon=True,
            name=(
                f"sender-{sender.name}-{peer}" if sender.name
                else f"sender-{peer}"
            ),
        )
        self.thread.start()

    def drain(self) -> int:
        """Drop everything queued (stale after a link incident); returns
        the count. A close sentinel pulled mid-drain is re-queued so the
        worker still exits."""
        drained = 0
        while True:
            try:
                item = self.queue.get_nowait()
            except _queue.Empty:
                return drained
            if item[1] is AsyncSender._CLOSE:
                self.queue.put_nowait(item)
                return drained
            drained += 1

    def _retire_if_idle(self) -> bool:
        """Idle reap, unless a frame raced in (the empty-check runs under
        the sender lock that ``send()`` enqueues under)."""
        with self.sender._lock:
            if not self.queue.empty():
                return False
            if self.sender._links.get(self.peer) is self:
                del self.sender._links[self.peer]
            return True

    def _drain(self) -> None:
        while True:
            try:
                item = self.queue.get(timeout=self.sender.idle_reap_s)
            except _queue.Empty:
                if self._retire_if_idle():
                    return
                continue
            method, payload, best_effort = item
            if payload is AsyncSender._CLOSE:
                return
            try:
                t0 = time.perf_counter()
                raw_b = wire_b = 0
                if callable(payload):
                    payload = payload()
                    if isinstance(payload, tuple) and len(payload) == 3:
                        payload, raw_b, wire_b = payload
                t1 = time.perf_counter()
                self.sender.transport.send(self.peer, method, payload)
                t2 = time.perf_counter()
                with self.stats_lock:
                    s = self.stats
                    s["frames_out"] += 1
                    s["bytes_out"] += wire_b
                    s["raw_bytes"] += raw_b
                    s["serialize_ms"] += (t1 - t0) * 1000.0
                    s["send_ms"] += (t2 - t1) * 1000.0
            except Exception as e:
                with self.stats_lock:
                    self.stats["errors"] += 1
                if best_effort:
                    # Courtesy frames' loss never aborts live traffic.
                    continue
                # Everything still queued belongs to requests the failure
                # callback is about to abort.
                dropped = self.drain()
                with self.stats_lock:
                    self.stats["drops"] += dropped
                self.sender._fail(self.peer, repr(e))
