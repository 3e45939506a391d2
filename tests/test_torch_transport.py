"""The port's transport (parallax_tpu_torch.p2p.transport): the AsyncSender
cases of tests/test_activation_transport.py run on the port's copy
(per-peer order, lazy payloads off the caller's thread, overflow and dead
peers fire the failure callback once and drain, best-effort frames never
escalate and overflow alone, idle links retire), and the TCP transport's
call / send / measure_rtt / error replies, also against a JAX package
transport on the other end of the socket."""

import threading
import time

import pytest

from parallax_tpu.p2p.transport import TcpTransport as JTcpTransport
from parallax_tpu_torch.p2p.transport import (
    NO_HANDLER_MARK,
    AsyncSender,
    LoopbackTransport,
    TcpTransport,
    Transport,
    TransportError,
    make_ping_handler,
)


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cond():
        time.sleep(0.01)
    return cond()


class _RecordingTransport(Transport):
    """Transport stub: records sends, optional per-send delay/failure."""

    def __init__(self, delay_s: float = 0.0):
        super().__init__("rec")
        self.sent: list[tuple] = []
        self.delay_s = delay_s
        self.fail_peers: set[str] = set()
        self.lock = threading.Lock()

    def send(self, peer, method, payload):
        if self.delay_s:
            time.sleep(self.delay_s)
        if peer in self.fail_peers:
            raise TransportError(f"{peer} is dead")
        with self.lock:
            self.sent.append((peer, method, payload))


def test_sender_preserves_per_peer_order():
    t = _RecordingTransport(delay_s=0.001)
    sender = AsyncSender(t)
    try:
        for i in range(50):
            sender.send("p1", "m", {"i": i})
            sender.send("p2", "m", {"i": i})
        assert _wait(lambda: len(t.sent) == 100, 10)
        for peer in ("p1", "p2"):
            seq = [p["i"] for pr, _m, p in t.sent if pr == peer]
            assert seq == list(range(50)), seq
    finally:
        sender.close()


def test_sender_lazy_payload_runs_off_caller_thread():
    t = _RecordingTransport()
    sender = AsyncSender(t)
    caller = threading.current_thread()
    seen = {}

    def build():
        seen["thread"] = threading.current_thread()
        return {"x": 1}, 100, 25

    try:
        sender.send("p", "m", build)
        assert _wait(lambda: bool(t.sent))
        assert t.sent == [("p", "m", {"x": 1})]
        assert seen["thread"] is not caller
        stats = sender.stats()["p"]
        assert stats["frames_out"] == 1
        assert stats["bytes_out"] == 25
        assert stats["compression_ratio"] == 4.0
    finally:
        sender.close()


def test_sender_queue_overflow_fires_failure_not_blocking():
    t = _RecordingTransport(delay_s=0.2)   # slow peer
    failures = []
    sender = AsyncSender(
        t, max_queue=4, on_failure=lambda p, r: failures.append((p, r))
    )
    try:
        t0 = time.perf_counter()
        for i in range(20):
            sender.send("slow", "m", {"i": i})
        # The caller never blocked on the slow link.
        assert time.perf_counter() - t0 < 0.15
        assert _wait(lambda: bool(failures))
        assert failures[0][0] == "slow" and "overflow" in failures[0][1]
        assert sender.stats()["slow"]["drops"] > 0
    finally:
        sender.close()


def test_sender_dead_peer_aborts_and_drains_queue():
    t = _RecordingTransport()
    t.fail_peers.add("dead")
    failures = []
    sender = AsyncSender(t, on_failure=lambda p, r: failures.append((p, r)))
    try:
        for i in range(10):
            sender.send("dead", "m", {"i": i})
        assert _wait(lambda: bool(failures))
        assert failures[0][0] == "dead"
        # The queue drained (bounded memory), and a live peer still works.
        assert _wait(lambda: sender.stats()["dead"]["queue_depth"] == 0)
        sender.send("alive", "m", {"ok": True})
        assert _wait(lambda: ("alive", "m", {"ok": True}) in t.sent)
    finally:
        sender.close()


def test_sender_best_effort_failure_never_escalates():
    t = _RecordingTransport()
    t.fail_peers.add("dead")
    failures = []
    sender = AsyncSender(t, on_failure=lambda p, r: failures.append((p, r)))
    try:
        sender.send("dead", "rpc_release", {"rids": ["r"]}, best_effort=True)
        assert _wait(lambda: sender.stats().get("dead", {}).get("errors")
                     == 1)
        time.sleep(0.05)
        assert not failures
    finally:
        sender.close()


def test_sender_overflow_drains_queue_in_one_incident():
    t = _RecordingTransport(delay_s=0.5)
    failures = []
    sender = AsyncSender(
        t, max_queue=4, on_failure=lambda p, r: failures.append(r)
    )
    try:
        for i in range(6):
            sender.send("slow", "m", {"i": i})
        assert len(failures) == 1 and "overflow" in failures[0]
        assert sender.stats()["slow"]["drops"] >= 4
        assert sender.stats()["slow"]["queue_depth"] <= 1
    finally:
        sender.close()


def test_sender_best_effort_overflow_drops_only_itself():
    release = threading.Event()

    class _GatedTransport(_RecordingTransport):
        def send(self, peer, method, payload):
            release.wait(10.0)
            super().send(peer, method, payload)

    t = _GatedTransport()
    failures = []
    sender = AsyncSender(
        t, max_queue=4, on_failure=lambda p, r: failures.append((p, r))
    )
    try:
        # Frame 0 blocks the worker inside transport.send; wait for the
        # dequeue so the next four frames fill the queue exactly.
        sender.send("p", "fwd", {"i": 0})
        assert _wait(lambda: sender.stats()["p"]["queue_depth"] == 0)
        for i in range(1, 5):
            sender.send("p", "fwd", {"i": i})
        assert sender.stats()["p"]["queue_depth"] == 4
        sender.send("p", "rpc_release", {"rids": ["r"]}, best_effort=True)
        stats = sender.stats()["p"]
        assert stats["drops"] == 1 and stats["queue_depth"] == 4
        assert not failures
        release.set()
        assert _wait(lambda: len(t.sent) == 5, 10)
        assert [p["i"] for _pr, _m, p in t.sent] == list(range(5))
        assert not failures
    finally:
        release.set()
        sender.close()


def test_sender_idle_link_retires_and_recreates():
    t = _RecordingTransport()
    sender = AsyncSender(t, idle_reap_s=0.1)
    try:
        sender.send("p", "m", {"i": 0})
        assert _wait(lambda: "p" not in sender.stats())  # retired
        sender.send("p", "m", {"i": 1})    # transparently recreated
        assert _wait(lambda: len(t.sent) == 2)
        assert [p["i"] for _pr, _m, p in t.sent] == [0, 1]
    finally:
        sender.close()


def test_loopback_transport_dispatches_and_names_missing_handlers():
    reg = {}
    a, b = LoopbackTransport("a", reg), LoopbackTransport("b", reg)
    b.register("echo", lambda peer, p: {"from": peer, "p": p})
    assert a.call("b", "echo", 3) == {"from": "a", "p": 3}
    with pytest.raises(TransportError, match=NO_HANDLER_MARK):
        a.call("b", "nothing", None)
    with pytest.raises(TransportError, match="unknown peer"):
        a.send("c", "echo", None)


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_tcp_transport_calls_sends_and_errors(server_kind):
    """The port's TcpTransport as the client of a port or a JAX server:
    request / reply, one-way sends in order, measure_rtt, the handler's
    exception as the caller's TransportError, the no-handler marker."""
    cls = TcpTransport if server_kind == "port" else JTcpTransport
    server = cls("", "127.0.0.1")
    client = TcpTransport("", "127.0.0.1")
    got, done = [], threading.Event()

    def on_data(peer, payload):
        got.append((peer, payload))
        if len(got) == 20:
            done.set()

    def boom(_peer, _payload):
        raise ValueError("boom")

    try:
        for t in (server, client):
            t.start()
            t.peer_id = t.address
        server.register("echo", lambda peer, p: {"peer": peer, "p": p})
        server.register("data", on_data)
        server.register("boom", boom)
        server.register("__ping__", make_ping_handler())
        payload = {"b": b"\x00\x01" * 1000, "x": [1, None, 2.5, "s"]}
        assert client.call(server.address, "echo", payload, timeout=5.0) == {
            "peer": client.address, "p": payload}
        for i in range(20):
            client.send(server.address, "data", {"i": i})
        assert done.wait(5.0)
        # A handler pool may dispatch back-to-back frames concurrently;
        # every frame arrives.
        assert sorted(p["i"] for _peer, p in got) == list(range(20))
        assert 0 < client.measure_rtt(server.address, samples=2) < 5.0
        with pytest.raises(TransportError, match="boom"):
            client.call(server.address, "boom", None, timeout=5.0)
        with pytest.raises(TransportError, match=NO_HANDLER_MARK):
            client.call(server.address, "nothing", None, timeout=5.0)
    finally:
        client.stop()
        server.stop()


def test_tcp_transport_serves_a_jax_client():
    server = TcpTransport("", "127.0.0.1")
    client = JTcpTransport("", "127.0.0.1")
    try:
        for t in (server, client):
            t.start()
            t.peer_id = t.address
        server.register("echo", lambda peer, p: [peer, p])
        assert client.call(server.address, "echo", {"a": b"xy"},
                           timeout=5.0) == [client.address, {"a": b"xy"}]
    finally:
        client.stop()
        server.stop()


def test_concurrent_first_calls_share_one_connection():
    """Eight threads call a peer the transport has not dialed yet, at once
    (a chat host's first requests): one connection is dialed and every
    call gets its reply."""
    server = TcpTransport("", "127.0.0.1")
    client = TcpTransport("", "127.0.0.1")
    results, errors = {}, []

    def go(i):
        try:
            results[i] = client.call(server.address, "echo", i, timeout=5.0)
        except Exception as e:  # collected for the assertion below
            errors.append(repr(e))

    try:
        for t in (server, client):
            t.start()
            t.peer_id = t.address
        server.register("echo", lambda _peer, p: p)
        threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(15.0)
        assert not errors, errors
        assert results == {i: i for i in range(8)}
        assert len(client._conns) == 1
        assert len(server._server_writers) == 1
    finally:
        client.stop()
        server.stop()


def test_one_way_frames_run_in_arrival_order():
    """``send`` frames of one connection reach their handler in the order
    they were sent, even when an earlier handler is slower than a later
    one (the sender's per-peer FIFO holds into the receiver); calls on the
    same connection still run beside them."""
    server = TcpTransport("", "127.0.0.1")
    client = TcpTransport("", "127.0.0.1")
    got, done = [], threading.Event()

    def on_data(_peer, p):
        time.sleep(0.002 * (20 - p["i"]) if p["i"] % 2 == 0 else 0)
        got.append(p["i"])
        if len(got) == 20:
            done.set()

    try:
        for t in (server, client):
            t.start()
            t.peer_id = t.address
        server.register("data", on_data)
        server.register("echo", lambda _peer, p: p)
        for i in range(20):
            client.send(server.address, "data", {"i": i})
        assert client.call(server.address, "echo", 7, timeout=5.0) == 7
        assert done.wait(10.0)
        assert got == list(range(20))
    finally:
        client.stop()
        server.stop()


def test_call_in_flight_fails_when_the_peer_closes():
    """A call awaiting its reply when the peer's connection closes (the
    peer stopped or died mid-call) fails at once with a connection error
    instead of waiting out its timeout — the scheduler failover rotates on
    it — and the next call dials again."""
    server = TcpTransport("", "127.0.0.1")
    client = TcpTransport("", "127.0.0.1")
    entered = threading.Event()

    def slow(_peer, _p):
        entered.set()
        time.sleep(3.0)
        return "late"

    try:
        for t in (server, client):
            t.start()
            t.peer_id = t.address
        server.register("slow", slow)
        addr = server.address
        threading.Thread(target=lambda: entered.wait(5.0) and server.stop(),
                         daemon=True).start()
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            client.call(addr, "slow", None, timeout=20.0)
        assert time.monotonic() - t0 < 2.5
        assert not client._pending
        with pytest.raises(ConnectionError):
            client.call(addr, "slow", None, timeout=5.0)
    finally:
        client.stop()
        server.stop()
