"""The port's relay transport (``parallax_tpu_torch/p2p/transport.py``) on
the CPU over TCP on localhost: NAT'd workers served through the
scheduler's relay.

- The cases of tests/test_relay_transport.py on port transports: a
  relayed call and send, the relay calling its own registered worker,
  re-registration, errors end to end, the identity binding, the stale
  route replaced, the token check, and a scheduled swarm through a relay
  worker.
- Mixed relays: a port relay serves a JAX worker, and a JAX relay serves
  a port worker (the frames are the JAX package's).
- A scheduled port swarm whose tail is relayed: its greedy and seeded
  streams equal a direct swarm's (the port's in-process pipeline, bit for
  bit), its greedy streams the JAX scheduler swarm's under the
  tie-tolerant rule of tests/test_engine_e2e.py::assert_greedy_matches;
  every FORWARD to the tail crossed the relay, and nobody dialed the
  tail.

Every transport stops in ``finally``.
"""

import asyncio
import contextlib
import threading
import time

import pytest

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu.p2p.transport import TcpTransport as JTcpTransport
from parallax_tpu.p2p.transport import TransportError as JTransportError
from parallax_tpu_torch.backend.run import SwarmClient
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import (
    TcpTransport,
    TransportError,
    make_ping_handler,
)
from parallax_tpu_torch.runtime.engine import EngineConfig
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from tests.test_torch_sched_mixed import (  # noqa: F401  (a fixture)
    _assert_tie_tolerant,
    jax_sched_streams,
)
from tests.test_torch_sched_swarm import two_layer_capacity  # noqa: F401
from tests.test_torch_swarm import (
    CFG,
    DEADLINE_S,
    ENGINE,
    N_NEW,
    _in_process,
    _port_params,
    _requests,
    _wait,
)

TRANSPORTS = {"port": TcpTransport, "jax": JTcpTransport}


def wait_route(relay, worker_id, timeout=5.0):
    """Registration is fire-and-forget (a heartbeat refresh in a swarm):
    do not race the relay's read loop."""
    assert _wait(lambda: worker_id in relay._relay_routes, timeout), \
        f"route for {worker_id} never registered"


@contextlib.contextmanager
def trio(relay_kind="port", worker_kind="port", client_kind="port",
         token=None, worker_token=None):
    made = []
    try:
        relay = TRANSPORTS[relay_kind]("relay-node", "127.0.0.1",
                                       relay_token=token)
        made.append(relay)
        relay.start()
        worker = TRANSPORTS[worker_kind]("", "127.0.0.1",
                                         relay_token=worker_token)
        made.append(worker)
        worker.start()
        worker.peer_id = f"relay:natted-1@{relay.address}"
        client = TRANSPORTS[client_kind]("", "127.0.0.1")
        made.append(client)
        client.start()
        client.peer_id = client.address
        yield relay, worker, client
    finally:
        for t in made:
            t.stop()


def test_relayed_call_round_trip():
    with trio() as (relay, worker, client):
        worker.register("echo",
                        lambda frm, payload: {"got": payload, "frm": frm})
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        out = client.call(worker.peer_id, "echo", {"x": 42}, timeout=10.0)
        assert out["got"] == {"x": 42}
        # The worker saw the originator's identity, not the relay hop.
        assert out["frm"] == client.peer_id
        stats = relay.transport_stats()["relay"]
        # The call down to the worker and its reply back to the client.
        assert stats["routed"][worker.peer_id]["envelopes"] == 1
        assert stats["routed"][client.peer_id]["envelopes"] == 1
        assert stats["registrations"] == 1 and stats["rejected"] == 0
        assert worker.transport_stats()["accepted"] == 0


def test_relay_counts_dial_out_before_the_reply_lands():
    """The reply's dial-out is counted before its write: a send that is
    slow to return (the client already holds the reply) leaves the count
    in place when the client reads the relay's stats."""
    with trio() as (relay, worker, client):
        worker.register("echo", lambda frm, payload: payload)
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        real = relay._send_async

        async def slow_send(peer, data):
            await real(peer, data)
            await asyncio.sleep(0.5)

        relay._send_async = slow_send
        assert client.call(worker.peer_id, "echo", 7, timeout=10.0) == 7
        routed = relay.transport_stats()["relay"]["routed"]
        assert routed[client.peer_id]["envelopes"] == 1
        assert routed[client.peer_id]["bytes"] > 0


def test_relay_failed_dial_out_takes_its_count_back():
    with trio() as (relay, _worker, _client):
        async def refused(peer, data):
            raise OSError("connection refused")

        relay._send_async = refused
        env = {"to": "127.0.0.1:9", "from": "x", "data": b"abc"}
        fut = asyncio.run_coroutine_threadsafe(
            relay._route_envelope(env), relay._loop)
        assert fut.result(timeout=5.0) is False
        routed = relay.transport_stats()["relay"]["routed"]
        assert routed.get("127.0.0.1:9", {"envelopes": 0})["envelopes"] == 0


def test_relay_delivers_to_its_own_registered_worker():
    """The relay itself calling a NAT'd worker (scheduler -> worker)."""
    with trio() as (relay, worker, _client):
        worker.register("double", lambda _f, p: p * 2)
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        assert relay.call(worker.peer_id, "double", 21, timeout=10.0) == 42


def test_relayed_send_fire_and_forget_keeps_order():
    """One-way frames through the relay arrive in the order they were
    sent, as on a direct connection."""
    with trio() as (relay, worker, client):
        got, done = [], threading.Event()

        def on_data(_frm, payload):
            time.sleep(0.01 if payload[0] == 0 else 0.0)
            got.append(payload)
            if len(got) == 5:
                done.set()

        worker.register("data", on_data)
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        for i in range(5):
            client.send(worker.peer_id, "data", bytes([i, 1, 2]))
        assert done.wait(10.0)
        assert got == [bytes([i, 1, 2]) for i in range(5)]


def test_relay_reregister_replaces_route():
    with trio() as (relay, worker, client):
        worker.register("ping2", make_ping_handler())
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        # Re-registration (every heartbeat in a swarm) rides the same
        # connection, so the route stays valid throughout.
        worker.register_at_relay(relay.address)
        assert client.call(worker.peer_id, "ping2", None,
                           timeout=10.0) == "pong"


def test_relay_errors_propagate_end_to_end():
    with trio() as (relay, worker, client):
        def boom(_f, _p):
            raise RuntimeError("kaboom")

        worker.register("boom", boom)
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        with pytest.raises(TransportError, match="kaboom"):
            client.call(worker.peer_id, "boom", None, timeout=10.0)


def test_relay_rejects_identity_mismatched_registration():
    """A second connection cannot steal a registered id: a registration's
    id must be its connection's hello identity."""
    with trio() as (relay, worker, client):
        worker.register("whoami", lambda _f, _p: "victim")
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        attacker = TcpTransport("", "127.0.0.1")
        attacker.start()
        attacker.peer_id = f"relay:attacker@{relay.address}"
        try:
            victim_id = worker.peer_id

            async def _register_stolen():
                _, w, lock = await attacker._get_conn(relay.address)
                async with lock:
                    attacker._write_frame(w, proto.encode_frame(
                        "__relay_register__",
                        {"id": victim_id, "token": None}, msg_id=0))
                    await w.drain()

            route_before = relay._relay_routes[victim_id]
            asyncio.run_coroutine_threadsafe(
                _register_stolen(), attacker._loop).result(10.0)
            assert _wait(
                lambda: relay.transport_stats()["relay"]["rejected"] == 1,
                5.0)
            assert relay._relay_routes[victim_id] is route_before
            assert client.call(worker.peer_id, "whoami", None,
                               timeout=10.0) == "victim"
        finally:
            attacker.stop()


def test_relay_stale_route_recovery_without_token():
    """A worker whose old relay connection died half-open registers again
    from a new connection: the route is replaced and the stale socket
    closed."""
    with trio() as (relay, worker, client):
        worker.register_at_relay(relay.address)
        wait_route(relay, worker.peer_id)
        stale_writer = relay._relay_routes[worker.peer_id]
        reborn = TcpTransport("", "127.0.0.1")
        reborn.start()
        reborn.peer_id = worker.peer_id
        reborn.register("alive", lambda _f, _p: "reborn")
        try:
            reborn.register_at_relay(relay.address)
            assert _wait(lambda: relay._relay_routes.get(worker.peer_id)
                         is not stale_writer, 5.0)
            assert stale_writer.is_closing()
            assert client.call(worker.peer_id, "alive", None,
                               timeout=10.0) == "reborn"
        finally:
            reborn.stop()


def test_relay_token_required_when_configured():
    """With a swarm secret on the relay, identity alone is not enough."""
    made = []
    try:
        relay = TcpTransport("relay-node", "127.0.0.1", relay_token="s3cret")
        legit = TcpTransport("", "127.0.0.1", relay_token="s3cret")
        intruder = TcpTransport("", "127.0.0.1", relay_token="wrong")
        client = TcpTransport("", "127.0.0.1")
        made = [relay, legit, intruder, client]
        for t in made:
            t.start()
        legit.peer_id = f"relay:legit@{relay.address}"
        intruder.peer_id = f"relay:intruder@{relay.address}"
        client.peer_id = client.address
        legit.register("ping3", make_ping_handler())
        legit.register_at_relay(relay.address)
        wait_route(relay, legit.peer_id)
        assert client.call(legit.peer_id, "ping3", None,
                           timeout=10.0) == "pong"
        intruder.register_at_relay(relay.address)
        assert _wait(
            lambda: relay.transport_stats()["relay"]["rejected"] == 1, 5.0)
        assert intruder.peer_id not in relay._relay_routes
        assert legit.peer_id in relay._relay_routes
    finally:
        for t in made:
            t.stop()


def _relay_swarm_worker(sched_addr: str, relayed: bool, token=None):
    t = TcpTransport("", "127.0.0.1", relay_token=token)
    t.start()
    if relayed:
        t.peer_id = f"relay:natted-w@{sched_addr}"
        t.register_at_relay(sched_addr)
    else:
        t.peer_id = t.address
    return WorkerNode(t, sched_addr, CFG, EngineConfig(**ENGINE),
                      load_params=_port_params, heartbeat_interval_s=0.2,
                      device="cpu")


@contextlib.contextmanager
def relay_swarm(token=None):
    """A port scheduler whose transport is the relay, a direct worker and
    a relayed one; yields (service, head, tail) once one 2 + 2 pipeline
    with the relayed worker in it is ready."""
    sched = GlobalScheduler(CFG, min_nodes_bootstrapping=2)
    st = TcpTransport("scheduler", "127.0.0.1", relay_token=token)
    service = SchedulerService(sched, st, join_timeout_s=DEADLINE_S)
    workers = []
    try:
        service.start()
        workers = [_relay_swarm_worker(st.address, relayed=i == 1,
                                       token=token) for i in range(2)]
        starters = [threading.Thread(target=w.start) for w in workers]
        # The direct worker joins first: the bootstrap lays nodes out in
        # join order, so the relayed one is the tail.
        starters[0].start()
        assert _wait(lambda: sched.manager.get(workers[0].node_id)
                     is not None)
        starters[1].start()
        for s in starters:
            s.join(DEADLINE_S)

        def ready():
            nodes = [n for p in sched.cluster_status()["pipelines"]
                     for n in p["nodes"]]
            return len(nodes) == 2 and all(n["ready"] for n in nodes)

        assert _wait(ready), sched.cluster_status()
        path = [n["node_id"] for n in
                sched.cluster_status()["pipelines"][0]["nodes"]]
        by_id = {w.node_id: w for w in workers}
        yield service, by_id[path[0]], by_id[path[1]]
    finally:
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        service.stop()


def test_swarm_serves_through_a_relay_worker():
    """A plain worker and a NAT'd relay worker behind the scheduler's
    transport serve a 2-stage pipeline end to end."""
    with relay_swarm() as (service, head, tail):
        path = service.route_request("rr-1", timeout_s=10.0)
        assert path is not None and len(path) == 2
        assert any(p.startswith("relay:") for p in path), path
        req = Request("rr-1", prompt_ids=[1, 2, 3, 4, 5, 6, 7],
                      sampling_params=SamplingParams(temperature=0.0,
                                                     max_new_tokens=6),
                      routing_table=list(path))
        first = head if path[0] == head.node_id else tail
        done = first.submit(req)
        assert done.wait(30.0), f"request did not finish: {req.status}"
        assert len(req.output_ids) == 6


@pytest.mark.parametrize("relay_kind,worker_kind", [
    ("port", "jax"), ("jax", "port")],
    ids=["port-relay-jax-worker", "jax-relay-port-worker"])
def test_mixed_relay_and_worker(relay_kind, worker_kind):
    """The relay frames are the JAX package's: each package's relay serves
    the other's NAT'd worker, calls, sends and errors included, for a
    client of either package."""
    for client_kind in ("port", "jax"):
        with trio(relay_kind, worker_kind, client_kind) as (
                relay, worker, client):
            got, done = [], threading.Event()
            worker.register("echo", lambda frm, p: {"got": p, "frm": frm})
            worker.register("data", lambda _f, p: (got.append(p),
                                                   done.set()))

            def boom(_f, _p):
                raise RuntimeError("kaboom")

            worker.register("boom", boom)
            worker.register_at_relay(relay.address)
            wait_route(relay, worker.peer_id)
            out = client.call(worker.peer_id, "echo", {"x": 1},
                              timeout=10.0)
            assert out == {"got": {"x": 1}, "frm": client.peer_id}
            assert relay.call(worker.peer_id, "echo", 2,
                              timeout=10.0)["got"] == 2
            client.send(worker.peer_id, "data", b"\x07")
            assert done.wait(10.0) and got == [b"\x07"]
            with pytest.raises((TransportError, JTransportError),
                               match="kaboom"):
                client.call(worker.peer_id, "boom", None, timeout=10.0)


def _serve(service, head, reqs):
    client = SwarmClient(service.transport, service)
    events = []
    for r in reqs:
        r.routing_table = client.route(r.request_id,
                                       prompt_ids=r.prompt_ids)
        assert r.routing_table[0] == head.node_id
        events.append(client.submit(r))
    for r, ev in zip(reqs, events):
        assert ev.wait(DEADLINE_S), f"{r.request_id}: {r.status}"
        assert r.status.value == "finished_length"
        assert len(r.output_ids) == N_NEW
    return reqs


def test_relayed_tail_matches_direct_and_jax_swarms(jax_sched_streams):
    """The tail is behind the relay (its id ``relay:...``; the token on
    both ends): greedy and seeded streams equal the direct in-process
    pipeline's bit for bit, greedy streams the JAX scheduler swarm's under
    the tie-tolerant rule; every FORWARD to the tail crossed the relay and
    nobody dialed the tail."""
    with relay_swarm(token="swarm-secret") as (service, head, tail):
        assert tail.node_id.startswith("relay:")
        frames = []
        forward = tail.transport._handlers[proto.FORWARD]
        tail.transport.register(
            proto.FORWARD, lambda p, x: (frames.append(p), forward(p, x))[1])
        seeded = _serve(service, head, _requests(Request, SamplingParams))
        greedy = _serve(service, head, [
            Request(f"g{r.request_id}", prompt_ids=list(r.prompt_ids),
                    sampling_params=r.sampling_params)
            for r in _requests(Request, SamplingParams, seeded=False)])
        relay = service.transport.transport_stats()["relay"]
        routed = relay["routed"][tail.node_id]["envelopes"]
        assert frames and set(frames) == {head.node_id}
        assert routed >= len(frames), (routed, len(frames))
        assert relay["rejected"] == 0
        assert tail.transport.transport_stats()["accepted"] == 0
        assert all(tail.transport.address not in
                   t.transport_stats()["dials"]
                   for t in (head.transport, service.transport))
    want = _in_process()
    assert [r.output_ids for r in seeded] == [r.output_ids for r in want]
    _assert_tie_tolerant(greedy, jax_sched_streams, "relayed-tail")
