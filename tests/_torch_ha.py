"""The harness of the scheduler HA swarm tests (tests/test_torch_ha_*):
tests/test_ha_failover.py's swarm — a primary scheduler journaling to a
warm standby that tails it over the RPC plane, and two workers joined
with ``scheduler_standby`` — with port workers behind a port or a JAX
scheduler pair, over TCP on localhost, at the tiny size of
tests/test_torch_swarm.py (4 layers, f32, capacity forced to 2 layers, so
one [0, 2) + [2, 4) pipeline).

:func:`kill_primary_mid_decode` is the acceptance story of
tests/test_ha_failover.py: requests routed and polled through a
SwarmClient over ``[primary, standby]``, the primary stopped once every
stream has its first token, the standby promoted within its lease, every
stream finished bit-identically to the port's InProcessPipeline with no
abort and no engine rebuilt, the workers' echoed epoch moved to the
promoted one, a seeded request routed through the promoted scheduler, the
load drained, and the revived old primary fenced.
"""

import contextlib
import dataclasses
import threading
import time
import types

from parallax_tpu.backend.scheduler_service import (
    SchedulerService as JSchedulerService,
)
from parallax_tpu.ha.journal import StateJournal as JStateJournal
from parallax_tpu.ha.journal import install_journal as j_install_journal
from parallax_tpu.ha.standby import StandbyScheduler as JStandbyScheduler
from parallax_tpu.p2p.transport import TcpTransport as JTcpTransport
from parallax_tpu.scheduling.scheduler import GlobalScheduler as JScheduler
from parallax_tpu_torch.backend.run import SwarmClient
from parallax_tpu_torch.backend.scheduler_service import SchedulerService
from parallax_tpu_torch.ha.journal import StateJournal, install_journal
from parallax_tpu_torch.ha.standby import StandbyScheduler
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.p2p.node import WorkerNode
from parallax_tpu_torch.p2p.transport import TcpTransport
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from parallax_tpu_torch.scheduling.scheduler import GlobalScheduler
from tests.test_torch_swarm import (
    BOUNDS,
    CFG,
    ENGINE,
    JCFG,
    PROMPTS,
    _port_params,
    _wait,
)

# The standby promotes after LEASE_S of silence; it pulls every SYNC_S.
LEASE_S = 1.0
SYNC_S = 0.2
DEADLINE_S = 30.0
GEN = 24
# tests/test_ha_failover.py's K = 1 and K = 4 decode (the port's K = 1 is
# the synchronous loop, K = 4 the overlapped one).
ENGINES = {
    "K1-sync": dict(ENGINE, decode_lookahead=1, overlap_steps=False),
    "K4-overlap": dict(ENGINE, decode_lookahead=4, overlap_steps=True),
}
SEEDED = dict(temperature=0.8, top_k=20, seed=1234)

_SCHED = {
    "port": types.SimpleNamespace(
        cfg=CFG, scheduler=GlobalScheduler, service=SchedulerService,
        transport=TcpTransport, journal=StateJournal,
        install=install_journal, standby=StandbyScheduler),
    "jax": types.SimpleNamespace(
        cfg=JCFG, scheduler=JScheduler, service=JSchedulerService,
        transport=JTcpTransport, journal=JStateJournal,
        install=j_install_journal, standby=JStandbyScheduler),
}


def scheduler_pair(sched: str = "port", standby: str | None = None):
    """A primary of package ``sched`` journaling to a passive mirror of
    package ``standby`` (default: the same) with a StandbyScheduler
    tailing it over TCP. The mirror's service listens first (the primary
    advertises its address), the standby starts once the primary listens
    (its lease arms when it is built)."""
    pkg, spkg = _SCHED[sched], _SCHED[standby or sched]
    mirror = spkg.scheduler(spkg.cfg, min_nodes_bootstrapping=2,
                            passive=True)
    mirror_service = spkg.service(mirror, spkg.transport("standby",
                                                         "127.0.0.1"),
                                  join_timeout_s=DEADLINE_S)
    mirror_service.start()      # passive: no scheduler threads yet
    standby_addr = mirror_service.transport.address
    sched_obj = pkg.scheduler(pkg.cfg, min_nodes_bootstrapping=2)
    service = pkg.service(sched_obj, pkg.transport("scheduler", "127.0.0.1"),
                          join_timeout_s=DEADLINE_S,
                          standby_addrs=[standby_addr])
    service.start()
    journal = pkg.journal(epoch=sched_obj.epoch)
    journal.bind(service.transport)
    pkg.install(sched_obj, journal)
    standby = spkg.standby(
        mirror, transport=mirror_service.transport,
        primary=service.transport.address, lease_s=LEASE_S,
        sync_interval_s=SYNC_S, node_id=standby_addr)
    standby.start()
    return types.SimpleNamespace(
        service=service, mirror_service=mirror_service, standby=standby,
        journal=journal, primary_addr=service.transport.address,
        standby_addr=standby_addr)


@contextlib.contextmanager
def ha_swarm(engine: dict, sched: str = "port"):
    """:func:`scheduler_pair` plus two port workers joined with the standby
    as ``scheduler_standby`` and a SwarmClient over [primary, standby] on
    a transport of its own; stops everything."""
    pair = scheduler_pair(sched)
    workers, client_t = [], TcpTransport("", "127.0.0.1")
    try:
        for _ in range(2):
            t = TcpTransport("", "127.0.0.1")
            t.start()
            t.peer_id = t.address
            workers.append(WorkerNode(
                t, pair.primary_addr, CFG, EngineConfig(**engine),
                load_params=_port_params, heartbeat_interval_s=0.2,
                device="cpu", scheduler_standby=[pair.standby_addr]))
        starters = [threading.Thread(target=w.start) for w in workers]
        for s in starters:
            s.start()
        for s in starters:
            s.join(DEADLINE_S)
        client_t.start()
        client_t.peer_id = client_t.address
        pair.workers = workers
        pair.client = SwarmClient(
            client_t, scheduler_peers=[pair.primary_addr, pair.standby_addr])
        assert _wait(lambda: _ready(pair.service.scheduler)), \
            pair.service.scheduler.cluster_status()
        yield pair
    finally:
        for w in workers:
            with contextlib.suppress(Exception):
                w.stop()
        client_t.stop()
        pair.standby.stop()
        pair.journal.stop()
        if pair.mirror_service.scheduler.journal is not None:
            pair.mirror_service.scheduler.journal.stop()
        pair.mirror_service.stop()
        pair.service.stop()


def _ready(sched) -> bool:
    st = sched.cluster_status()
    nodes = [n for p in st["pipelines"] for n in p["nodes"]]
    return len(nodes) == 2 and all(n["ready"] for n in nodes)


def _request(rid: str, prompt, sampling: dict) -> Request:
    return Request(rid, prompt_ids=list(prompt), sampling_params=(
        SamplingParams(max_new_tokens=GEN, ignore_eos=True, **sampling)))


def reference(engine: dict, reqs) -> dict:
    """The same requests through the port's InProcessPipeline on the same
    weights: rid -> output ids."""
    engines = [StageEngine(create_stage_model(CFG, s, e),
                           _port_params(create_stage_model(CFG, s, e)),
                           EngineConfig(**engine), device="cpu")
               for s, e in BOUNDS]
    pipe = InProcessPipeline(engines)
    ref = [Request(r.request_id, prompt_ids=list(r.prompt_ids),
                   sampling_params=dataclasses.replace(r.sampling_params))
           for r in reqs]
    for r in ref:
        pipe.submit(r)
    pipe.run_until_complete()
    return {r.request_id: r.output_ids for r in ref}


def kill_primary_mid_decode(pair, engine: dict) -> dict:
    """The acceptance story (module docstring). Returns its figures."""
    service, mirror = pair.service, pair.mirror_service.scheduler
    sched, client, workers = service.scheduler, pair.client, pair.workers
    engines = {w.node_id: (id(w.engine), w.start_layer, w.end_layer)
               for w in workers}
    reqs = [_request(f"ha-{i}", p, SEEDED if i == 3 else
                     dict(temperature=0.0))
            for i, p in enumerate(PROMPTS)]
    events = []
    for r in reqs:
        r.routing_table = client.route(r.request_id, prompt_ids=r.prompt_ids)
        assert r.routing_table and len(r.routing_table) == 2, r.request_id
        events.append(client.submit(r))
    # Kill the primary mid-decode: its scheduler threads and its transport
    # die. Token frames ride worker-to-worker links, and the client polls
    # the heads, so decode continues.
    assert _wait(lambda: all(r.output_ids for r in reqs), DEADLINE_S)
    service.stop()
    t_kill = time.monotonic()
    at_kill = [len(r.output_ids) for r in reqs]
    assert min(at_kill) < GEN, at_kill

    # The standby promotes within its lease (plus one sync interval and
    # the promotion itself).
    # (The JAX standby flips ``promoted`` before its scheduler goes
    # active: wait for the scheduler.)
    assert _wait(lambda: pair.standby.promoted and not mirror.passive,
                 DEADLINE_S)
    promoted_after = time.monotonic() - t_kill
    assert promoted_after < LEASE_S + SYNC_S + 1.0, promoted_after
    assert not mirror.passive and mirror.epoch == 2
    assert {w.node_id for w in workers} <= {
        n.node_id for n in mirror.manager.nodes()}
    assert len(mirror.manager.pipelines) == 1

    # Every in-flight stream finished, with no abort, bit-identically.
    for r, ev in zip(reqs, events):
        assert ev.wait(DEADLINE_S), (r.request_id, r.status)
        assert r.status.value == "finished_length", (r.request_id, r.status)
    want = reference(engine, reqs)
    assert {r.request_id: r.output_ids for r in reqs} == want

    # The workers' heartbeats failed over and echo the promoted epoch.
    assert _wait(lambda: all(w.sched_transport.epoch == mirror.epoch
                             and w.sched_transport.active_peer
                             == pair.standby_addr for w in workers))

    # A seeded request routes through the PROMOTED scheduler (the client
    # rotates to it) and is bit-identical.
    late = _request("ha-late", [9, 8, 7, 6, 5], SEEDED)
    t_route = time.monotonic()
    late.routing_table = client.route(late.request_id,
                                      prompt_ids=late.prompt_ids)
    route_s = time.monotonic() - t_route
    assert late.routing_table and len(late.routing_table) == 2
    assert client.sched_transport.active_peer == pair.standby_addr
    assert client.submit(late).wait(DEADLINE_S), late.status
    assert late.status.value == "finished_length"
    assert late.output_ids == reference(engine, [late])["ha-late"]

    # No worker reloaded: the same engine on the same range.
    assert {w.node_id: (id(w.engine), w.start_layer, w.end_layer)
            for w in workers} == engines
    # Load charges drain back to zero on the promoted scheduler.
    assert _wait(lambda: sum(n.load for n in mirror.manager.nodes()) == 0)

    # A revived old primary fences itself on the first beat echoing the
    # promoted epoch, and refuses every later mutation.
    nodes_before = {n.node_id for n in sched.manager.nodes()}
    head = workers[0]
    reply = service._on_update(head.node_id, {
        "node_id": head.node_id, "load": 9,
        "epoch": head.sched_transport.epoch})
    assert reply.get("not_primary") and sched.fenced
    assert service._on_join("z", {"node_id": "z"}).get("not_primary")
    sched.drain_events()
    assert {n.node_id for n in sched.manager.nodes()} == nodes_before
    return {"tokens_at_kill": at_kill, "promoted_after_s": promoted_after,
            "route_after_promotion_s": route_s,
            "journal_seq": pair.journal.seq}
