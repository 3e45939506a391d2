"""Live migration through scheduled swarms on the CPU over TCP on
localhost, at the tiny size of tests/test_torch_sched_mixed.py (4 layers,
f32, 2 layers a node), mirroring tests/test_churn_migration.py's
end-to-end churn case.

- With two pipelines, the tail of one stops mid-decode; its head
  checkpoints its requests to the other pipeline, the client follows
  ``migrated``, and every request finishes with the unchurned stream and
  none aborts — under the port scheduler and under the JAX scheduler,
  port workers both times.
- The JAX workers, under the JAX scheduler, do what the port's do when a
  pipeline's only tail leaves and a new one joins
  (tests/test_torch_sched_swarm.py): park, retry until a pipeline exists,
  restore by replay on its head, and continue.
"""

import pytest

from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from tests.test_torch_sched_mixed import swarm
from tests.test_torch_swarm import (
    CFG,
    ENGINE,
    PROMPTS,
    _port_params,
    _wait,
)

MIG_ENGINE = dict(ENGINE, max_model_len=512, num_pages=160)
MIG_NEW = 24


def _mig_requests(req_cls, sp_cls):
    return [req_cls(f"m{i}", prompt_ids=list(p),
                    sampling_params=sp_cls(temperature=0.0,
                                           max_new_tokens=MIG_NEW,
                                           ignore_eos=True))
            for i, p in enumerate(PROMPTS)]


def _unchurned(req_cls=Request, sp_cls=SamplingParams):
    engines = [StageEngine(create_stage_model(CFG, s, e),
                           _port_params(create_stage_model(CFG, s, e)),
                           EngineConfig(**MIG_ENGINE), device="cpu")
               for s, e in ((0, 2), (2, 4))]
    pipe = InProcessPipeline(engines)
    reqs = _mig_requests(req_cls, sp_cls)
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("sched_kind", ["port", "jax"])
def test_tail_stopped_mid_decode_loses_no_request(sched_kind, monkeypatch):
    """Two [0, 2) + [2, 4) pipelines of port workers; the tail of the one
    serving r0 stops once its requests streamed tokens. Its head parks
    them, the scheduler picks the other pipeline, the checkpoints ship and
    restore there (re-prefill + replay: the target is two stages), the
    SwarmClient follows ``migrated``: zero aborts, every stream the
    unchurned one."""
    import parallax_tpu.scheduling.layer_allocation as j_alloc

    from parallax_tpu_torch.backend.run import SwarmClient
    from parallax_tpu_torch.scheduling import layer_allocation as p_alloc

    # The leave's rebalance test reads heartbeat-measured latencies: when
    # it fires, every node goes standby and nothing re-bootstraps below
    # the four nodes this swarm started with. Pinned off in both
    # packages, so the surviving pipeline stays.
    for mod in (j_alloc, p_alloc):
        monkeypatch.setattr(mod.BaseLayerAllocator, "should_global_rebalance",
                            lambda self, active, cv_threshold=0.5: False)
    with swarm(sched_kind, ("port",) * 4, monkeypatch=monkeypatch,
               engine=MIG_ENGINE) as (service, workers):
        assert len(service.scheduler.manager.pipelines) == 2
        client = SwarmClient(service.transport, service)
        reqs = _mig_requests(Request, SamplingParams)
        events = []
        for r in reqs:
            r.routing_table = client.route(r.request_id,
                                           prompt_ids=r.prompt_ids)
            assert r.routing_table, r.request_id
            events.append(client.submit(r))
        doomed = list(reqs[0].routing_table)
        head, tail = workers[doomed[0]], workers[doomed[-1]]
        moved = [r for r in reqs if r.routing_table == doomed]
        assert _wait(lambda: all(len(r.output_ids) >= 2 for r in moved))
        assert all(len(r.output_ids) < MIG_NEW for r in moved)
        tail.stop()
        for r, ev in zip(reqs, events):
            assert ev.wait(60.0), f"{r.request_id}: {r.status}"
        aborted = [r.request_id for r in reqs
                   if r.status.value != "finished_length"]
        assert aborted == [], [(r.request_id, r.abort_reason) for r in reqs]
        for r in moved:
            target = service.scheduler.migrated_head(r.request_id)
            assert target is not None and target != head.node_id
            assert workers[target].restores[r.request_id][0] == "replay"
            assert head._migrated_to[r.request_id] == target
    want = _unchurned()
    assert [r.output_ids for r in reqs] == want


def _leave_and_rejoin(kind, monkeypatch):
    """One [0, 2) + [2, 4) pipeline of ``kind`` workers under the
    ``kind`` scheduler; a long request; the tail stops; a new tail joins.
    Returns what the head did: (parked before the rejoin, the restored
    request's stream, tokens before the leave, where_is)."""
    req_cls, sp_cls = ((Request, SamplingParams) if kind == "port"
                       else (JRequest, JSampling))
    extra = []
    with swarm(kind, (kind, kind), monkeypatch=monkeypatch,
               engine=MIG_ENGINE, extra=extra) as (service, workers):
        new_worker, started = extra
        path = service.route_request("long", timeout_s=10.0,
                                     prompt_ids=[1, 2, 3])
        head, tail = workers[path[0]], workers[path[-1]]
        req = req_cls("long", prompt_ids=[1, 2, 3], routing_table=list(path),
                      sampling_params=sp_cls(temperature=0.0,
                                             max_new_tokens=400,
                                             ignore_eos=True))
        head.submit(req)
        assert _wait(lambda: len(req.output_ids) > 2)
        tail.stop()
        assert _wait(lambda: "long" in head._migration_parked)
        parked = not req.status.is_finished
        before = list(req.output_ids)
        assert _wait(lambda: not service.scheduler.manager.pipelines)
        new = new_worker(kind)
        started.append(new)
        new.start()
        # The restore lands on the new pipeline's head (the old head or the
        # new worker, as the allocator lays it out), which where_is names.
        by_id = {**workers, new.node_id: new}

        def restored():
            target = by_id.get(service.scheduler.migrated_head("long"))
            r = target and target._chat_requests.get("long")
            return bool(r) and len(r.output_ids) > len(before) + 8

        assert _wait(restored), head._migration_parked
        target = service.scheduler.migrated_head("long")
        path = [n["node_id"] for n in
                service.scheduler.cluster_status()["pipelines"][0]["nodes"]]
        moved = by_id[target]._chat_requests["long"]
        return (parked, list(moved.output_ids[:len(before) + 8]), before,
                target == path[0], moved.status.is_finished)


def test_jax_workers_park_and_restore_as_the_port_does(monkeypatch):
    """The leave-and-rejoin of test_torch_sched_swarm.py, with JAX workers
    under the JAX scheduler and port workers under the port scheduler:
    both heads park (no abort), restore the request on the new pipeline by
    replay, keep the streamed tokens and record the restore in
    ``where_is``; the continued streams are equal."""
    got = {}
    for kind in ("jax", "port"):
        with monkeypatch.context() as mp:
            got[kind] = _leave_and_rejoin(kind, mp)
    for kind, (parked, stream, before, where_is, finished) in got.items():
        assert parked and where_is and not finished, kind
        assert stream[:len(before)] == before, kind
    n = min(len(got["jax"][1]), len(got["port"][1]))
    assert got["jax"][1][:n] == got["port"][1][:n]
