"""Disaggregated prefill / decode serving in the port, end to end on the CPU:
tests/test_disaggregation.py's swarm cases run on port workers under the
port scheduler (tests/_torch_disagg.py).

- A prefill + decode pair serves greedy and seeded streams BIT-IDENTICAL
  to a mixed pair, with overlap at K = 1 and with K = 4 windows. Every
  request is handed off by image (the decode head adopted 4 images, the
  prefill head's ledger names the decode head for each), ``where_is``
  names the decode head, the transfer counters and the scheduler's
  ``disagg`` section are populated, and no request is preempted or
  extracted while a step or window in flight still writes its pages.
- The ladder: a prefix-warm target, a nacked transfer and a lost result
  (re-shipped to the same head, acked there as a duplicate) keep the
  streams; a prefill-only swarm restores each request locally, once,
  with the same streams; a two-stage prefill pipeline restores locally by
  replay through its downstream stage, with the same streams.
- A JSON-schema row through a disaggregated pair equals the same row
  through a mixed pair, and its handoff carries the DFA state read before
  ``extract``.
- The client resume rung: ``chat_submit`` with ``replay_ids``
  teacher-forces the streamed tokens.
"""

import dataclasses
import json

import pytest

from parallax_tpu_torch.runtime.request import SamplingParams
from tests._torch_disagg import (
    GEN,
    request_set,
    serve,
    streams,
    swarm,
    wait_for,
)


def _mixed_streams(reqs_and_sp, **kw):
    with swarm([("port", None), ("port", None)], **kw) as (
            _s, _svc, client, _w):
        base = serve(client, "mx", reqs_and_sp)
    assert all(r.status.value == "finished_length" for r in base)
    return streams(base)


def _watch_inflight(node, seen: list) -> None:
    """Record every preempt or extract of a request that a dispatched step
    or window still holds (none may happen), and every time a flagged row
    was found in flight (the park waited for it)."""
    eng = node.engine
    real_preempt = eng.cache.preempt_to_host
    real_extract = eng.extract
    real_inflight = eng.inflight_rids

    def preempt(req):
        if req.request_id in real_inflight():
            seen.append(("preempt", req.request_id))
        return real_preempt(req)

    def extract(rid, force=False):
        if rid in real_inflight():
            seen.append(("extract", rid))
        return real_extract(rid, force=force)

    def inflight():
        out = real_inflight()
        waited = out & set(node._handoff_pending)
        if waited:
            seen.append(("waited", sorted(waited)))
        return out

    eng.cache.preempt_to_host = preempt
    eng.extract = extract
    eng.inflight_rids = inflight


@pytest.mark.parametrize("lookahead,overlap", [(1, True), (4, True)],
                         ids=["overlap-k1", "multistep-k4"])
def test_disaggregated_streams_bit_identical_to_mixed(lookahead, overlap):
    requests = request_set()
    base = _mixed_streams(requests, lookahead=lookahead, overlap=overlap)
    with swarm([("port", "prefill"), ("port", "decode")],
               lookahead=lookahead, overlap=overlap) as (
            sched, _svc, client, (prefill, decode)):
        seen: list = []
        _watch_inflight(prefill, seen)
        disagg = serve(client, "dg", requests)
        assert all(r.status.value == "finished_length" for r in disagg)
        assert streams(disagg) == base
        # Every request crossed the phase boundary by image: adopted on
        # the decode head, which where_is names.
        assert wait_for(lambda: decode.handoff_stats.handoffs == {
            "kv_image": len(requests)})
        assert [sched.migrated_head(r.request_id) for r in disagg] == [
            decode.node_id] * len(requests)
        log = prefill.handoff_stats.snapshot()["log"]
        assert sorted(log) == sorted(r.request_id for r in disagg)
        for e in log.values():
            assert e["outcome"] == "image" and e["target"] == decode.node_id
            assert e["pages"] == 3 and e["frames"] == 3   # begin, 1, end
        assert prefill.handoff_stats.fallbacks == {}
        assert prefill.handoff_stats.transfer_frames["out"] == 3 * len(
            requests)
        assert decode.handoff_stats.transfer_bytes["in"] == (
            prefill.handoff_stats.transfer_bytes["out"]) > 0
        assert not prefill._handoff_parked and not prefill._handoff_pending
        st = sched.cluster_status()
        assert st["disagg"]["active"] is True
        assert st["disagg"]["targets_chosen"] >= len(requests)
        assert [x for x in seen if x[0] != "waited"] == []
        # Rows were flagged while a dispatched step still held them, and
        # their parks waited for it.
        assert any(x[0] == "waited" for x in seen)
        # The decode head never prefilled: it resumed adopted images.
        stats = decode.engine.cache_stats()
        assert stats["resumes"] == len(requests)
        summary = decode.engine.kernel_dispatch_summary()
        assert summary["dispatch_total"].get(
            f"{summary['prefill_impl']}/prefill", 0) == 0


def _nack_first_transfers(decode) -> None:
    """The decode head rejects each request's first transfer at its end
    frame (as a corrupt image would be)."""
    real = decode._kv_assembler.feed
    nacked = set()

    def feed(peer, frame):
        res = real(peer, frame)
        if res is not None and res[0] == "done" \
                and res[1].request_id not in nacked:
            nacked.add(res[1].request_id)
            return ("error", "rejected once by the test")
        return res

    decode._kv_assembler.feed = feed


@pytest.mark.parametrize("rung", ["prefix-warm", "nack", "result-timeout"])
def test_fallback_rungs_keep_streams_bit_identical(rung, monkeypatch):
    """Each rung of the ladder below the image keeps the streams the mixed
    pair's: a prompt within a page of the target's cache ships its
    checkpoint alone (prefix-warm); a nacked transfer re-ships
    checkpoint-only to any decode head; a transfer whose result is lost
    re-ships checkpoint-only to the SAME head, whose duplicate ack
    resolves it in place — one restore, never a second decode."""
    from parallax_tpu.testing.chaos import ChaosController
    from parallax_tpu_torch.p2p import proto
    from parallax_tpu_torch.p2p.node import WorkerNode

    requests = request_set(2, gen=48)
    chaos = None
    if rung == "prefix-warm":
        requests = [([1, 2, 3 + i], sp) for i, (_p, sp) in
                    enumerate(requests)]
    elif rung == "result-timeout":
        chaos = ChaosController(seed=1, lock_sanitizer=False,
                                conformance=False)
        monkeypatch.setattr(WorkerNode, "HANDOFF_RESULT_TIMEOUT_S", 0.3)
    base = _mixed_streams(requests)
    with swarm([("port", "prefill"), ("port", "decode")], chaos=chaos) as (
            sched, _svc, client, (prefill, decode)):
        if rung == "nack":
            _nack_first_transfers(decode)
        elif rung == "result-timeout":
            chaos.drop_frames(method=proto.KV_RESULT)
        reqs = serve(client, "fb", requests)
        assert all(r.status.value == "finished_length" for r in reqs)
        assert streams(reqs) == base
        n = len(requests)
        want = {"prefix-warm": ({"prefix_warm": n}, {"reprefill": n}),
                "nack": ({"transfer_failed": n}, {"reprefill": n}),
                "result-timeout": ({"result_timeout": n},
                                   {"kv_image": n})}[rung]
        assert prefill.handoff_stats.fallbacks == want[0]
        assert wait_for(lambda: decode.handoff_stats.handoffs == want[1])
        assert [sched.migrated_head(r.request_id) for r in reqs] == [
            decode.node_id] * n
        assert not prefill._handoff_parked


def test_handoff_restores_locally_without_decode_pool():
    """A prefill-only swarm keeps serving: handoffs find no target and
    restore locally — the mixed-mode rung, zero aborts, streams exact, and
    exactly one local restore per request (the restored request is pinned
    local)."""
    requests = request_set(2)
    with swarm([("port", None)]) as (_s, _svc, client, _w):
        base = streams(serve(client, "b", requests))
    with swarm([("port", "prefill")]) as (sched, _svc, client, (w,)):
        reqs = serve(client, "p", requests)
        assert all(r.status.value == "finished_length" for r in reqs)
        assert streams(reqs) == base
        assert w.handoff_stats.fallbacks["no_decode_pool"] == len(requests)
        assert w.handoff_stats.handoffs == {"local": len(requests)}
        assert sched.disagg_stats["no_target"] >= len(requests)


def test_multistage_prefill_pipeline_restores_locally(monkeypatch):
    """A TWO-STAGE prefill pipeline with no decode pool: the local restore
    keeps the original routing table (decode flows through the downstream
    stage) and replays (adopting the head's image alone would starve the
    downstream stage's KV); the streams equal a mixed two-stage
    pipeline's."""
    from parallax_tpu_torch.scheduling import node as node_mod

    monkeypatch.setattr(node_mod.RooflinePerformanceModel,
                        "max_layers_in_memory",
                        lambda self, kv_fraction=0.35: 2)
    requests = request_set(2)
    with swarm([("port", None), ("port", None)], min_pipelines=1) as (
            sched, _svc, client, _w):
        assert len(sched.manager.pipelines[0].nodes) == 2
        base = streams(serve(client, "mb", requests))
    with swarm([("port", "prefill"), ("port", "prefill")],
               min_pipelines=1) as (sched, _svc, client, workers):
        pipes = sched.manager.pipelines
        assert len(pipes) == 1 and pipes[0].role == "prefill"
        assert len(pipes[0].nodes) == 2
        reqs = serve(client, "mp", requests)
        assert all(r.status.value == "finished_length" for r in reqs), [
            (r.request_id, r.status) for r in reqs]
        assert streams(reqs) == base
        head = next(w for w in workers
                    if w.node_id == pipes[0].nodes[0].node_id)
        assert head.handoff_stats.handoffs == {"local": len(requests)}
        assert head.handoff_stats.fallbacks == {
            "no_decode_pool": len(requests)}


SCHEMA = json.dumps({"type": "object",
                     "properties": {"v": {"enum": ["x", "yy", "zzz"]},
                                    "n": {"type": "integer"}},
                     "required": ["v", "n"]})


def test_constrained_row_through_a_disaggregated_pair(monkeypatch):
    """A JSON-schema row (greedy, and seeded) through a prefill + decode
    pair equals the same row through a mixed pair; the handoff carried
    the DFA state the prefill head read before ``extract``, and a row that
    stopped at EOS is schema-valid JSON."""
    # Prompts past two pages: a shorter one is within a page of the
    # cold target's zero cached tokens, so the handoff would take the
    # prefix-warm rung.
    rows = [(list(range(1, 21)), SamplingParams(
                temperature=0.0, max_new_tokens=40, json_schema=SCHEMA)),
            (list(range(40, 63)), SamplingParams(
                temperature=0.9, top_k=16, seed=3, max_new_tokens=40,
                json_schema=SCHEMA))]
    with swarm([("port", None), ("port", None)], grammar=True,
               monkeypatch=monkeypatch) as (_s, _svc, client, _w):
        base = streams(serve(client, "gm", rows))
    shipped = []
    with swarm([("port", "prefill"), ("port", "decode")], grammar=True,
               monkeypatch=monkeypatch) as (_s, _svc, client, (p, d)):
        real = p._park_for_handoff

        def park(eng, req, flagged):
            shipped.append(eng.grammar_checkpoint_fields(req.request_id))
            real(eng, req, flagged)
            entry = p._handoff_parked.get(req.request_id)
            shipped.append(entry and entry["grammar"])

        p._park_for_handoff = park
        reqs = serve(client, "gd", rows)
        assert d.handoff_stats.handoffs == {"kv_image": len(rows)}
    assert streams(reqs) == base
    for r in reqs:
        assert r.status.value in ("finished_stop", "finished_length")
        if r.status.value == "finished_stop":
            json.loads(bytes(t for t in r.output_ids if t < 256))
    # Each park read the DFA state past its first token and kept it.
    assert len(shipped) == 2 * len(rows)
    for before, kept in zip(shipped[::2], shipped[1::2]):
        assert before is not None and before[0] > 0 and kept == before


def test_chat_submit_replay_ids_teacher_forces():
    """The client resume rung: a chat_submit carrying replay_ids
    teacher-forces exactly those tokens before free-running — equal to an
    uninterrupted serve."""
    with swarm([("port", None)]) as (_s, _svc, client, (w,)):
        prompt, sp = request_set(1)[0]
        base = serve(client, "rb", [(prompt, sp)])[0]
        stream = list(base.output_ids)
        assert len(stream) == GEN
        cut = GEN // 2
        w.transport.call(w.node_id, "chat_submit", {
            "rid": "replayed-1", "prompt_ids": list(prompt),
            "sampling_params": dataclasses.replace(sp).to_dict(),
            "routing_table": [w.node_id], "eos_token_ids": [],
            "replay_ids": stream[:cut],
        }, timeout=10.0)
        assert wait_for(lambda: w._chat_requests.get("replayed-1") is None
                        or w._chat_requests["replayed-1"].status.is_finished,
                        timeout=60.0)
        req = w._chat_requests.get("replayed-1")
        assert req is not None and req.status.is_finished
        assert list(req.output_ids) == stream
