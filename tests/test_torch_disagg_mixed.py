"""Disaggregated prefill / decode across the two packages, and the chaos
case, on the CPU (tests/_torch_disagg.py's swarms; a swarm that mixes the
packages runs over TCP on localhost).

- Port workers, prefill + decode, under the JAX scheduler: every request
  handed off by image to the port decode head, the streams bit-identical
  to a port mixed pair's, and the JAX scheduler's ``disagg`` section
  counting the targets it chose.
- A JAX prefill head hands off to a port decode head: the JAX frames are
  assembled and the JAX image adopted by the port, and the greedy
  streams equal an all-JAX prefill + decode pair's.
- The prefill node dies while KV transfers are in flight (the JAX
  package's ChaosController over the port's transports): nothing aborts,
  and every stream stays bit-identical to the healthy mixed pair's.
"""

import threading
import time

from parallax_tpu.p2p import proto as jproto
from parallax_tpu.testing.chaos import ChaosController
from parallax_tpu_torch.runtime.request import SamplingParams
from tests._torch_disagg import (
    GEN,
    request_set,
    serve,
    streams,
    swarm,
    wait_for,
)


def _port_mixed(requests):
    with swarm([("port", None), ("port", None)]) as (_s, _svc, client, _w):
        base = serve(client, "mx", requests)
    assert all(r.status.value == "finished_length" for r in base)
    return streams(base)


def test_port_pair_under_the_jax_scheduler():
    requests = request_set()
    base = _port_mixed(requests)
    with swarm([("port", "prefill"), ("port", "decode")], sched="jax") as (
            sched, _svc, client, (prefill, decode)):
        reqs = serve(client, "js", requests)
        assert all(r.status.value == "finished_length" for r in reqs)
        assert streams(reqs) == base
        assert wait_for(lambda: decode.handoff_stats.handoffs == {
            "kv_image": len(requests)})
        assert [sched.migrated_head(r.request_id) for r in reqs] == [
            decode.node_id] * len(requests)
        st = sched.cluster_status()
        assert {p["role"] for p in st["pipelines"]} == {"prefill", "decode"}
        assert st["disagg"]["active"] is True
        assert st["disagg"]["targets_chosen"] >= len(requests)
        assert not prefill._handoff_parked


def _greedy(n=4):
    base = [7, 8, 9, 10] * 4
    return [(base + [30 + i, 40 + i, 50 + i],
             SamplingParams(temperature=0.0, max_new_tokens=GEN,
                            ignore_eos=True)) for i in range(n)]


def test_jax_prefill_head_hands_off_to_a_port_decode_head():
    """The JAX prefill head frames its images with msgpack; the port decode
    head assembles them, adopts the pages and decodes: the same greedy
    streams as a JAX prefill head handing off to a JAX decode head."""
    requests = _greedy()
    with swarm([("jax", "prefill"), ("jax", "decode")], sched="jax") as (
            _s, _svc, client, _w):
        want = streams(serve(client, "jj", requests))
    with swarm([("jax", "prefill"), ("port", "decode")], sched="jax") as (
            sched, _svc, client, (_jprefill, decode)):
        reqs = serve(client, "jp", requests)
        assert all(r.status.value == "finished_length" for r in reqs)
        assert wait_for(lambda: decode.handoff_stats.handoffs == {
            "kv_image": len(requests)})
        assert decode.handoff_stats.transfer_frames["in"] > 0
        assert [sched.migrated_head(r.request_id) for r in reqs] == [
            decode.node_id] * len(requests)
    assert streams(reqs) == want


def test_kill_prefill_node_mid_transfer_zero_aborts():
    """The prefill node dies while KV transfers are in flight. Nothing
    aborts — pollers recover through where_is (the transfer completed) or
    the client resume rung (re-route and replay onto the surviving decode
    pool) — and every stream stays bit-identical to the healthy
    baseline."""
    requests = request_set()
    base = _port_mixed(requests)
    chaos = ChaosController(seed=5, lock_sanitizer=False,
                            conformance=False)
    # One layer a frame and a delay on each: transfers take about a
    # second, so the kill below lands mid-flight.
    with swarm([("port", "prefill"), ("port", "decode")], chunk_bytes=1,
               chaos=chaos) as (_s, _svc, client, (prefill, decode)):
        chaos.delay_frames(0.15, method=jproto.KV_TRANSFER)
        killed = {}
        lock = threading.Lock()

        def kill_prefill(_i, _req):
            with lock:
                if killed:
                    return
                killed["at"] = time.monotonic()
                # Let the handoffs start shipping, then sever the source.
                time.sleep(0.3)
                chaos.kill(prefill)

        reqs = serve(client, "ck", requests, on_tokens=kill_prefill)
        assert killed, "the prefill node was never killed"
        aborted = [r.request_id for r in reqs
                   if r.status.value == "finished_abort"]
        assert aborted == [], aborted
        assert streams(reqs) == base
        # The kill cut transfers short: not every request arrived by image.
        assert decode.handoff_stats.handoffs.get("kv_image", 0) < len(
            requests)
