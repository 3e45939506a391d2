"""The port's scheduler HA units (parallax_tpu_torch.ha) against the JAX
package's (parallax_tpu.ha): every case of tests/test_ha.py but the churn
replay (it needs ``testing/churn.py``, ROADMAP queue 1 item 9), each run on
both packages with the same events, clocks and seeded RNGs, and the two
packages' results held equal — backoff delays, failover rotations, the
journal's records (kind and data, record for record), state fingerprints,
promotions and fences.

Across the packages: a snapshot of either scheduler restores in the other
with an equal ``state_fingerprint`` (soft state and pipeline ids too); a
standby of either package tails the other's JSONL journal to an equal
state; snapshots and journal records cross the port's codec as msgpack
bytes (string-keyed maps only); a snapshot carrying QoS state is refused
by name, and a JAX snapshot's timeline cursors are dropped.

No engine and no thread: the schedulers are driven through their
synchronous twins.
"""

import json
import random
import types

import msgpack
import pytest

import parallax_tpu.backend.scheduler_service as j_service
import parallax_tpu.ha.backoff as j_backoff
import parallax_tpu.ha.failover as j_failover
import parallax_tpu.ha.journal as j_journal
import parallax_tpu.ha.standby as j_standby
import parallax_tpu.scheduling.scheduler as j_sched
import parallax_tpu.utils.hw as j_hw
import parallax_tpu_torch.backend.scheduler_service as p_service
import parallax_tpu_torch.ha.backoff as p_backoff
import parallax_tpu_torch.ha.failover as p_failover
import parallax_tpu_torch.ha.journal as p_journal
import parallax_tpu_torch.ha.standby as p_standby
import parallax_tpu_torch.scheduling.scheduler as p_sched
import parallax_tpu_torch.utils.hw as p_hw
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.p2p import proto as j_proto
from parallax_tpu_torch.config import normalize_config as p_normalize
from parallax_tpu_torch.p2p import proto as p_proto
from parallax_tpu_torch.p2p import wire

RAW = dict(
    architectures=["Qwen2ForCausalLM"],
    hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
    num_key_value_heads=2, intermediate_size=128, vocab_size=151,
    max_position_embeddings=256,
)

PKGS = {
    "jax": types.SimpleNamespace(
        backoff=j_backoff, failover=j_failover, journal=j_journal,
        standby=j_standby, sched=j_sched, service=j_service, hw=j_hw,
        cfg=j_normalize(RAW)),
    "port": types.SimpleNamespace(
        backoff=p_backoff, failover=p_failover, journal=p_journal,
        standby=p_standby, sched=p_sched, service=p_service, hw=p_hw,
        cfg=p_normalize(RAW)),
}
BOTH = pytest.mark.parametrize("direction", ["jax->port", "port->jax"])


def _hw(pkg, kind="v5e", chips=4):
    t, g, b, i = j_hw.TPU_CHIP_DB[kind]
    return pkg.hw.HardwareInfo(kind, chips, t, g, b, i)


def _scheduler(pkg, passive=False):
    return pkg.sched.GlobalScheduler(pkg.cfg, min_nodes_bootstrapping=1,
                                     passive=passive)


def _serving_scheduler(pkg, n=2, journal_path=None):
    """A bootstrapped scheduler with ``n`` ready nodes, driven through the
    synchronous twins (no threads)."""
    sched = _scheduler(pkg)
    if journal_path is not None:
        journal = pkg.journal.StateJournal(sink_path=journal_path,
                                           epoch=sched.epoch)
        pkg.journal.install_journal(sched, journal)
    for i in range(n):
        sched.enqueue_join(f"w{i}", _hw(pkg))
    sched.drain_events()
    for i in range(n):
        sched.enqueue_update(f"w{i}", is_ready=True, load=i,
                             layer_latency_ms=8.0, busy=False)
    sched.drain_events()
    sched.sweep_once()
    assert sched.bootstrapped.is_set()
    return sched


def _both(fn):
    """``fn(pkg)`` on each package; returns {"jax": ..., "port": ...}."""
    return {name: fn(pkg) for name, pkg in PKGS.items()}


def _fp(pkg, sched, **kw):
    return pkg.journal.state_fingerprint(sched, **kw)


def _records(path):
    """A JSONL journal's (kind, data) pairs, with the clock-derived fields
    (ages, stamps) taken out of snapshot records."""
    out = []
    for rec in map(json.loads, open(path)):
        data = rec["data"]
        if rec["kind"] == "snapshot":
            data = dict(data, nodes=[
                {k: v for k, v in nd.items() if k != "hb_age_s"}
                | {"cache_index": {k: v for k, v in nd["cache_index"].items()
                                   if k != "age_s"}}
                for nd in data["nodes"]])
        out.append((rec["seq"], rec["kind"], rec["epoch"], data))
    return out


# -- backoff -----------------------------------------------------------------


def test_backoff_full_jitter_under_cap_and_deadline():
    def run(pkg):
        clock = [0.0]
        slept = []

        def sleep(s):
            slept.append(s)
            clock[0] += s

        b = pkg.backoff.Backoff(
            pkg.backoff.BackoffPolicy(base_s=1.0, cap_s=4.0, multiplier=2.0),
            deadline_s=10.0, rng=random.Random(3), clock=lambda: clock[0],
            sleep=sleep,
        )
        # Jitter ceiling grows 1, 2, 4, then pins at the cap.
        delays = [b.next_delay() for _ in range(6)]
        assert all(d <= 4.0 for d in delays)
        assert b.attempts == 6
        # wait() never sleeps past the shared deadline and reports
        # exhaustion instead of looping forever.
        b2 = pkg.backoff.Backoff(
            pkg.backoff.BackoffPolicy(base_s=8.0, cap_s=8.0), deadline_s=2.0,
            rng=random.Random(1), clock=lambda: clock[0], sleep=sleep,
        )
        ok, rounds = True, 0
        while ok and rounds < 50:
            ok = b2.wait()
            rounds += 1
        assert not ok and rounds < 50
        assert max(slept) <= 8.0
        return delays, slept, rounds

    got = _both(run)
    assert got["port"] == got["jax"]
    assert (p_backoff.SCHEDULER_RPC_POLICY
            == p_backoff.BackoffPolicy(**vars(j_backoff.SCHEDULER_RPC_POLICY)))


# -- failover wrapper --------------------------------------------------------


class _ScriptedTransport:
    """Transport-shaped stub: per-peer reply scripts."""

    def __init__(self, scripts):
        self.scripts = {k: list(v) for k, v in scripts.items()}
        self.calls = []

    def call(self, peer, method, payload, timeout=10.0):
        self.calls.append((peer, method))
        script = self.scripts.get(peer) or [ConnectionError(peer)]
        step = script.pop(0) if len(script) > 1 else script[0]
        if isinstance(step, Exception):
            raise step
        return step


def test_failover_rotates_on_transport_error():
    def run(pkg):
        t = _ScriptedTransport({
            "primary": [ConnectionError("down")],
            "standby": [{"ok": True, "epoch": 2}],
        })
        fo = pkg.failover.SchedulerFailover(
            t, ["primary", "standby"],
            policy=pkg.backoff.BackoffPolicy(base_s=0.0, cap_s=0.0),
        )
        reply = fo.call("primary", "node_update", {"node_id": "w0"})
        assert reply == {"ok": True, "epoch": 2}
        assert fo.active_peer == "standby"
        assert fo.epoch == 2
        return t.calls, fo.peers

    got = _both(run)
    assert got["port"] == got["jax"]


def test_failover_rotates_on_not_primary_and_learns_standbys():
    def run(pkg):
        t = _ScriptedTransport({
            "primary": [{"not_primary": True, "epoch": 3,
                         "standbys": ["standby"]}],
            "standby": [{"ok": True, "epoch": 3}],
        })
        # The wrapper starts knowing ONLY the primary; the redirect reply
        # advertises the standby and the retry lands there.
        fo = pkg.failover.SchedulerFailover(
            t, ["primary"],
            policy=pkg.backoff.BackoffPolicy(base_s=0.0, cap_s=0.0),
        )
        reply = fo.call("primary", "node_update", {"node_id": "w0"})
        assert reply == {"ok": True, "epoch": 3}
        assert fo.peers == ["primary", "standby"]
        assert fo.epoch == 3
        return t.calls

    got = _both(run)
    assert got["port"] == got["jax"]


def test_failover_exhausts_deadline_with_original_error():
    for pkg in PKGS.values():
        t = _ScriptedTransport({"only": [ConnectionError("down")]})
        fo = pkg.failover.SchedulerFailover(
            t, ["only"],
            policy=pkg.backoff.BackoffPolicy(base_s=0.05, cap_s=0.05),
        )
        with pytest.raises(ConnectionError):
            fo.call("only", "node_update", {"node_id": "w0"}, timeout=0.2)


# -- snapshot codec ----------------------------------------------------------


def test_snapshot_roundtrip_preserves_fingerprint():
    def run(pkg):
        sched = _serving_scheduler(pkg)
        sched.record_migration("r1", "w0")
        snap = pkg.journal.snapshot_state(sched)
        mirror = _scheduler(pkg, passive=True)
        pkg.journal.restore_state(mirror, snap)
        assert _fp(pkg, mirror) == _fp(pkg, sched)
        assert (pkg.journal.soft_state_fingerprint(mirror)
                == pkg.journal.soft_state_fingerprint(sched))
        # Pipeline ids survive verbatim.
        ids = [p.pipeline_id for p in mirror.manager.pipelines]
        assert ids == [p.pipeline_id for p in sched.manager.pipelines]
        return _fp(pkg, mirror), ids, sorted(snap)

    got = _both(run)
    assert got["port"] == got["jax"]


def test_snapshot_version_and_model_guard():
    for pkg in PKGS.values():
        snap = pkg.journal.snapshot_state(_serving_scheduler(pkg, n=1))
        mirror = _scheduler(pkg, passive=True)
        with pytest.raises(ValueError):
            pkg.journal.restore_state(mirror, dict(snap, v=99))
        with pytest.raises(ValueError):
            pkg.journal.restore_state(mirror, dict(snap, model="other"))


# -- journal replay + promotion ---------------------------------------------


def test_file_journal_replay_promotes_equivalent_state(tmp_path):
    def run(pkg):
        path = str(tmp_path / f"journal_{id(pkg)}.jsonl")
        sched = _serving_scheduler(pkg, journal_path=path)
        sched.record_migration("r7", "w1")
        # Post-install churn must flow through the journal too.
        sched.enqueue_join("w2", _hw(pkg, "v5e", 2))
        sched.drain_events()
        sched.enqueue_update("w2", is_ready=True, load=0,
                             layer_latency_ms=9.0)
        sched.drain_events()
        sched.sweep_once()

        mirror = _scheduler(pkg, passive=True)
        standby = pkg.standby.StandbyScheduler(mirror, journal_path=path,
                                               auto_promote=False)
        assert standby.sync_once()
        assert _fp(pkg, mirror) == _fp(pkg, sched)
        assert (pkg.journal.soft_state_fingerprint(mirror)
                == pkg.journal.soft_state_fingerprint(sched))

        epoch = standby.promote(start_threads=False)
        assert epoch == sched.epoch + 1
        assert mirror.epoch == epoch
        assert not mirror.passive and not mirror.fenced
        # The promoted scheduler owns a fresh journal seeded with its own
        # snapshot + epoch record — a second standby can tail IT now.
        assert mirror.journal is not None and mirror.journal.seq >= 2
        # Promotion is idempotent.
        assert standby.promote(start_threads=False) == epoch
        return (_records(path), _fp(pkg, mirror), standby.applied_seq,
                [r["kind"] for r in mirror.journal.records_since(0)[0]])

    got = _both(run)
    # The port journals what the JAX scheduler journals, record for record.
    assert got["port"] == got["jax"]
    # The port keeps the JAX registry's HA families as attributes.
    standby = p_standby.StandbyScheduler(
        _scheduler(PKGS["port"], passive=True),
        journal_path=str(tmp_path / "none.jsonl"), auto_promote=False)
    assert (standby.promotions, standby.replay_ms, standby.resyncs) == (
        0, None, 0)


def test_journal_ring_eviction_reports_discontiguity():
    def run(pkg):
        j = pkg.journal.StateJournal(capacity=4)
        for i in range(10):
            j.record("hb", {"i": i})
        recs, contiguous = j.records_since(0)
        assert not contiguous          # seqs 1..6 were evicted
        recs, contiguous = j.records_since(6)
        assert contiguous and [r["seq"] for r in recs] == [7, 8, 9, 10]
        return [r["data"] for r in recs]

    got = _both(run)
    assert got["port"] == got["jax"]
    j = p_journal.StateJournal(capacity=4)
    j.record("hb", {})
    j.record("join", {})
    assert j.records_by_kind == {"hb": 1, "join": 1}


# -- fencing -----------------------------------------------------------------


def test_fenced_scheduler_refuses_mutations():
    for pkg in PKGS.values():
        sched = _serving_scheduler(pkg)
        before = _fp(pkg, sched)
        sched.fence(7)
        assert sched.fenced
        sched.enqueue_join("zombie", _hw(pkg))
        sched.enqueue_update("w0", is_ready=False, load=99)
        sched.drain_events()
        assert _fp(pkg, sched) == before
        assert sched.manager.get("zombie") is None


def test_service_fences_on_higher_echoed_epoch():
    class _T:
        def register(self, *_a, **_k):
            pass

    def run(pkg):
        sched = _serving_scheduler(pkg)
        service = pkg.service.SchedulerService(sched, _T(),
                                               standby_addrs=["sb:1"])
        # Normal beat: mutates and advertises epoch + standby list.
        reply = service._on_update("w0", {"node_id": "w0", "load": 1})
        assert reply.get("epoch") == sched.epoch
        assert reply.get("standbys") == ["sb:1"]
        # A worker echoing a higher epoch proves a standby promoted past
        # us: the service fences BEFORE handling and refuses the mutation.
        refused = service._on_update(
            "w0", {"node_id": "w0", "load": 5, "epoch": sched.epoch + 1},
        )
        assert refused.get("not_primary") and sched.fenced
        # Every mutating frame now bounces; reads still answer.
        assert service._on_join("w9", {"node_id": "w9"}).get("not_primary")
        assert service.route_request("r1", timeout_s=0.01) is None
        assert service._on_where_is("w0", {"rid": "nope"}) == {}
        return refused, sorted(reply)

    got = _both(run)
    assert got["port"] == got["jax"]


# -- digest continuity across promotion (no full-snapshot storm) -------------


def test_digest_seq_gap_after_promotion_asks_one_resync(tmp_path):
    def run(pkg):
        path = str(tmp_path / f"digests_{id(pkg)}.jsonl")
        sched = _serving_scheduler(pkg, journal_path=path)
        sched.enqueue_update(
            "w0", cache_digests={"seq": 0, "block": 16, "full": [1, 2, 3]},
        )
        sched.enqueue_update(
            "w0", cache_digests={"seq": 1, "block": 16, "added": [4]},
        )
        sched.drain_events()

        mirror = _scheduler(pkg, passive=True)
        standby = pkg.standby.StandbyScheduler(mirror, journal_path=path,
                                               auto_promote=False)
        assert standby.sync_once()
        node = mirror.manager.get("w0")
        assert node.cache_index.seq == 1
        standby.promote(start_threads=False)

        # Delta seq 2 died with the old primary; the worker's next beat
        # carries seq 3 — a gap. The promoted scheduler must ask for ONE
        # resync, not storm.
        mirror.enqueue_update(
            "w0", cache_digests={"seq": 3, "block": 16, "added": [6]},
        )
        mirror.drain_events()
        assert node.digests_need_resync
        assert mirror.digests_resync_requested("w0") is True
        assert mirror.digests_resync_requested("w0") is False
        mirror.enqueue_update(
            "w0",
            cache_digests={"seq": 3, "block": 16, "full": [1, 2, 3, 4, 6]},
        )
        mirror.drain_events()
        assert node.cache_index.seq == 3
        entries = sorted(node.cache_index.export()["entries"])
        assert entries == [1, 2, 3, 4, 6]
        assert not node.digests_need_resync
        assert mirror.digests_resync_requested("w0") is False
        return entries, _fp(pkg, mirror)

    got = _both(run)
    assert got["port"] == got["jax"]


# -- across the packages -------------------------------------------------------


@BOTH
def test_snapshot_restores_across_packages(direction):
    """A snapshot of one package's scheduler, carried over the other
    package's codec, restores in the other package's mirror with an equal
    fingerprint, equal soft state and the same pipeline ids."""
    src_name, dst_name = direction.split("->")
    src, dst = PKGS[src_name], PKGS[dst_name]
    sched = _serving_scheduler(src, n=3)
    sched.record_migration("r1", "w0")
    sched.enqueue_update(
        "w1", cache_digests={"seq": 0, "block": 8,
                             "full": [(1 << 64) - 5, 3, 1 << 40]},
    )
    sched.drain_events()
    snap = src.journal.snapshot_state(sched)
    frame = (j_proto if src_name == "jax" else p_proto).encode_frame(
        "ha_sync", {"snapshot": snap})
    snap = (p_proto if dst_name == "port" else j_proto).decode_frame(
        frame)["p"]["snapshot"]
    mirror = _scheduler(dst, passive=True)
    dst.journal.restore_state(mirror, snap)
    assert _fp(dst, mirror) == _fp(src, sched)
    assert (dst.journal.soft_state_fingerprint(mirror)
            == src.journal.soft_state_fingerprint(sched))
    assert ([p.pipeline_id for p in mirror.manager.pipelines]
            == [p.pipeline_id for p in sched.manager.pipelines])
    assert mirror.manager.next_pipeline_id == sched.manager.next_pipeline_id
    assert mirror.migrated_head("r1") == "w0"


@BOTH
def test_standby_tails_the_other_packages_journal(tmp_path, direction):
    """A file-mode standby of one package tails the other package's JSONL
    journal, promotes to epoch 2, and mirrors it field by field."""
    src_name, dst_name = direction.split("->")
    src, dst = PKGS[src_name], PKGS[dst_name]
    path = str(tmp_path / "journal.jsonl")
    sched = _serving_scheduler(src, journal_path=path)
    sched.record_migration("r7", "w1")
    sched.enqueue_peer_down("w0", "w1", "send failed")
    sched.enqueue_update("w1", is_ready=True, load=2)
    sched.enqueue_leave("w0")
    sched.drain_events()
    sched.sweep_once()
    mirror = _scheduler(dst, passive=True)
    standby = dst.standby.StandbyScheduler(mirror, journal_path=path,
                                           auto_promote=False)
    assert standby.sync_once()
    assert _fp(dst, mirror) == _fp(src, sched)
    assert standby.promote(start_threads=False) == 2


def test_snapshots_and_records_are_msgpack_with_string_keys():
    """The port's snapshot and journal records pack as msgpack's own bytes,
    and read back under msgpack's strict_map_key (every map string-keyed:
    refit_index, the stats maps, the timeline cursors)."""
    sched = _serving_scheduler(PKGS["port"], n=2)
    journal = p_journal.StateJournal(epoch=sched.epoch)
    p_journal.install_journal(sched, journal)
    sched.enqueue_update("w0", load=3, cache_digests={
        "seq": 0, "block": 8, "full": [(1 << 64) - 1, 7]})
    sched.drain_events()
    sched.record_migration("rid", "w1")
    records, contiguous = journal.records_since(0)
    assert contiguous and [r["kind"] for r in records] == [
        "snapshot", "hb", "migration_done"]
    for obj in [p_journal.snapshot_state(sched), *records]:
        packed = wire.packb(obj)
        assert packed == msgpack.packb(obj, use_bin_type=True)
        assert msgpack.unpackb(packed, raw=False,
                               strict_map_key=True) == wire.unpackb(packed)
    assert records[0]["data"]["qos"] is None
    assert records[0]["data"]["timeline"] == {"cursors": {}, "local_seq": {}}


def test_qos_snapshot_refused_and_timeline_cursors_dropped():
    jsched = _serving_scheduler(PKGS["jax"], n=1)
    snap = j_journal.snapshot_state(jsched)
    mirror = _scheduler(PKGS["port"], passive=True)
    # QoS is ported: a mirror without QoS ignores the section, one with
    # QoS adopts the shed state.
    shed = {"shedding": True, "last_burn": 2.0}
    p_journal.restore_state(mirror, dict(snap, qos=shed))
    from parallax_tpu_torch.qos import parse_qos_spec

    qmirror = p_sched.GlobalScheduler(
        p_normalize(RAW), passive=True, qos=parse_qos_spec("on"))
    p_journal.restore_state(qmirror, dict(snap, qos=shed))
    assert qmirror.qos_controller.shedding
    assert qmirror.qos_controller.last_burn == 2.0
    cursors = {"cursors": {"w0": {"epoch": "e", "seq": 4}},
               "local_seq": {"w0": 4}}
    p_journal.restore_state(mirror, dict(snap, timeline=cursors))
    assert _fp(PKGS["port"], mirror) == _fp(PKGS["jax"], jsched)
