"""Scheduler HA across the packages over TCP on the CPU: a port standby
tails a JAX primary's journal (pushed ``ha_journal`` frames and
``ha_sync`` pulls in the JAX package's msgpack frames), and a JAX standby
tails a port primary. Each mirrors its primary's ``state_fingerprint``
field by field, promotes to epoch 2 once the primary stops, and keeps the
fingerprint through the promotion. Then port workers behind a JAX
scheduler pair fail over from the JAX primary to the JAX standby mid
decode, with the streams bit-identical to the port's InProcessPipeline
(tests/_torch_ha.py's story).
"""

import contextlib

import pytest

import parallax_tpu.ha.journal as j_journal
import parallax_tpu.utils.hw as j_hw
import parallax_tpu_torch.ha.journal as p_journal
import parallax_tpu_torch.utils.hw as p_hw
from tests._torch_ha import (
    DEADLINE_S,
    ENGINES,
    ha_swarm,
    kill_primary_mid_decode,
    scheduler_pair,
)
from tests.test_torch_sched_swarm import two_layer_capacity  # noqa: F401
from tests.test_torch_swarm import _wait

_PKG = {"jax": (j_journal, j_hw), "port": (p_journal, p_hw)}


@pytest.mark.parametrize("primary,standby", [("jax", "port"),
                                             ("port", "jax")],
                         ids=["jax-primary", "port-primary"])
def test_standby_of_the_other_package_promotes_equal(primary, standby):
    pair = scheduler_pair(primary, standby)
    pj, phw = _PKG[primary]
    sj = _PKG[standby][0]
    sched = pair.service.scheduler
    mirror = pair.mirror_service.scheduler
    try:
        t, g, b, i = j_hw.TPU_CHIP_DB["v5e"]
        for k in range(3):
            sched.enqueue_join(f"w{k}", phw.HardwareInfo("v5e", 4, t, g, b,
                                                         i))
        assert _wait(lambda: sched.bootstrapped.is_set()
                     and len(sched.manager) == 3)
        for k in range(3):
            sched.enqueue_update(f"w{k}", is_ready=True, load=k,
                                 layer_latency_ms=8.0, busy=False,
                                 cache_digests={"seq": 0, "block": 8,
                                                "full": [k, (1 << 63) + k]})
        sched.record_migration("rid-1", "w0")

        def mirrored():
            return (pair.standby.applied_seq == pair.journal.seq
                    and sj.state_fingerprint(mirror)
                    == pj.state_fingerprint(sched))

        assert _wait(mirrored), (sj.state_fingerprint(mirror),
                                 pj.state_fingerprint(sched))
        want = pj.state_fingerprint(sched)
        assert want["nodes"]["w1"]["ready"] and len(want["pipelines"]) == 1
        pair.service.stop()
        # (The JAX standby flips ``promoted`` before its scheduler goes
        # active: wait for the scheduler.)
        assert _wait(lambda: pair.standby.promoted and not mirror.passive,
                     DEADLINE_S)
        assert mirror.epoch == 2
        assert sj.state_fingerprint(mirror) == want
        assert ([p.pipeline_id for p in mirror.manager.pipelines]
                == [p.pipeline_id for p in sched.manager.pipelines])
    finally:
        pair.standby.stop()
        pair.journal.stop()
        with contextlib.suppress(Exception):
            mirror.journal.stop()
        pair.mirror_service.stop()
        pair.service.stop()


def test_port_workers_fail_over_from_jax_primary_to_jax_standby():
    engine = ENGINES["K4-overlap"]
    with ha_swarm(engine, sched="jax") as pair:
        kill_primary_mid_decode(pair, engine)
