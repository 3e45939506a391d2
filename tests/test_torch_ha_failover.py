"""The port's scheduler failover end to end on the CPU (port of
tests/test_ha_failover.py): a port primary scheduler journaling to a port
warm standby over TCP, two port workers and a SwarmClient over [primary,
standby]. The primary is stopped once every stream has its first token;
the standby promotes within its 1 s lease to epoch 2; every stream
finishes bit-identically to the port's InProcessPipeline, with no abort
and no engine rebuilt; the workers' heartbeats and the client's routes
move to the promoted scheduler; a seeded request routed through it is
bit-identical too; the revived old primary fences itself. At K = 1 with
the synchronous loop and at K = 4 with the overlapped one (the harness is
tests/_torch_ha.py).
"""

import pytest

from tests._torch_ha import ENGINES, ha_swarm, kill_primary_mid_decode
from tests.test_torch_sched_swarm import two_layer_capacity  # noqa: F401


@pytest.mark.parametrize("mode", sorted(ENGINES))
def test_failover_mid_decode_streams_survive(mode):
    with ha_swarm(ENGINES[mode]) as pair:
        figures = kill_primary_mid_decode(pair, ENGINES[mode])
        assert pair.standby.promotions == 1
        assert pair.standby.replay_ms is not None
        # The journal carried the registry across: joins, the pipeline
        # table and the heartbeat replay window, pushed record by record.
        kinds = pair.journal.records_by_kind
        assert kinds["snapshot"] == 1 and kinds["join"] == 2
        assert kinds["pipelines"] >= 1 and kinds["hb"] > 0
        assert pair.journal.pushes > 0
        assert figures["journal_seq"] == sum(kinds.values())
