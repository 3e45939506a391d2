"""The port's host KV tier with K = 8 windows (tests/_torch_host_cache.py
has the suite's helpers): preempted streams bit for bit against the
unpreempted ones, greedy and seeded, synchronous and overlapped."""

import pytest

from parallax_tpu_torch.runtime.request import RequestStatus
from tests._torch_host_cache import (
    PRESSURE,
    _port_engine,
    _pressure_reqs,
    _serve,
    _unpreempted,
)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("k", [8], ids=["K8"])
def test_preempted_streams_bit_identical(sampled, overlap, k):
    """Every configuration's preempted streams equal the unpreempted K = 1
    synchronous ones, bit for bit."""
    kw = dict(temp=0.8, seed=42) if sampled else {}
    cfg = dict(overlap_steps=overlap, decode_lookahead=k)
    base = _unpreempted(sampled)
    eng = _port_engine(**PRESSURE, **cfg)
    on = _serve(eng, _pressure_reqs(**kw))
    stats = eng.cache_stats()
    assert stats["kv_oom_aborts"] == 0
    assert stats["preemptions"] > 0 and stats["resumes"] > 0
    assert stats["pages_demoted"] >= stats["preemptions"]
    for a, b in zip(base, on):
        assert b.status == a.status == RequestStatus.FINISHED_LENGTH
        assert b.output_ids == a.output_ids, b.request_id
