"""The float8 link mode across the packages: a JAX worker and a port worker
(``tests/test_torch_swarm.py``'s two-stage TCP swarm, f32 workers) with
``wire_dtype="fp8"`` on both ends negotiate ``float8_e4m3fn`` over
``wire_caps`` and complete every request, the head's hidden rows crossing
at one byte a value plus a 4-byte scale a row (the JAX package's
``tests/test_activation_transport.py`` runs the same with two JAX
workers). The mode is lossy by design: each stream is checked only for
completion here, and its greedy tokens against the f32 model within a
generous gap."""

import pytest

from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from test_torch_swarm import (
    ENGINE,
    N_NEW,
    PROMPTS,
    _reference_logits,
    _requests,
    _serve,
    swarm,
)

HIDDEN = 64


@pytest.mark.parametrize("kinds", [("jax", "port"), ("port", "jax")],
                         ids=["jax-head", "port-head"])
def test_float8_link_negotiated_between_jax_and_port(kinds):
    engine = dict(ENGINE, wire_dtype="fp8")
    req_cls, sp_cls = ((Request, SamplingParams) if kinds[0] == "port"
                       else (JRequest, JSampling))
    with swarm(kinds, engine=engine) as (head, tail):
        got = _serve(head, _requests(req_cls, sp_cls, seeded=False))
        assert head._wire_dtypes[tail.node_id][0] == "float8_e4m3fn"
        stats = head.transport_stats()[tail.node_id]
        rx = tail.transport_stats()[head.node_id]
    rows = sum(len(p) + N_NEW - 1 for p in PROMPTS)
    assert stats["bytes_out"] == rx["bytes_in"] == rows * (HIDDEN + 4)
    assert stats["compression_ratio"] > 3.5
    for r in got:
        assert r.status.value == "finished_length"
        logits = _reference_logits(list(r.prompt_ids) + r.output_ids[:-1])
        p0 = len(r.prompt_ids) - 1
        for i, tok in enumerate(r.output_ids):
            row = logits[p0 + i]
            assert float(row.max() - row[tok]) < 0.5, (r.request_id, i)
