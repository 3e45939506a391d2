"""The port's MiniMax engines against the JAX engine
(tests/_torch_msa.py has the suite's configs and helpers): M2 and M3
greedy streams under the tie-tolerant rule with a prefix hit, and M3's
fused, split-kernel and plain streams identical, each route reaching its
wrappers once per layer and decode step."""

import pytest

from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.ops import (
    decode_fused,
    dsa_decode,
    kernel_select,
)
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests.test_torch_deepseek_engine import (
    ENGINE,
    TOL,
)
from tests.test_torch_deepseek_routes import _spy
from tests._torch_msa import (
    JCLS,
    N_LAYERS,
    N_NEW,
    RAWS,
    _port_engines,
    _reference_logits,
    _serve,
    _stage,
    _weights,
)


@pytest.mark.parametrize("name", sorted(RAWS))
def test_engine_streams_match_jax(name):
    cfg, full, _ = _weights(name)
    k1 = dict(decode_lookahead=1, overlap_steps=False)
    port = _serve(InProcessPipeline(_port_engines(name, [(0, 3)], **k1)),
                  Request, SamplingParams)
    jeng = JStageEngine(JCLS[name](cfg, 0, N_LAYERS, use_pallas=False),
                        _stage(full, 0, N_LAYERS),
                        JEngineConfig(**ENGINE, **k1))
    ref = _serve(JPipeline([jeng]), JRequest, JSampling)
    all_logits = _reference_logits(
        name, [pr.prompt_ids + pr.output_ids[:-1] for pr in port])
    for pr, jr, logits in zip(port, ref, all_logits):
        assert pr.status.value == "finished_length"
        assert len(pr.output_ids) == N_NEW
        p0 = len(pr.prompt_ids) - 1
        for i, tok in enumerate(pr.output_ids):
            row = logits[p0 + i]
            gap = float(row.max() - row[tok])
            assert gap < TOL, (pr.request_id, i, tok, int(row.argmax()), gap)
        same = 0
        while same < N_NEW and pr.output_ids[same] == jr.output_ids[same]:
            same += 1
        if same < N_NEW:
            row = logits[p0 + same]
            gap = abs(float(row[pr.output_ids[same]]
                            - row[jr.output_ids[same]]))
            assert gap < TOL, (pr.request_id, same, gap)
    assert port[-1].num_cached_tokens > 0
    assert ref[-1].num_cached_tokens == port[-1].num_cached_tokens


def test_m3_fused_split_and_plain_streams_identical(monkeypatch):
    """Within the port: fused decode (A7 on the sparse layers, A2 on the
    dense one), the split route through the split kernels' wrappers (A8,
    A1 attend-only) and the plain route give the same streams, greedy and
    seeded; each decode step reaches the indexer wrapper once per sparse
    layer. (On the CPU every wrapper runs its plain version; the test lets
    the engine take the fused route on the CPU.)"""
    monkeypatch.setattr(kernel_select, "_check_kernel_device",
                        lambda device, what: None)
    calls: dict[str, int] = {}
    _spy(monkeypatch, decode_fused, "indexer_scores_fused", calls)
    _spy(monkeypatch, decode_fused, "gqa_fused_decode", calls)
    _spy(monkeypatch, dsa_decode, "paged_token_scores_decode", calls)
    streams, seen = {}, {}
    for route, fused, kernels in (("fused", True, None),
                                  ("split-kernel", False, True),
                                  ("plain", False, None)):
        calls.clear()
        engines = _port_engines("m3", [(0, 3)], use_kernels=kernels,
                                decode_fused=fused, prefill_fused=fused)
        reqs = _serve(InProcessPipeline(engines), Request, SamplingParams,
                      seeded=True)
        streams[route] = [r.output_ids for r in reqs]
        seen[route] = (dict(calls), engines[0].kernel_dispatch_summary())
    assert streams["fused"] == streams["split-kernel"] == streams["plain"]
    sparse = 2
    for route, (c, summary) in seen.items():
        totals = summary["dispatch_total"]
        decode = sum(totals.get(f"{summary['impl']}/{path}", 0)
                     for path in ("decode", "multistep"))
        assert decode > 0
        # MSA turns fused prefill off: prefill takes the split chain.
        assert summary["prefill_impl"] != "cuda-fused"
        want = {"fused": {"indexer_scores_fused": sparse * decode,
                          "gqa_fused_decode": decode},
                "split-kernel": {"paged_token_scores_decode":
                                 sparse * decode},
                "plain": {}}[route]
        assert {k: v for k, v in c.items() if v} == want, route
