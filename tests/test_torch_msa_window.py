"""The port's MiniMax engines in windows and pipelines
(tests/_torch_msa.py has the suite's configs and helpers): the K = 8
overlapped window bit-identical to K = 1 sync, greedy and seeded, and a
2-stage pipeline equal to the single stage."""

import pytest

from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests._torch_msa import (
    RAWS,
    _port_engines,
    _serve,
)


@pytest.mark.parametrize("name", sorted(RAWS))
def test_overlap_window_equals_k1_sync(name):
    """The engine's defaults (adaptive K = 8 windows, overlapped) give the
    K = 1 synchronous streams bit for bit, greedy and seeded."""
    streams, windows = {}, {}
    for mode, kw in (("k8", {}), ("k1_sync", dict(decode_lookahead=1,
                                                   overlap_steps=False))):
        engines = _port_engines(name, [(0, 3)], **kw)
        streams[mode] = [r.output_ids for r in _serve(
            InProcessPipeline(engines), Request, SamplingParams,
            seeded=True)]
        summary = engines[0].kernel_dispatch_summary()
        windows[mode] = summary["dispatch_total"].get("torch/multistep", 0)
    assert streams["k8"] == streams["k1_sync"]
    assert windows["k8"] > 0 and windows["k1_sync"] == 0


@pytest.mark.parametrize("name", sorted(RAWS))
def test_two_stages_equal_one(name):
    one = _serve(InProcessPipeline(_port_engines(name, [(0, 3)])), Request,
                 SamplingParams, seeded=True)
    two = _serve(InProcessPipeline(_port_engines(name, [(0, 1), (1, 3)])),
                 Request, SamplingParams, seeded=True)
    assert [r.output_ids for r in two] == [r.output_ids for r in one]
    assert all(r.status.value == "finished_length" for r in two)
