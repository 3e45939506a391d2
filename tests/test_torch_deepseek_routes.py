"""The port's DeepSeek-V3 and DeepSeek-V3.2 engines against each other
(float32, CPU; the weights and tiny configs of
``tests/test_torch_deepseek.py``):
- fused and split streams identical (greedy and seeded), the split path's
  decode batches marked ``decode_only``, the dispatch labels, and each
  decode route reaching its kernel wrapper once per layer and decode step;
- a 2-stage pipeline gives the single stage's streams.
"""

import pytest

from parallax_tpu_torch.ops import decode_fused, dsa_decode, kernel_select
from parallax_tpu_torch.ops import mla_decode
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from tests.test_torch_deepseek import N_LAYERS
from tests.test_torch_deepseek_engine import _port_engines, _serve


def _spy(monkeypatch, module, fn_name, calls):
    real = getattr(module, fn_name)

    def wrapped(*args, **kwargs):
        calls[fn_name] = calls.get(fn_name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, fn_name, wrapped)


@pytest.mark.parametrize("name", ["v3", "v3.2"])
def test_fused_and_split_streams_identical(name, monkeypatch):
    """Within the port: the fused decode route, the split route through the
    split kernels' wrappers and the plain split route give the same
    streams, greedy and seeded. (On the CPU every wrapper runs its plain
    version; the test lets the engine take the fused route on the CPU.)"""
    monkeypatch.setattr(kernel_select, "_check_kernel_device",
                        lambda device, what: None)
    calls: dict[str, int] = {}
    _spy(monkeypatch, decode_fused, "mla_fused_decode", calls)
    _spy(monkeypatch, decode_fused, "indexer_scores_fused", calls)
    _spy(monkeypatch, mla_decode, "mla_decode_attention", calls)
    _spy(monkeypatch, dsa_decode, "paged_token_scores_decode", calls)
    streams, seen = {}, {}
    for route, fused, kernels in (("fused", True, None),
                                  ("split-kernel", False, True),
                                  ("plain", False, None)):
        calls.clear()
        engines = _port_engines(name, [(0, 3)], use_kernels=kernels,
                                decode_fused=fused)
        flags = []
        real_call = type(engines[0].model).__call__

        def spy_call(self, params, kv, inputs, _flags=flags, _real=real_call):
            _flags.append((inputs.kv_lens.shape[0] == inputs.positions.shape[0]
                           and inputs.decode_only, inputs.decode_only,
                           inputs.decode_fused))
            return _real(self, params, kv, inputs)

        monkeypatch.setattr(type(engines[0].model), "__call__", spy_call)
        reqs = _serve(InProcessPipeline(engines), Request, SamplingParams,
                      seeded=True)
        monkeypatch.setattr(type(engines[0].model), "__call__", real_call)
        streams[route] = [r.output_ids for r in reqs]
        seen[route] = (dict(calls), flags,
                       engines[0].kernel_dispatch_summary())
    assert streams["fused"] == streams["split-kernel"] == streams["plain"]
    n_layers = N_LAYERS
    for route, (c, flags, summary) in seen.items():
        # Single steps and the decode windows' forward steps.
        decode_steps = sum(summary["dispatch_total"].get(
            f"{summary['impl']}/{path}", 0) for path in ("decode",
                                                         "multistep"))
        assert decode_steps > 0
        # Every one-token step is marked decode_only, on the split path too.
        assert sum(f[1] for f in flags) == decode_steps
        assert all(f[0] for f in flags if f[1])
        assert all(f[2] == (route == "fused") for f in flags if f[1])
        want = {"fused": ("mla_fused_decode", "indexer_scores_fused"),
                "split-kernel": ("mla_decode_attention",
                                 "paged_token_scores_decode"),
                "plain": ()}[route]
        if name == "v3":
            want = want[:1]
        else:       # V3.2's latent append is a scatter; its indexer fuses
            want = want[1:]
        assert {k: v for k, v in c.items() if v} == {
            k: n_layers * decode_steps for k in want}, route
    assert seen["fused"][2]["impl"] == "cuda-fused"
    assert seen["split-kernel"][2]["impl"] == "cuda-split"
    assert seen["plain"][2]["impl"] == "torch"


@pytest.mark.parametrize("name", ["v3", "v3.2"])
def test_two_stages_equal_one(name):
    one = _serve(InProcessPipeline(_port_engines(name, [(0, 3)])), Request,
                 SamplingParams, seeded=True)
    two = _serve(InProcessPipeline(_port_engines(name, [(0, 1), (1, 3)])),
                 Request, SamplingParams, seeded=True)
    assert [r.output_ids for r in two] == [r.output_ids for r in one]
    assert all(r.status.value == "finished_length" for r in two)
