"""The port's host KV tier against the JAX engine on the same traces
(tests/_torch_host_cache.py has the suite's helpers): equal preemption,
resume and host-hit counts and tie-tolerant greedy streams at K = 1,
synchronous; ``kv_page_signature()`` and the tier's presence equal to
the JAX engine's on every model family."""

import pytest

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.registry import create_stage_model as j_create_stage_model
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.engine import drive_step as j_drive_step
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.request import (
    Request,
    SamplingParams,
)
from tests.test_torch_engine import (
    TINY_QWEN2,
    _assert_tie_tolerant,
    _reference_logits,
    _weights,
)
from tests._torch_host_cache import (
    K1_SYNC,
    PRESSURE,
    SIG_CONFIGS,
    _jax_engine,
    _port_engine,
    _pressure_reqs,
    _serve,
    _two_waves,
)


@pytest.mark.parametrize("trace", ["preempt", "two-waves"])
def test_counts_and_streams_match_jax(trace):
    """K = 1, synchronous, the same trace through both packages: equal
    ``preemptions``, ``resumes`` and ``tokens_hit_host`` (the scheduling
    is deterministic), equal demotion and swap-in page counts, and greedy
    streams under the tie-tolerant rule against the JAX engine's."""
    jcfg, full, _ = _weights(TINY_QWEN2)
    peng = _port_engine(**PRESSURE, **K1_SYNC)
    jeng = _jax_engine(**PRESSURE, **K1_SYNC)
    if trace == "preempt":
        port = _serve(peng, _pressure_reqs())
        ref = _serve(jeng, _pressure_reqs(JRequest, JSampling), j_drive_step)
    else:
        port = _two_waves(peng, Request, SamplingParams, drive_step)
        ref = _two_waves(jeng, JRequest, JSampling, j_drive_step)
    ps, js = peng.cache_stats(), jeng.cache_stats()
    for key in ("preemptions", "resumes", "tokens_hit_host",
                "tokens_hit_device", "kv_oom_aborts", "pages_demoted",
                "pages_swapped_in"):
        assert ps[key] == js[key], (key, ps[key], js[key])
    if trace == "preempt":
        assert ps["preemptions"] >= 2 and ps["resumes"] >= 2
    else:
        assert ps["tokens_hit_host"] > 0 and ps["pages_swapped_in"] > 0
    for pr, jr in zip(port, ref):
        assert pr.status.value == jr.status.value == "finished_length"
        ctx = list(pr.prompt_ids) + pr.output_ids[:-1]
        logits = _reference_logits(jcfg, full, ctx)
        _assert_tie_tolerant(logits, len(pr.prompt_ids), pr.output_ids,
                             pr.request_id)


@pytest.mark.parametrize("name", sorted(SIG_CONFIGS))
def test_kv_page_signature_matches_jax(name):
    raw = SIG_CONFIGS[name]
    cfg = dict(page_size=8, num_pages=16, max_model_len=64,
               kv_dtype="float32", host_cache_bytes=1 << 22)
    jc = j_normalize(raw)
    n = jc.num_hidden_layers
    # The signature reads the KV layout alone: no weights are needed.
    jeng = JStageEngine(j_create_stage_model(jc, 0, n, use_pallas=False),
                        {}, JEngineConfig(**cfg))
    peng = StageEngine(create_stage_model(normalize_config(raw), 0, n), {},
                       EngineConfig(**cfg), device="cpu")
    want = jeng.kv_page_signature()
    assert peng.kv_page_signature() == want
    assert (peng.host_tier is None) == (jeng.host_tier is None)
    if want is not None:
        assert peng.host_tier.pool.page_nbytes == jeng.host_tier.pool.page_nbytes
