"""Quantized DeepSeek-V3.2 and MiniMax-M3 in the port against the JAX
package: ``test_torch_quant_models.py``'s stage-logit and engine-stream
checks (one quantized JAX tree carried across; logits within 1e-4, greedy
streams tie-tolerant against the JAX model, K = 8 == K1_SYNC == 2 stages
inside the port) on the model families that reach quantized leaves outside
the dense blocks: DSA's indexer projections and DeepSeek's absorbed
``kv_b_proj``, MSA's index projections."""

import pytest

import _torch_cpu  # noqa: F401
from test_torch_quant_models import check_engine_streams, check_stage_logits

NAMES = ("deepseek-v3.2-int8", "minimax-m3-int4")


@pytest.mark.parametrize("bounds", ["1-stage", "2-stage"])
@pytest.mark.parametrize("name", NAMES)
def test_quantized_stage_logits_match_jax(name, bounds):
    check_stage_logits(name, bounds)


@pytest.mark.parametrize("name", NAMES)
def test_quantized_engine_streams_match_jax(name):
    check_engine_streams(name)
