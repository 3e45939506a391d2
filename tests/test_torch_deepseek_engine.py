"""The port's DeepSeek-V3 and DeepSeek-V3.2 engines against parallax_tpu's
on the same weights (float32, CPU).

The weights and tiny configs are ``tests/test_torch_deepseek.py``'s.
Checked: engine greedy streams against the JAX engine under the tie-tolerant rule
of tests/test_engine_e2e.py (every token within 5e-3 of the JAX model's
argmax; where the engines part, they part at a near-tie), with a prefix
cache hit. The port's own routes are held against each other in
``tests/test_torch_deepseek_routes.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from tests.test_torch_deepseek import (
    JCLS,
    N_LAYERS,
    PAGE,
    RAWS,
    _stage,
    _weights,
)

ENGINE = dict(page_size=8, num_pages=96, max_model_len=256,
              max_num_tokens_per_batch=64, prefill_chunk_size=16,
              max_batch_size=3, kv_dtype="float32")
N_NEW = 6
TOL = 5e-3


def _prompts():
    rng = np.random.default_rng(11)
    prefix = [int(x) for x in rng.integers(1, 198, size=16)]   # 2 pages
    rand = [[int(x) for x in rng.integers(1, 198, size=n)] for n in (29, 35)]
    # r0 donates the prefix; r3 waits for a batch slot (3 max) and is
    # admitted after a release, so it must hit the prefix cache.
    return [prefix + [5, 6, 7]] + rand + [prefix + [9, 10]]


def _serve(pipe, req_cls, samp_cls, seeded=False):
    reqs = []
    for i, p in enumerate(_prompts()):
        sp = (samp_cls(temperature=0.8, top_k=5, seed=3 + i,
                       max_new_tokens=N_NEW)
              if seeded and i % 2 else
              samp_cls(temperature=0.0, max_new_tokens=N_NEW))
        reqs.append(req_cls(f"r{i}", prompt_ids=list(p), sampling_params=sp))
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def _reference_logits(name, ctxs):
    """The JAX model's logits at every position of each context in
    ``ctxs``, from one ragged forward over all of them."""
    cfg, full, _ = _weights(name)
    lens = [len(c) for c in ctxs]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    n = int(cu[-1])
    t = 1 << (n - 1).bit_length()
    model = JCLS[name](cfg, 0, N_LAYERS, use_pallas=False)
    pps = max((m + PAGE - 1) // PAGE for m in lens)
    pages = 1 + np.arange(len(ctxs) * pps, dtype=np.int32).reshape(-1, pps)
    kv = model.new_kv_caches(len(ctxs) * pps + 1, PAGE, jnp.float32)
    tok = np.zeros(t, np.int32)
    pos = np.zeros(t, np.int32)
    slots = np.full(t, -1, np.int32)
    for i, c in enumerate(ctxs):
        p = np.arange(len(c))
        tok[cu[i]:cu[i + 1]] = c
        pos[cu[i]:cu[i + 1]] = p
        slots[cu[i]:cu[i + 1]] = pages[i, p // PAGE] * PAGE + p % PAGE
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray(lens, jnp.int32),
        page_indices=jnp.asarray(pages), cu_q_lens=jnp.asarray(cu),
        num_seqs=jnp.asarray([len(ctxs)], jnp.int32),
        slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32),
    )
    logits, _ = model(full, kv, inp)
    logits = np.asarray(logits)
    return [logits[cu[i]:cu[i + 1]] for i in range(len(ctxs))]


def _port_engines(name, bounds, use_kernels=None, **cfg):
    tcfg = normalize_config(RAWS[name])
    tfull = params_from_numpy(_weights(name)[2], "cpu")
    return [StageEngine(create_stage_model(tcfg, s, e,
                                           use_kernels=use_kernels),
                        _stage(tfull, s, e), EngineConfig(**ENGINE, **cfg),
                        device="cpu")
            for s, e in bounds]


@pytest.mark.parametrize("name", ["v3", "v3.2"])
def test_engine_streams_match_jax(name):
    bounds = [(0, 3)]
    cfg, full, _ = _weights(name)
    port = _serve(InProcessPipeline(_port_engines(name, bounds)), Request,
                  SamplingParams)
    jeng = [JStageEngine(JCLS[name](cfg, s, e, use_pallas=False),
                         _stage(full, s, e),
                         JEngineConfig(**ENGINE, decode_lookahead=1,
                                       overlap_steps=False))
            for s, e in bounds]
    ref = _serve(JPipeline(jeng), JRequest, JSampling)
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
