"""The port's StageEngine / InProcessPipeline (device="cpu") against the JAX
StageEngine (use_pallas=False, decode_lookahead=1, overlap_steps=False) on
the same weights: prefix cache on, chunked prefill, six concurrent greedy
requests of which two share a 3-page prefix, one stage and three stages.

Greedy streams pass the tie-tolerant rule of tests/test_engine_e2e.py
(tol 5e-3): every port token is within tol of the reference argmax at its
position, the reference being the JAX StageModel's logits over the whole
stream in one forward; where the two engines' streams part, they part at a
near-tie. Also: the sharer hits the prefix cache, the dispatch summary shows
the plain ``torch`` impl, unported features raise, and the sampling
features serve with the JAX engine's streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    StageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams

TINY_QWEN2 = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=4,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=199, max_position_embeddings=512, rms_norm_eps=1e-6,
    rope_theta=10000.0, tie_word_embeddings=False, attention_bias=True,
    torch_dtype="float32",
)
# Non-power-of-two group (Hq = 6, Hkv = 2), qk-norm, tied embeddings.
TINY_QWEN3_G3 = dict(
    architectures=["Qwen3ForCausalLM"], hidden_size=48, num_hidden_layers=4,
    num_attention_heads=6, num_key_value_heads=2, head_dim=16,
    intermediate_size=96, vocab_size=199, max_position_embeddings=512,
    tie_word_embeddings=True, rope_theta=1e6, torch_dtype="float32",
)
ENGINE = dict(page_size=8, num_pages=128, max_model_len=256,
              max_num_tokens_per_batch=64, prefill_chunk_size=16,
              max_batch_size=5, kv_dtype="float32")
N_NEW = 8
TOL = 5e-3


def _prompts():
    rng = np.random.default_rng(7)
    prefix = [int(x) for x in rng.integers(1, 198, size=24)]   # 3 pages
    rand = [[int(x) for x in rng.integers(1, 198, size=n)]
            for n in (37, 30, 45, 41)]
    # r0 donates the shared prefix; r5 waits for a batch slot (5 max) and
    # is admitted after r0 finished, so it must hit the prefix cache.
    return [prefix + [5, 6, 7]] + rand + [prefix + [9, 10, 11, 12]]


_WEIGHTS: dict = {}


def _weights(raw):
    """(JAX config, JAX params, the same params as numpy) for ``raw``."""
    key = raw["architectures"][0]
    if key not in _WEIGHTS:
        cfg = j_normalize(raw)
        full = JStageModel(cfg, 0, 4, use_pallas=False).init_params(
            jax.random.key(0), dtype=jnp.float32
        )
        _WEIGHTS[key] = (cfg, full, jax.tree.map(np.asarray, full))
    return _WEIGHTS[key]


@pytest.fixture(scope="module")
def weights():
    return _weights(TINY_QWEN2)


def _stage(tree, s, e):
    p = {"layers": tree["layers"][s:e]}
    if s == 0 or (e == 4 and "lm_head" not in tree):
        p["embed_tokens"] = tree["embed_tokens"]
    if e == 4:
        p["norm"] = tree["norm"]
        if "lm_head" in tree:
            p["lm_head"] = tree["lm_head"]
    return p


def _run_port(raw, full_np, bounds):
    cfg = normalize_config(raw)
    full = params_from_numpy(full_np, "cpu")
    engines = [
        StageEngine(create_stage_model(cfg, s, e), _stage(full, s, e),
                    EngineConfig(**ENGINE), device="cpu")
        for s, e in bounds
    ]
    pipe = InProcessPipeline(engines)
    reqs = [Request(f"r{i}", prompt_ids=list(p),
                    sampling_params=SamplingParams(temperature=0.0,
                                                   max_new_tokens=N_NEW))
            for i, p in enumerate(_prompts())]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs, engines


def _run_jax(cfg, full, bounds):
    engines = [
        JStageEngine(JStageModel(cfg, s, e, use_pallas=False),
                     _stage(full, s, e),
                     JEngineConfig(**ENGINE, decode_lookahead=1,
                                   overlap_steps=False))
        for s, e in bounds
    ]
    pipe = JPipeline(engines)
    reqs = [JRequest(f"r{i}", prompt_ids=list(p),
                     sampling_params=JSampling(temperature=0.0,
                                               max_new_tokens=N_NEW))
            for i, p in enumerate(_prompts())]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def _reference_logits(cfg, full, ctx: list[int]) -> np.ndarray:
    """JAX StageModel logits at every position of ``ctx`` (one forward)."""
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = JStageModel(cfg, 0, 4, use_pallas=False)
    page = 8
    npages = (n + page - 1) // page
    kv = model.new_kv_caches(npages + 1, page, jnp.float32)
    tok = np.zeros(t, np.int32)
    tok[:n] = ctx
    pos = np.zeros(t, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(t, -1, np.int32)
    slots[:n] = np.arange(n) + page            # pages 1..npages
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray([n], jnp.int32),
        page_indices=jnp.asarray(np.arange(1, npages + 1)[None], jnp.int32),
        cu_q_lens=jnp.asarray([0, n], jnp.int32),
        num_seqs=jnp.asarray([1], jnp.int32), slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32),
    )
    logits, _ = model(full, kv, inp)
    return np.asarray(logits)[:n]


def _assert_tie_tolerant(logits, prompt_len, tokens, label):
    for i, tok in enumerate(tokens):
        row = logits[prompt_len - 1 + i]
        best = int(np.argmax(row))
        gap = float(row[best] - row[tok])
        assert tok == best or gap < TOL, (
            f"{label} step {i}: got {tok}, reference argmax {best}, gap {gap}"
        )


@pytest.mark.parametrize("raw,bounds", [
    (TINY_QWEN2, [(0, 4)]),
    (TINY_QWEN2, [(0, 1), (1, 3), (3, 4)]),
    (TINY_QWEN3_G3, [(0, 4)]),
], ids=["qwen2-1-stage", "qwen2-3-stage", "qwen3-g3-1-stage"])
def test_engine_streams_match_jax(raw, bounds):
    cfg, full, full_np = _weights(raw)
    port_reqs, engines = _run_port(raw, full_np, bounds)
    jax_reqs = _run_jax(cfg, full, bounds)
    for pr, jr in zip(port_reqs, jax_reqs):
        assert pr.status.value == "finished_length"
        assert len(pr.output_ids) == N_NEW
        ctx = pr.prompt_ids + pr.output_ids[:-1]
        logits = _reference_logits(cfg, full, ctx)
        _assert_tie_tolerant(logits, len(pr.prompt_ids), pr.output_ids,
                             pr.request_id)
        # Where the two engines part, they part at a near-tie.
        same = 0
        while same < N_NEW and pr.output_ids[same] == jr.output_ids[same]:
            same += 1
        if same < N_NEW:
            row = logits[len(pr.prompt_ids) - 1 + same]
            gap = abs(float(row[pr.output_ids[same]] - row[jr.output_ids[same]]))
            assert gap < TOL, (pr.request_id, same, gap)
    sharer = port_reqs[-1]
    assert sharer.num_cached_tokens > 0
    stats = engines[0].cache_stats()
    assert stats["tokens_hit_device"] >= sharer.num_cached_tokens
    assert stats["kv_oom_aborts"] == 0
    assert jax_reqs[-1].num_cached_tokens == sharer.num_cached_tokens
    for eng in engines:
        summary = eng.kernel_dispatch_summary()
        assert summary["impl"] == summary["prefill_impl"] == "torch"
        assert summary["decode_fused"] is False
        assert all(k.startswith("torch/") for k in summary["dispatch_total"])
        assert summary["dispatch_total"]


@pytest.mark.parametrize("field,value", [
    ("decode_lookahead", None), ("decode_lookahead", 8),
    ("overlap_steps", True), ("speculative_tokens", 2),
    ("sp_threshold", 64), ("qos", "on"),
])
def test_engine_config_refuses_unported(weights, field, value):
    """Unported fields raise. The overlapped step, the K-step window and
    speculation are ported: their values construct and serve (a window
    ran, and the stream equals the K=1 synchronous engine's)."""
    _, _, full_np = weights
    cfg = normalize_config(TINY_QWEN2)
    kw = dict(ENGINE, **{field: value})

    def engine(**over):
        return StageEngine(create_stage_model(cfg, 0, 4),
                           params_from_numpy(full_np, "cpu"),
                           EngineConfig(**dict(kw, **over)), device="cpu")

    if field == "qos":
        # QoS is ported: the spec builds the local scheduler's policy.
        eng = engine()
        assert eng.scheduler.qos is not None
        assert engine(qos=None).scheduler.qos is None
        return
    if field not in ("decode_lookahead", "overlap_steps",
                     "speculative_tokens"):
        with pytest.raises(NotImplementedError, match=field):
            engine()
        return
    streams, engines = [], (engine(),
                            engine(decode_lookahead=1, overlap_steps=False))
    for eng in engines:
        req = Request("x", prompt_ids=_prompts()[1],
                      sampling_params=SamplingParams(temperature=0.0,
                                                     max_new_tokens=N_NEW))
        pipe = InProcessPipeline([eng])
        pipe.submit(req)
        pipe.run_until_complete()
        assert req.status.value == "finished_length"
        streams.append(req.output_ids)
    assert streams[0] == streams[1]
    totals = engines[0].kernel_dispatch_summary()["dispatch_total"]
    assert totals.get("torch/multistep", 0) + totals.get("torch/spec", 0) > 0


def test_engine_config_host_cache_bytes_builds_the_tier(weights):
    """``host_cache_bytes`` is ported: the engine builds its host KV tier
    at the budget's page capacity (the JAX engine's page bytes), serves
    the stream it serves without one, and reports the tier's counters."""
    cfg_j, full, full_np = weights
    budget = 1 << 20
    eng = StageEngine(create_stage_model(normalize_config(TINY_QWEN2), 0, 4),
                      params_from_numpy(full_np, "cpu"),
                      EngineConfig(**ENGINE, host_cache_bytes=budget),
                      device="cpu")
    jeng = JStageEngine(JStageModel(cfg_j, 0, 4, use_pallas=False), full,
                        JEngineConfig(**ENGINE, host_cache_bytes=budget))
    assert eng.host_tier is not None
    assert eng.host_tier.pool.page_nbytes == jeng.host_tier.pool.page_nbytes
    assert eng.host_tier.capacity_pages == jeng.host_tier.capacity_pages
    assert eng.cache.host_tier is eng.host_tier
    req = Request("x", prompt_ids=_prompts()[1],
                  sampling_params=SamplingParams(temperature=0.0,
                                                 max_new_tokens=N_NEW))
    pipe = InProcessPipeline([eng])
    pipe.submit(req)
    pipe.run_until_complete()
    assert req.status.value == "finished_length"
    stats = eng.cache_stats()
    assert stats["host_capacity_pages"] == eng.host_tier.capacity_pages
    assert stats["preemptions"] == stats["kv_oom_aborts"] == 0
    off = _run_port(TINY_QWEN2, full_np, [(0, 4)])[0][1]
    assert req.output_ids == off.output_ids


def test_submit_refuses_lora(weights):
    """A LoRA adapter is still refused at ``submit``, with its item."""
    _, _, full_np = weights
    cfg = normalize_config(TINY_QWEN2)
    eng = StageEngine(create_stage_model(cfg, 0, 4),
                      params_from_numpy(full_np, "cpu"),
                      EngineConfig(**ENGINE), device="cpu")
    req = Request("x", prompt_ids=[1, 2, 3], lora_id="adapter")
    with pytest.raises(NotImplementedError, match="LoRA.*item 11"):
        eng.submit(req)
    assert not eng.has_work()


# The byte vocabulary over TINY_QWEN2's 199 ids, EOS last.
_GRAMMAR_VOCAB = [bytes([i]) for i in range(197)] + [b"", b""]


@pytest.mark.parametrize("sp", [
    dict(presence_penalty=0.5),
    dict(repetition_penalty=1.2),
    dict(logit_bias={3: 1.0}),
    dict(logprobs=True),
    dict(json_schema="{}"),
], ids=["presence", "repetition", "logit_bias", "logprobs", "json_schema"])
def test_submit_accepts_sampling_features(weights, sp):
    """The sampling features the engine once refused serve, K = 8 windows
    by default, with the JAX engine's greedy stream (and logprobs) on the
    same weights."""
    cfg, full, full_np = weights
    eng = StageEngine(create_stage_model(normalize_config(TINY_QWEN2), 0, 4),
                      params_from_numpy(full_np, "cpu"),
                      EngineConfig(**ENGINE), device="cpu")
    jeng = JStageEngine(JStageModel(cfg, 0, 4, use_pallas=False), full,
                        JEngineConfig(**ENGINE))
    for e in (eng, jeng):
        e.set_grammar_vocab(_GRAMMAR_VOCAB, 198)
    req = Request("x", prompt_ids=_prompts()[1], eos_token_ids=(198,),
                  sampling_params=SamplingParams(
                      temperature=0.0, max_new_tokens=N_NEW, **sp))
    jreq = JRequest("x", prompt_ids=_prompts()[1], eos_token_ids=(198,),
                    sampling_params=JSampling(
                        temperature=0.0, max_new_tokens=N_NEW, **sp))
    pipe = InProcessPipeline([eng])
    pipe.submit(req)
    pipe.run_until_complete()
    jpipe = JPipeline([jeng])
    jpipe.submit(jreq)
    jpipe.run_until_complete()
    assert req.status.value == jreq.status.value
    assert req.output_ids == jreq.output_ids
    if sp.get("logprobs"):
        assert len(req.output_logprobs) == len(req.output_ids)
        np.testing.assert_allclose(req.output_logprobs,
                                   jreq.output_logprobs, atol=1e-4)
    else:
        assert req.output_logprobs == []
    if "json_schema" in sp:
        assert eng.constrained_summary()["mask_steps"] > 0
    assert eng.kernel_dispatch_summary()["dispatch_total"][
        "torch/multistep"] > 0


def test_unported_model_families_refused(weights):
    """The engine refuses a config its model's class does not run even when
    the model was built without the registry's check: MiniMax-M3 is ported
    (its own class runs MSA), but a base block holding an M3 config would
    serve dense attention in its place."""
    _, _, full_np = weights
    msa = normalize_config(dict(TINY_QWEN2,
                                architectures=["MiniMaxM3ForCausalLM"],
                                index_n_heads=2, index_head_dim=16))
    assert msa.msa is not None
    with pytest.raises(NotImplementedError, match="MSA"):
        StageEngine(StageModel(msa, 0, 4), params_from_numpy(full_np, "cpu"),
                    EngineConfig(**ENGINE), device="cpu")
