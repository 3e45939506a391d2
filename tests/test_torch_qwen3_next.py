"""The port's Qwen3-Next hybrid (GatedDeltaNet + gated attention + MoE)
against parallax_tpu's on the same weights (float32, CPU).

The JAX ``init_params`` tree is carried across with ``params_from_numpy``
(its conv taps, ``A_log`` and ``dt_bias`` made non-uniform, so a wrong slice
or head order shows). Checked:
- stage logits of a ragged prefill (two rows, state slots reset) and a
  decode step, at one stage and at two stages, one of them attention-only:
  within 1e-4;
- engine greedy streams against the JAX engine under the tie-tolerant rule
  of tests/test_engine_e2e.py: chunked prefill across the conv window,
  concurrent rows, a recycled state slot giving the same stream;
- inside the port: the K = 8 window equal to the K = 1 synchronous engine,
  fused == split == plain (on the CPU the three take the plain versions,
  so they must agree bit for bit), the head-dim 256 shape checks;
- the refusals: no host tier, no speculation and no KV image for hybrids,
  and a draft model refused by ``serve``."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.base import BatchInputs as JBatch
from parallax_tpu.models.qwen3_next import Qwen3NextStageModel as JNext
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import (
    Qwen3NextStageModel,
    create_stage_model,
    params_from_numpy,
)
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.request import Request, SamplingParams

TINY = dict(
    architectures=["Qwen3NextForCausalLM"], hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=96, moe_intermediate_size=32,
    num_experts=4, num_experts_per_tok=2, shared_expert_intermediate_size=32,
    decoder_sparse_step=1, mlp_only_layers=[], norm_topk_prob=True,
    layer_types=["linear_attention", "full_attention",
                 "linear_attention", "full_attention"],
    linear_conv_kernel_dim=4, linear_num_key_heads=2,
    linear_num_value_heads=4, linear_key_head_dim=16,
    linear_value_head_dim=16, partial_rotary_factor=0.25, vocab_size=199,
    max_position_embeddings=512, rms_norm_eps=1e-6, rope_theta=10000.0,
    tie_word_embeddings=False, attention_bias=False,
)
PAGE = 8
N_LAYERS = 4
_WEIGHTS: dict = {}


def _weights():
    """(JAX config, JAX params, the same params as numpy)."""
    if not _WEIGHTS:
        cfg = j_normalize(TINY)
        full = JNext(cfg, 0, N_LAYERS, use_pallas=False).init_params(
            jax.random.key(0), dtype=jnp.float32)
        full_np = jax.tree.map(np.asarray, full)
        rng = np.random.default_rng(3)
        for lp in full_np["layers"]:
            lin = lp.get("linear_attn")
            if lin is not None:
                hv = lin["A_log"].shape[0]
                lin["conv1d"]["weight"] = (
                    rng.standard_normal(lin["conv1d"]["weight"].shape) * 0.3
                ).astype(np.float32)
                lin["A_log"] = (rng.standard_normal(hv) * 0.5).astype(
                    np.float32)
                lin["dt_bias"] = (1.0 + rng.standard_normal(hv) * 0.2).astype(
                    np.float32)
        _WEIGHTS["w"] = (cfg, jax.tree.map(jnp.asarray, full_np), full_np)
    return _WEIGHTS["w"]


def _stage(tree, s, e):
    p = {"layers": tree["layers"][s:e]}
    if s == 0:
        p["embed_tokens"] = tree["embed_tokens"]
    if e == N_LAYERS:
        p["norm"] = tree["norm"]
        p["lm_head"] = tree["lm_head"]
    return p


def _batches():
    """A ragged prefill of two sequences (7 and 12 tokens in a 32-token
    bucket, state slots 1 and 2 reset), then one decode token each."""
    rng = np.random.default_rng(0)
    pages = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    tok = rng.integers(1, 190, size=19).astype(np.int32)
    t = 32
    pre = dict(token_ids=np.zeros(t, np.int32),
               positions=np.zeros(t, np.int32),
               slot_mapping=np.full(t, -1, np.int32))
    pre["token_ids"][:19] = tok
    pos = np.concatenate([np.arange(7), np.arange(12)])
    pre["positions"][:19] = pos
    seq = np.array([0] * 7 + [1] * 12)
    pre["slot_mapping"][:19] = pages[seq, pos // PAGE] * PAGE + pos % PAGE
    dm = np.full((2, 16), t, np.int32)
    dm[0, :7] = np.arange(7)
    dm[1, :12] = np.arange(7, 19)
    pre.update(kv_lens=np.array([7, 12], np.int32), page_indices=pages,
               cu_q_lens=np.array([0, 7, 19], np.int32),
               num_seqs=np.array([2], np.int32),
               logits_indices=np.array([6, 18], np.int32),
               state_slots=np.array([1, 2], np.int32), dense_map=dm,
               q_lens=np.array([7, 12], np.int32),
               reset_state=np.array([1, 1], np.int32))
    dec = dict(token_ids=np.array([5, 9], np.int32),
               positions=np.array([7, 12], np.int32),
               kv_lens=np.array([8, 13], np.int32), page_indices=pages,
               cu_q_lens=np.array([0, 1, 2], np.int32),
               num_seqs=np.array([2], np.int32),
               slot_mapping=np.array([1 * PAGE + 7, 5 * PAGE + 4], np.int32),
               logits_indices=np.array([0, 1], np.int32),
               state_slots=np.array([1, 2], np.int32),
               dense_map=np.array([[0], [1]], np.int32),
               q_lens=np.array([1, 1], np.int32),
               reset_state=np.array([0, 0], np.int32))
    return [pre, dec]


_KEYS = ("positions", "kv_lens", "page_indices", "cu_q_lens", "num_seqs",
         "slot_mapping", "logits_indices", "state_slots", "dense_map",
         "q_lens", "reset_state")


def _stage_outputs_jax(cfg, full, bounds):
    models = [JNext(cfg, s, e, use_pallas=False) for s, e in bounds]
    kvs = [m.new_kv_caches(8, PAGE, jnp.float32, num_state_slots=4)
           for m in models]
    outs = []
    for b in _batches():
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = JBatch(
                token_ids=jnp.asarray(b["token_ids"]) if m.is_first else None,
                hidden_states=hidden,
                **{k: jnp.asarray(b[k]) for k in _KEYS})
            hidden, kvs[i] = m(_stage(full, s, e), kvs[i], inp)
        outs.append(np.asarray(hidden))
    return outs


def _stage_outputs_port(cfg, full, bounds):
    models = [create_stage_model(cfg, s, e) for s, e in bounds]
    kvs = [m.new_kv_caches(8, PAGE, torch.float32, "cpu", num_state_slots=4)
           for m in models]
    outs = []
    for b in _batches():
        hidden = None
        for i, (m, (s, e)) in enumerate(zip(models, bounds)):
            inp = BatchInputs(
                token_ids=torch.from_numpy(b["token_ids"]) if m.is_first
                else None,
                hidden_states=hidden,
                **{k: torch.from_numpy(np.asarray(b[k])) for k in _KEYS})
            with torch.no_grad():
                hidden, kvs[i] = m(_stage(full, s, e), kvs[i], inp)
        outs.append(hidden.numpy())
    return outs


@pytest.mark.parametrize("bounds", [[(0, 4)], [(0, 3), (3, 4)]],
                         ids=["1-stage", "2-stage-attention-only-tail"])
def test_stage_logits_match_jax(bounds):
    jcfg, full_j, full_np = _weights()
    tcfg = normalize_config(TINY)
    assert tcfg.layer_types == jcfg.layer_types == (
        "linear_attention", "attention", "linear_attention", "attention")
    ref = _stage_outputs_jax(jcfg, full_j, bounds)
    got = _stage_outputs_port(tcfg, params_from_numpy(full_np, "cpu"),
                              bounds)
    if len(bounds) > 1:
        assert not create_stage_model(tcfg, 3, 4).has_linear_layers
    for r, g in zip(ref, got):
        assert r.shape == g.shape == (2, tcfg.vocab_size)
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)


def test_model_structure_and_checkpoint_hooks():
    tcfg = normalize_config(TINY)
    m = create_stage_model(tcfg, 0, N_LAYERS)
    assert type(m) is Qwen3NextStageModel and m.norm_offset == 1.0
    for alias in ("Qwen3_5ForConditionalGeneration",
                  "Qwen3_5MoeForConditionalGeneration"):
        cfg = normalize_config(dict(TINY, architectures=[alias]))
        assert type(create_stage_model(cfg, 0, 2)) is Qwen3NextStageModel
    caches = m.new_kv_caches(8, PAGE, torch.float32, "cpu",
                             num_state_slots=6)
    conv, rec = caches[0]
    assert conv.shape == (7, m.conv_dim, 3) and conv.dtype == torch.float32
    assert rec.shape == (7, 4, 16, 16)
    assert caches[1].shape == (8, PAGE, 4, 16)
    # init_params matches the JAX tree's keys and shapes.
    _, full_j, _ = _weights()
    got = m.init_params(torch.Generator().manual_seed(0), torch.float32,
                        "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(got) == shapes(jax.tree.map(np.asarray, full_j))
    # finalize_params: torch's conv1d [out, 1, K] -> [out, K].
    w = torch.randn(m.conv_dim, 1, 4)
    tree = {"layers": [{"linear_attn": {"conv1d": {"weight": w}}}]}
    out = m.finalize_params(tree)["layers"][0]["linear_attn"]["conv1d"]
    assert torch.equal(out["weight"], w[:, 0, :])


# -- engine streams ---------------------------------------------------------

ENGINE = dict(page_size=PAGE, num_pages=128, max_model_len=256,
              kv_dtype="float32", max_batch_size=8)
TOL = 5e-3


def _reference_logits(cfg, full, ctx):
    """JAX logits at every position of ``ctx`` (one prefill)."""
    n = len(ctx)
    t = 1 << (n - 1).bit_length()
    model = JNext(cfg, 0, N_LAYERS, use_pallas=False)
    npages = (n + PAGE - 1) // PAGE
    kv = model.new_kv_caches(npages + 1, PAGE, jnp.float32,
                             num_state_slots=1)
    tok = np.zeros(t, np.int32)
    tok[:n] = ctx
    pos = np.zeros(t, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(t, -1, np.int32)
    slots[:n] = np.arange(n) + PAGE
    dm = np.full((1, t), t, np.int32)
    dm[0, :n] = np.arange(n)
    inp = JBatch(
        token_ids=jnp.asarray(tok), hidden_states=None,
        positions=jnp.asarray(pos), kv_lens=jnp.asarray([n], jnp.int32),
        page_indices=jnp.asarray(np.arange(1, npages + 1)[None], jnp.int32),
        cu_q_lens=jnp.asarray([0, n], jnp.int32),
        num_seqs=jnp.asarray([1], jnp.int32), slot_mapping=jnp.asarray(slots),
        logits_indices=jnp.arange(t, dtype=jnp.int32),
        state_slots=jnp.asarray([1], jnp.int32), dense_map=jnp.asarray(dm),
        q_lens=jnp.asarray([n], jnp.int32),
        reset_state=jnp.asarray([1], jnp.int32))
    logits, _ = model(full, kv, inp)
    return np.asarray(logits)[:n]


def _check_greedy(cfg, full, req):
    """Every token of ``req`` within TOL of the reference argmax."""
    logits = _reference_logits(cfg, full, req.prompt_ids
                               + req.output_ids[:-1])
    p0 = len(req.prompt_ids) - 1
    for i, tok in enumerate(req.output_ids):
        row = logits[p0 + i]
        gap = float(row.max() - row[tok])
        assert gap < TOL, (req.request_id, i, tok, int(row.argmax()), gap)


def _serve(pipe, req_cls, samp_cls, prompts, n_new=6, prefix="r"):
    reqs = [req_cls(f"{prefix}{i}", prompt_ids=list(p),
                    sampling_params=samp_cls(temperature=0.0,
                                             max_new_tokens=n_new))
            for i, p in enumerate(prompts)]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return reqs


def _port_engines(bounds=((0, 4),), **kw):
    tcfg = normalize_config(TINY)
    _, _, full_np = _weights()
    tfull = params_from_numpy(full_np, "cpu")
    return [StageEngine(create_stage_model(tcfg, s, e), _stage(tfull, s, e),
                        EngineConfig(**dict(ENGINE, **kw)), device="cpu")
            for s, e in bounds]


PROMPTS = [[5, 6, 7], [100, 101, 102, 103], [42] * 6,
           [int(x) for x in np.random.default_rng(7).integers(0, 198, 30)]]


@pytest.mark.parametrize("chunk,bounds", [
    (1024, [(0, 4)]), (8, [(0, 4)]), (8, [(0, 2), (2, 4)])],
    ids=["one-chunk", "chunked", "chunked-2-stage"])
def test_engine_streams_match_jax(chunk, bounds):
    """Concurrent rows (per-request slots, no cross-talk) and chunked
    prefill whose chunk boundaries cross the conv window."""
    cfg, full, _ = _weights()
    port = _serve(InProcessPipeline(_port_engines(
        bounds, prefill_chunk_size=chunk)), Request, SamplingParams, PROMPTS)
    jeng = [JStageEngine(JNext(cfg, s, e, use_pallas=False),
                         _stage(full, s, e),
                         JEngineConfig(**ENGINE, prefill_chunk_size=chunk))
            for s, e in bounds]
    ref = _serve(JPipeline(jeng), JRequest, JSampling, PROMPTS)
    for pr, jr in zip(port, ref):
        assert pr.status.value == "finished_length"
        _check_greedy(cfg, full, pr)
        if pr.output_ids != jr.output_ids:
            _check_greedy(cfg, full, jr)


def test_slot_reuse_is_deterministic():
    """A recycled state slot starts from zero state: the same prompt twice
    on one engine gives the same stream (and the JAX engine's)."""
    pipe = InProcessPipeline(_port_engines(enable_prefix_cache=False))
    outs = [_serve(pipe, Request, SamplingParams, [[5, 6, 7, 8]],
                   prefix=f"d{i}")[0].output_ids for i in range(2)]
    assert outs[0] == outs[1]
    cfg, full, _ = _weights()
    jpipe = JPipeline([JStageEngine(JNext(cfg, 0, 4, use_pallas=False), full,
                                    JEngineConfig(**ENGINE))])
    assert _serve(jpipe, JRequest, JSampling,
                  [[5, 6, 7, 8]])[0].output_ids == outs[0]


def _sampled_prompts():
    return [(p, SamplingParams(temperature=0.0 if i % 2 else 0.9, seed=i,
                               max_new_tokens=11))
            for i, p in enumerate(PROMPTS)]


def _drive(engines):
    pipe = InProcessPipeline(engines)
    reqs = [Request(f"s{i}", prompt_ids=list(p), sampling_params=sp)
            for i, (p, sp) in enumerate(_sampled_prompts())]
    for r in reqs:
        pipe.submit(r)
    pipe.run_until_complete()
    return [r.output_ids for r in reqs]


def test_window_equals_k1_sync_and_routes_agree():
    """K = 8 windows (overlap on, the defaults) give the K = 1 synchronous
    engine's streams, greedy and seeded, and the fused / split / plain
    routes agree."""
    k1 = _drive(_port_engines(decode_lookahead=1, overlap_steps=False))
    eng = _port_engines()
    assert _drive(eng) == k1
    assert any(k.endswith("/multistep") for k in
               eng[0].kernel_dispatch_summary()["dispatch_total"])
    assert _drive(_port_engines(decode_fused=False,
                                prefill_fused=False)) == k1
    plain = _port_engines(decode_fused=False, prefill_fused=False)
    plain[0].model.use_kernels = False
    assert _drive(plain) == k1


def test_head_dim_256_shape_checks():
    """The GQA kernels' wrappers take head dim 256 (Qwen3-Next's full
    attention) and refuse 96; the f32 tile shape shrinks to fit the
    block's shared memory."""
    from parallax_tpu_torch.ops.decode_fused import (
        SMEM_LIMIT,
        check_attention_shapes,
        smem_bytes,
        tile_rows,
    )
    from parallax_tpu_torch.ops.prefill_fused import q_tile_for

    q = torch.zeros((3, 16, 256), dtype=torch.bfloat16)
    cache = torch.zeros((4, 16, 4, 256), dtype=torch.bfloat16)
    assert check_attention_shapes("t", q, cache, None) == (16, 2, 256)
    with pytest.raises(ValueError, match="head_dim 96"):
        check_attention_shapes(
            "t", torch.zeros((3, 16, 96)), torch.zeros((4, 16, 4, 96)), None)
    assert tile_rows(256, 2) == 128 and tile_rows(256, 4) == 64
    assert q_tile_for(8, tile_rows(256, 4)) == 8
    for elem in (2, 4):
        for rows in (16, 32, tile_rows(256, elem)):
            assert smem_bytes(rows, 256, elem) + 16 <= SMEM_LIMIT
        for rows, wk in ((16, 4), (32, 2)):
            assert wk * rows * (256 + 2) * 4 <= smem_bytes(rows, 256, elem)
    assert smem_bytes(128, 256, 2) == 202752
    assert smem_bytes(64, 256, 4) == 199680


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.text = ""

    def emit(self, record):
        self.text += record.getMessage() + "\n"


def test_hybrid_refusals():
    """No host tier (warned), no speculation and no KV image for a hybrid
    stage; its stream equals the engine's without them."""
    base = _drive(_port_engines())
    log = logging.getLogger("parallax_tpu_torch.runtime.engine")
    rec = _Records()
    log.addHandler(rec)
    try:
        eng = _port_engines(host_cache_bytes=1 << 22, speculative_tokens=3)
    finally:
        log.removeHandler(rec)
    err = rec.text
    assert "host KV tier disabled" in err
    assert "speculative decoding disabled" in err
    e = eng[0]
    assert e.host_tier is None and e.cfg.speculative_tokens == 0
    assert e.spec_summary() is None
    assert e.kv_page_signature() is None
    assert _drive(eng) == base
    # An attention-only stage of a hybrid keeps its page signature.
    tail = _port_engines(bounds=((0, 3), (3, 4)))[1]
    assert not tail._needs_state and tail.kv_page_signature() is not None


def test_serve_refuses_a_draft_for_a_hybrid(tmp_path):
    """``serve --draft-model-path`` refuses a hybrid main model (it never
    speculates), as the JAX package's serve does, before any engine is
    built; ``--linear-prefix-slots`` is parsed."""
    from parallax_tpu_torch import cli
    from parallax_tpu_torch.backend import serve as serve_mod
    from tests.test_torch_loader import _hf_tensors, _write

    full_np = _weights()[2]
    tree = jax.tree.map(lambda a: np.array(a), full_np)
    for layer in tree["layers"]:
        lin = layer.get("linear_attn")
        if lin is not None:
            lin["conv1d"]["weight"] = lin["conv1d"]["weight"][:, None, :]
    _write(tmp_path, _hf_tensors(tree), TINY, "f32")
    argv = ["serve", "--model-path", str(tmp_path), "--device", "cpu",
            "--port", "0", "--linear-prefix-slots", "5"]
    args = cli.build_parser().parse_args(
        argv + ["--draft-model-path", str(tmp_path)])
    with pytest.raises(ValueError, match="hybrid linear-attention"):
        serve_mod.serve_main(args)
    assert cli.build_parser().parse_args(argv).linear_prefix_slots == 5
