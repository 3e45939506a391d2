"""Linear-state prefix reuse for the port's hybrid models, on its Python
and native cache managers, against parallax_tpu's.

The cases of tests/test_linear_prefix_cache.py (radix slot semantics,
cache-manager matching, end-to-end reuse) run on the port: the radix
cases on the Python radix and, where its interface reaches, the native
one; the manager and engine cases on both managers. Streams equal the
port's run with the prefix cache off and the JAX engine's, and the two
managers give the same matches (``num_cached_tokens``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models.registry import create_stage_model as j_create
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.pipeline import InProcessPipeline as JPipeline
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch import native
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.runtime.cache_manager import (
    CacheManager,
    make_cache_manager,
)
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.pipeline import InProcessPipeline
from parallax_tpu_torch.runtime.radix_cache import RadixPageCache
from parallax_tpu_torch.runtime.request import (
    Request,
    RequestStatus,
    SamplingParams,
)

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
MANAGERS = ["python", "native"]


def _radix(kind, **kw):
    if kind == "native":
        return native.NativeRadixPageCache(2, **kw)
    return RadixPageCache(page_size=2, **kw)


def _manager(kind, **kw):
    if kind == "native":
        return native.NativeCacheManager(2, 16, linear_state=True, **kw)
    return CacheManager(page_size=2, num_pages=16, linear_state=True, **kw)


# -- radix-level slot semantics ---------------------------------------------


def test_radix_attach_and_match_truncation():
    cache = RadixPageCache(page_size=2)
    cache.insert([1, 2, 3, 4, 5, 6], [10, 11, 12])
    pages, path = cache.match_prefix([1, 2, 3, 4, 5, 6, 7])
    assert pages == [10, 11, 12]
    assert cache.deepest_linear_slot(path, 3) == 0
    assert cache.attach_linear_slot([1, 2, 3, 4], slot=77)
    assert cache.deepest_linear_slot(path, 3) == 2
    assert path[1].linear_slot == 77
    assert cache.deepest_linear_slot(path, 1) == 0


@pytest.mark.parametrize("kind", MANAGERS)
def test_radix_attach_rejects_missing_or_taken_node(kind):
    cache = _radix(kind)
    cache.insert([1, 2, 3, 4], [10, 11])
    assert not cache.attach_linear_slot([9, 9], slot=5)
    assert not cache.attach_linear_slot([1, 2, 3], slot=5)
    assert cache.attach_linear_slot([1, 2], slot=5)
    assert not cache.attach_linear_slot([1, 2], slot=6)


@pytest.mark.parametrize("kind", MANAGERS)
def test_radix_eviction_frees_attached_slot(kind):
    freed = []
    cache = _radix(kind, on_evict_slot=freed.append)
    cache.insert([1, 2, 3, 4], [10, 11])
    cache.attach_linear_slot([1, 2, 3, 4], slot=9)
    cache.evict(1)
    assert freed == [9]
    cache.reset()
    assert freed == [9]
    cache.insert([5, 6], [20])
    cache.attach_linear_slot([5, 6], slot=4)
    cache.reset()
    assert freed == [9, 4]


@pytest.mark.parametrize("kind", MANAGERS)
def test_radix_detach_lru_skips_pinned(kind):
    cache = _radix(kind)
    cache.insert([1, 2], [10])
    cache.insert([3, 4], [11])
    cache.attach_linear_slot([1, 2], slot=7)
    cache.attach_linear_slot([3, 4], slot=8)
    _, path = cache.match_prefix([1, 2])
    cache.lock(path)
    assert cache.detach_lru_linear_slot() == 8
    assert cache.detach_lru_linear_slot() is None
    cache.unlock(path)
    assert cache.detach_lru_linear_slot() == 7


# -- cache-manager-level matching -------------------------------------------


def _donate(cm, rid, prompt, computed, snapshots=None, abort=False):
    r = Request(rid, prompt_ids=list(prompt),
                sampling_params=SamplingParams(max_new_tokens=1))
    assert cm.allocate_for_prompt(r)
    r.num_computed_tokens = computed
    if snapshots is not None:
        r.state_snapshots = snapshots
    if abort:
        r.abort("test")
    else:
        r.status = RequestStatus.FINISHED_LENGTH
    cm.release(r)


@pytest.mark.parametrize("kind", MANAGERS)
def test_hybrid_match_requires_snapshot_and_restores_slot(kind):
    cm = _manager(kind)
    _donate(cm, "d", [1, 2, 3, 4, 5], 5, {"prefill": (4, 99)})
    hit = Request("h", prompt_ids=[1, 2, 3, 4, 5, 6],
                  sampling_params=SamplingParams(max_new_tokens=1))
    assert cm.allocate_for_prompt(hit)
    assert hit.num_cached_tokens == 4
    assert hit.restore_state_from == 99

    cm2 = _manager(kind)
    _donate(cm2, "d2", [1, 2, 3, 4, 5], 5)
    h2 = Request("h2", prompt_ids=[1, 2, 3, 4, 5, 6],
                 sampling_params=SamplingParams(max_new_tokens=1))
    assert cm2.allocate_for_prompt(h2)
    assert h2.num_cached_tokens == 0
    assert not hasattr(h2, "restore_state_from")


@pytest.mark.parametrize("kind", MANAGERS)
def test_unattachable_snapshot_slot_returns_to_pool(kind):
    freed = []
    cm = _manager(kind, on_slot_free=freed.append)
    _donate(cm, "a", [1, 2, 3], 3, {"prefill": (2, 42)}, abort=True)
    assert freed == [42]


def test_factory_passes_linear_state_to_both_managers():
    for use_native, cls in ((True, native.NativeCacheManager),
                            (False, CacheManager)):
        cm = make_cache_manager(PAGE, 32, use_native=use_native,
                                linear_state=True, on_slot_free=print)
        assert type(cm) is cls and cm.linear_state
        assert cm.on_slot_free is print


# -- end-to-end: identical tokens with and without reuse ---------------------

_WEIGHTS: dict = {}


def _weights():
    if not _WEIGHTS:
        cfg = j_normalize(TINY)
        full = j_create(cfg, 0, 4, use_pallas=False).init_params(
            jax.random.key(0), dtype=jnp.float32)
        _WEIGHTS["w"] = (cfg, full, jax.tree.map(np.asarray, full))
    return _WEIGHTS["w"]


def _stage(tree, s, e):
    p = {"layers": tree["layers"][s:e]}
    if s == 0:
        p["embed_tokens"] = tree["embed_tokens"]
    if e == 4:
        p["norm"] = tree["norm"]
        p["lm_head"] = tree["lm_head"]
    return p


def _cfg(prefix, kw):
    kw = dict(kw)
    kw.setdefault("linear_decode_snapshot_stride", 1)
    return dict(page_size=PAGE, num_pages=64, max_model_len=256,
                kv_dtype="float32", enable_prefix_cache=prefix,
                prefill_chunk_size=16, **kw)


def _engine(prefix, kind="native", stages=((0, 4),), **kw):
    tcfg = normalize_config(TINY)
    tfull = params_from_numpy(_weights()[2], "cpu")
    return [StageEngine(create_stage_model(tcfg, s, e), _stage(tfull, s, e),
                        EngineConfig(**_cfg(prefix, kw)), device="cpu",
                        use_native=kind == "native")
            for s, e in stages]


def _jax_engine(prefix, stages=((0, 4),), **kw):
    cfg, full, _ = _weights()
    return [JStageEngine(j_create(cfg, s, e, use_pallas=False),
                         _stage(full, s, e), JEngineConfig(**_cfg(prefix, kw)))
            for s, e in stages]


def _run(engines, rid, ids, n=6):
    jax_side = isinstance(engines[0], JStageEngine)
    req_cls, samp = (JRequest, JSampling) if jax_side else (Request,
                                                            SamplingParams)
    r = req_cls(rid, prompt_ids=list(ids),
                sampling_params=samp(temperature=0.0, max_new_tokens=n))
    p = (JPipeline if jax_side else InProcessPipeline)(engines)
    p.submit(r)
    p.run_until_complete()
    return r


BASE = list(range(1, 42))           # 41 tokens; aligned floor = 40
SUFFIX = [50, 51, 52, 53, 54, 55, 56]


@pytest.mark.parametrize("kind", MANAGERS)
def test_hybrid_prefix_reuse_exact_match_single_stage(kind):
    oracle = _engine(prefix=False)
    o1 = _run(oracle, "o1", BASE)
    o2 = _run(oracle, "o2", BASE + SUFFIX)
    eng = _engine(prefix=True, kind=kind)
    r1 = _run(eng, "r1", BASE)
    assert r1.output_ids == o1.output_ids
    assert eng[0].cache.prefix_cache.num_cached_pages > 0
    r2 = _run(eng, "r2", BASE + SUFFIX)
    assert r2.num_cached_tokens == 40
    assert r2.output_ids == o2.output_ids
    jeng = _jax_engine(prefix=True)
    _run(jeng, "j1", BASE)
    j2 = _run(jeng, "j2", BASE + SUFFIX)
    assert j2.num_cached_tokens == 40
    assert j2.output_ids == r2.output_ids


@pytest.mark.parametrize("kind", MANAGERS)
def test_hybrid_prefix_reuse_divergent_prompt_is_safe(kind):
    eng = _engine(prefix=True, kind=kind)
    oracle = _engine(prefix=False)
    _run(eng, "r1", BASE)
    divergent = BASE[:20] + [90, 91, 92] + BASE[23:] + SUFFIX
    r = _run(eng, "r2", divergent)
    o = _run(oracle, "o", divergent)
    assert r.num_cached_tokens <= 16
    assert r.output_ids == o.output_ids


@pytest.mark.parametrize("kind", MANAGERS)
def test_hybrid_prefix_reuse_two_stage_pipeline(kind):
    stages = ((0, 2), (2, 4))
    oracle = _engine(prefix=False, stages=stages)
    o2 = _run(oracle, "o2", BASE + SUFFIX)
    eng = _engine(prefix=True, kind=kind, stages=stages)
    _run(eng, "r1", BASE)
    r2 = _run(eng, "r2", BASE + SUFFIX)
    assert r2.num_cached_tokens == 40
    assert r2.output_ids == o2.output_ids
    for e in eng:
        assert e.cache.prefix_cache.num_cached_pages > 0


@pytest.mark.parametrize("kind", MANAGERS)
def test_hybrid_snapshot_slot_exhaustion_recycles_lru(kind):
    oracle = _engine(prefix=False)
    eng = _engine(prefix=True, kind=kind, linear_prefix_slots=1)
    conv_a = list(range(1, 42))
    conv_b = list(range(100, 141))
    _run(eng, "a1", conv_a)
    _run(eng, "b1", conv_b)
    rb = _run(eng, "b2", conv_b + SUFFIX)
    ob = _run(oracle, "ob", conv_b + SUFFIX)
    assert rb.num_cached_tokens == 40
    assert rb.output_ids == ob.output_ids
    ra = _run(eng, "a2", conv_a + SUFFIX)
    oa = _run(oracle, "oa", conv_a + SUFFIX)
    assert ra.num_cached_tokens == 0
    assert ra.output_ids == oa.output_ids


@pytest.mark.parametrize("kind", MANAGERS)
def test_hybrid_chained_turns_compound_reuse(kind):
    oracle = _engine(prefix=False)
    eng = _engine(prefix=True, kind=kind)
    t1 = BASE
    t2 = BASE + SUFFIX + [60, 61, 62]
    t3 = t2 + [70, 71, 72, 73, 74]
    _run(eng, "r1", t1)
    r2 = _run(eng, "r2", t2)
    assert r2.num_cached_tokens == 40
    r3 = _run(eng, "r3", t3)
    assert r3.num_cached_tokens == 48
    o3 = _run(oracle, "o3", t3)
    assert r3.output_ids == o3.output_ids


@pytest.mark.parametrize("kind", MANAGERS)
def test_hybrid_prefix_reuse_page_aligned_prompt(kind):
    aligned = list(range(1, 49))
    oracle = _engine(prefix=False)
    o2 = _run(oracle, "o2", aligned + SUFFIX)
    eng = _engine(prefix=True, kind=kind)
    _run(eng, "r1", aligned)
    r2 = _run(eng, "r2", aligned + SUFFIX)
    assert r2.num_cached_tokens == 48
    assert r2.output_ids == o2.output_ids
    r3 = _run(eng, "r3", aligned)
    o3 = _run(oracle, "o3", aligned)
    assert r3.num_cached_tokens == 40
    assert r3.output_ids == o3.output_ids


@pytest.mark.parametrize("kind", MANAGERS)
@pytest.mark.parametrize("k", [1, None], ids=["k1", "window"])
def test_hybrid_decode_snapshots_extend_reuse_past_prompt(kind, k):
    """A follow-up whose prompt is the whole previous conversation resumes
    at the deepest decode snapshot. At K = 1 a decode row snapshots at
    every page boundary it computes (48 of the 52 tokens); a K = 8 window
    snapshots only where it ends on one, so the prompt floor (32) is the
    match here, as the JAX engine's is."""
    kw = {} if k is None else dict(decode_lookahead=1, overlap_steps=False)
    oracle = _engine(prefix=False)
    eng = _engine(prefix=True, kind=kind, **kw)
    t1 = list(range(1, 38))
    r1 = _run(eng, "r1", t1, n=15)
    o1 = _run(oracle, "o1", t1, n=15)
    assert r1.output_ids == o1.output_ids
    convo = t1 + r1.output_ids
    assert len(convo) == 52
    t2 = convo + [90, 91, 92]
    r2 = _run(eng, "r2", t2)
    o2 = _run(oracle, "o2", t2)
    assert r2.num_cached_tokens == (48 if k == 1 else 32)
    assert r2.output_ids == o2.output_ids
    if kind == "native":
        # The JAX engine takes the same snapshots and gives the same stream.
        jeng = _jax_engine(prefix=True, **kw)
        j1 = _run(jeng, "j1", t1, n=15)
        assert j1.output_ids == r1.output_ids
        j2 = _run(jeng, "j2", t2)
        assert j2.num_cached_tokens == r2.num_cached_tokens
        assert j2.output_ids == r2.output_ids
