"""The port's native (C++) cache manager: behaviour parity with the port's
Python manager (the oracle), the same op sequences through the JAX
package's native manager and the port's (one C++ source: the same pages,
match lengths and eviction order), the engine on it (streams bit-identical
to the Python manager's, greedy-equal to the JAX engine's) and the factory's
gates. The wall-clock comparison of ``tests/test_native_cache.py`` is
measured on the card instead (``chip_smoke.py --only native``)."""

import filecmp
import os
import types

import numpy as np
import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu_torch import native
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.runtime.allocator import OutOfPages, PageAllocator
from parallax_tpu_torch.runtime.cache_manager import (
    CacheManager,
    make_cache_manager,
)
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.radix_cache import RadixPageCache
from parallax_tpu_torch.runtime.request import (
    Request,
    RequestStatus,
    SamplingParams,
)

if not native.native_available():
    pytest.skip("g++ cannot build the native library",
                allow_module_level=True)

RAW = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    intermediate_size=128, vocab_size=151, max_position_embeddings=512,
    tie_word_embeddings=False,
)


def test_source_is_the_jax_packages_and_builds_into_build_dir():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert filecmp.cmp(native.SRC, os.path.join(
        here, "parallax_tpu", "native", "radix_cache.cpp"), shallow=False)
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(native.BUILD_DIR) == "_build"
    # Nothing is written beside the source.
    assert not [f for f in os.listdir(os.path.dirname(native.SRC))
                if f.endswith((".so", ".tmp"))]


@pytest.fixture(params=["python", "native"])
def impls(request):
    if request.param == "python":
        return PageAllocator(64), RadixPageCache(4)
    return native.NativePageAllocator(64), native.NativeRadixPageCache(4)


class TestBehaviorParity:
    def test_alloc_free_cycle(self, impls):
        alloc, _ = impls
        pages = alloc.alloc(10)
        assert len(set(pages)) == 10 and 0 not in pages
        assert alloc.num_free == 53
        alloc.free(pages[:5])
        assert alloc.num_free == 58
        with pytest.raises(OutOfPages):
            alloc.alloc(1000)

    def test_match_insert_evict(self, impls):
        _, tree = impls
        tokens = list(range(12))
        assert tree.insert(tokens, [5, 6, 7]) == []
        pages, path = tree.match_prefix(tokens)
        assert pages == [5, 6, 7]
        assert tree.num_cached_pages == 3
        pages2, _ = tree.match_prefix([0, 1, 2, 3, 99, 99, 99, 99])
        assert pages2 == [5]
        assert tree.insert(tokens[:4], [9]) == [9]
        tree.lock(path)
        assert tree.evict(3) == []
        tree.unlock(path)
        assert sorted(tree.evict(3)) == [5, 6, 7]
        assert tree.num_cached_pages == 0

    def test_partial_lock_path(self, impls):
        _, tree = impls
        tokens = list(range(8))
        tree.insert(tokens, [3, 4])
        _pages, full = tree.match_prefix(tokens)
        part = tree.slice_path(full, 1)
        tree.lock(part)
        assert tree.evict(2) == [4]
        tree.unlock(part)
        assert sorted(tree.evict(2)) == [3]

    def test_reset_returns_all(self, impls):
        _, tree = impls
        tree.insert(list(range(8)), [1, 2])
        tree.insert([9] * 4, [3])
        assert sorted(tree.reset()) == [1, 2, 3]
        assert tree.num_cached_pages == 0


def test_randomized_differential():
    """The same random op sequence on both trees: the same observable
    state."""
    rng = np.random.default_rng(0)
    py = RadixPageCache(4)
    nat = native.NativeRadixPageCache(4)
    next_page = 1
    for step in range(300):
        op = rng.random()
        toks = [int(x) for x in rng.integers(0, 3, size=4 * int(
            rng.integers(1, 5)))]
        if op < 0.5:
            pages = list(range(next_page, next_page + len(toks) // 4))
            next_page += len(pages)
            assert py.insert(toks, pages) == nat.insert(toks, pages), step
        elif op < 0.85:
            assert py.match_prefix(toks)[0] == nat.match_prefix(toks)[0], step
        else:
            n = int(rng.integers(1, 4))
            assert sorted(py.evict(n)) == sorted(nat.evict(n)), step
        assert py.num_cached_pages == nat.num_cached_pages, step


def _req(rid, prompt, cls=Request, sp_cls=SamplingParams):
    return cls(request_id=rid, prompt_ids=list(prompt),
               sampling_params=sp_cls())


def test_cache_manager_differential():
    """Identical request lifecycles through the port's Python manager and
    its native one leave identical observable state (admission outcomes,
    prefix hits, free and cached page counts)."""
    rng = np.random.default_rng(1)
    py = CacheManager(page_size=4, num_pages=64)
    nat = native.NativeCacheManager(page_size=4, num_pages=64)
    live: list[tuple] = []
    for step in range(400):
        op = rng.random()
        if op < 0.45 or not live:
            n = int(rng.integers(1, 40))
            prompt = [int(x) for x in rng.integers(0, 3, size=n)]
            r1, r2 = _req(f"p{step}", prompt), _req(f"p{step}", prompt)
            ok = py.allocate_for_prompt(r1)
            assert ok == nat.allocate_for_prompt(r2), step
            if ok:
                assert r1.num_cached_tokens == r2.num_cached_tokens, step
                r1.num_computed_tokens = r2.num_computed_tokens = n
                live.append((r1, r2))
        elif op < 0.7:
            r1, r2 = live[int(rng.integers(len(live)))]
            extra = [int(x) for x in rng.integers(0, 3, size=int(
                rng.integers(1, 9)))]
            r1.output_ids.extend(extra)
            r2.output_ids.extend(extra)
            assert (py.ensure_capacity(r1, r1.total_len)
                    == nat.ensure_capacity(r2, r2.total_len)), step
            r1.num_computed_tokens = r2.num_computed_tokens = (
                r1.total_len - 1)
        else:
            r1, r2 = live.pop(int(rng.integers(len(live))))
            r1.status = r2.status = (
                RequestStatus.FINISHED_ABORT if rng.random() < 0.2
                else RequestStatus.FINISHED_EOS)
            py.release(r1)
            nat.release(r2)
        assert py.num_free_pages == nat.num_free_pages, step
        assert (py.prefix_cache.num_cached_pages
                == nat.prefix_cache.num_cached_pages), step


def test_native_managers_agree_across_packages():
    """The same seeded lifecycle through the JAX package's native manager
    and the port's: the same admissions, prefix hits and page ids at every
    step, then the same pages in the same eviction order."""
    jnative = pytest.importorskip("parallax_tpu.native")
    if not jnative.native_available():
        pytest.skip("the JAX package's native library does not build")
    from parallax_tpu.runtime.request import Request as JRequest
    from parallax_tpu.runtime.request import RequestStatus as JStatus
    from parallax_tpu.runtime.request import SamplingParams as JSampling

    jm = jnative.NativeCacheManager(page_size=4, num_pages=64)
    pm = native.NativeCacheManager(page_size=4, num_pages=64)
    rng = np.random.default_rng(7)
    live = []
    for step in range(300):
        op = rng.random()
        if op < 0.5 or not live:
            prompt = [int(x) for x in rng.integers(0, 3, size=int(
                rng.integers(1, 40)))]
            jr = _req(f"p{step}", prompt, JRequest, JSampling)
            pr = _req(f"p{step}", prompt)
            ok = jm.allocate_for_prompt(jr)
            assert ok == pm.allocate_for_prompt(pr), step
            if ok:
                assert jr.page_ids == pr.page_ids, step
                assert jr.num_cached_tokens == pr.num_cached_tokens, step
                jr.num_computed_tokens = pr.num_computed_tokens = len(prompt)
                live.append((jr, pr))
        else:
            jr, pr = live.pop(int(rng.integers(len(live))))
            jr.status, pr.status = JStatus.FINISHED_EOS, RequestStatus.FINISHED_EOS
            jm.release(jr)
            pm.release(pr)
        assert jm.num_free_pages == pm.num_free_pages, step
    for n in (3, 5, 64):
        assert (jm.prefix_cache.evict(n) == pm.prefix_cache.evict(n))


def _engine_streams(use_native, prompts, max_new=6, seed=None):
    cfg = normalize_config(RAW)
    model = create_stage_model(cfg, 0, 2)
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
    eng = StageEngine(model, params, EngineConfig(
        page_size=8, num_pages=64, max_model_len=128, kv_dtype="float32"),
        device="cpu", use_native=use_native)
    reqs = []
    for i, p in enumerate(prompts):
        sp = (SamplingParams(temperature=0.0, max_new_tokens=max_new)
              if seed is None else
              SamplingParams(temperature=0.9, seed=seed + i,
                             max_new_tokens=max_new))
        reqs.append(Request(f"r{i}", prompt_ids=list(p), sampling_params=sp))
    for r in reqs[:1]:
        eng.submit(r)
    pending = None
    while eng.has_work() or pending is not None:
        _, pending = drive_step(eng, pending)
    for r in reqs[1:]:
        eng.submit(r)
    while eng.has_work() or pending is not None:
        _, pending = drive_step(eng, pending)
    return reqs, eng


def test_engine_runs_on_native_cache():
    shared = list(range(1, 20))
    reqs, eng = _engine_streams(None, [shared + [40], shared + [50]],
                                max_new=5)
    assert type(eng.cache).__name__ == "NativeCacheManager"
    assert type(eng.cache.prefix_cache).__name__ == "NativeRadixPageCache"
    assert [len(r.output_ids) for r in reqs] == [5, 5]
    assert reqs[1].num_cached_tokens == 16
    assert eng.cache_stats()["tokens_hit_device"] == 16


@pytest.mark.parametrize("seed", [None, 11], ids=["greedy", "seeded"])
def test_engine_streams_native_equal_python(seed):
    shared = list(range(1, 20))
    prompts = [shared + [40], shared + [50], [7, 8, 9], shared]
    nat, ne = _engine_streams(True, prompts, seed=seed)
    py, pe = _engine_streams(False, prompts, seed=seed)
    assert type(ne.cache).__name__ == "NativeCacheManager"
    assert type(pe.cache) is CacheManager
    assert [r.output_ids for r in nat] == [r.output_ids for r in py]
    assert [r.num_cached_tokens for r in nat] == [
        r.num_cached_tokens for r in py]


def test_engine_on_native_greedy_equals_jax_engine(hf_model):
    """Port engine on the native manager against the JAX engine (on its
    own native manager) on the same HF weights, tie-tolerant."""
    import jax
    import jax.numpy as jnp

    from parallax_tpu.config import normalize_config as j_normalize
    from parallax_tpu.models.base import StageModel as JStageModel
    from parallax_tpu.models.loader import params_from_torch_state_dict
    from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
    from parallax_tpu.runtime.engine import StageEngine as JStageEngine
    from parallax_tpu.runtime.engine import drive_step as j_drive_step
    from parallax_tpu.runtime.request import Request as JRequest
    from parallax_tpu.runtime.request import SamplingParams as JSampling
    from parallax_tpu_torch.models.registry import params_from_numpy
    from tests.test_engine_e2e import assert_greedy_matches
    from tests._torch_multistep import RAW as MRAW

    raw = dict(MRAW, num_hidden_layers=4, rms_norm_eps=1e-6)
    jmodel = JStageModel(j_normalize(raw), 0, 4, use_pallas=False)
    jparams = params_from_torch_state_dict(jmodel, hf_model.state_dict(),
                                           dtype=jnp.float32)
    ecfg = dict(page_size=8, num_pages=128, max_model_len=256,
                kv_dtype="float32")
    shared = list(range(3, 22))
    prompts = [shared + [40], shared + [50], [7, 21, 108]]
    n_new = 8

    def drive(eng, req_cls, sp_cls, step_fn):
        reqs = [req_cls(f"r{i}", prompt_ids=list(p),
                        sampling_params=sp_cls(temperature=0.0,
                                               max_new_tokens=n_new,
                                               ignore_eos=True))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
            pending = None
            while eng.has_work() or pending is not None:
                _, pending = step_fn(eng, pending)
        return reqs

    jeng = JStageEngine(jmodel, jparams, JEngineConfig(**ecfg))
    assert type(jeng.cache).__name__ == "NativeCacheManager"
    j_reqs = drive(jeng, JRequest, JSampling, j_drive_step)
    port = StageEngine(create_stage_model(normalize_config(raw), 0, 4),
                       params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"),
                       EngineConfig(**ecfg), device="cpu")
    assert type(port.cache).__name__ == "NativeCacheManager"
    p_reqs = drive(port, Request, SamplingParams, drive_step)
    for pr, jr in zip(p_reqs, j_reqs):
        assert pr.num_cached_tokens == jr.num_cached_tokens
        assert_greedy_matches(hf_model, pr.prompt_ids, pr.output_ids, n_new)


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    from tests._torch_multistep import RAW as MRAW

    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**{
        k: v for k, v in dict(MRAW, num_hidden_layers=4,
                              rms_norm_eps=1e-6).items()
        if k != "architectures"}))
    model.eval()
    return model


# -- the factory's gates --------------------------------------------------


def test_factory_defaults_to_native():
    assert type(make_cache_manager(8, 64)).__name__ == "NativeCacheManager"
    assert type(make_cache_manager(8, 64, use_native=True)).__name__ == (
        "NativeCacheManager")
    assert type(make_cache_manager(8, 64, use_native=False)) is CacheManager


@pytest.mark.parametrize("gate", ["tier", "digests", "chunk_skip_off"])
def test_factory_gates_pick_python(gate):
    kw = {"tier": {}, "digests": dict(track_digests=True),
          "chunk_skip_off": dict(prefill_chunk_skip=False)}[gate]
    if gate == "tier":
        # Only the factory's choice is under test: a stand-in tier.
        kw = dict(host_tier=types.SimpleNamespace(
            set_evict_cb=lambda cb: None))
    m = make_cache_manager(8, 64, **kw)
    assert type(m) is CacheManager


def test_factory_env_var_picks_python(monkeypatch):
    monkeypatch.setenv("PARALLAX_TPU_NO_NATIVE", "1")
    assert type(make_cache_manager(8, 64)) is CacheManager
    with pytest.raises(RuntimeError, match="PARALLAX_TPU_NO_NATIVE"):
        make_cache_manager(8, 64, use_native=True)


def test_explicit_native_raises_on_a_failed_build(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "build_error", None)
    with pytest.raises(RuntimeError, match="unavailable"):
        make_cache_manager(8, 64, use_native=True)
    # The default falls back quietly (with a warning) to the Python one.
    assert type(make_cache_manager(8, 64)) is CacheManager
    assert not os.path.exists(native.library_path(str(bad)))


def test_native_refuses_linear_state_and_lora():
    """Linear-state snapshots are ported (tests/test_torch_linear_prefix_
    cache.py holds them to the Python manager), and so are the LoRA
    namespaces: the same adapter lifecycle through both managers gives the
    same hits — a donor's pages hit under its adapter, never under another
    adapter or the base namespace."""
    assert native.NativeCacheManager(8, 64, linear_state=True).linear_state
    prompt = list(range(1, 30))
    hits = []
    for m in (CacheManager(page_size=8, num_pages=64),
              native.NativeCacheManager(page_size=8, num_pages=64)):
        donor = _req("d", prompt)
        donor.lora_id = "adapter"
        assert m.allocate_for_prompt(donor)
        donor.num_computed_tokens = len(prompt)
        donor.status = RequestStatus.FINISHED_EOS
        m.release(donor)
        got = []
        for i, lid in enumerate(("other", None, "adapter")):
            r = _req(f"r{i}", prompt)
            r.lora_id = lid
            assert m.allocate_for_prompt(r)
            got.append(r.num_cached_tokens)
            r.status = RequestStatus.FINISHED_ABORT
            m.release(r)
        hits.append(got)
    assert hits[0] == hits[1] == [0, 0, 24]
