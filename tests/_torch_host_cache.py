"""The port's host-DRAM KV tier (``parallax_tpu_torch/runtime/host_cache.py``
and the tier half of ``runtime/cache_manager.py`` / ``runtime/scheduler.py``)
against ``parallax_tpu``, on the CPU.

- The pool, its LRU and low watermark, pinned pages and ``evict_cb``
  refusal; the radix tier (demote, host hit, partial lock, pool pressure,
  the twin on insert, reset) and the preemption bookkeeping, over a fake
  torch "device", as tests/test_host_cache.py drives the JAX tier over a
  numpy one. The port's own transfers (``tier_from_paged_kv``) move pages
  bit for bit, in place; a transfer that fails raises.
- Engines end to end, f32, the tier on and a pool small enough to preempt:
  the port's preempted streams equal its unpreempted ones bit for bit
  (greedy and seeded; synchronous and overlapped; K = 1 and K = 8); with K
  = 1, synchronous, the port counts the same ``preemptions``, ``resumes``
  and ``tokens_hit_host`` as the JAX engine on the same trace, and its
  greedy streams pass the tie-tolerant rule against the JAX engine's.
- ``kv_page_signature()`` is None in the port exactly where it is in the
  JAX engine (dense, MoE, MLA, DSA, gpt-oss, MiniMax), equal where not, and
  the tier is built in exactly the same cases.

The suite's fake device, cache-manager builders, engines, pressure mixes
and the unpreempted baselines; its cases are in
tests/test_torch_host_cache*.py.
"""

import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu.models.base import StageModel as JStageModel
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.engine import drive_step as j_drive_step
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.runtime.allocator import PageAllocator
from parallax_tpu_torch.runtime.cache_manager import CacheManager
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
    drive_step,
)
from parallax_tpu_torch.runtime.host_cache import (
    HostKVTier,
    HostPagePool,
    tier_from_paged_kv,
)
from parallax_tpu_torch.runtime.request import (
    Request,
    RequestStatus,
    SamplingParams,
)
from tests.test_torch_deepseek import TINY_V3, TINY_V32
from tests.test_torch_engine import (
    TINY_QWEN2,
    _assert_tie_tolerant,
    _reference_logits,
    _weights,
)
from tests.test_torch_gpt_oss import TINY as TINY_GPT_OSS
from tests.test_torch_msa import TINY_M2, TINY_M3
from tests.test_torch_qwen3_moe import QWEN3_MOE

# -- the pool -------------------------------------------------------------


class TestHostPagePool:
    def test_store_load_free(self):
        pool = HostPagePool(budget_bytes=4 * 100, page_nbytes=100)
        h = pool.store("a")
        assert pool.load(h) == "a"
        assert pool.num_pages == 1
        pool.free(h)
        assert pool.num_pages == 0

    def test_capacity_from_budget(self):
        pool = HostPagePool(budget_bytes=350, page_nbytes=100)
        assert pool.capacity == 3
        assert HostPagePool(budget_bytes=50, page_nbytes=100).capacity == 0

    def test_lru_eviction_order_and_watermark(self):
        evicted = []
        pool = HostPagePool(10 * 100, 100, low_watermark=0.5)
        pool.evict_cb = lambda h: evicted.append(h) or True
        handles = [pool.store(i) for i in range(10)]
        pool.load(handles[0])          # refresh h0 -> MRU
        assert pool.store("x") is not None
        # Watermark: shed down to 5 in one batch, oldest (but not h0) first.
        assert pool.num_pages <= 6
        assert handles[0] not in evicted
        assert evicted == handles[1:1 + len(evicted)]

    def test_pinned_never_evicted(self):
        pool = HostPagePool(3 * 100, 100)
        pool.evict_cb = lambda h: True
        hs = [pool.store(i, pinned=True) for i in range(3)]
        assert pool.store("x") is None          # everything pinned
        pool.unpin(hs[0])
        assert pool.store("x") is not None
        assert hs[0] not in pool._pages

    def test_evict_cb_refusal_skips(self):
        pool = HostPagePool(2 * 100, 100)
        keep = set()
        pool.evict_cb = lambda h: h not in keep
        h0, h1 = pool.store("a"), pool.store("b")
        keep.add(h0)
        assert pool.store("c") is not None      # h1 evicted instead of h0
        assert h0 in pool._pages and h1 not in pool._pages


# -- radix + cache manager over a fake torch device ----------------------------


PAGE = 4
PAGES = 16


def partial_demoter(tier):
    return lambda ids: tier.demote(ids, partial=True)


def make_cm(host_pages=8, num_pages=PAGES):
    """CacheManager over a torch 'device' (one layer, 2 floats/token)."""
    dev = torch.arange(num_pages * PAGE * 2, dtype=torch.float32).reshape(
        num_pages, PAGE * 2)

    def gather(ids):
        return [dev[torch.tensor(ids)].clone()]

    def scatter(ids, layers):
        dev[torch.tensor(ids)] = torch.stack(layers[0])

    nbytes = dev[0].numel() * dev.element_size()
    tier = HostKVTier(host_pages * nbytes, nbytes, gather, scatter)
    cm = CacheManager(page_size=PAGE, num_pages=num_pages, host_tier=tier)
    return cm, tier, dev


def finish(cm, req, computed=None):
    req.num_computed_tokens = (
        computed if computed is not None else len(req.all_token_ids)
    )
    req.status = RequestStatus.FINISHED_EOS
    cm.release(req)


class TestRadixHostTier:
    def test_evict_demotes_and_match_hits_host(self):
        cm, tier, dev = make_cm()
        orig = dev.clone()
        r1 = Request("r1", prompt_ids=list(range(12)))
        assert cm.allocate_for_prompt(r1)
        p1 = list(r1.page_ids)
        finish(cm, r1)
        # Pressure demotes the whole tree.
        freed = cm.prefix_cache.evict(3, demoter=partial_demoter(tier))
        assert len(freed) == 3
        cm.allocator.free(freed)
        assert cm.prefix_cache.num_cached_pages == 0
        assert cm.prefix_cache.num_host_pages == 3
        # Scribble the freed device pages: the swap-in restores them.
        for p in p1:
            dev[p] = -1.0
        r2 = Request("r2", prompt_ids=list(range(12)) + [50, 51, 52])
        assert cm.allocate_for_prompt(r2)
        assert r2.num_cached_tokens == 12
        assert cm.stats.tokens_hit_host == 12
        assert tier.pages_swapped_in == 3
        pages, _path = cm.prefix_cache.match_prefix(list(range(12)))
        assert all(p >= 0 for p in pages)
        for pg, op in zip(pages, p1):
            assert torch.equal(dev[pg], orig[op])

    def test_pinned_pages_never_demoted_or_freed(self):
        """evict() while a matched prefix is pinned must not demote or
        free the pinned pages."""
        cm, tier, _dev = make_cm()
        r1 = Request("r1", prompt_ids=list(range(12)))
        assert cm.allocate_for_prompt(r1)
        finish(cm, r1)
        pages, path = cm.prefix_cache.match_prefix(list(range(12)))
        cm.prefix_cache.lock(path)
        pinned = set(pages)
        freed = cm.prefix_cache.evict(3, demoter=partial_demoter(tier))
        assert not (set(freed) & pinned)
        assert all(n.on_device for n in path)
        assert cm.prefix_cache.num_cached_pages == 3
        cm.prefix_cache.unlock(path)
        freed = cm.prefix_cache.evict(3, demoter=partial_demoter(tier))
        assert len(freed) == 3    # unpinned -> all demote now

    def test_partial_lock_demotes_only_unpinned_suffix(self):
        cm, tier, _dev = make_cm()
        r1 = Request("r1", prompt_ids=list(range(12)))
        assert cm.allocate_for_prompt(r1)
        finish(cm, r1)
        pages, full = cm.prefix_cache.match_prefix(list(range(12)))
        part = cm.prefix_cache.slice_path(full, 1)
        cm.prefix_cache.lock(part)
        freed = cm.prefix_cache.evict(3, demoter=partial_demoter(tier))
        assert pages[0] not in freed
        assert sorted(freed) == sorted(pages[1:])
        assert full[0].on_device and not full[1].on_device
        cm.prefix_cache.unlock(part)

    def test_host_pool_pressure_recycles_radix_pages(self):
        """A full pool sheds its OLDEST radix-owned host pages to admit new
        demotions; the surviving host nodes form an ancestor chain."""
        cm, tier, _dev = make_cm(host_pages=2)
        r1 = Request("r1", prompt_ids=list(range(12)))
        assert cm.allocate_for_prompt(r1)
        finish(cm, r1)
        freed = cm.prefix_cache.evict(3, demoter=partial_demoter(tier))
        assert len(freed) == 3
        assert cm.prefix_cache.num_cached_pages == 0
        assert cm.prefix_cache.num_host_pages == tier.num_host_pages == 2
        pages, path = cm.prefix_cache.match_prefix(list(range(12)))
        assert len(path) == 2 and all(not n.on_device for n in path)

    def test_demote_refused_when_tier_cannot_hold(self):
        """Zero-capacity tier: demotion is refused and eviction drops the
        pages outright."""
        cm, tier, _dev = make_cm(host_pages=0)
        r1 = Request("r1", prompt_ids=list(range(12)))
        assert cm.allocate_for_prompt(r1)
        finish(cm, r1)
        freed = cm.prefix_cache.evict(3, demoter=partial_demoter(tier))
        assert len(freed) == 3
        assert cm.prefix_cache.num_host_pages == 0
        assert cm.prefix_cache.num_cached_pages == 0
        assert tier.num_host_pages == 0

    def test_insert_adopts_host_resident_twin(self):
        cm, tier, _dev = make_cm()
        r1 = Request("r1", prompt_ids=list(range(8)))
        assert cm.allocate_for_prompt(r1)
        finish(cm, r1)
        freed = cm.prefix_cache.evict(2, demoter=partial_demoter(tier))
        cm.allocator.free(freed)
        assert cm.prefix_cache.num_host_pages == 2
        # The same content recomputed by a cache-missing request.
        r2 = Request("r2", prompt_ids=list(range(8)))
        assert cm.allocate_for_prompt(r2)
        assert r2.num_cached_tokens == 4    # only 1 page usable (8-1)//4
        finish(cm, r2)
        # The recomputed full pages upgraded the host nodes to device.
        assert cm.prefix_cache.num_host_pages == 0
        assert tier.num_host_pages == 0

    def test_reset_releases_host_pages(self):
        cm, tier, _dev = make_cm()
        r1 = Request("r1", prompt_ids=list(range(12)))
        assert cm.allocate_for_prompt(r1)
        finish(cm, r1)
        cm.allocator.free(
            cm.prefix_cache.evict(3, demoter=partial_demoter(tier)))
        assert tier.num_host_pages == 3
        cm.reset_prefix_cache()
        assert tier.num_host_pages == 0
        assert cm.prefix_cache.num_host_pages == 0

    def test_failed_demotion_raises_after_freeing_the_victims(self):
        """No fallback hides a transfer fault: the reclaim raises, and the
        victims' device pages are back in the allocator first."""
        cm, tier, _dev = make_cm()
        r1 = Request("r1", prompt_ids=list(range(12)))
        assert cm.allocate_for_prompt(r1)
        finish(cm, r1)
        free_before = cm.num_free_pages

        def broken(_ids):
            raise RuntimeError("D2H failed")

        tier._gather = broken
        with pytest.raises(RuntimeError, match="D2H failed"):
            cm._reclaim(cm.num_free_pages + 3)
        assert cm.num_free_pages == free_before + 3
        assert cm.prefix_cache.num_cached_pages == 0


class TestPreemptionBookkeeping:
    def _decoding_request(self, cm, rid, n_prompt=8):
        req = Request(rid, prompt_ids=list(range(100, 100 + n_prompt)))
        assert cm.allocate_for_prompt(req)
        req.status = RequestStatus.DECODING
        req.num_computed_tokens = n_prompt
        return req

    def test_preempt_and_resume_roundtrip(self):
        cm, tier, dev = make_cm()
        req = self._decoding_request(cm, "p1")
        pages = list(req.page_ids)
        image = dev[torch.tensor(pages)].clone()
        assert cm.preempt_to_host(req)
        assert req.page_ids == []
        assert cm.stats.preemptions == 1
        assert tier.num_host_pages == len(pages)
        for p in pages:
            dev[p] = -7.0
        assert cm.resume_from_host(req)
        assert len(req.page_ids) == len(pages)
        assert torch.equal(dev[torch.tensor(req.page_ids)], image)
        assert tier.num_host_pages == 0
        assert cm.stats.resumes == 1
        cm.release(req)

    def test_preempted_image_is_pinned_against_pool_pressure(self):
        cm, tier, _dev = make_cm(host_pages=2)
        req = self._decoding_request(cm, "p1")
        assert cm.preempt_to_host(req)
        # Radix demotions cannot displace the parked image.
        r2 = Request("r2", prompt_ids=list(range(8)))
        assert cm.allocate_for_prompt(r2)
        finish(cm, r2)
        freed = cm.prefix_cache.evict(2, demoter=partial_demoter(tier))
        assert len(freed) == 2               # dropped outright, pool full
        assert tier.num_host_pages == 2      # the parked image, untouched
        assert cm.resume_from_host(req)
        cm.release(req)

    def test_release_while_preempted_frees_host_image(self):
        cm, tier, _dev = make_cm()
        req = self._decoding_request(cm, "p1")
        assert cm.preempt_to_host(req)
        req.abort("timeout")
        cm.release(req)
        assert tier.num_host_pages == 0
        assert not hasattr(req, "host_page_handles")

    def test_preempt_without_tier_is_refused(self):
        cm = CacheManager(page_size=PAGE, num_pages=PAGES)
        req = self._decoding_request(cm, "p1")
        assert not cm.preempt_to_host(req)
        assert req.page_ids            # untouched

    def test_trim_uncomputed_pages_keeps_the_computed_span(self):
        cm, _tier, _dev = make_cm()
        req = Request("p1", prompt_ids=list(range(100, 114)))
        assert cm.allocate_for_prompt(req)
        assert len(req.page_ids) == 4
        req.num_computed_tokens = 5
        assert cm.trim_uncomputed_pages(req) == 2
        assert len(req.page_ids) == 2
        cm.release(req)

    def test_allocator_guards_hold_across_tier_traffic(self):
        """Every page freed by preemption and swap-in is freed once: the
        allocator's double-free guard never fires and no page leaks."""
        cm, _tier, _dev = make_cm()
        reqs = [self._decoding_request(cm, f"p{i}") for i in range(3)]
        for r in reqs:
            assert cm.preempt_to_host(r)
        for r in reversed(reqs):
            assert cm.resume_from_host(r)
        for r in reqs:
            r.abort("done")
            cm.release(r)
        assert cm.num_free_pages == PageAllocator(PAGES).num_free


# -- the port's transfers ---------------------------------------------------


def test_tier_transfers_move_pages_bitwise_and_in_place():
    """``tier_from_paged_kv`` on CPU cache tensors: a demoted page comes
    back bit for bit into another page, the padding of a non-power-of-two
    batch writes nothing else, and the cache tensors are never
    reallocated (captured graphs hold their pointers)."""
    g = torch.Generator().manual_seed(0)
    kv = [torch.randn((12, 4, 2, 8), generator=g, dtype=torch.float32),
          torch.randn((12, 4, 2, 8), generator=g).to(torch.bfloat16)]
    ptrs = [t.data_ptr() for t in kv]
    page_nbytes = sum(t[0].numel() * t.element_size() for t in kv)
    tier = tier_from_paged_kv(16 * page_nbytes, lambda: kv, 12)
    assert tier.pool.page_nbytes == page_nbytes and tier.capacity_pages == 16
    before = [t.clone() for t in kv]
    handles = tier.demote([1, 5, 7], pinned=True)
    assert len(handles) == 3 and tier.num_host_pages == 3
    tier.promote(handles, [9, 10, 11])
    for t, b in zip(kv, before):
        assert torch.equal(t[[9, 10, 11]], b[[1, 5, 7]])
        assert torch.equal(t[:9], b[:9])
    assert [t.data_ptr() for t in kv] == ptrs
    assert tier.num_host_pages == 0 and tier.pages_swapped_in == 3
    # A budget below one page and a tuple cache build no tier.
    assert tier_from_paged_kv(page_nbytes - 1, lambda: kv, 12) is None
    assert tier_from_paged_kv(1 << 20, lambda: [(kv[0], kv[1])], 12) is None


# -- engines end to end ---------------------------------------------------------

ENGINE = dict(page_size=8, max_model_len=256, kv_dtype="float32")
PRESSURE = dict(num_pages=22, host_cache_bytes=1 << 24)
K1_SYNC = dict(decode_lookahead=1, overlap_steps=False)


def _params_np():
    return _weights(TINY_QWEN2)[2]


def _port_engine(**cfg):
    c = normalize_config(TINY_QWEN2)
    return StageEngine(create_stage_model(c, 0, 4),
                       params_from_numpy(_params_np(), "cpu"),
                       EngineConfig(**dict(ENGINE, **cfg)), device="cpu")


def _jax_engine(**cfg):
    jcfg, full, _ = _weights(TINY_QWEN2)
    return JStageEngine(JStageModel(jcfg, 0, 4, use_pallas=False), full,
                        JEngineConfig(**dict(ENGINE, **cfg)))


def _drain(eng, step=drive_step):
    pending, guard = None, 0
    while (eng.has_work() or pending is not None) and guard < 5000:
        guard += 1
        _outs, pending = step(eng, pending)
    assert guard < 5000, "engine made no progress"


def _pressure_reqs(req_cls=Request, sp_cls=SamplingParams, temp=0.0,
                   seed=None):
    return [req_cls(f"r{i}", prompt_ids=[3 + i] * 12,
                    sampling_params=sp_cls(temperature=temp, seed=seed,
                                           max_new_tokens=24,
                                           ignore_eos=True))
            for i in range(6)]


def _serve(eng, reqs, step=drive_step):
    for r in reqs:
        eng.submit(r)
    _drain(eng, step)
    return reqs


_UNPREEMPTED: dict = {}


def _unpreempted(sampled: bool):
    """The K = 1 synchronous streams on a pool no request outgrows (one
    run a sampling mode: the window and the overlapped loop commit the
    K = 1 stream bit for bit, tests/test_torch_multistep.py)."""
    if sampled not in _UNPREEMPTED:
        kw = dict(temp=0.8, seed=42) if sampled else {}
        _UNPREEMPTED[sampled] = _serve(_port_engine(num_pages=256, **K1_SYNC),
                                       _pressure_reqs(**kw))
    return _UNPREEMPTED[sampled]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
@pytest.mark.parametrize("k", [1, 8], ids=["K1", "K8"])
def test_preempted_streams_bit_identical(sampled, overlap, k):
    """Every configuration's preempted streams equal the unpreempted K = 1
    synchronous ones, bit for bit."""
    kw = dict(temp=0.8, seed=42) if sampled else {}
    cfg = dict(overlap_steps=overlap, decode_lookahead=k)
    base = _unpreempted(sampled)
    eng = _port_engine(**PRESSURE, **cfg)
    on = _serve(eng, _pressure_reqs(**kw))
    stats = eng.cache_stats()
    assert stats["kv_oom_aborts"] == 0
    assert stats["preemptions"] > 0 and stats["resumes"] > 0
    assert stats["pages_demoted"] >= stats["preemptions"]
    for a, b in zip(base, on):
        assert b.status == a.status == RequestStatus.FINISHED_LENGTH
        assert b.output_ids == a.output_ids, b.request_id


def test_tier_disabled_behavior_unchanged():
    """host_cache_bytes=0: pressure aborts with kv_oom, the survivors'
    streams match the unpressured run, and the stats carry no tier
    fields."""
    base = _unpreempted(False)
    eng = _port_engine(num_pages=22)
    off = _serve(eng, _pressure_reqs())
    stats = eng.cache_stats()
    assert stats["preemptions"] == 0 and "pages_demoted" not in stats
    assert stats["kv_oom_aborts"] > 0
    assert any(r.abort_reason == "kv_oom" for r in off)
    for a, b in zip(base, off):
        if b.abort_reason is None:
            assert b.output_ids == a.output_ids


def _two_waves(eng, req_cls, sp_cls, step):
    w1 = [req_cls(f"a{i}", prompt_ids=[5 + i] * 24,
                  sampling_params=sp_cls(temperature=0.0, max_new_tokens=16,
                                         ignore_eos=True))
          for i in range(4)]
    _serve(eng, w1, step)
    w2 = [req_cls(f"b{i}", prompt_ids=list(r.all_token_ids) + [9, 9, 9, 9],
                  sampling_params=sp_cls(temperature=0.0, max_new_tokens=16,
                                         ignore_eos=True))
          for i, r in enumerate(w1)]
    _serve(eng, w2, step)
    return w1 + w2



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


# -- kv_page_signature parity ------------------------------------------------

SIG_CONFIGS = {
    "dense": TINY_QWEN2, "qwen3-moe": QWEN3_MOE, "deepseek-v3": TINY_V3,
    "deepseek-v3.2": TINY_V32, "gpt-oss": TINY_GPT_OSS,
    "minimax-m2": TINY_M2, "minimax-m3": TINY_M3,
}
