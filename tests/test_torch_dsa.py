"""The port's DSA ops against parallax_tpu's on the same numpy inputs
(float32, CPU; the Pallas kernels in interpret mode).

Checked:
- ``store_index_cache``: bitwise equal;
- K5: ``indexer_scores_fused_plain`` (A7's plain version) and the A7
  wrapper on CPU tensors against ``indexer_scores_fused_pallas``, DSA and
  MSA reductions: cache bitwise, scores within 2e-5, the ``-inf``
  positions identical;
- K8: ``paged_token_scores_decode_plain`` (A8's plain version) against
  ``dsa_indexer_scores_decode_pallas`` and
  ``msa_token_scores_decode_pallas``, the same way;
- the A7 / A8 grid's partition twin ``indexer_runs``: every page slot of
  a row in exactly one block's run, live or dead, at kv_len 0, a full
  row, a mid-page end, more blocks than live pages and one block;
- ``paged_token_scores_runs_plain`` (the kernels' walk: runs, 64-position
  tiles, heads padded to 64 rows) against the K5 and K8 Pallas kernels,
  DSA and MSA at Hi 16 and 64, and against the plain version at several
  block counts;
- ``dsa_indexer_scores_plain`` against ``dsa_indexer_scores_xla`` on a
  mixed prefill / decode batch spanning several chunks;
- ``dsa_topk_indices``: the same indices, forced ties and dense rows
  included;
- the sparse attention against ``mla_ragged_sparse_attention_xla`` on its
  single-pass (K <= 512) and chunked (K > 512) branches;
- ``dsa_store_and_score`` on each route against the JAX facade.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops.decode_fused_pallas import indexer_scores_fused_pallas
from parallax_tpu.ops.dsa import dsa_indexer_scores_xla
from parallax_tpu.ops.dsa import dsa_store_and_score as j_store_and_score
from parallax_tpu.ops.dsa import dsa_topk_indices as j_topk
from parallax_tpu.ops.dsa import mla_ragged_sparse_attention_xla
from parallax_tpu.ops.dsa import store_index_cache as j_store
from parallax_tpu.ops.dsa_pallas import dsa_indexer_scores_decode_pallas
from parallax_tpu.ops.msa_pallas import msa_token_scores_decode_pallas
from parallax_tpu_torch.ops.decode_fused import (
    indexer_scores_fused,
    indexer_scores_fused_plain,
)
from parallax_tpu_torch.ops.dsa import (
    dsa_indexer_scores_plain,
    dsa_store_and_score,
    dsa_topk_indices,
    mla_ragged_sparse_attention_plain,
    new_index_pages,
    store_index_cache,
)
from parallax_tpu_torch.ops.dsa_decode import (
    HEAD_TILE,
    indexer_blocks,
    indexer_runs,
    paged_token_scores_decode,
    paged_token_scores_decode_plain,
    paged_token_scores_runs_plain,
)

TOL = 2e-5
HI, DI = 4, 16
PAGE = 8
LENS = np.array([5, 17, 48, 0, 9, 16], np.int32)
FROZEN_ROW = 4


def t(a):
    return torch.from_numpy(np.asarray(a))


def _decode_inputs(seed, hi=HI, lens=LENS, page=PAGE, pps=6):
    rng = np.random.default_rng(seed)
    s = len(lens)
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(lens):
        npg = (int(n) + page - 1) // page
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    slot = np.full((s,), -1, np.int32)
    for i, n in enumerate(lens):
        if n > 0 and i != FROZEN_ROW:
            slot[i] = pages[i, (n - 1) // page] * page + (n - 1) % page
    f = np.float32
    return dict(
        q=rng.normal(size=(s, hi, DI)).astype(f),
        w=np.abs(rng.normal(size=(s, hi))).astype(f),
        k=rng.normal(size=(s, DI)).astype(f),
        cache=rng.normal(size=(used + 1, page, 1, DI)).astype(f),
        lens=lens, pages=pages, slot=slot,
    )


def _assert_scores(got, ref):
    assert got.shape == ref.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    assert np.isfinite(got[~np.isneginf(got)]).all()
    mask = np.isfinite(ref)
    np.testing.assert_allclose(got[mask], ref[mask], atol=TOL, rtol=TOL)


def test_store_index_cache_bitwise():
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(5, PAGE, 1, DI)).astype(np.float32)
    k = rng.normal(size=(4, DI)).astype(np.float32)
    slots = np.array([3, -1, 33, 17], np.int32)
    ref = np.asarray(j_store(jnp.asarray(cache), jnp.asarray(k),
                             jnp.asarray(slots)))
    got = t(cache.copy())
    assert store_index_cache(got, t(k), t(slots)) is got
    assert np.array_equal(got.numpy(), ref)
    assert new_index_pages(2, PAGE, DI, torch.float32).shape == (2, PAGE, 1,
                                                                  DI)


@pytest.mark.parametrize("kind", ["dsa", "msa"])
def test_k5_fused_scores_match_pallas(kind):
    c = _decode_inputs(1)
    w = c["w"] if kind == "dsa" else None
    ref_sc, ref_cache = indexer_scores_fused_pallas(
        jnp.asarray(c["q"]), None if w is None else jnp.asarray(w),
        jnp.asarray(c["k"]), jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["slot"]), reduce_kind=kind,
        sm_scale=0.25, interpret=True,
    )
    for fn in (indexer_scores_fused_plain, indexer_scores_fused):
        cache = t(c["cache"].copy())
        sc, out_cache = fn(
            t(c["q"]), None if w is None else t(w), t(c["k"]), cache,
            t(c["lens"]), t(c["pages"]), t(c["slot"]), reduce_kind=kind,
            sm_scale=0.25,
        )
        assert out_cache is cache
        assert np.array_equal(cache.numpy(), np.asarray(ref_cache))
        _assert_scores(sc.numpy(), np.asarray(ref_sc))
        assert np.isneginf(sc[3].numpy()).all()        # kv_len 0 row


@pytest.mark.parametrize("kind", ["dsa", "msa"])
def test_k8_split_scores_match_pallas(kind):
    c = _decode_inputs(2)
    q, cache, lens, pages = (jnp.asarray(c[k]) for k in
                             ("q", "cache", "lens", "pages"))
    if kind == "dsa":
        ref = dsa_indexer_scores_decode_pallas(
            q, jnp.asarray(c["w"]), cache, lens, pages, interpret=True)
    else:
        ref = msa_token_scores_decode_pallas(q, cache, lens, pages,
                                             sm_scale=0.3, interpret=True)
    got = paged_token_scores_decode(
        t(c["q"]), t(c["w"]) if kind == "dsa" else None, t(c["cache"]),
        t(c["lens"]), t(c["pages"]), reduce_kind=kind, sm_scale=0.3)
    plain = paged_token_scores_decode_plain(
        t(c["q"]), t(c["w"]) if kind == "dsa" else None, t(c["cache"]),
        t(c["lens"]), t(c["pages"]), reduce_kind=kind, sm_scale=0.3,
    )
    _assert_scores(plain.numpy(), np.asarray(ref))
    assert torch.equal(got, plain)             # CPU tensors: the plain version


# Rows for the runs: a frozen kv_len 1 row (4), kv_len 0, a page-exact row,
# mid-page ends and a full row (13 pages of 16).
RUN_LENS = np.array([150, 0, 64, 97, 1, 208], np.int32)
RUN_PAGE, RUN_PPS = 16, 13


@pytest.mark.parametrize("n,blocks", [(0, 5), (13 * 16, 5), (150, 5),
                                      (40, 9), (150, 1)],
                         ids=["kv_len_0", "full_row", "mid_page",
                              "blocks_past_live", "one_block"])
def test_indexer_runs_cover_every_slot_once(n, blocks):
    page, pps = RUN_PAGE, RUN_PPS
    runs = indexer_runs(n, page, pps, blocks)
    assert len(runs) == blocks
    live = -(-n // page)
    seen = np.zeros(pps * page, np.int32)
    live_pages, dead_pages = [], []
    for lo, hi, dead_lo, dead_hi in runs:
        assert 0 <= lo <= hi <= live <= dead_lo <= dead_hi <= pps
        live_pages += range(lo, hi)
        dead_pages += range(dead_lo, dead_hi)
        seen[lo * page:hi * page] += 1
        seen[dead_lo * page:dead_hi * page] += 1
    assert live_pages == list(range(live))         # in order, once each
    assert dead_pages == list(range(live, pps))
    assert (seen == 1).all()
    # Equal shares: runs differ by at most one page.
    sizes = [hi - lo for lo, hi, _, _ in runs]
    assert max(sizes) - min(sizes) <= 1
    dead = [dh - dl for _, _, dl, dh in runs]
    assert max(dead) - min(dead) <= 1


def _runs_inputs(seed, hi):
    return _decode_inputs(seed, hi=hi, lens=RUN_LENS, page=RUN_PAGE,
                          pps=RUN_PPS)


@pytest.mark.parametrize("hi", [16, HEAD_TILE])
@pytest.mark.parametrize("kind", ["dsa", "msa"])
def test_k8_runs_plain_matches_pallas(kind, hi):
    """The kernels' walk against K8's wrappers in interpret mode, with the
    grid's block count at these rows and with 3 blocks (runs of several
    pages and tiles); Hi 16 pads the 64-row head tile."""
    c = _runs_inputs(7, hi)
    q, cache, lens, pages = (jnp.asarray(c[k]) for k in
                             ("q", "cache", "lens", "pages"))
    if kind == "dsa":
        ref = dsa_indexer_scores_decode_pallas(
            q, jnp.asarray(c["w"]), cache, lens, pages, interpret=True)
    else:
        ref = msa_token_scores_decode_pallas(q, cache, lens, pages,
                                             sm_scale=0.3, interpret=True)
    assert indexer_blocks(len(RUN_LENS), RUN_PPS) == -(-RUN_PPS // 2)
    for blocks in (None, 3):
        got = paged_token_scores_runs_plain(
            t(c["q"]), t(c["w"]) if kind == "dsa" else None, t(c["cache"]),
            t(c["lens"]), t(c["pages"]), reduce_kind=kind, sm_scale=0.3,
            blocks=blocks)
        _assert_scores(got.numpy(), np.asarray(ref))
    assert np.isneginf(got[1].numpy()).all()           # kv_len 0 row


@pytest.mark.parametrize("hi", [16, HEAD_TILE])
@pytest.mark.parametrize("kind", ["dsa", "msa"])
def test_k5_runs_plain_matches_pallas(kind, hi):
    """The append then the kernels' walk against K5 in interpret mode (A7
    reads the append slot's key from k_new, which equals the cache after
    the append)."""
    c = _runs_inputs(8, hi)
    w = c["w"] if kind == "dsa" else None
    ref_sc, ref_cache = indexer_scores_fused_pallas(
        jnp.asarray(c["q"]), None if w is None else jnp.asarray(w),
        jnp.asarray(c["k"]), jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["slot"]), reduce_kind=kind,
        sm_scale=0.25, interpret=True,
    )
    cache = store_index_cache(t(c["cache"].copy()), t(c["k"]), t(c["slot"]))
    assert np.array_equal(cache.numpy(), np.asarray(ref_cache))
    got = paged_token_scores_runs_plain(
        t(c["q"]), None if w is None else t(w), cache, t(c["lens"]),
        t(c["pages"]), reduce_kind=kind, sm_scale=0.25, blocks=3)
    _assert_scores(got.numpy(), np.asarray(ref_sc))


@pytest.mark.parametrize("blocks", [1, 2, 7, RUN_PPS])
def test_runs_plain_matches_plain_at_any_block_count(blocks):
    c = _runs_inputs(9, 64)
    args = (t(c["q"]), t(c["w"]), t(c["cache"]), t(c["lens"]),
            t(c["pages"]))
    ref = paged_token_scores_decode_plain(*args, reduce_kind="dsa")
    got = paged_token_scores_runs_plain(*args, reduce_kind="dsa",
                                        blocks=blocks)
    _assert_scores(got.numpy(), ref.numpy())


def _ragged_case(seed):
    """Two sequences over 16-token pages: a 30-token prefill continuing at
    1,100 (3 chunks of 512) and a decode token at 600; a 32-token bucket."""
    rng = np.random.default_rng(seed)
    page, pps = 16, 70
    ctx, new = [1100, 600], [30, 1]
    pages = np.zeros((2, pps), np.int32)
    used = 1
    for i, n in enumerate(ctx):
        npg = -(-n // page)
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    f = np.float32
    return dict(
        q=rng.normal(size=(32, HI, DI)).astype(f),
        w=rng.normal(size=(32, HI)).astype(f),
        cache=rng.normal(size=(used, page, 1, DI)).astype(f),
        lens=np.array(ctx, np.int32), pages=pages,
        cu=np.array([0, 30, 31], np.int32), t_real=31,
    )


def test_indexer_scores_plain_matches_xla():
    c = _ragged_case(3)
    ref = np.asarray(dsa_indexer_scores_xla(
        *(jnp.asarray(c[k]) for k in ("q", "w", "cache", "lens", "pages",
                                      "cu"))))
    got = dsa_indexer_scores_plain(
        *(t(c[k]) for k in ("q", "w", "cache", "lens", "pages", "cu"))
    ).numpy()
    n = c["t_real"]
    _assert_scores(got[:n], ref[:n])


def test_topk_indices_equal_with_ties_and_dense_rows():
    rng = np.random.default_rng(4)
    scores = np.full((5, 40), -np.inf, np.float32)
    scores[0, :6] = rng.normal(size=6)            # 6 valid <= 8: dense
    scores[1, :30] = rng.normal(size=30)          # sparse
    scores[2, :30] = 1.0                          # all tied: lowest first
    scores[3, :20] = np.repeat(np.arange(5.0), 4)  # ties at the k-th value
    scores[4, :9] = 2.0                           # 9 valid > 8: sparse, ties
    for k in (8, 64):                             # 64 > kv_cap: -1 padding
        ref = np.asarray(j_topk(jnp.asarray(scores), index_topk=k))
        got = dsa_topk_indices(t(scores), index_topk=k)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), ref), k
    assert (np.asarray(j_topk(jnp.asarray(scores), index_topk=8))[0]
            == -1).all()


def _sparse_case(seed, k):
    """Three query rows of two sequences over 8-token pages: a decode row at
    context 700 and two prefill rows at 699 / 700 of another sequence,
    with top-k picks inside the context (sparse rows), a pick past the
    context and a dense row."""
    rng = np.random.default_rng(seed)
    page, r, dr, hq = 8, 16, 8, 2
    ctx = [700, 700]
    npg = -(-700 // page)
    pps = npg
    pages = np.stack([np.arange(1, npg + 1),
                      np.arange(npg + 1, 2 * npg + 1)]).astype(np.int32)
    cache = rng.normal(size=(2 * npg + 1, page, 1, r + dr)).astype(np.float32)
    cu = np.array([0, 1, 3], np.int32)
    q_pos = np.array([699, 698, 699])
    topk = np.stack([rng.choice(q_pos[i] + 1, size=k, replace=False)
                     for i in range(3)]).astype(np.int32)
    topk[1, 0] = 699                  # past row 1's causal position: masked
    topk[2] = -1                      # dense row
    f = np.float32
    return dict(ql=rng.normal(size=(3, hq, r)).astype(f),
                qp=rng.normal(size=(3, hq, dr)).astype(f), cache=cache,
                lens=np.array(ctx, np.int32), pages=pages[:, :pps], cu=cu,
                topk=topk, r=r)


@pytest.mark.parametrize("k", [64, 600], ids=["single-pass", "chunked"])
def test_sparse_attention_matches_xla(k):
    c = _sparse_case(5, k)
    keys = ("ql", "qp", "cache", "lens", "pages", "cu", "topk")
    ref = np.asarray(mla_ragged_sparse_attention_xla(
        *(jnp.asarray(c[x]) for x in keys), sm_scale=0.3,
        kv_lora_rank=c["r"]))
    got = mla_ragged_sparse_attention_plain(
        *(t(c[x]) for x in keys), sm_scale=0.3, kv_lora_rank=c["r"]).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("route", ["fused", "split-kernel", "plain"])
def test_store_and_score_routes_match_jax(route):
    c = _decode_inputs(6)
    s = len(LENS)
    cu = np.arange(s + 1, dtype=np.int32)
    ref_sc, ref_cache = j_store_and_score(
        *(jnp.asarray(c[x]) for x in ("q", "w", "k", "cache", "lens",
                                      "pages")),
        jnp.asarray(cu), jnp.asarray(c["slot"]), decode_only=True,
        use_pallas=False,
    )
    cache = t(c["cache"].copy())
    sc, _ = dsa_store_and_score(
        t(c["q"]), t(c["w"]), t(c["k"]), cache, t(c["lens"]), t(c["pages"]),
        t(cu), t(c["slot"]), decode_only=True,
        use_kernels=route == "split-kernel", decode_fused=route == "fused",
    )
    assert np.array_equal(cache.numpy(), np.asarray(ref_cache))
    _assert_scores(sc.numpy(), np.asarray(ref_sc))
