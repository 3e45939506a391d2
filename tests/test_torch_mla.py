"""The port's MLA ops against parallax_tpu's on the same numpy inputs
(float32, CPU; the Pallas kernels in interpret mode).

Checked:
- ``store_mla_cache``: bitwise equal, negative slots dropped;
- ``mla_rope_permute``: exact;
- ``mla_ragged_attention_plain`` against ``mla_ragged_attention_xla`` on
  mixed prefill / decode batches whose contexts span several 512-row
  chunks (2e-5: f32 summation order);
- K7: ``mla_decode_attention_plain`` (A6's plain version) and the A6
  wrapper on CPU tensors against ``mla_decode_attention_pallas``;
- K4: ``mla_fused_decode_plain`` (A5's plain version) and the A5 wrapper
  on CPU tensors against ``mla_fused_decode_pallas``: cache bitwise equal,
  output within 2e-5, padding rows exactly zero, frozen slots untouched;
- ``mla_append_and_attend`` on each route (fused, split kernel, plain)
  against the JAX facade.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops.decode_fused_pallas import mla_fused_decode_pallas
from parallax_tpu.ops.mla import mla_append_and_attend as j_append_and_attend
from parallax_tpu.ops.mla import mla_ragged_attention_xla
from parallax_tpu.ops.mla import mla_rope_permute as j_rope_permute
from parallax_tpu.ops.mla import store_mla_cache as j_store
from parallax_tpu.ops.mla_pallas import mla_decode_attention_pallas
from parallax_tpu_torch.ops.decode_fused import (
    mla_fused_decode,
    mla_fused_decode_plain,
)
from parallax_tpu_torch.ops.mla import (
    mla_append_and_attend,
    mla_ragged_attention_plain,
    mla_rope_permute,
    new_mla_pages,
    store_mla_cache,
)
from parallax_tpu_torch.ops.mla_decode import (
    MAX_SPLITS,
    SPLIT_KEYS,
    mla_decode_attention,
    mla_decode_attention_plain,
    mla_num_splits_bound,
    mla_split_decode_plain,
    mla_split_ranges,
)

TOL = 2e-5
R, DR, HQ = 32, 8, 4
PAGE = 8
# Decode geometry: ragged lengths across page boundaries, a padding row
# (kv_len 0), page-exact rows (48, 16) and a frozen row (slot -1).
LENS = np.array([5, 17, 48, 0, 9, 16], np.int32)
FROZEN_ROW = 4


def t(a):
    return torch.from_numpy(np.asarray(a))


def _decode_geometry():
    s = len(LENS)
    pps = 6
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(LENS):
        npg = (int(n) + PAGE - 1) // PAGE
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    slot = np.full((s,), -1, np.int32)
    for i, n in enumerate(LENS):
        if n > 0 and i != FROZEN_ROW:
            slot[i] = pages[i, (n - 1) // PAGE] * PAGE + (n - 1) % PAGE
    return used + 1, pages, slot


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    num_pages, pages, slot = _decode_geometry()
    s = len(LENS)
    f = np.float32
    return dict(
        ql=rng.normal(size=(s, HQ, R)).astype(f),
        qp=rng.normal(size=(s, HQ, DR)).astype(f),
        lat=rng.normal(size=(s, R)).astype(f),
        kpe=rng.normal(size=(s, DR)).astype(f),
        cache=rng.normal(size=(num_pages, PAGE, 1, R + DR)).astype(f),
        lens=LENS, pages=pages, slot=slot,
    )


def test_store_mla_cache_bitwise():
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(6, PAGE, 1, R + DR)).astype(np.float32)
    lat = rng.normal(size=(5, R)).astype(np.float32)
    kpe = rng.normal(size=(5, DR)).astype(np.float32)
    slots = np.array([9, -1, 40, 3, -1], np.int32)
    ref = np.asarray(j_store(jnp.asarray(cache), jnp.asarray(lat),
                             jnp.asarray(kpe), jnp.asarray(slots)))
    got = t(cache.copy())
    out = store_mla_cache(got, t(lat), t(kpe), t(slots))
    assert out is got                      # in place
    assert np.array_equal(got.numpy(), ref)
    empty = new_mla_pages(3, PAGE, R, DR, torch.float32)
    assert empty.shape == (3, PAGE, 1, R + DR) and not empty.any()


def test_mla_rope_permute_exact():
    x = np.random.default_rng(1).normal(size=(7, 3, 16)).astype(np.float32)
    assert np.array_equal(mla_rope_permute(t(x)).numpy(),
                          np.asarray(j_rope_permute(jnp.asarray(x))))


def _ragged_case(seed):
    """Three sequences over 16-token pages, contexts up to 1,100 rows (3
    chunks of 512): a chunked-prefill continuation (5 new tokens at 1,100),
    a decode token at 700 and a 40-token prefill from 0; 46 real tokens in
    a 64-token bucket."""
    rng = np.random.default_rng(seed)
    page = 16
    ctx = [1100, 700, 40]
    new = [5, 1, 40]
    pps = 70
    s = len(ctx)
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(ctx):
        npg = -(-n // page)
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    cache = rng.normal(size=(used, page, 1, R + DR)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(new)]).astype(np.int32)
    tt = 64
    ql = rng.normal(size=(tt, HQ, R)).astype(np.float32)
    qp = rng.normal(size=(tt, HQ, DR)).astype(np.float32)
    return dict(ql=ql, qp=qp, cache=cache, lens=np.array(ctx, np.int32),
                pages=pages, cu=cu, nseq=np.array([s], np.int32),
                t_real=int(cu[-1]))


def test_ragged_attention_matches_xla_across_chunks():
    c = _ragged_case(2)
    ref = np.asarray(mla_ragged_attention_xla(
        jnp.asarray(c["ql"]), jnp.asarray(c["qp"]), jnp.asarray(c["cache"]),
        jnp.asarray(c["lens"]), jnp.asarray(c["pages"]), jnp.asarray(c["cu"]),
        jnp.asarray(c["nseq"]), sm_scale=0.17, kv_lora_rank=R,
    ))
    got = mla_ragged_attention_plain(
        t(c["ql"]), t(c["qp"]), t(c["cache"]), t(c["lens"]), t(c["pages"]),
        t(c["cu"]), t(c["nseq"]), sm_scale=0.17, kv_lora_rank=R,
    ).numpy()
    n = c["t_real"]
    np.testing.assert_allclose(got[:n], ref[:n], atol=TOL, rtol=TOL)


def _k7_case(seed, lens, hq):
    rng = np.random.default_rng(seed)
    s, pps = len(lens), 8
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(lens):
        npg = -(-n // 16)
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    cache = rng.normal(size=(used + 1, 16, 1, R + DR)).astype(np.float32)
    ql = rng.normal(size=(s, hq, R)).astype(np.float32)
    qp = rng.normal(size=(s, hq, DR)).astype(np.float32)
    return ql, qp, cache, np.array(lens, np.int32), pages


@pytest.mark.parametrize("lens", [[7], [64, 1], [13, 64, 0, 3],
                                  [100, 1, 57, 8]])
@pytest.mark.parametrize("hq", [4, 16])
def test_k7_split_decode_matches_pallas(lens, hq):
    ql, qp, cache, kl, pages = _k7_case(3, lens, hq)
    ref = np.asarray(mla_decode_attention_pallas(
        jnp.asarray(ql), jnp.asarray(qp), jnp.asarray(cache),
        jnp.asarray(kl), jnp.asarray(pages), sm_scale=0.25,
        kv_lora_rank=R, interpret=True,
    ))
    args = (t(ql), t(qp), t(cache), t(kl), t(pages))
    kw = dict(sm_scale=0.25, kv_lora_rank=R)
    plain = mla_decode_attention_plain(*args, **kw).numpy()
    wrapped = mla_decode_attention(*args, **kw).numpy()
    np.testing.assert_allclose(plain, ref, atol=TOL, rtol=TOL)
    assert np.array_equal(wrapped, plain)     # CPU tensors: the plain version
    for i, n in enumerate(lens):
        if n == 0:
            assert not plain[i].any()


def test_k4_fused_decode_matches_pallas():
    c = _decode_inputs(4)
    ref_out, ref_cache = mla_fused_decode_pallas(
        jnp.asarray(c["ql"]), jnp.asarray(c["qp"]), jnp.asarray(c["lat"]),
        jnp.asarray(c["kpe"]), jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["slot"]), sm_scale=0.17,
        kv_lora_rank=R, interpret=True,
    )
    ref_out, ref_cache = np.asarray(ref_out), np.asarray(ref_cache)
    for fn in (mla_fused_decode_plain, mla_fused_decode):
        cache = t(c["cache"].copy())
        out, cache_out = fn(
            t(c["ql"]), t(c["qp"]), t(c["lat"]), t(c["kpe"]), cache,
            t(c["lens"]), t(c["pages"]), t(c["slot"]), sm_scale=0.17,
            kv_lora_rank=R,
        )
        assert cache_out is cache
        assert np.array_equal(cache.numpy(), ref_cache)
        np.testing.assert_allclose(out.numpy(), ref_out, atol=TOL, rtol=TOL)
        assert not out[3].any()                      # kv_len 0 row
    # The frozen row appended nothing: its would-be slot keeps its value.
    n = int(LENS[FROZEN_ROW])
    page = int(c["pages"][FROZEN_ROW, (n - 1) // PAGE])
    before = c["cache"][page, (n - 1) % PAGE]
    assert np.array_equal(cache.numpy()[page, (n - 1) % PAGE], before)
    # Every live row's append landed.
    for i, sl in enumerate(c["slot"]):
        if sl >= 0:
            row = cache.numpy().reshape(-1, R + DR)[sl]
            assert np.array_equal(row, np.concatenate([c["lat"][i],
                                                       c["kpe"][i]]))


@pytest.mark.parametrize("route", ["fused", "split-kernel", "plain"])
def test_append_and_attend_routes_match_jax(route):
    c = _decode_inputs(5)
    s = len(LENS)
    cu = np.arange(s + 1, dtype=np.int32)
    nseq = np.array([s], np.int32)
    ref_out, ref_cache = j_append_and_attend(
        jnp.asarray(c["ql"]), jnp.asarray(c["qp"]), jnp.asarray(c["lat"]),
        jnp.asarray(c["kpe"]), jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(cu), jnp.asarray(nseq),
        jnp.asarray(c["slot"]), sm_scale=0.2, kv_lora_rank=R,
        decode_only=True, use_pallas=False,
    )
    cache = t(c["cache"].copy())
    out, _ = mla_append_and_attend(
        t(c["ql"]), t(c["qp"]), t(c["lat"]), t(c["kpe"]), cache,
        t(c["lens"]), t(c["pages"]), t(cu), t(nseq), t(c["slot"]),
        sm_scale=0.2, kv_lora_rank=R, decode_only=True,
        use_kernels=route == "split-kernel", decode_fused=route == "fused",
    )
    assert np.array_equal(cache.numpy(), np.asarray(ref_cache))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL,
                               rtol=TOL)


# A5 / A6's split-KV form: lengths across split and page boundaries at
# each page size (one split: <= 64 keys; the 16-split cap: 1,100 keys at
# page 8), kv_len 0 and 1.
SPLIT_LENS = [0, 1, 63, 64, 65, 130, 520, 1100]


def _split_case(seed, lens, page, hq=HQ):
    rng = np.random.default_rng(seed)
    s = len(lens)
    pps = max(-(-n // page) for n in lens) + 1
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(lens):
        npg = -(-n // page)
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    slot = np.full((s,), -1, np.int32)
    for i, n in enumerate(lens):
        if n > 0 and i != 2:                  # row 2 is frozen (slot -1)
            slot[i] = pages[i, (n - 1) // page] * page + (n - 1) % page
    f = np.float32
    return dict(
        ql=rng.normal(size=(s, hq, R)).astype(f),
        qp=rng.normal(size=(s, hq, DR)).astype(f),
        lat=rng.normal(size=(s, R)).astype(f),
        kpe=rng.normal(size=(s, DR)).astype(f),
        cache=rng.normal(size=(used + 1, page, 1, R + DR)).astype(f),
        lens=np.array(lens, np.int32), pages=pages, slot=slot,
    )


@pytest.mark.parametrize("page", [8, 16, 64])
def test_mla_split_form_matches_pallas(page):
    """A6's split-KV decomposition (split ranges, 32-key tiles, the ordered
    combine) in f32 against mla_decode_attention_pallas in interpret mode;
    rows with kv_len 0 give exact zeros."""
    c = _split_case(7, SPLIT_LENS, page)
    ref = np.asarray(mla_decode_attention_pallas(
        jnp.asarray(c["ql"]), jnp.asarray(c["qp"]), jnp.asarray(c["cache"]),
        jnp.asarray(c["lens"]), jnp.asarray(c["pages"]), sm_scale=0.2,
        kv_lora_rank=R, interpret=True,
    ))
    got = mla_split_decode_plain(
        t(c["ql"]), t(c["qp"]), t(c["cache"]), t(c["lens"]), t(c["pages"]),
        sm_scale=0.2, kv_lora_rank=R,
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    assert not got[0].any()


@pytest.mark.parametrize("page", [8, 64])
def test_mla_fused_split_form_matches_pallas(page):
    """A5's form: the append (a frozen row appends nothing), then the split
    decode, against mla_fused_decode_pallas in interpret mode."""
    c = _split_case(8, SPLIT_LENS, page)
    ref_out, ref_cache = mla_fused_decode_pallas(
        jnp.asarray(c["ql"]), jnp.asarray(c["qp"]), jnp.asarray(c["lat"]),
        jnp.asarray(c["kpe"]), jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["slot"]), sm_scale=0.13,
        kv_lora_rank=R, interpret=True,
    )
    cache = t(c["cache"].copy())
    store_mla_cache(cache, t(c["lat"]), t(c["kpe"]), t(c["slot"]))
    assert np.array_equal(cache.numpy(), np.asarray(ref_cache))
    got = mla_split_decode_plain(
        t(c["ql"]), t(c["qp"]), cache, t(c["lens"]), t(c["pages"]),
        sm_scale=0.13, kv_lora_rank=R,
    ).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_out), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("page", [1, 8, 16, 64, 128])
def test_mla_split_ranges_cover_each_row(page):
    """The splits of a row tile its pages [0, ceil(kv_len / page)) in
    order, each of at least SPLIT_KEYS keys but the last, at most
    MAX_SPLITS of them, and never more than the grid bound of the row's
    page table."""
    for n in [0, 1, 2, 63, 64, 65, 127, 300, 1024, 1100, 8192, 32768]:
        ranges = mla_split_ranges(n, page)
        pages = -(-n // page)
        assert len(ranges) <= MAX_SPLITS
        if not ranges:
            assert n == 0
            continue
        assert [lo for lo, _ in ranges] == [0] + [hi for _, hi in ranges][:-1]
        assert ranges[-1][1] == pages
        for lo, hi in ranges[:-1]:
            assert (hi - lo) * page >= SPLIT_KEYS
        for pps in (pages, pages + 3):
            if pps:
                assert len(ranges) <= mla_num_splits_bound(pps, page)
