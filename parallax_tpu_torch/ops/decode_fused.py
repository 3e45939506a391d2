"""Fused decode kernels, each a cache append plus the step's attention or
scoring in one launch (the ports of
``parallax_tpu/ops/decode_fused_pallas.py``):

- :func:`gqa_fused_decode`: KV append + GQA flash decode (A2,
  ``csrc/gqa_decode.cu``; ``gqa_fused_decode_pallas``);
- :func:`mla_fused_decode`: latent append + MLA flash decode (A5,
  ``csrc/mla_decode.cu``; ``mla_fused_decode_pallas``);
- :func:`indexer_scores_fused`: index-key append + DSA / MSA indexer scores
  (A7, ``csrc/indexer_scores.cu``; ``indexer_scores_fused_pallas``).

Each wrapper takes the plain PyTorch version beside it for CPU tensors;
CUDA tensors launch the kernel or raise. Caches are updated in place (the
JAX package donates them).
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops.attention import KERNEL_NEG, paged_attention_plain
from parallax_tpu_torch.ops.kv_cache_ops import reshape_and_cache

# Shapes the GQA attention kernels (csrc/attend.cuh) take.
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 32
SMEM_LIMIT = 227 * 1024
# The decode split partition of csrc/attend.cuh (kSplitKeys, kMaxSplits).
SPLIT_KEYS = 128
MAX_SPLITS = 32


def gqa_fused_decode_plain(
    q, k_new, v_new, kv_pages, kv_lens, page_indices, slot_mapping, sinks,
    *, sm_scale: float, sliding_window: int | None = None,
    soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: append each row's new K/V (slot < 0 skipped), then
    attend with one query token per row at position ``kv_len - 1``; sinks
    seed the running max/denominator as the kernel does; rows with
    ``kv_len = 0`` give zeros."""
    reshape_and_cache(kv_pages, k_new, v_new, slot_mapping)
    s = q.shape[0]
    cu = torch.arange(s + 1, dtype=torch.int32, device=q.device)
    out = paged_attention_plain(
        q, kv_pages, kv_lens, page_indices, cu,
        sm_scale=sm_scale, sliding_window=sliding_window, soft_cap=soft_cap,
        sinks=sinks, seed_sinks=True, mask_value=KERNEL_NEG,
    )
    return out, kv_pages


def split_ranges(kv_len: int, page: int,
                 window: int | None = None) -> list[tuple[int, int]]:
    """The page ranges ``[lo, hi)`` of one row's decode splits, as
    ``split_range`` in csrc/attend.cuh cuts them: runs of at least
    ``SPLIT_KEYS`` keys and at most ``MAX_SPLITS`` runs, from the window's
    first page ``max(kv_len - W, 0) // page`` to the row's last page. They
    depend on the page size, the window and ``kv_len`` alone, never on the
    batch, so a row's bits do not depend on its batch-mates."""
    if kv_len <= 0:
        return []
    hi_page = -(-kv_len // page)
    lo_page = max(kv_len - window, 0) // page if window else 0
    n = hi_page - lo_page
    per = max(-(-SPLIT_KEYS // page), -(-n // MAX_SPLITS))
    return [(lo, min(lo + per, hi_page)) for lo in range(lo_page, hi_page, per)]


def num_splits_bound(pages_per_seq: int, page: int) -> int:
    """The most splits a row of ``pages_per_seq`` pages can have: the
    decode grid's third dimension."""
    return max(1, min(MAX_SPLITS, -(-pages_per_seq // -(-SPLIT_KEYS // page))))


def split_scratch(rows: int, hkv: int, group: int, d: int, page_indices,
                  page: int) -> tuple[torch.Tensor, int]:
    """The f32 scratch of the split partials, ``[rows, hkv, splits, group,
    d + 2]`` flattened (o, then (m, l) per head), and the split count."""
    splits = num_splits_bound(page_indices.shape[1], page)
    scratch = torch.empty(rows * hkv * splits * group * (d + 2),
                          dtype=torch.float32, device=page_indices.device)
    return scratch, splits


def gqa_split_decode_plain(
    q, kv_pages, kv_lens, page_indices, sinks, *, sm_scale: float,
    sliding_window: int | None = None, soft_cap: float | None = None,
    pad_splits: bool = False,
) -> torch.Tensor:
    """The split-KV form of the decode kernels' arithmetic, for the tests:
    per row and split (:func:`split_ranges`), an online softmax over
    64-position key tiles (numerators rounded to the value dtype before the
    PV product), then the splits combined in order with the sinks folded in
    once, as a virtual key of logit ``sink`` and no value. ``pad_splits``
    appends empty splits up to the grid's bound, which must fold in
    nothing. Returns ``[S, Hq, D]``."""
    s_rows, hq, d = q.shape
    _, page, combined, _ = kv_pages.shape
    hkv = combined // 2
    g = hq // hkv
    bound = num_splits_bound(page_indices.shape[1], page)
    out = torch.zeros((s_rows, hkv, g, d), dtype=torch.float32)
    for s in range(s_rows):
        n = int(kv_lens[s])
        qs = q[s].float().reshape(hkv, g, d)
        rows = kv_pages[page_indices[s].long()].reshape(-1, combined, d)
        parts = []
        for lo, hi in split_ranges(n, page, sliding_window):
            m = torch.full((hkv, g), KERNEL_NEG)
            l = torch.zeros((hkv, g))
            o = torch.zeros((hkv, g, d))
            end = min(hi * page, n)
            for p0 in range(lo * page, end, 64):
                pos = torch.arange(p0, min(p0 + 64, end))
                k = rows[pos, 0::2].float()                 # [L, Hkv, D]
                v = rows[pos, 1::2]
                x = torch.einsum("hgd,lhd->hgl", qs, k) * sm_scale
                if soft_cap is not None:
                    x = soft_cap * torch.tanh(x / soft_cap)
                valid = torch.ones_like(pos, dtype=torch.bool)
                if sliding_window is not None:
                    valid = pos > n - 1 - sliding_window
                x = torch.where(valid, x, -torch.inf)
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(valid, torch.exp(x - m_new[..., None]), 0.0)
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum(
                    "hgl,lhd->hgd", p.to(v.dtype).float(), v.float())
                m = m_new
            parts.append((m, l, o))
        while pad_splits and len(parts) < bound:
            parts.append((torch.full((hkv, g), KERNEL_NEG),
                          torch.zeros((hkv, g)), torch.zeros((hkv, g, d))))
        # The combine: m the largest of the splits' maxima and the sink,
        # each split weighed by e_k = exp(m_k - m), summed in split order.
        sink = (sinks.float().reshape(hkv, g) if sinks is not None
                else torch.full((hkv, g), -torch.inf))
        m = sink
        for mk, _, _ in parts:
            m = torch.maximum(m, mk)
        l = torch.exp(sink - m) if sinks is not None else torch.zeros((hkv, g))
        o = torch.zeros((hkv, g, d))
        for mk, lk, ok in parts:
            e = torch.exp(mk - m)
            l = l + lk * e
            o = o + ok * e[..., None]
        out[s] = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(s_rows, hq, d).to(q.dtype)


def check_attention_shapes(name, q, kv_pages, sinks) -> tuple[int, int, int]:
    """Shared argument checks of the two attention kernels; returns
    ``(hq, hkv, d)``."""
    if kv_pages.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"{name}: cache dtype {kv_pages.dtype} not supported; the kernel "
            "takes q and kv_pages both bfloat16 or both float32"
        )
    if q.dtype != kv_pages.dtype:
        raise TypeError(
            f"{name}: q is {q.dtype} but the cache is {kv_pages.dtype}; the "
            "kernel takes both bfloat16 or both float32"
        )
    _, page, combined, d = kv_pages.shape
    hq = q.shape[1]
    hkv = combined // 2
    if q.shape[2] != d or hq % hkv:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} does not fit the cache "
            f"{tuple(kv_pages.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{name}: head_dim {d} not taken; the kernels are built for "
            f"head dims {HEAD_DIMS}"
        )
    if kv_pages.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError(f"{name}: q and the cache must be 16-byte aligned "
                         "(the kernel stages them with 16-byte copies)")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"{name}: group size {hq // hkv} > {MAX_GROUP}")
    if sinks is not None and (
        sinks.dtype != torch.float32 or sinks.shape != (hq,)
    ):
        raise ValueError(f"{name}: sinks must be f32[{hq}]")
    return hq, hkv, d


def check_decode_args(name, q, kv_pages, kv_lens, page_indices,
                      sinks) -> tuple[int, int, int]:
    """The checks shared by the two decode kernels (A2, A9; grid (S, Hkv,
    splits), one query token per row); returns ``(hq, hkv, d)``."""
    hq, hkv, d = check_attention_shapes(name, q, kv_pages, sinks)
    s = q.shape[0]
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (s,):
        raise ValueError(f"{name}: kv_lens must be i32[{s}]")
    if page_indices.dtype != torch.int32 or page_indices.shape[0] != s:
        raise ValueError(f"{name}: page_indices must be i32[S, pps]")
    return hq, hkv, d


def ring_stages(d: int, elem: int) -> int:
    """Stages of the cp.async ring (csrc/attend.cuh ``Shape::kRing``): two,
    one for f32 at D > 128 (two would not fit the block's shared
    memory)."""
    return 1 if elem == 4 and d > 128 else 2


def tile_rows(d: int, elem: int) -> int:
    """Query rows of a multi-token tile (``Shape::kRows``): eight warps of
    16, four for f32 at D > 128."""
    return 64 if elem == 4 and d > 128 else 128


def smem_bytes(rows: int, d: int, elem: int) -> int:
    """Dynamic shared memory of a block of the attention core
    (csrc/attend.cuh ``attn_smem_bytes``): ``rows`` query rows, then
    :func:`ring_stages` stages of a 64-key K tile and V tile, every row
    padded by 16 bytes. Decode blocks hold 16 or 32 rows, multi-token tiles
    :func:`tile_rows`."""
    return (rows + 2 * ring_stages(d, elem) * 64) * (d * elem + 16)


def gqa_fused_decode(
    q: torch.Tensor,             # [S, Hq, D] — ONE query token per row
    k_new: torch.Tensor,         # [S, Hkv, D] this step's keys (rope'd)
    v_new: torch.Tensor,         # [S, Hkv, D]
    kv_pages: torch.Tensor,      # [P, page, 2*Hkv, D], updated in place
    kv_lens: torch.Tensor,       # i32[S] INCLUDING the new token
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    slot_mapping: torch.Tensor,  # i32[S]; < 0 = no append
    sinks: torch.Tensor | None,  # f32[Hq] or None
    *,
    sm_scale: float,
    sliding_window: int | None = None,
    soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused KV append + GQA flash decode (A2: split-KV, then the ordered
    combine; one count per call). Returns ``(out [S, Hq, D], kv_pages)``."""
    if q.device.type == "cpu":
        return gqa_fused_decode_plain(
            q, k_new, v_new, kv_pages, kv_lens, page_indices, slot_mapping,
            sinks, sm_scale=sm_scale, sliding_window=sliding_window,
            soft_cap=soft_cap,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck

    hq, hkv, d = check_decode_args("gqa_decode", q, kv_pages, kv_lens,
                                   page_indices, sinks)
    s = q.shape[0]
    num_pages, page, _, _ = kv_pages.shape
    k_new = k_new.to(kv_pages.dtype).contiguous()
    v_new = v_new.to(kv_pages.dtype).contiguous()
    if k_new.shape != (s, hkv, d) or v_new.shape != (s, hkv, d):
        raise ValueError("gqa_decode: k_new/v_new must be [S, Hkv, D]")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (s,):
        raise ValueError(f"gqa_decode: slot_mapping must be i32[{s}]")
    tensors = [q, k_new, v_new, kv_pages, kv_lens, page_indices, slot_mapping]
    if sinks is not None:
        tensors.append(sinks)
    ck.require_cuda("gqa_decode", *tensors)
    out = torch.empty_like(q)
    scratch, splits = split_scratch(s, hkv, hq // hkv, d, page_indices, page)
    code = ck.lib().pk_gqa_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kv_pages.data_ptr(),
        out.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
        slot_mapping.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, scratch.data_ptr(),
        s, hq, hkv, d, page, page_indices.shape[1], splits, num_pages * page,
        sliding_window or 0, float(sm_scale), float(soft_cap or 0.0),
        ck.dtype_code(kv_pages), ck.stream_of(q),
    )
    ck.check(code, "gqa_decode")
    ck.count("gqa_decode")
    return out, kv_pages


# -- MLA: latent append + flash decode (A5) ---------------------------------


def mla_fused_decode_plain(
    q_latent, q_pe, latent_new, k_pe_new, cache, kv_lens, page_indices,
    slot_mapping, *, sm_scale: float, kv_lora_rank: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of A5: scatter each row's ``[latent ‖ k_pe]``
    (slot < 0 skipped), then MLA decode over the row's context."""
    from parallax_tpu_torch.ops.mla import store_mla_cache
    from parallax_tpu_torch.ops.mla_decode import mla_decode_attention_plain

    store_mla_cache(cache, latent_new, k_pe_new, slot_mapping)
    out = mla_decode_attention_plain(
        q_latent, q_pe, cache, kv_lens, page_indices,
        sm_scale=sm_scale, kv_lora_rank=kv_lora_rank,
    )
    return out, cache


def mla_fused_decode(
    q_latent: torch.Tensor,      # [S, Hq, R] — ONE query token per row
    q_pe: torch.Tensor,          # [S, Hq, Dr]
    latent_new: torch.Tensor,    # [S, R] this step's compressed latent
    k_pe_new: torch.Tensor,      # [S, Dr] this step's rope key
    cache: torch.Tensor,         # [P, page, 1, R + Dr], updated in place
    kv_lens: torch.Tensor,       # i32[S] INCLUDING the new token
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    slot_mapping: torch.Tensor,  # i32[S]; < 0 = no append
    *,
    sm_scale: float,
    kv_lora_rank: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The A5 wrapper (``csrc/mla_decode.cu``), the port of
    ``mla_fused_decode_pallas``: latent append + MLA flash decode. Returns
    ``(out [S, Hq, R], cache)``."""
    if q_latent.device.type == "cpu":
        return mla_fused_decode_plain(
            q_latent, q_pe, latent_new, k_pe_new, cache, kv_lens,
            page_indices, slot_mapping, sm_scale=sm_scale,
            kv_lora_rank=kv_lora_rank,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops.mla_decode import check_mla_args, mla_scratch

    s, hq, r, dr = check_mla_args("mla_decode", q_latent, q_pe, cache,
                                  kv_lens, page_indices, kv_lora_rank)
    if latent_new.shape != (s, r) or k_pe_new.shape != (s, dr):
        raise ValueError("mla_decode: latent_new/k_pe_new must be [S, R] / "
                         "[S, Dr]")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (s,):
        raise ValueError(f"mla_decode: slot_mapping must be i32[{s}]")
    latent_new = latent_new.to(cache.dtype).contiguous()
    k_pe_new = k_pe_new.to(cache.dtype).contiguous()
    q_latent, q_pe = q_latent.contiguous(), q_pe.contiguous()
    ck.require_cuda("mla_decode", q_latent, q_pe, latent_new, k_pe_new,
                    cache, kv_lens, page_indices, slot_mapping)
    num_pages, page = cache.shape[:2]
    out = torch.empty_like(q_latent)
    scratch, splits = mla_scratch(s, hq, r, page_indices, page)
    code = ck.lib().pk_mla_decode(
        q_latent.data_ptr(), q_pe.data_ptr(), latent_new.data_ptr(),
        k_pe_new.data_ptr(), cache.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), page_indices.data_ptr(), slot_mapping.data_ptr(),
        scratch.data_ptr(), s, hq, r, dr, page, page_indices.shape[1],
        splits, num_pages * page,
        float(sm_scale), ck.dtype_code(cache), ck.stream_of(q_latent),
    )
    ck.check(code, "mla_decode")
    ck.count("mla_decode")
    return out, cache


# -- DSA / MSA indexer: index-key append + scores (A7) ----------------------


def indexer_scores_fused_plain(
    q, weights, k_new, index_cache, kv_lens, page_indices, slot_mapping, *,
    reduce_kind: str, sm_scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of A7: scatter each row's index key (slot < 0
    skipped), then score every page slot of the row."""
    from parallax_tpu_torch.ops.dsa import store_index_cache
    from parallax_tpu_torch.ops.dsa_decode import (
        paged_token_scores_decode_plain,
    )

    store_index_cache(index_cache, k_new, slot_mapping)
    scores = paged_token_scores_decode_plain(
        q, weights, index_cache, kv_lens, page_indices,
        reduce_kind=reduce_kind, sm_scale=sm_scale,
    )
    return scores, index_cache


def indexer_scores_fused(
    q: torch.Tensor,             # [S, Hi, D] — ONE query token per row
    weights: torch.Tensor | None,  # f32[S, Hi] (DSA) or None (MSA)
    k_new: torch.Tensor,         # [S, D] this step's index key
    index_cache: torch.Tensor,   # [P, page, 1, D], updated in place
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    slot_mapping: torch.Tensor,  # i32[S]; < 0 = no append
    *,
    reduce_kind: str,            # "dsa" | "msa"
    sm_scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The A7 wrapper (``csrc/indexer_scores.cu``), the port of
    ``indexer_scores_fused_pallas``: index-key append + per-token scores.
    Returns ``(scores f32[S, pages_per_seq * page], index_cache)`` with
    exact ``-inf`` at and past each row's ``kv_len``."""
    if q.device.type == "cpu":
        return indexer_scores_fused_plain(
            q, weights, k_new, index_cache, kv_lens, page_indices,
            slot_mapping, reduce_kind=reduce_kind, sm_scale=sm_scale,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops.dsa_decode import (
        REDUCE_KINDS,
        aligned_rows,
        check_indexer_args,
        indexer_blocks,
    )

    s, hi, d = check_indexer_args("indexer_fused", q, weights, index_cache,
                                  kv_lens, page_indices, reduce_kind)
    k_new = aligned_rows("indexer_fused", k_new.to(index_cache.dtype))
    if k_new.shape != (s, d):
        raise ValueError(f"indexer_fused: k_new must be [{s}, {d}]")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (s,):
        raise ValueError(f"indexer_fused: slot_mapping must be i32[{s}]")
    q = aligned_rows("indexer_fused", q)
    tensors = [q, k_new, index_cache, kv_lens, page_indices, slot_mapping]
    if weights is not None:
        weights = weights.contiguous()
        tensors.append(weights)
    ck.require_cuda("indexer_fused", *tensors)
    num_pages, page = index_cache.shape[:2]
    pps = page_indices.shape[1]
    scores = torch.empty((s, pps * page), dtype=torch.float32,
                         device=q.device)
    code = ck.lib().pk_indexer_fused(
        q.data_ptr(), weights.data_ptr() if weights is not None else None,
        k_new.data_ptr(), index_cache.data_ptr(), scores.data_ptr(),
        kv_lens.data_ptr(), page_indices.data_ptr(), slot_mapping.data_ptr(),
        s, hi, d, page, pps, indexer_blocks(s, pps), num_pages * page,
        REDUCE_KINDS[reduce_kind],
        float(sm_scale), ck.dtype_code(index_cache), ck.stream_of(q),
    )
    ck.check(code, "indexer_fused")
    ck.count("indexer_fused")
    return scores, index_cache
