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

MAX_HEAD_DIM = 256
SMEM_LIMIT = 227 * 1024


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
    if d > MAX_HEAD_DIM or (d * kv_pages.element_size()) % 16:
        raise ValueError(
            f"{name}: head_dim {d} must be <= 256 with rows a multiple of "
            "16 bytes (the kernel stages pages with 16-byte loads)"
        )
    if kv_pages.data_ptr() % 16:
        raise ValueError(f"{name}: the cache must be 16-byte aligned")
    if hq // hkv > 64:
        raise ValueError(f"{name}: group size {hq // hkv} > 64")
    if sinks is not None and (
        sinks.dtype != torch.float32 or sinks.shape != (hq,)
    ):
        raise ValueError(f"{name}: sinks must be f32[{hq}]")
    return hq, hkv, d


def check_decode_args(name, q, kv_pages, kv_lens, page_indices,
                      sinks) -> tuple[int, int, int]:
    """The checks shared by the two decode kernels (A2, A9; grid (S, Hkv),
    one query token per row); returns ``(hq, hkv, d)``."""
    hq, hkv, d = check_attention_shapes(name, q, kv_pages, sinks)
    s = q.shape[0]
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (s,):
        raise ValueError(f"{name}: kv_lens must be i32[{s}]")
    if page_indices.dtype != torch.int32 or page_indices.shape[0] != s:
        raise ValueError(f"{name}: page_indices must be i32[S, pps]")
    maxr = 16 if hq // hkv <= 16 else 64
    if smem_bytes(hq // hkv, maxr, d, kv_pages.shape[1],
                  kv_pages.element_size()) > SMEM_LIMIT:
        raise ValueError(f"{name}: page size {kv_pages.shape[1]} too large")
    return hq, hkv, d


def smem_bytes(rows: int, maxr: int, d: int, page: int, elem: int) -> int:
    """Dynamic shared memory of the streaming core (csrc/attend.cuh)."""
    def a16(n):
        return (n + 15) // 16 * 16

    kw = d * elem // 4
    return (a16(page * (kw + 1) * 4) + a16(page * kw * 4) + a16(rows * d * 4)
            + a16(rows * (page + 1) * 4) + 3 * a16(maxr * 4))


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
    """Fused KV append + GQA flash decode. Returns ``(out [S, Hq, D],
    kv_pages)``."""
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
    code = ck.lib().pk_gqa_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kv_pages.data_ptr(),
        out.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
        slot_mapping.data_ptr(),
        sinks.data_ptr() if sinks is not None else None,
        s, hq, hkv, d, page, page_indices.shape[1], num_pages * page,
        sliding_window or 0, float(sm_scale), float(soft_cap or 0.0),
        ck.dtype_code(kv_pages), ck.stream_of(q),
    )
    ck.check(code, "gqa_decode")
    ck.LAUNCHES["gqa_decode"] += 1
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
    from parallax_tpu_torch.ops.mla_decode import check_mla_args

    s, hq, r, dr = check_mla_args("mla_decode", q_latent, q_pe, cache,
                                  kv_lens, page_indices, kv_lora_rank)
    rows = torch.cat([latent_new, k_pe_new], dim=-1).to(cache.dtype)
    if rows.shape != (s, r + dr):
        raise ValueError("mla_decode: latent_new/k_pe_new must be [S, R] / "
                         "[S, Dr]")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (s,):
        raise ValueError(f"mla_decode: slot_mapping must be i32[{s}]")
    q_latent, q_pe, rows = (q_latent.contiguous(), q_pe.contiguous(),
                            rows.contiguous())
    ck.require_cuda("mla_decode", q_latent, q_pe, rows, cache, kv_lens,
                    page_indices, slot_mapping)
    num_pages, page = cache.shape[:2]
    out = torch.empty_like(q_latent)
    code = ck.lib().pk_mla_decode(
        q_latent.data_ptr(), q_pe.data_ptr(), rows.data_ptr(),
        cache.data_ptr(), out.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(), slot_mapping.data_ptr(),
        s, hq, r, dr, page, page_indices.shape[1], num_pages * page,
        float(sm_scale), ck.dtype_code(cache), ck.stream_of(q_latent),
    )
    ck.check(code, "mla_decode")
    ck.LAUNCHES["mla_decode"] += 1
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
        check_indexer_args,
    )

    s, hi, d = check_indexer_args("indexer_fused", q, weights, index_cache,
                                  kv_lens, page_indices, reduce_kind)
    k_new = k_new.to(index_cache.dtype).contiguous()
    if k_new.shape != (s, d):
        raise ValueError(f"indexer_fused: k_new must be [{s}, {d}]")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (s,):
        raise ValueError(f"indexer_fused: slot_mapping must be i32[{s}]")
    q = q.contiguous()
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
        s, hi, d, page, pps, num_pages * page, REDUCE_KINDS[reduce_kind],
        float(sm_scale), ck.dtype_code(index_cache), ck.stream_of(q),
    )
    ck.check(code, "indexer_fused")
    ck.LAUNCHES["indexer_fused"] += 1
    return scores, index_cache
