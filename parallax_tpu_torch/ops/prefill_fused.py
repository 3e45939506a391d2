"""Fused ragged chunked prefill: the port of
``parallax_tpu/ops/prefill_fused_pallas.py::gqa_fused_prefill_pallas``.

The TPU kernel appends each query block's K/V inside the same program and
relies on its grid running in order, so later blocks see keys earlier
blocks appended. GPU blocks run concurrently in no order, so the port splits
the work into two launches on one stream: A0 (``kv_append``, the whole
chunk's K/V into the cache) and then A1 (``csrc/gqa_prefill.cu``), an
attend-only ragged flash attention. Stream order makes every appended key
visible to A1. With ``k_new=None`` (attend-only mode) A0 is skipped.

:func:`gqa_fused_prefill` is the wrapper: CPU tensors take the plain PyTorch
version beside it; CUDA tensors launch the kernels or raise. The cache is
updated in place (the JAX package donates it).
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops.attention import KERNEL_NEG, paged_attention_plain
from parallax_tpu_torch.ops.decode_fused import (
    check_attention_shapes,
    split_scratch,
    tile_rows,
)
from parallax_tpu_torch.ops.kv_cache_ops import kv_append, reshape_and_cache

# (token, head) rows of a multi-token tile: eight warps of 16 (csrc/attend.cuh
# kTileRows; ``decode_fused.tile_rows`` gives each shape's).
MAX_TILE_ROWS = 128


def q_tile_for(group: int, rows: int = MAX_TILE_ROWS) -> int:
    """Query tokens per multi-token tile: as many as fill its ``rows``."""
    return max(1, rows // group)


def gqa_prefill_attend_plain(
    q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, sinks,
    *, sm_scale: float, sliding_window: int | None = None,
    soft_cap: float | None = None,
) -> torch.Tensor:
    """The plain version of A1: ragged causal attention over each row's full
    context, sinks seeded as in the kernel, exact zeros for tokens at or
    past ``cu_q_lens[num_seqs]``."""
    out = paged_attention_plain(
        q, kv_pages, kv_lens, page_indices, cu_q_lens,
        sm_scale=sm_scale, sliding_window=sliding_window, soft_cap=soft_cap,
        sinks=sinks, seed_sinks=True, mask_value=KERNEL_NEG,
    )
    live_end = cu_q_lens.long()[num_seqs.long()[0]]
    live = torch.arange(q.shape[0], device=q.device) < live_end
    return torch.where(live[:, None, None], out, torch.zeros_like(out))


def gqa_fused_prefill_plain(
    q, k_new, v_new, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
    slot_mapping, sinks, *, sm_scale: float,
    sliding_window: int | None = None, soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the A0 + A1 pair."""
    if k_new is not None:
        reshape_and_cache(kv_pages, k_new, v_new, slot_mapping)
    out = gqa_prefill_attend_plain(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, sinks,
        sm_scale=sm_scale, sliding_window=sliding_window, soft_cap=soft_cap,
    )
    return out, kv_pages


def gqa_prefill_attend(
    q: torch.Tensor,             # [T, Hq, D] flattened ragged query tokens
    kv_pages: torch.Tensor,      # [P, page, 2*Hkv, D] (chunk K/V appended)
    kv_lens: torch.Tensor,       # i32[S] FULL context length per row
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,     # i32[S+1]
    num_seqs: torch.Tensor,      # i32[1]
    sinks: torch.Tensor | None,  # f32[Hq] or None
    *,
    sm_scale: float,
    sliding_window: int | None = None,
    soft_cap: float | None = None,
) -> torch.Tensor:
    """The A1 wrapper: attend-only ragged prefill attention. Multi-token
    sequences run per-sequence tensor-core tiles; one-token sequences run
    A2's split-KV decode and combine (so a decode row gives A2's bits).
    One count per call."""
    if q.device.type == "cpu":
        return gqa_prefill_attend_plain(
            q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, sinks,
            sm_scale=sm_scale, sliding_window=sliding_window,
            soft_cap=soft_cap,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck

    hq, hkv, d = check_attention_shapes("gqa_prefill", q, kv_pages, sinks)
    t = q.shape[0]
    s = kv_lens.shape[0]
    _, page, _, _ = kv_pages.shape
    if kv_lens.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("gqa_prefill: kv_lens/page_indices must be int32")
    if cu_q_lens.dtype != torch.int32 or cu_q_lens.shape != (s + 1,):
        raise ValueError(f"gqa_prefill: cu_q_lens must be i32[{s + 1}]")
    if num_seqs.dtype != torch.int32 or num_seqs.numel() != 1:
        raise ValueError("gqa_prefill: num_seqs must be i32[1]")
    if page_indices.shape[0] != s:
        raise ValueError("gqa_prefill: page_indices must be i32[S, pps]")
    tensors = [q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs]
    if sinks is not None:
        tensors.append(sinks)
    ck.require_cuda("gqa_prefill", *tensors)
    out = torch.empty_like(q)
    g = hq // hkv
    scratch, splits = split_scratch(s, hkv, g, d, page_indices, page)
    code = ck.lib().pk_gqa_prefill(
        q.data_ptr(), kv_pages.data_ptr(), out.data_ptr(),
        kv_lens.data_ptr(), page_indices.data_ptr(), cu_q_lens.data_ptr(),
        num_seqs.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, scratch.data_ptr(),
        t, s, hq, hkv, d, page, page_indices.shape[1],
        q_tile_for(g, tile_rows(d, kv_pages.element_size())), splits,
        sliding_window or 0, float(sm_scale), float(soft_cap or 0.0),
        ck.dtype_code(kv_pages), ck.stream_of(q),
    )
    ck.check(code, "gqa_prefill")
    ck.count("gqa_prefill")
    return out


def gqa_fused_prefill(
    q: torch.Tensor,
    k_new: torch.Tensor | None,  # [T, Hkv, D], or None: attend only
    v_new: torch.Tensor | None,
    kv_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    slot_mapping: torch.Tensor,  # i32[T]; < 0 = no append for that token
    sinks: torch.Tensor | None,
    *,
    sm_scale: float,
    sliding_window: int | None = None,
    soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """KV append (A0, unless attend-only) then ragged flash prefill (A1).
    Returns ``(out [T, Hq, D], kv_pages)``."""
    if q.device.type == "cpu":
        return gqa_fused_prefill_plain(
            q, k_new, v_new, kv_pages, kv_lens, page_indices, cu_q_lens,
            num_seqs, slot_mapping, sinks, sm_scale=sm_scale,
            sliding_window=sliding_window, soft_cap=soft_cap,
        )
    if k_new is not None:
        kv_append(kv_pages, k_new, v_new, slot_mapping)
    out = gqa_prefill_attend(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, sinks,
        sm_scale=sm_scale, sliding_window=sliding_window, soft_cap=soft_cap,
    )
    return out, kv_pages
