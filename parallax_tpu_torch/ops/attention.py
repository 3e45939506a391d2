"""Ragged paged attention: the single attention op for prefill, chunked
prefill, decode and mixed batches (port of ``parallax_tpu/ops/attention.py``).

Queries of every sequence in the step are flattened into one
``[num_tokens, num_q_heads, head_dim]`` tensor; keys/values are always read
from the paged cache, so prefix-cache hits and chunked prefill need no
special path. ``append_and_attend`` routes a batch to the fused decode
kernel, the fused prefill kernel, or the split path (cache scatter, then
:func:`ragged_paged_attention`, which runs a split kernel or plain PyTorch
by the JAX package's branch table).
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops import kernel_select
from parallax_tpu_torch.ops.kv_cache_ops import reshape_and_cache
from parallax_tpu_torch.ops.ragged import (
    page_chunks,
    ragged_token_positions,
    row_slices,
)

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# The kernels' (and the TPU kernels') running-max floor for masked scores.
KERNEL_NEG = -1e30


def append_and_attend(
    q: torch.Tensor,             # [T, num_q_heads, head_dim]
    k: torch.Tensor,             # [T, num_kv_heads, head_dim] (pre-rope'd)
    v: torch.Tensor,             # [T, num_kv_heads, head_dim]
    kv_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    slot_mapping: torch.Tensor,  # i32[T]; < 0 = padding, not written
    *,
    sm_scale: float = 1.0,
    sliding_window: int | None = None,
    soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,
    use_kernels: bool | None = None,
    decode_only: bool = False,
    decode_fused: bool = False,
    prefill_fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write this step's K/V into the paged cache (in place) and attend.

    ``decode_fused`` on a decode-only batch (one query token per sequence)
    runs the fused decode kernel (append inside the attention kernel);
    ``prefill_fused`` runs the prefill kernel pair (append, then ragged
    flash attention) for every multi-token shape. With both off: the split
    path, whose attention takes a split kernel per ``use_kernels``.
    Returns ``(out, kv_pages)``.
    """
    kw = dict(sm_scale=sm_scale, sliding_window=sliding_window,
              soft_cap=soft_cap)
    if decode_fused and decode_only and q.shape[0] == kv_lens.shape[0]:
        from parallax_tpu_torch.ops.decode_fused import gqa_fused_decode

        return gqa_fused_decode(
            q, k, v, kv_pages, kv_lens, page_indices, slot_mapping, sinks,
            **kw,
        )
    if prefill_fused:
        from parallax_tpu_torch.ops.prefill_fused import gqa_fused_prefill

        return gqa_fused_prefill(
            q, k, v, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
            slot_mapping, sinks, **kw,
        )
    reshape_and_cache(kv_pages, k, v, slot_mapping)
    out = ragged_paged_attention(
        q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        sinks=sinks, use_kernels=use_kernels, decode_only=decode_only, **kw,
    )
    return out, kv_pages


def ragged_paged_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    *,
    sm_scale: float = 1.0,
    sliding_window: int | None = None,
    soft_cap: float | None = None,
    sinks: torch.Tensor | None = None,
    use_kernels: bool | None = None,
    decode_only: bool = False,
) -> torch.Tensor:
    """The split path's attention, routed as the JAX package routes it
    (``parallax_tpu/ops/attention.py:175-239``). With kernels on
    (``use_kernels``; None = when the tensors are on CUDA):
    - sinks on a decode-only batch: the split decode kernel (A9, the
      counterpart of ``gqa_decode_attention_pallas``), which takes no soft
      cap, as the JAX branch passes none;
    - anything else (sinks on a multi-token batch, and every batch without
      sinks, the bundled ``ragged_paged_attention``'s share): the prefill
      kernel in attend-only mode (A1), exact zeros on bucket padding.
    With kernels off: :func:`paged_attention_plain`, the plain twin of
    ``_ragged_paged_attention_xla``.

    Args:
      q: [T, num_q_heads, head_dim] — all sequences' query tokens.
      kv_pages: [P, page_size, 2*num_kv_heads, head_dim]; this step's K/V
        must already be written.
      kv_lens: i32[S] total context length per sequence (incl. this step).
      page_indices: i32[S, pages_per_seq].
      cu_q_lens: i32[S+1] cumulative query lengths.
      num_seqs: i32[1] live sequence count (unused by the plain math: rows
        past it carry kv_len 0 and empty query spans).
      sinks: optional f32[num_q_heads] sink logits, joining the softmax at
        the end with no value payload.
    """
    if kernel_select.resolve_use_kernels(use_kernels, q.device):
        one_per_row = decode_only and q.shape[0] == kv_lens.shape[0]
        if sinks is not None and one_per_row:
            from parallax_tpu_torch.ops.gqa_decode import gqa_decode_attention

            return gqa_decode_attention(
                q, kv_pages, kv_lens, page_indices, sinks, sm_scale=sm_scale,
                sliding_window=sliding_window,
            )
        from parallax_tpu_torch.ops.prefill_fused import gqa_prefill_attend

        return gqa_prefill_attend(
            q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs, sinks,
            sm_scale=sm_scale, sliding_window=sliding_window,
            soft_cap=soft_cap,
        )
    return paged_attention_plain(
        q, kv_pages, kv_lens, page_indices, cu_q_lens,
        sm_scale=sm_scale, sliding_window=sliding_window, soft_cap=soft_cap,
        sinks=sinks, seed_sinks=False, mask_value=_MASK_VALUE,
    )


def paged_attention_plain(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    *,
    sm_scale: float,
    sliding_window: int | None,
    soft_cap: float | None,
    sinks: torch.Tensor | None,
    seed_sinks: bool,
    mask_value: float,
) -> torch.Tensor:
    """Page-chunked online softmax over the paged cache, vectorised over the
    tokens of the batch: GQA, causal over each row's full ``kv_lens``,
    sliding window, soft cap, sinks. Scores and accumulators are f32; the
    softmax numerators are cast to the value dtype before the PV product,
    as the JAX package does. ``seed_sinks`` seeds the running max and
    denominator with the sink (the kernels' form) instead of adding it at
    the end (the XLA path's form); the two agree to rounding."""
    t, num_q_heads, head_dim = q.shape
    num_kv_heads = kv_pages.shape[2] // 2
    s, _ = page_indices.shape
    seq_of_tok, q_pos = ragged_token_positions(kv_lens, cu_q_lens, t, s)
    qg = q.float().reshape(t, num_kv_heads, num_q_heads // num_kv_heads,
                           head_dim)
    kw = dict(sm_scale=sm_scale, sliding_window=sliding_window,
              soft_cap=soft_cap, sinks=sinks, seed_sinks=seed_sinks,
              mask_value=mask_value)
    out = torch.cat([
        _attend_rows(qg[sl], kv_pages, kv_lens, page_indices,
                     seq_of_tok[sl], q_pos[sl], **kw)
        for sl in row_slices(t)
    ])
    return out.reshape(t, num_q_heads, head_dim).to(q.dtype)


def _attend_rows(qg, kv_pages, kv_lens, page_indices, seq_of_tok, q_pos, *,
                 sm_scale, sliding_window, soft_cap, sinks, seed_sinks,
                 mask_value):
    """:func:`paged_attention_plain` over a slice of query rows: ``qg``
    f32[T, Hkv, G, D] with each row's sequence and position; returns f32
    [T, Hkv, G, D]."""
    t, num_kv_heads, group, head_dim = qg.shape
    _, page_size, combined, _ = kv_pages.shape
    s, _ = page_indices.shape
    device = qg.device
    kv_len_tok = kv_lens.long()[seq_of_tok]
    padded, chunk_pages, lc, num_chunks = page_chunks(page_indices, page_size)

    m = torch.full((t, num_kv_heads, group), mask_value, dtype=torch.float32,
                   device=device)
    l = torch.zeros((t, num_kv_heads, group), dtype=torch.float32, device=device)
    o = torch.zeros((t, num_kv_heads, group, head_dim), dtype=torch.float32,
                    device=device)
    sink = None
    if sinks is not None:
        sink = sinks.float().reshape(1, num_kv_heads, group)
        if seed_sinks:
            m = sink.expand(t, -1, -1).clone()
            l = torch.ones_like(l)
    for c in range(num_chunks):
        pages_c = padded[:, c * chunk_pages:(c + 1) * chunk_pages]
        rows = kv_pages[pages_c.reshape(-1).long()].reshape(
            s, lc, combined, head_dim
        )
        k_tok = rows[:, :, 0::2, :][seq_of_tok].float()   # [T, Lc, Hkv, D]
        v_tok = rows[:, :, 1::2, :][seq_of_tok]
        scores = torch.einsum("thgd,tlhd->thgl", qg, k_tok) * sm_scale
        if soft_cap is not None:
            scores = soft_cap * torch.tanh(scores / soft_cap)
        kv_pos = c * lc + torch.arange(lc, device=device)
        valid = (kv_pos[None, :] <= q_pos[:, None]) & (
            kv_pos[None, :] < kv_len_tok[:, None]
        )
        if sliding_window is not None:
            valid &= kv_pos[None, :] > q_pos[:, None] - sliding_window
        vm = valid[:, None, None, :]
        scores = torch.where(vm, scores, mask_value)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pz = torch.where(vm, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * alpha + pz.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "thgl,tlhd->thgd", pz.to(v_tok.dtype).float(), v_tok.float()
        )
        m = m_new
    if sink is not None and not seed_sinks:
        l = l + torch.exp(sink - m)
    return o / torch.clamp_min(l, 1e-30)[..., None]
