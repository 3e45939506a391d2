"""DeepSeek sparse attention (DSA) ops: the lightning indexer and top-k
sparse MLA attention over the latent cache (port of
``parallax_tpu/ops/dsa.py``).

One gather-based attention op serves prefill and decode: every query row
attends to exactly ``index_topk`` gathered latent rows (sparse rows use
their top-k positions; dense rows, whose context fits in the budget, use
``0..K-1``), so the work is O(T * K) rather than O(T * context).

Cache layout per DSA layer: the MLA latent cache (``ops/mla.py``) plus an
index-key cache ``[num_pages, page_size, 1, index_head_dim]`` addressed by
the same page table and slot mapping, written in place.

``dsa_store_and_score`` routes decode-only batches to the fused indexer
kernel (A7, ``ops/decode_fused.py``) or, on the split path, to the scatter
plus the split scorer (A8, ``ops/dsa_decode.py``) when kernels are on;
everything else takes :func:`dsa_indexer_scores_plain`, the twin of the JAX
package's XLA path.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops import kernel_select
from parallax_tpu_torch.ops.mla import scatter_rows
from parallax_tpu_torch.ops.ragged import (
    SPARSE_CHUNK,
    SPARSE_CHUNK_THRESHOLD,
    page_chunks,
    ragged_token_positions,
)

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_NEG_INF = float("-inf")


def new_index_pages(num_pages: int, page_size: int, index_head_dim: int,
                    dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """One layer's empty index-key cache (one key head, as DeepSeek-V3.2 and
    GLM have)."""
    return torch.zeros((num_pages, page_size, 1, index_head_dim),
                       dtype=dtype, device=device)


def store_index_cache(cache: torch.Tensor, k: torch.Tensor,
                      slot_mapping: torch.Tensor) -> torch.Tensor:
    """Scatter this step's index keys ``[T, D]`` into their slots, in place
    (negative slots dropped). Returns ``cache``."""
    return scatter_rows(cache, k, slot_mapping)


def dsa_store_and_score(
    q: torch.Tensor,             # [T, Hi, D]
    weights: torch.Tensor,       # f32[T, Hi]
    k_new: torch.Tensor,         # [T, D] this step's index key
    index_cache: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    slot_mapping: torch.Tensor,
    *,
    decode_only: bool = False,
    use_kernels: bool | None = None,
    decode_fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write this step's index key into the paged index cache and score the
    full context, the indexer twin of ``ops/attention.append_and_attend``.
    Returns ``(scores f32[T, kv_cap], index_cache)``."""
    if decode_only and decode_fused and q.shape[0] == kv_lens.shape[0]:
        from parallax_tpu_torch.ops.decode_fused import indexer_scores_fused

        return indexer_scores_fused(
            q, weights, k_new, index_cache, kv_lens, page_indices,
            slot_mapping, reduce_kind="dsa",
        )
    store_index_cache(index_cache, k_new, slot_mapping)
    scores = dsa_indexer_scores(
        q, weights, index_cache, kv_lens, page_indices, cu_q_lens,
        decode_only=decode_only, use_kernels=use_kernels,
    )
    return scores, index_cache


def dsa_indexer_scores(
    q, weights, index_cache, kv_lens, page_indices, cu_q_lens, *,
    decode_only: bool = False, use_kernels: bool | None = None,
) -> torch.Tensor:
    """Indexer-score dispatcher: the split scorer kernel (A8) for
    decode-only batches when kernels are on, the chunked plain path
    otherwise."""
    if (
        decode_only
        and kernel_select.resolve_use_kernels(use_kernels, q.device)
        and q.shape[0] == kv_lens.shape[0]
    ):
        from parallax_tpu_torch.ops.dsa_decode import paged_token_scores_decode

        return paged_token_scores_decode(q, weights, index_cache, kv_lens,
                                         page_indices, reduce_kind="dsa")
    return dsa_indexer_scores_plain(q, weights, index_cache, kv_lens,
                                    page_indices, cu_q_lens)


def dsa_indexer_scores_plain(
    q: torch.Tensor,             # [T, Hi, D] rope-applied index queries
    weights: torch.Tensor,       # f32[T, Hi] head weights (already scaled)
    index_cache: torch.Tensor,   # [P, page, 1, D]
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,     # i32[S+1]
) -> torch.Tensor:
    """The twin of ``dsa_indexer_scores_xla``: per-token scores over the
    cached context, ``f32[T, kv_cap]``, ``score[t, s] = sum_h w[t, h] *
    relu(q[t, h] . k[s])`` and exactly ``-inf`` outside the causal context.
    The per-head intermediate is chunked over pages (O(T * Hi * chunk))."""
    t, _, d = q.shape
    _, page_size, _, _ = index_cache.shape
    s, pages_per_seq = page_indices.shape
    kv_cap = pages_per_seq * page_size
    device = q.device

    seq_of_tok, q_pos = ragged_token_positions(kv_lens, cu_q_lens, t, s)
    kv_len_tok = kv_lens.long()[seq_of_tok]
    w = weights.float()
    qf = q.float()
    padded, chunk_pages, lc, num_chunks = page_chunks(page_indices, page_size)
    chunks = []
    for c in range(num_chunks):
        pages_c = padded[:, c * chunk_pages:(c + 1) * chunk_pages]
        keys = index_cache[pages_c.reshape(-1).long(), :, 0, :].reshape(
            s, lc, d
        )[seq_of_tok]                                    # [T, Lc, D]
        dots = torch.einsum("thd,tld->thl", qf, keys.float())
        sc = torch.einsum("th,thl->tl", w, dots.clamp_min(0.0))
        kv_pos = c * lc + torch.arange(lc, device=device)
        valid = ((kv_pos[None, :] <= q_pos[:, None])
                 & (kv_pos[None, :] < kv_len_tok[:, None]))
        chunks.append(torch.where(valid, sc, _NEG_INF))
    return torch.cat(chunks, dim=1)[:, :kv_cap]


def dsa_topk_indices(scores: torch.Tensor, *, index_topk: int) -> torch.Tensor:
    """Top-k token positions per query row, ``i32[T, index_topk]``, ties to
    the lower position as ``jax.lax.top_k`` breaks them (a stable
    descending sort). Rows whose valid-token count fits in the budget are
    marked dense with all -1: attention then covers positions
    ``0..index_topk-1``, which is the whole context for those rows."""
    t, kv_cap = scores.shape
    k = min(index_topk, kv_cap)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]
    idx = idx.to(torch.int32)
    if k < index_topk:
        idx = torch.cat([idx, torch.full((t, index_topk - k), -1,
                                         dtype=torch.int32,
                                         device=scores.device)], dim=-1)
    dense = (scores > _NEG_INF).sum(dim=-1) <= index_topk
    return torch.where(dense[:, None], torch.full_like(idx, -1), idx)


def mla_ragged_sparse_attention_plain(
    q_latent: torch.Tensor,      # [T, Hq, R]
    q_pe: torch.Tensor,          # [T, Hq, Dr]
    cache: torch.Tensor,         # [P, page, 1, R + Dr] MLA latent cache
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,     # i32[S+1]
    topk_indices: torch.Tensor,  # i32[T, K]; a row of -1 = dense
    *,
    sm_scale: float,
    kv_lora_rank: int,
) -> torch.Tensor:
    """The twin of ``mla_ragged_sparse_attention_xla``: each query row
    attends to its top-k latent positions only, ``softmax(scale *
    (q_latent . latent + q_pe . rope)) . latent``; returns ``[T, Hq, R]``.
    Above ``SPARSE_CHUNK_THRESHOLD`` positions it runs the chunked online
    softmax over ``SPARSE_CHUNK`` slices, as the JAX package does, with the
    same masking (so a row with no valid position averages its gathered
    rows in both)."""
    t, hq, r = q_latent.shape
    p, page_size, _, width = cache.shape
    s, _ = page_indices.shape
    k = topk_indices.shape[1]
    device = q_latent.device

    seq_of_tok, q_pos = ragged_token_positions(kv_lens, cu_q_lens, t, s)
    topk = topk_indices.long()
    dense_row = topk[:, 0] < 0
    iota = torch.arange(k, device=device).expand(t, k)
    pos = torch.where(dense_row[:, None], iota, topk)
    valid = ((pos >= 0) & (pos <= q_pos[:, None])
             & (pos < kv_lens.long()[seq_of_tok][:, None]))
    safe_pos = torch.where(valid, pos, 0)
    phys_page = torch.gather(page_indices.long()[seq_of_tok], 1,
                             safe_pos // page_size)
    flat_rows = phys_page * page_size + safe_pos % page_size   # [T, K]
    flat_cache = cache.view(p * page_size, width)
    ql, qp = q_latent.float(), q_pe.float()

    def score_block(rows_blk, valid_blk):
        latent = rows_blk[..., :kv_lora_rank]
        sc = (
            torch.einsum("thr,tkr->thk", ql, latent.float())
            + torch.einsum("thd,tkd->thk", qp,
                           rows_blk[..., kv_lora_rank:].float())
        ) * sm_scale
        return torch.where(valid_blk[:, None, :], sc, _MASK_VALUE), latent

    if k <= SPARSE_CHUNK_THRESHOLD:
        scores, latent = score_block(flat_cache[flat_rows], valid)
        unnorm = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = unnorm / torch.clamp_min(unnorm.sum(dim=-1, keepdim=True),
                                         1e-30)
        out = torch.einsum("thk,tkr->thr", probs.to(latent.dtype).float(),
                           latent.float())
        return out.to(q_latent.dtype)

    chunk = SPARSE_CHUNK
    num_chunks = -(-k // chunk)
    pad = num_chunks * chunk - k
    if pad:
        flat_rows = torch.nn.functional.pad(flat_rows, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    m_run = torch.full((t, hq, 1), _NEG_INF, dtype=torch.float32,
                       device=device)
    l_run = torch.zeros((t, hq, 1), dtype=torch.float32, device=device)
    acc = torch.zeros((t, hq, r), dtype=torch.float32, device=device)
    for c in range(num_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        sc, latent = score_block(flat_cache[flat_rows[:, sl]], valid[:, sl])
        m_new = torch.maximum(m_run, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_run - m_new)
        p_blk = torch.exp(sc - m_new)
        l_run = l_run * alpha + p_blk.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "thk,tkr->thr", p_blk.to(latent.dtype).float(), latent.float()
        )
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-30)
    return out.to(q_latent.dtype)
