"""MiniMax-M3 block-sparse attention (MSA) ops (port of
``parallax_tpu/ops/msa.py``).

The block indexer scores every cached token as the max over index heads of
``q_idx . k_idx * scale``, takes each block's max over its tokens, always
keeps the first ``init_blocks`` (score 1e30) and the ``local_blocks``
nearest blocks (1e29), picks the top ``topk_blocks`` causal blocks and
expands them to ``topk_blocks * block_size`` token positions per query row
(-1 = invalid, behind the real blocks). One gather-based GQA attention then
serves prefill and decode over exactly those positions. When the context
fits inside the top-k budget every causal block is selected, and the sparse
path equals dense attention.

The index-key cache reuses DSA's layout ``[P, page, 1, D_idx]`` and the
main cache's slot mapping (``ops/dsa.py``). ``msa_store_and_positions``
routes decode-only batches to the fused indexer kernel (A7,
``ops/decode_fused.py``) or, on the split path with kernels on, to the
scatter plus the split scorer (A8, ``ops/dsa_decode.py``), both in their
MSA reduction; everything else takes :func:`msa_sparse_positions_plain`,
the twin of the JAX package's XLA path. The sparse attention runs in plain
PyTorch, as the JAX package runs it in XLA (no Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallax_tpu_torch.ops import kernel_select
from parallax_tpu_torch.ops.dsa import store_index_cache
from parallax_tpu_torch.ops.ragged import (
    SPARSE_CHUNK,
    SPARSE_CHUNK_THRESHOLD,
    page_chunks,
    ragged_token_positions,
    row_slices,
)

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_NEG_INF = float("-inf")
_INIT_SCORE = 1e30
_LOCAL_SCORE = 1e29


def topk_block_positions(
    token_scores: torch.Tensor,  # f32[T, kv_cap] (-inf outside context)
    q_pos: torch.Tensor,         # i64[T] (-1 on padding rows)
    *,
    block_size: int,
    topk_blocks: int,
    init_blocks: int,
    local_blocks: int,
) -> torch.Tensor:
    """Token scores -> the selected blocks' token positions,
    ``i32[T, topk_blocks * block_size]``. Ties go to the lower block, as
    ``jax.lax.top_k`` breaks them (a stable descending sort): the forced
    init / local blocks tie by design, and so do the ``-inf`` blocks,
    which sort behind every real one and come out as -1."""
    t, kv_cap = token_scores.shape
    nb = -(-kv_cap // block_size)
    pad = nb * block_size - kv_cap
    if pad:
        token_scores = F.pad(token_scores, (0, pad), value=_NEG_INF)
    block_scores = token_scores.reshape(t, nb, block_size).amax(dim=2)

    device = token_scores.device
    blocks = torch.arange(nb, device=device)
    cur_block = torch.div(q_pos.long(), block_size, rounding_mode="floor")
    causal = blocks[None, :] <= cur_block[:, None]
    selected = torch.where(causal, block_scores, _NEG_INF)
    if init_blocks > 0:
        selected = torch.where((blocks[None, :] < init_blocks) & causal,
                               _INIT_SCORE, selected)
    if local_blocks > 0:
        local_start = (cur_block - local_blocks + 1).clamp_min(0)
        selected = torch.where(
            (blocks[None, :] >= local_start[:, None]) & causal,
            _LOCAL_SCORE, selected)

    kb = min(topk_blocks, nb)
    top_vals, top_idx = torch.sort(selected, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :kb], top_idx[:, :kb]
    pos = (top_idx[:, :, None] * block_size
           + torch.arange(block_size, device=device)[None, None, :])
    pos = torch.where((top_vals > _NEG_INF)[:, :, None], pos, -1)
    pos = pos.reshape(t, kb * block_size).to(torch.int32)
    if kb < topk_blocks:
        pos = F.pad(pos, (0, (topk_blocks - kb) * block_size), value=-1)
    return pos


def msa_sparse_positions_plain(
    idx_q: torch.Tensor,         # [T, Hi, D] rope-applied index queries
    index_cache: torch.Tensor,   # [P, page, 1, D]
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,     # i32[S+1]
    *,
    block_size: int,
    topk_blocks: int,
    init_blocks: int,
    local_blocks: int,
    sm_scale: float,
) -> torch.Tensor:
    """The twin of ``msa_sparse_positions_xla``: per-token scores over the
    cached context (max over heads of the scaled dots, exactly ``-inf``
    outside the causal context), page-chunked so only the ``[T, Hi,
    chunk]`` dots of one chunk exist at a time, then
    :func:`topk_block_positions`."""
    t, _, d = idx_q.shape
    page_size = index_cache.shape[1]
    s, pages_per_seq = page_indices.shape
    kv_cap = pages_per_seq * page_size
    device = idx_q.device

    seq_of_tok, q_pos = ragged_token_positions(kv_lens, cu_q_lens, t, s)
    kv_len_tok = kv_lens.long()[seq_of_tok]
    qf = idx_q.float()
    padded, chunk_pages, lc, num_chunks = page_chunks(page_indices, page_size)
    chunks = []
    for c in range(num_chunks):
        pages_c = padded[:, c * chunk_pages:(c + 1) * chunk_pages]
        keys = index_cache[pages_c.reshape(-1).long(), :, 0, :].reshape(
            s, lc, d
        )[seq_of_tok]                                    # [T, Lc, D]
        sc = torch.einsum("thd,tld->thl", qf, keys.float()) * sm_scale
        sc = sc.amax(dim=1)                              # max over heads
        kv_pos = c * lc + torch.arange(lc, device=device)
        valid = ((kv_pos[None, :] <= q_pos[:, None])
                 & (kv_pos[None, :] < kv_len_tok[:, None]))
        chunks.append(torch.where(valid, sc, _NEG_INF))
    token_scores = torch.cat(chunks, dim=1)[:, :kv_cap]
    return topk_block_positions(
        token_scores, q_pos, block_size=block_size, topk_blocks=topk_blocks,
        init_blocks=init_blocks, local_blocks=local_blocks,
    )


def msa_sparse_positions(
    idx_q, index_cache, kv_lens, page_indices, cu_q_lens, *,
    block_size: int, topk_blocks: int, init_blocks: int, local_blocks: int,
    sm_scale: float, decode_only: bool = False,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Block-indexer dispatcher: the split scorer kernel (A8, MSA
    reduction) for decode-only batches when kernels are on, the chunked
    plain path otherwise (prefill, the CPU, the card's reference)."""
    kw = dict(block_size=block_size, topk_blocks=topk_blocks,
              init_blocks=init_blocks, local_blocks=local_blocks)
    if (
        decode_only
        and kernel_select.resolve_use_kernels(use_kernels, idx_q.device)
        and idx_q.shape[0] == kv_lens.shape[0]
    ):
        from parallax_tpu_torch.ops.dsa_decode import paged_token_scores_decode

        scores = paged_token_scores_decode(
            idx_q, None, index_cache, kv_lens, page_indices,
            reduce_kind="msa", sm_scale=sm_scale,
        )
        # Decode q_pos = kv_len - 1; padding rows (kv_len 0) get -1, so
        # the causal mask rejects every block (all -1 out).
        return topk_block_positions(scores, kv_lens.long() - 1, **kw)
    return msa_sparse_positions_plain(
        idx_q, index_cache, kv_lens, page_indices, cu_q_lens,
        sm_scale=sm_scale, **kw,
    )


def msa_store_and_positions(
    idx_q: torch.Tensor,         # [T, Hi, D]
    idx_k: torch.Tensor,         # [T, D] this step's index key
    index_cache: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    slot_mapping: torch.Tensor,
    *,
    block_size: int,
    topk_blocks: int,
    init_blocks: int,
    local_blocks: int,
    sm_scale: float,
    decode_only: bool = False,
    use_kernels: bool | None = None,
    decode_fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write this step's index key into the paged index cache (in place)
    and pick the sparse block positions, the MSA twin of
    ``ops/attention.append_and_attend``: on fused decode the key append
    rides inside A7; otherwise the scatter, then
    :func:`msa_sparse_positions`. Returns ``(positions, index_cache)``."""
    kw = dict(block_size=block_size, topk_blocks=topk_blocks,
              init_blocks=init_blocks, local_blocks=local_blocks)
    if decode_fused and decode_only and idx_q.shape[0] == kv_lens.shape[0]:
        from parallax_tpu_torch.ops.decode_fused import indexer_scores_fused

        scores, index_cache = indexer_scores_fused(
            idx_q, None, idx_k, index_cache, kv_lens, page_indices,
            slot_mapping, reduce_kind="msa", sm_scale=sm_scale,
        )
        return topk_block_positions(scores, kv_lens.long() - 1,
                                    **kw), index_cache
    store_index_cache(index_cache, idx_k, slot_mapping)
    positions = msa_sparse_positions(
        idx_q, index_cache, kv_lens, page_indices, cu_q_lens,
        sm_scale=sm_scale, decode_only=decode_only, use_kernels=use_kernels,
        **kw,
    )
    return positions, index_cache


def _sparse_gqa_rows(qg, flat_kv, flat_rows, valid, sm_scale):
    """One pass of :func:`paged_sparse_gqa_attention_plain` over a slice of
    query rows: ``qg`` f32[T, Hkv, G, D], ``flat_rows`` / ``valid`` [T, K];
    returns f32[T, Hkv, G, D]."""
    t, hkv, g, d = qg.shape
    k = flat_rows.shape[1]
    device = qg.device

    def score_block(rows_blk, valid_blk):
        """[T, Kc, 2Hkv, D] -> (masked f32 scores [T, Hkv, G, Kc], v)."""
        k_sel = rows_blk[:, :, 0::2, :].float()
        v_sel = rows_blk[:, :, 1::2, :]
        sc = torch.einsum("thgd,tkhd->thgk", qg, k_sel) * sm_scale
        return torch.where(valid_blk[:, None, None, :], sc,
                           _MASK_VALUE), v_sel

    if k <= SPARSE_CHUNK_THRESHOLD:
        scores, v_sel = score_block(flat_kv[flat_rows], valid)
        unnorm = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = unnorm / torch.clamp_min(unnorm.sum(dim=-1, keepdim=True),
                                         1e-30)
        return torch.einsum("thgk,tkhd->thgd",
                            probs.to(v_sel.dtype).float(), v_sel.float())

    # Chunked online softmax over K. The first chunk always holds a valid
    # position (the indexer sorts real blocks ahead of the -1 padding), so
    # the running max is real before a fully masked chunk can add exp(0)
    # terms.
    chunk = SPARSE_CHUNK
    num_chunks = -(-k // chunk)
    pad = num_chunks * chunk - k
    if pad:
        flat_rows = F.pad(flat_rows, (0, pad))
        valid = F.pad(valid, (0, pad))
    m_run = torch.full((t, hkv, g, 1), _NEG_INF, dtype=torch.float32,
                       device=device)
    l_run = torch.zeros((t, hkv, g, 1), dtype=torch.float32, device=device)
    acc = torch.zeros((t, hkv, g, d), dtype=torch.float32, device=device)
    for c in range(num_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        sc, v_sel = score_block(flat_kv[flat_rows[:, sl]], valid[:, sl])
        m_new = torch.maximum(m_run, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m_run - m_new)
        p_blk = torch.exp(sc - m_new)
        l_run = l_run * alpha + p_blk.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "thgk,tkhd->thgd", p_blk.to(v_sel.dtype).float(), v_sel.float()
        )
        m_run = m_new
    return acc / torch.clamp_min(l_run, 1e-30)


def paged_sparse_gqa_attention_plain(
    q: torch.Tensor,             # [T, Hq, D]
    kv_pages: torch.Tensor,      # [P, page, 2*Hkv, D]
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,     # i32[S+1]
    positions: torch.Tensor,     # i32[T, K] logical positions; -1 invalid
    *,
    sm_scale: float,
) -> torch.Tensor:
    """The twin of ``paged_sparse_gqa_attention_xla``: GQA attention over
    the listed token positions of the paged KV cache, causality enforced
    here (a selected block may reach past the query). One pass at up to
    ``SPARSE_CHUNK_THRESHOLD`` positions, above that an online softmax over
    ``SPARSE_CHUNK``-position slices, with the JAX package's masking (a row
    with no valid position averages its gathered rows in both). Returns
    ``[T, Hq, D]`` in ``q``'s dtype."""
    t, hq, d = q.shape
    p, page_size, combined, _ = kv_pages.shape
    hkv = combined // 2
    s = page_indices.shape[0]

    seq_of_tok, q_pos = ragged_token_positions(kv_lens, cu_q_lens, t, s)
    pos = positions.long()
    valid = ((pos >= 0) & (pos <= q_pos[:, None])
             & (pos < kv_lens.long()[seq_of_tok][:, None]))
    safe_pos = torch.where(valid, pos, 0)
    phys_page = torch.gather(page_indices.long()[seq_of_tok], 1,
                             safe_pos // page_size)
    flat_rows = phys_page * page_size + safe_pos % page_size   # [T, K]
    flat_kv = kv_pages.view(p * page_size, combined, d)
    qg = q.float().reshape(t, hkv, hq // hkv, d)
    out = torch.cat([
        _sparse_gqa_rows(qg[sl], flat_kv, flat_rows[sl], valid[sl], sm_scale)
        for sl in row_slices(t)
    ])
    return out.reshape(t, hq, d).to(q.dtype)
