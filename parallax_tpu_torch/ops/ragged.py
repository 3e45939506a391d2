"""Shared ragged-batch indexing for paged attention ops (port of
``parallax_tpu/ops/ragged.py``).

Every attention op receives the same flattened ragged batch (``cu_q_lens``
row offsets + per-sequence ``kv_lens``); this maps each query token to its
sequence and its absolute position in that sequence's context.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# KV rows per online-softmax chunk in the plain paths: bounds each op's
# gather transient at O(T * chunk) instead of O(T * context).
KV_CHUNK_ROWS = 512
# Sparse (top-k) attention: above SPARSE_CHUNK_THRESHOLD selected positions
# the single-pass gather's [T, K, width] transient dominates, so the op runs
# an online softmax over SPARSE_CHUNK-position slices with the same math.
SPARSE_CHUNK_THRESHOLD = 512
SPARSE_CHUNK = 256
# Query rows per pass of the plain attention ops (dense and MSA's sparse):
# each pass gathers its rows' keys, so a long prefill's transient stays at
# O(rows * chunk) however many tokens the step holds. Rows are independent,
# so the passes give one pass's result.
QUERY_ROWS = 512


def ragged_token_positions(
    kv_lens: torch.Tensor,    # i32[S]
    cu_q_lens: torch.Tensor,  # i32[S+1]
    num_tokens: int,
    num_seqs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(seq_of_tok i64[T], q_pos i64[T])``: the owning sequence of
    each query token and its absolute context position (the last new token
    of sequence ``s`` sits at ``kv_lens[s] - 1``)."""
    device = cu_q_lens.device
    token_ids = torch.arange(num_tokens, device=device, dtype=torch.int64)
    cu = cu_q_lens.to(torch.int64)
    seq_of_tok = torch.searchsorted(cu[1:], token_ids, right=True).clamp(
        0, num_seqs - 1
    )
    q_len = cu[seq_of_tok + 1] - cu[seq_of_tok]
    q_pos = kv_lens.to(torch.int64)[seq_of_tok] - q_len + (
        token_ids - cu[seq_of_tok]
    )
    return seq_of_tok, q_pos


def page_chunks(page_indices: torch.Tensor, page_size: int,
                chunk_rows: int | None = None):
    """Split a page table into page-group chunks.

    Returns ``(padded_pages, chunk_pages, rows_per_chunk, num_chunks)``;
    the table is zero-padded so every chunk is full (position masking in
    the caller hides the padding — page 0 is the reserved null page).
    """
    _, pages_per_seq = page_indices.shape
    rows = chunk_rows if chunk_rows is not None else KV_CHUNK_ROWS
    chunk_pages = max(1, rows // page_size)
    if chunk_pages >= pages_per_seq:
        chunk_pages = pages_per_seq
    num_chunks = (pages_per_seq + chunk_pages - 1) // chunk_pages
    pad = num_chunks * chunk_pages - pages_per_seq
    padded = F.pad(page_indices, (0, pad)) if pad else page_indices
    return padded, chunk_pages, chunk_pages * page_size, num_chunks


def row_slices(num_rows: int) -> list[slice]:
    """The query-row passes of a batch of ``num_rows`` rows."""
    return [slice(r, r + QUERY_ROWS) for r in range(0, num_rows, QUERY_ROWS)]
