"""Multi-head latent attention (MLA) over a compressed paged cache (port of
``parallax_tpu/ops/mla.py``).

The cache stores, per token, only the compressed latent (``kv_lora_rank``)
and the shared rope key (``qk_rope_head_dim``): the "absorbed" form, where
W_UK folds into the query and W_UV applies after attention, so a token
costs R + Dr elements of cache instead of 2 * H * D.

Cache layout per MLA layer: ``[num_pages, page_size, 1, R + Dr]`` (the
singleton axis keeps the page gathers shared with the regular KV cache).
The port writes it in place where the JAX package donates it.

``mla_append_and_attend`` routes a batch to the fused decode kernel (A5,
``ops/decode_fused.py``), or to the split path: the cache scatter, then the
split decode kernel (A6, ``ops/mla_decode.py``) for decode-only batches when
kernels are on, else :func:`mla_ragged_attention_plain`, the twin of the
JAX package's XLA path, which also serves every prefill.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops import kernel_select
from parallax_tpu_torch.ops.kv_cache_ops import scatter_drop
from parallax_tpu_torch.ops.ragged import page_chunks, ragged_token_positions

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def new_mla_pages(
    num_pages: int, page_size: int, kv_lora_rank: int, rope_dim: int,
    dtype=torch.bfloat16, device=None,
) -> torch.Tensor:
    """One layer's empty latent cache ``[P, page, 1, R + Dr]``."""
    return torch.zeros((num_pages, page_size, 1, kv_lora_rank + rope_dim),
                       dtype=dtype, device=device)


def scatter_rows(cache: torch.Tensor, rows: torch.Tensor,
                 slot_mapping: torch.Tensor) -> torch.Tensor:
    """Write ``rows [T, W]`` into the single-head paged ``cache [P, page, 1,
    W]`` at the flat slots, in place; negative and out-of-range slots are
    dropped (the JAX scatter's ``mode="drop"``). Returns ``cache``."""
    p, page, _, width = cache.shape
    scatter_drop(cache.view(p * page, width), rows.to(cache.dtype),
                 slot_mapping)
    return cache


def store_mla_cache(
    cache: torch.Tensor,         # [P, page, 1, R + Dr]
    latent: torch.Tensor,        # [T, R]
    k_pe: torch.Tensor,          # [T, Dr]
    slot_mapping: torch.Tensor,  # i32[T]
) -> torch.Tensor:
    """Scatter this step's ``[latent ‖ k_pe]`` rows, cast to the cache
    dtype, into their slots (in place). Returns ``cache``."""
    return scatter_rows(cache, torch.cat([latent, k_pe], dim=-1),
                        slot_mapping)


def mla_append_and_attend(
    q_latent: torch.Tensor,      # [T, Hq, R]
    q_pe: torch.Tensor,          # [T, Hq, Dr]
    latent: torch.Tensor,        # [T, R] this step's compressed latent
    k_pe: torch.Tensor,          # [T, Dr] this step's rope key
    cache: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    slot_mapping: torch.Tensor,
    *,
    sm_scale: float,
    kv_lora_rank: int,
    decode_only: bool = False,
    use_kernels: bool | None = None,
    decode_fused: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write this step's latent + rope row into the paged cache and attend,
    the MLA twin of ``ops/attention.append_and_attend``. With
    ``decode_fused`` on a decode-only batch the append happens inside the
    fused decode kernel; otherwise the split path scatters, then
    :func:`mla_ragged_attention`. Returns ``(out [T, Hq, R], cache)``."""
    if decode_fused and decode_only and q_latent.shape[0] == kv_lens.shape[0]:
        from parallax_tpu_torch.ops.decode_fused import mla_fused_decode

        return mla_fused_decode(
            q_latent, q_pe, latent, k_pe, cache, kv_lens, page_indices,
            slot_mapping, sm_scale=sm_scale, kv_lora_rank=kv_lora_rank,
        )
    store_mla_cache(cache, latent, k_pe, slot_mapping)
    out = mla_ragged_attention(
        q_latent, q_pe, cache, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_lora_rank=kv_lora_rank,
        decode_only=decode_only, use_kernels=use_kernels,
    )
    return out, cache


def mla_ragged_attention(
    q_latent, q_pe, cache, kv_lens, page_indices, cu_q_lens, num_seqs, *,
    sm_scale: float, kv_lora_rank: int, decode_only: bool = False,
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """MLA attention dispatcher: the split decode kernel (A6) for
    decode-only batches when kernels are on (``use_kernels`` None: when the
    tensors are on CUDA), :func:`mla_ragged_attention_plain` otherwise."""
    if (
        decode_only
        and kernel_select.resolve_use_kernels(use_kernels, q_latent.device)
        and q_latent.shape[0] == kv_lens.shape[0]
    ):
        from parallax_tpu_torch.ops.mla_decode import mla_decode_attention

        return mla_decode_attention(
            q_latent, q_pe, cache, kv_lens, page_indices,
            sm_scale=sm_scale, kv_lora_rank=kv_lora_rank,
        )
    return mla_ragged_attention_plain(
        q_latent, q_pe, cache, kv_lens, page_indices, cu_q_lens, num_seqs,
        sm_scale=sm_scale, kv_lora_rank=kv_lora_rank,
    )


def mla_ragged_attention_plain(
    q_latent: torch.Tensor,      # [T, Hq, R] (q_nope absorbed through W_UK)
    q_pe: torch.Tensor,          # [T, Hq, Dr]
    cache: torch.Tensor,         # [P, page, 1, R + Dr]
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor,     # i32[S+1]
    num_seqs: torch.Tensor,      # i32[1] (rows past it carry kv_len 0)
    *,
    sm_scale: float,
    kv_lora_rank: int,
) -> torch.Tensor:
    """The twin of ``mla_ragged_attention_xla``: causal attention of every
    query token over its sequence's latent cache, returned in latent space
    ``[T, Hq, R]`` (the caller up-projects with W_UV). An online softmax
    over page chunks of ``KV_CHUNK_ROWS`` keeps the transient at
    O(T * chunk). Scores and accumulators are f32; the numerators are cast
    to the cache dtype before the value product, as the JAX package does."""
    del num_seqs
    t, hq, r = q_latent.shape
    _, page_size, _, width = cache.shape
    s, _ = page_indices.shape
    device = q_latent.device

    seq_of_tok, q_pos = ragged_token_positions(kv_lens, cu_q_lens, t, s)
    kv_len_tok = kv_lens.long()[seq_of_tok]
    padded, chunk_pages, lc, num_chunks = page_chunks(page_indices, page_size)
    ql, qp = q_latent.float(), q_pe.float()

    m = torch.full((t, hq), _MASK_VALUE, dtype=torch.float32, device=device)
    l = torch.zeros((t, hq), dtype=torch.float32, device=device)
    o = torch.zeros((t, hq, r), dtype=torch.float32, device=device)
    for c in range(num_chunks):
        pages_c = padded[:, c * chunk_pages:(c + 1) * chunk_pages]
        rows = cache[pages_c.reshape(-1).long(), :, 0, :].reshape(
            s, lc, width
        )[seq_of_tok]                                    # [T, Lc, W]
        lat = rows[..., :kv_lora_rank]
        scores = (
            torch.einsum("thr,tlr->thl", ql, lat.float())
            + torch.einsum("thd,tld->thl", qp, rows[..., kv_lora_rank:].float())
        ) * sm_scale
        kv_pos = c * lc + torch.arange(lc, device=device)
        valid = ((kv_pos[None, :] <= q_pos[:, None])
                 & (kv_pos[None, :] < kv_len_tok[:, None]))[:, None, :]
        scores = torch.where(valid, scores, _MASK_VALUE)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pz = torch.where(valid, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * alpha + pz.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "thl,tlr->thr", pz.to(lat.dtype).float(), lat.float()
        )
        m = m_new
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q_latent.dtype)


def mla_rope_permute(x: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope-dim interleave (the HF modeling convention): view the
    last dim as [d/2, 2], transpose, flatten; applied to q_pe / k_pe before
    the standard rotate-half rope."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
