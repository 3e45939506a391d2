"""Split paged indexer scoring for decode batches (A8,
``csrc/indexer_scores.cu``): the port of
``parallax_tpu/ops/dsa_pallas.py::paged_token_scores_decode``, and of its
two wrappers, ``dsa_indexer_scores_decode_pallas`` (DSA) and
``parallax_tpu/ops/msa_pallas.py::msa_token_scores_decode_pallas`` (MSA),
through ``reduce_kind``.

One query token per row scores every page slot of the row's index-key
cache into ``f32[S, pages_per_seq * page]``, reducing the per-head dots
``q_h . k``: DSA ``sum_h w_h * relu(.)``, MSA ``max_h(.) * sm_scale``.
Positions at or past ``kv_len`` are exactly ``-inf`` (top-k's dense-row
detection relies on it).

:func:`paged_token_scores_decode` is the wrapper: CPU tensors take the
plain version beside it; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

REDUCE_KINDS = {"dsa": 0, "msa": 1}
SMEM_LIMIT = 227 * 1024
MAX_PAGE = 256


def paged_token_scores_decode_plain(
    q, weights, index_cache, kv_lens, page_indices, *, reduce_kind: str,
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """The plain version: gather every page slot of each row, the f32 dots
    of every head, the head reduction, ``-inf`` at and past ``kv_len``."""
    s, _, d = q.shape
    _, page, _, _ = index_cache.shape
    pps = page_indices.shape[1]
    keys = index_cache[page_indices.long(), :, 0, :].reshape(s, pps * page, d)
    dots = torch.einsum("shd,sld->shl", q.float(), keys.float())
    if reduce_kind == "dsa":
        sc = (weights.float()[:, :, None] * dots.clamp_min(0.0)).sum(dim=1)
    else:
        sc = dots.amax(dim=1) * sm_scale
    pos = torch.arange(pps * page, device=q.device)
    return torch.where(pos[None, :] < kv_lens.long()[:, None], sc,
                       float("-inf"))


def indexer_smem_bytes(hi: int, d: int, page: int, elem: int) -> int:
    """Dynamic shared memory of one A7/A8 block."""
    def a16(n):
        return (n + 15) // 16 * 16

    return (a16(page * (d * elem + 16)) + a16(hi * d * 4) + a16(hi * 4)
            + a16(256 * 4))


def check_indexer_args(name, q, weights, index_cache, kv_lens, page_indices,
                       reduce_kind) -> tuple[int, int, int]:
    """Shared argument checks of A7 and A8; returns ``(s, hi, d)``."""
    if reduce_kind not in REDUCE_KINDS:
        raise ValueError(f"{name}: reduce_kind {reduce_kind!r}")
    if index_cache.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"{name}: cache dtype {index_cache.dtype} not supported; the "
            "kernel takes bfloat16 or float32"
        )
    if q.dtype != index_cache.dtype:
        raise TypeError(
            f"{name}: q is {q.dtype} but the cache is {index_cache.dtype}"
        )
    s, hi, d = q.shape
    _, page, one, cd = index_cache.shape
    if one != 1 or cd != d:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} does not fit the cache "
            f"{tuple(index_cache.shape)}"
        )
    if reduce_kind == "dsa" and (
        weights is None or weights.dtype != torch.float32
        or weights.shape != (s, hi)
    ):
        raise ValueError(f"{name}: DSA weights must be f32[{s}, {hi}]")
    if page > MAX_PAGE or MAX_PAGE % page:
        raise ValueError(
            f"{name}: page size {page} must divide {MAX_PAGE} (the block's "
            "threads split into 256 / page head groups)"
        )
    if (d * index_cache.element_size()) % 16 or index_cache.data_ptr() % 16:
        raise ValueError(
            f"{name}: index rows must be a multiple of 16 bytes and the "
            "cache 16-byte aligned"
        )
    if indexer_smem_bytes(hi, d, page, index_cache.element_size()) > SMEM_LIMIT:
        raise ValueError(f"{name}: Hi {hi} x D {d} too large")
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (s,):
        raise ValueError(f"{name}: kv_lens must be i32[{s}]")
    if page_indices.dtype != torch.int32 or page_indices.shape[0] != s:
        raise ValueError(f"{name}: page_indices must be i32[S, pps]")
    return s, hi, d


def paged_token_scores_decode(
    q: torch.Tensor,             # [S, Hi, D] — ONE query token per row
    weights: torch.Tensor | None,  # f32[S, Hi] (DSA) or None (MSA)
    index_cache: torch.Tensor,   # [P, page, 1, D]
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    *,
    reduce_kind: str,            # "dsa" | "msa"
    sm_scale: float = 1.0,
) -> torch.Tensor:
    """Split page-streaming indexer scores: ``f32[S, pages_per_seq *
    page]``."""
    if q.device.type == "cpu":
        return paged_token_scores_decode_plain(
            q, weights, index_cache, kv_lens, page_indices,
            reduce_kind=reduce_kind, sm_scale=sm_scale,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck

    s, hi, d = check_indexer_args("indexer_scores", q, weights, index_cache,
                                  kv_lens, page_indices, reduce_kind)
    q = q.contiguous()
    tensors = [q, index_cache, kv_lens, page_indices]
    if weights is not None:
        weights = weights.contiguous()
        tensors.append(weights)
    ck.require_cuda("indexer_scores", *tensors)
    page, pps = index_cache.shape[1], page_indices.shape[1]
    scores = torch.empty((s, pps * page), dtype=torch.float32,
                         device=q.device)
    code = ck.lib().pk_indexer_scores(
        q.data_ptr(), weights.data_ptr() if weights is not None else None,
        index_cache.data_ptr(), scores.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(), s, hi, d, page, pps,
        REDUCE_KINDS[reduce_kind], float(sm_scale),
        ck.dtype_code(index_cache), ck.stream_of(q),
    )
    ck.check(code, "indexer_scores")
    ck.LAUNCHES["indexer_scores"] += 1
    return scores

