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
plain version beside it; CUDA tensors launch the kernel or raise. The
kernel's grid is (row, :func:`indexer_blocks`), each block scoring its run
of :func:`indexer_runs`; :func:`paged_token_scores_runs_plain` walks the
same runs in plain PyTorch.
"""

from __future__ import annotations

import torch

REDUCE_KINDS = {"dsa": 0, "msa": 1}
SMEM_LIMIT = 227 * 1024
# csrc/indexer_scores.cu's constants (tests/test_torch_kernels_abi.py
# holds them equal).
KEY_TILE = 64          # kKeyTile: positions per key tile
HEAD_TILE = 64         # kHeadTile: head rows of the tensor-core tile
STAGES = 3             # kStages: the tensor-core body's ring
FMA_STAGES = 2         # kFmaStages: the CUDA-core body's ring
MAX_TC_DEPTH = 256     # kMaxTcDepth
THREADS = 128          # kThreads: one warpgroup
GROUPS = THREADS // KEY_TILE   # kGroups: the CUDA-core body's head groups
# The grid's blocks per row come from the row count alone: at most three
# blocks on each of the H100's 132 SMs (three of the tensor-core body's
# carve fit an SM at D 128), so every block is in the first wave.
TARGET_BLOCKS = 3 * 132


def indexer_blocks(rows: int, pages_per_seq: int) -> int:
    """Blocks per row of an A7 / A8 launch: TARGET_BLOCKS in all, at least
    one per row, and at most half the row's page slots, so that no block
    stands for a single page slot. The host never reads kv_len."""
    return max(1, min(-(-pages_per_seq // 2), TARGET_BLOCKS // max(rows, 1)))


def indexer_runs(kv_len: int, page: int, pages_per_seq: int, blocks: int
                 ) -> list[tuple[int, int, int, int]]:
    """Each block's share of one row, as ``indexer_run`` in
    csrc/indexer_scores.cu cuts it: ``(lo, hi, dead_lo, dead_hi)``, the
    live pages ``[lo, hi)`` (an equal share of the row's
    ``ceil(kv_len / page)``) and the dead pages ``[dead_lo, dead_hi)`` (an
    equal share of the rest), which the block fills with -inf."""
    live = 0 if kv_len <= 0 else min(-(-kv_len // page), pages_per_seq)
    dead = pages_per_seq - live
    return [(b * live // blocks, (b + 1) * live // blocks,
             live + b * dead // blocks, live + (b + 1) * dead // blocks)
            for b in range(blocks)]


def indexer_uses_tensor_cores(hi: int, d: int, elem: int, page: int) -> bool:
    """The tensor-core body takes bf16 with Hi <= 64, D a multiple of 64 up
    to 256 and pages of a multiple of 8 positions (its TMA boxes of
    gcd(page, 64) rows); everything else runs the CUDA-core body."""
    return (elem == 2 and hi <= HEAD_TILE and d % 64 == 0
            and d <= MAX_TC_DEPTH and page % 8 == 0)


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


def paged_token_scores_runs_plain(
    q, weights, index_cache, kv_lens, page_indices, *, reduce_kind: str,
    sm_scale: float = 1.0, blocks: int | None = None,
) -> torch.Tensor:
    """The kernels' walk in plain PyTorch: each block's run
    (:func:`indexer_runs`) in KEY_TILE-position tiles, the heads padded to
    HEAD_TILE rows (zero queries, weight 0, left out of the max), the dead
    pages -inf. Gives the plain version's scores in another order."""
    s, hi, d = q.shape
    page = index_cache.shape[1]
    pps = page_indices.shape[1]
    blocks = blocks or indexer_blocks(s, pps)
    rows = max(hi, HEAD_TILE)
    qp = torch.zeros((s, rows, d), dtype=torch.float32, device=q.device)
    qp[:, :hi] = q.float()
    wp = torch.zeros((s, rows), dtype=torch.float32, device=q.device)
    if reduce_kind == "dsa":
        wp[:, :hi] = weights.float()
    flat = index_cache.reshape(-1, d)
    out = torch.empty((s, pps * page), dtype=torch.float32, device=q.device)
    for r in range(s):
        n = int(kv_lens[r])
        for lo, hi_p, dead_lo, dead_hi in indexer_runs(n, page, pps, blocks):
            out[r, dead_lo * page:dead_hi * page] = float("-inf")
            for p0 in range(lo * page, hi_p * page, KEY_TILE):
                pos = torch.arange(p0, min(p0 + KEY_TILE, hi_p * page),
                                   device=q.device)
                live = pos < n
                phys = (page_indices[r, pos // page].long() * page
                        + pos % page)
                keys = torch.where(live[:, None], flat[phys].float(), 0.0)
                dots = qp[r] @ keys.T                       # [rows, L]
                if reduce_kind == "dsa":
                    sc = (wp[r, :, None] * dots.clamp_min(0.0)).sum(0)
                else:
                    sc = dots[:hi].amax(0) * sm_scale
                out[r, pos] = torch.where(live, sc, float("-inf"))
    return out


def indexer_smem_bytes(hi: int, d: int, elem: int, page: int) -> int:
    """Dynamic shared memory of one A7 / A8 block (csrc/indexer_scores.cu
    ``mma_smem_bytes`` / ``fma_smem_bytes``)."""
    def a16(n):
        return (n + 15) // 16 * 16

    if indexer_uses_tensor_cores(hi, d, elem, page):
        # 1 KB of alignment, the query tile, the ring, each warp's 16
        # staged scores, one mbarrier and one append row per stage.
        return (1024 + HEAD_TILE * d * 2 + STAGES * KEY_TILE * d * 2
                + THREADS // 32 * 16 * 4 + 12 * STAGES)
    # The f32 queries, the weights, the ring of padded rows, the groups'
    # partials.
    return (a16(hi * d * 4) + a16(hi * 4)
            + FMA_STAGES * KEY_TILE * (d * elem + 16) + GROUPS * KEY_TILE * 4)


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
    if (d * index_cache.element_size()) % 16 or index_cache.data_ptr() % 16:
        raise ValueError(
            f"{name}: index rows must be a multiple of 16 bytes and the "
            "cache 16-byte aligned"
        )
    if indexer_smem_bytes(hi, d, index_cache.element_size(),
                          page) > SMEM_LIMIT:
        raise ValueError(f"{name}: Hi {hi} x D {d} too large")
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (s,):
        raise ValueError(f"{name}: kv_lens must be i32[{s}]")
    if page_indices.dtype != torch.int32 or page_indices.shape[0] != s:
        raise ValueError(f"{name}: page_indices must be i32[S, pps]")
    return s, hi, d


def aligned_rows(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous; the kernel copies its rows 16 bytes at a time."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {tuple(t.shape)} input not 16-byte "
                         "aligned")
    return t


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
    q = aligned_rows("indexer_scores", q)
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
        indexer_blocks(s, pps), index_cache.shape[0] * page,
        REDUCE_KINDS[reduce_kind], float(sm_scale),
        ck.dtype_code(index_cache), ck.stream_of(q),
    )
    ck.check(code, "indexer_scores")
    ck.count("indexer_scores")
    return scores

