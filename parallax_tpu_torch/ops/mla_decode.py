"""Split MLA flash decode, attention only (A6, ``csrc/mla_decode.cu``): the
port of ``parallax_tpu/ops/mla_pallas.py::mla_decode_attention_pallas``.

One query token per row attends to the row's latent cache:
``softmax(scale * (q_latent . latent + q_pe . rope)) . latent``, returned in
latent space ``[S, Hq, R]``; rows with ``kv_len = 0`` give zeros. The latent
append ran before, as a separate scatter (``ops/mla.store_mla_cache``).

:func:`mla_decode_attention` is the wrapper: CPU tensors take the plain
version beside it; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops.mla import mla_ragged_attention_plain

# The kernel keeps a head's latent output in the registers of two
# warpgroups (bf16) or warps (f32), 256 columns each.
MAX_LATENT = 512
SMEM_LIMIT = 227 * 1024
# csrc/mla_decode.cu: keys per staged tile (kKT), heads per block and ring
# stages by cache dtype (Cfg), and the split partition (kSplitKeys,
# kMaxSplits).
KEY_TILE = 32
HEADS_PER_BLOCK = {2: 64, 4: 16}
RING_STAGES = {2: 3, 4: 2}
SPLIT_KEYS = 64
MAX_SPLITS = 16


def mla_decode_attention_plain(
    q_latent, q_pe, cache, kv_lens, page_indices, *, sm_scale: float,
    kv_lora_rank: int,
) -> torch.Tensor:
    """The plain version: the ragged MLA path with one query token per row
    at position ``kv_len - 1``."""
    s = q_latent.shape[0]
    cu = torch.arange(s + 1, dtype=torch.int32, device=q_latent.device)
    return mla_ragged_attention_plain(
        q_latent, q_pe, cache, kv_lens, page_indices, cu, None,
        sm_scale=sm_scale, kv_lora_rank=kv_lora_rank,
    )


def mla_split_ranges(kv_len: int, page: int) -> list[tuple[int, int]]:
    """The page ranges ``[lo, hi)`` of one row's A5 / A6 splits, as
    ``mla_split_range`` in csrc/mla_decode.cu cuts them: runs of at least
    ``SPLIT_KEYS`` keys and at most ``MAX_SPLITS`` runs from page 0. They
    depend on the page size and ``kv_len`` alone, never on the batch."""
    if kv_len <= 0:
        return []
    pages = -(-kv_len // page)
    per = max(-(-SPLIT_KEYS // page), -(-pages // MAX_SPLITS))
    return [(lo, min(lo + per, pages)) for lo in range(0, pages, per)]


def mla_num_splits_bound(pages_per_seq: int, page: int) -> int:
    """The most splits a row of ``pages_per_seq`` pages can have: the split
    grid's third dimension."""
    return max(1, min(MAX_SPLITS,
                      -(-pages_per_seq // -(-SPLIT_KEYS // page))))


def mla_part_stride(r: int) -> int:
    """Floats per head of a split partial (csrc/mla_decode.cu
    ``part_stride``): o padded to 16 values, then m, l and 2 spare."""
    return -(-r // 16) * 16 + 4


def mla_scratch(rows: int, hq: int, r: int, page_indices, page: int
                ) -> tuple[torch.Tensor, int]:
    """The f32 scratch of the split partials, ``[rows, splits, hq,
    mla_part_stride(r)]`` flattened, and the split count."""
    splits = mla_num_splits_bound(page_indices.shape[1], page)
    scratch = torch.empty(rows * splits * hq * mla_part_stride(r),
                          dtype=torch.float32, device=page_indices.device)
    return scratch, splits


def mla_smem_bytes(width: int, elem: int) -> int:
    """Dynamic shared memory of one A5 / A6 split block (csrc/mla_decode.cu
    ``smem_bytes``): 1,024 bytes of alignment slack, the query tile and the
    ring's key tiles, then the warps' score exchange (16 x 32 f32 a warp).
    bf16 rows are 64-column chunks of 128 bytes (the depth padded to 64);
    f32 rows the depth padded to 32, plus 16 bytes."""
    heads = HEADS_PER_BLOCK[elem]
    if elem == 2:
        row = -(-width // 64) * 128
    else:
        row = (-(-width // 32) * 32) * elem + 16
    return (1024 + (heads + RING_STAGES[elem] * KEY_TILE) * row
            + (heads // 8) * 16 * 32 * 4)


def mla_split_decode_plain(
    q_latent, q_pe, cache, kv_lens, page_indices, *, sm_scale: float,
    kv_lora_rank: int,
) -> torch.Tensor:
    """The split-KV form of A5 / A6's arithmetic, for the tests: per row and
    split (:func:`mla_split_ranges`), an online softmax over 32-position
    key tiles (numerators rounded to the cache dtype before the value
    product), then the splits combined in split order: m the largest of
    their maxima, each weighed by exp(m_k - m), o / max(l, 1e-30). Rows
    with ``kv_len = 0`` give zeros. Returns ``[S, Hq, R]``."""
    s_rows, hq, r = q_latent.shape
    _, page, _, width = cache.shape
    out = torch.zeros((s_rows, hq, r), dtype=torch.float32)
    for s in range(s_rows):
        n = int(kv_lens[s])
        q = torch.cat([q_latent[s], q_pe[s]], dim=-1).float()   # [Hq, W]
        rows = cache[page_indices[s].long(), :, 0, :].reshape(-1, width)
        parts = []
        for lo, hi in mla_split_ranges(n, page):
            m = torch.full((hq,), -1e30)
            l = torch.zeros((hq,))
            o = torch.zeros((hq, r))
            end = min(hi * page, n)
            for p0 in range(lo * page, end, KEY_TILE):
                kv = rows[p0:min(p0 + KEY_TILE, end)]
                x = (q @ kv.float().T) * sm_scale                # [Hq, L]
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[:, None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[:, None] + (p.to(cache.dtype).float()
                                          @ kv[:, :r].float())
                m = m_new
            parts.append((m, l, o))
        if not parts:
            continue
        m = torch.stack([mk for mk, _, _ in parts]).amax(0)
        l = torch.zeros((hq,))
        o = torch.zeros((hq, r))
        for mk, lk, ok in parts:
            e = torch.exp(mk - m)
            l = l + lk * e
            o = o + ok * e[:, None]
        out[s] = o / torch.clamp_min(l, 1e-30)[:, None]
    return out.to(q_latent.dtype)


def check_mla_args(name, q_latent, q_pe, cache, kv_lens, page_indices,
                   kv_lora_rank) -> tuple[int, int, int, int]:
    """Shared argument checks of A5 and A6; returns ``(s, hq, r, dr)``."""
    if cache.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"{name}: cache dtype {cache.dtype} not supported; the kernel "
            "takes bfloat16 or float32"
        )
    if q_latent.dtype != cache.dtype or q_pe.dtype != cache.dtype:
        raise TypeError(
            f"{name}: q_latent {q_latent.dtype} / q_pe {q_pe.dtype} must "
            f"have the cache's dtype {cache.dtype}"
        )
    s, hq, r = q_latent.shape
    _, _, one, width = cache.shape
    dr = width - r
    if one != 1 or r != kv_lora_rank or dr <= 0 or q_pe.shape != (s, hq, dr):
        raise ValueError(
            f"{name}: q_latent {tuple(q_latent.shape)} / q_pe "
            f"{tuple(q_pe.shape)} do not fit the cache {tuple(cache.shape)} "
            f"with kv_lora_rank {kv_lora_rank}"
        )
    if r > MAX_LATENT:
        raise ValueError(f"{name}: kv_lora_rank {r} > {MAX_LATENT}")
    if (width * cache.element_size()) % 16 or cache.data_ptr() % 16:
        raise ValueError(
            f"{name}: cache rows must be a multiple of 16 bytes and the "
            "cache 16-byte aligned (the kernel stages rows with 16-byte "
            "loads)"
        )
    if mla_smem_bytes(width, cache.element_size()) > SMEM_LIMIT:
        raise ValueError(f"{name}: cache row width {width} too large")
    if kv_lens.dtype != torch.int32 or kv_lens.shape != (s,):
        raise ValueError(f"{name}: kv_lens must be i32[{s}]")
    if page_indices.dtype != torch.int32 or page_indices.shape[0] != s:
        raise ValueError(f"{name}: page_indices must be i32[S, pps]")
    return s, hq, r, dr


def mla_decode_attention(
    q_latent: torch.Tensor,      # [S, Hq, R] — ONE query token per row
    q_pe: torch.Tensor,          # [S, Hq, Dr]
    cache: torch.Tensor,         # [P, page, 1, R + Dr]
    kv_lens: torch.Tensor,       # i32[S]
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    *,
    sm_scale: float,
    kv_lora_rank: int,
) -> torch.Tensor:
    """Split MLA flash decode: ``[S, Hq, R]`` in latent space (the kernel's
    split-KV launch, then its ordered combine; one count per call)."""
    if q_latent.device.type == "cpu":
        return mla_decode_attention_plain(
            q_latent, q_pe, cache, kv_lens, page_indices,
            sm_scale=sm_scale, kv_lora_rank=kv_lora_rank,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck

    s, hq, r, dr = check_mla_args("mla_attend", q_latent, q_pe, cache,
                                  kv_lens, page_indices, kv_lora_rank)
    q_latent, q_pe = q_latent.contiguous(), q_pe.contiguous()
    ck.require_cuda("mla_attend", q_latent, q_pe, cache, kv_lens,
                    page_indices)
    out = torch.empty_like(q_latent)
    page = cache.shape[1]
    scratch, splits = mla_scratch(s, hq, r, page_indices, page)
    code = ck.lib().pk_mla_attend(
        q_latent.data_ptr(), q_pe.data_ptr(), cache.data_ptr(),
        out.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
        scratch.data_ptr(), s, hq, r, dr, page, page_indices.shape[1],
        splits, float(sm_scale), ck.dtype_code(cache),
        ck.stream_of(q_latent),
    )
    ck.check(code, "mla_attend")
    ck.count("mla_attend")
    return out
