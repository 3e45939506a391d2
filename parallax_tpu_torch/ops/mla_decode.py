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

# The kernel keeps a thread's share of a head's latent output in registers:
# 256 threads x 2 columns.
MAX_LATENT = 512
SMEM_LIMIT = 227 * 1024
# Keys staged per tile and heads per block (csrc/mla_decode.cu KT / HB).
KEY_TILE = 32
HEADS_PER_BLOCK = 8


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


def mla_smem_bytes(width: int, elem: int) -> int:
    """Dynamic shared memory of one A5/A6 block."""
    def a16(n):
        return (n + 15) // 16 * 16

    return (a16(KEY_TILE * (width * elem + 16))
            + a16(HEADS_PER_BLOCK * width * 4)
            + a16(KEY_TILE * HEADS_PER_BLOCK * 4)
            + 3 * a16(HEADS_PER_BLOCK * 4))


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
    """Split MLA flash decode: ``[S, Hq, R]`` in latent space."""
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
    code = ck.lib().pk_mla_attend(
        q_latent.data_ptr(), q_pe.data_ptr(), cache.data_ptr(),
        out.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
        s, hq, r, dr, cache.shape[1], page_indices.shape[1],
        float(sm_scale), ck.dtype_code(cache), ck.stream_of(q_latent),
    )
    ck.check(code, "mla_attend")
    ck.LAUNCHES["mla_attend"] += 1
    return out
