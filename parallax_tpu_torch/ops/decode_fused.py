"""Fused GQA decode: KV append + flash decode in one kernel (A2,
``csrc/gqa_decode.cu``), the port of
``parallax_tpu/ops/decode_fused_pallas.py::gqa_fused_decode_pallas``.

:func:`gqa_fused_decode` is the wrapper: CPU tensors take the plain PyTorch
version beside it (:func:`gqa_fused_decode_plain`); CUDA tensors launch the
kernel or raise. The cache is updated in place (the JAX package donates it).
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops.attention import KERNEL_NEG, paged_attention_plain
from parallax_tpu_torch.ops.kv_cache_ops import reshape_and_cache

MAX_HEAD_DIM = 256
SMEM_LIMIT = 227 * 1024


def gqa_fused_decode_plain(
    q, k_new, v_new, kv_pages, kv_lens, page_indices, slot_mapping, sinks,
    *, sm_scale: float, sliding_window: int | None = None,
    soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: append each row's new K/V (slot < 0 skipped), then
    attend with one query token per row at position ``kv_len - 1``; sinks
    seed the running max/denominator as the kernel does; rows with
    ``kv_len = 0`` give zeros."""
    reshape_and_cache(kv_pages, k_new, v_new, slot_mapping)
    s = q.shape[0]
    cu = torch.arange(s + 1, dtype=torch.int32, device=q.device)
    out = paged_attention_plain(
        q, kv_pages, kv_lens, page_indices, cu,
        sm_scale=sm_scale, sliding_window=sliding_window, soft_cap=soft_cap,
        sinks=sinks, seed_sinks=True, mask_value=KERNEL_NEG,
    )
    return out, kv_pages


def check_attention_shapes(name, q, kv_pages, sinks) -> tuple[int, int, int]:
    """Shared argument checks of the two attention kernels; returns
    ``(hq, hkv, d)``."""
    if kv_pages.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"{name}: cache dtype {kv_pages.dtype} not supported; the kernel "
            "takes q and kv_pages both bfloat16 or both float32"
        )
    if q.dtype != kv_pages.dtype:
        raise TypeError(
            f"{name}: q is {q.dtype} but the cache is {kv_pages.dtype}; the "
            "kernel takes both bfloat16 or both float32"
        )
    _, page, combined, d = kv_pages.shape
    hq = q.shape[1]
    hkv = combined // 2
    if q.shape[2] != d or hq % hkv:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} does not fit the cache "
            f"{tuple(kv_pages.shape)}"
        )
    if d > MAX_HEAD_DIM or (d * kv_pages.element_size()) % 16:
        raise ValueError(
            f"{name}: head_dim {d} must be <= 256 with rows a multiple of "
            "16 bytes (the kernel stages pages with 16-byte loads)"
        )
    if kv_pages.data_ptr() % 16:
        raise ValueError(f"{name}: the cache must be 16-byte aligned")
    if hq // hkv > 64:
        raise ValueError(f"{name}: group size {hq // hkv} > 64")
    if sinks is not None and (
        sinks.dtype != torch.float32 or sinks.shape != (hq,)
    ):
        raise ValueError(f"{name}: sinks must be f32[{hq}]")
    return hq, hkv, d


def smem_bytes(rows: int, maxr: int, d: int, page: int, elem: int) -> int:
    """Dynamic shared memory of the streaming core (csrc/attend.cuh)."""
    def a16(n):
        return (n + 15) // 16 * 16

    kw = d * elem // 4
    return (a16(page * (kw + 1) * 4) + a16(page * kw * 4) + a16(rows * d * 4)
            + a16(rows * (page + 1) * 4) + 3 * a16(maxr * 4))


def gqa_fused_decode(
    q: torch.Tensor,             # [S, Hq, D] — ONE query token per row
    k_new: torch.Tensor,         # [S, Hkv, D] this step's keys (rope'd)
    v_new: torch.Tensor,         # [S, Hkv, D]
    kv_pages: torch.Tensor,      # [P, page, 2*Hkv, D], updated in place
    kv_lens: torch.Tensor,       # i32[S] INCLUDING the new token
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    slot_mapping: torch.Tensor,  # i32[S]; < 0 = no append
    sinks: torch.Tensor | None,  # f32[Hq] or None
    *,
    sm_scale: float,
    sliding_window: int | None = None,
    soft_cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused KV append + GQA flash decode. Returns ``(out [S, Hq, D],
    kv_pages)``."""
    if q.device.type == "cpu":
        return gqa_fused_decode_plain(
            q, k_new, v_new, kv_pages, kv_lens, page_indices, slot_mapping,
            sinks, sm_scale=sm_scale, sliding_window=sliding_window,
            soft_cap=soft_cap,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck

    hq, hkv, d = check_attention_shapes("gqa_decode", q, kv_pages, sinks)
    s = q.shape[0]
    num_pages, page, _, _ = kv_pages.shape
    k_new = k_new.to(kv_pages.dtype).contiguous()
    v_new = v_new.to(kv_pages.dtype).contiguous()
    if k_new.shape != (s, hkv, d) or v_new.shape != (s, hkv, d):
        raise ValueError("gqa_decode: k_new/v_new must be [S, Hkv, D]")
    for name, t in (("kv_lens", kv_lens), ("slot_mapping", slot_mapping)):
        if t.dtype != torch.int32 or t.shape != (s,):
            raise ValueError(f"gqa_decode: {name} must be i32[{s}]")
    if page_indices.dtype != torch.int32 or page_indices.shape[0] != s:
        raise ValueError("gqa_decode: page_indices must be i32[S, pps]")
    maxr = 16 if hq // hkv <= 16 else 64
    if smem_bytes(hq // hkv, maxr, d, page, kv_pages.element_size()) > SMEM_LIMIT:
        raise ValueError(f"gqa_decode: page size {page} too large")
    tensors = [q, k_new, v_new, kv_pages, kv_lens, page_indices, slot_mapping]
    if sinks is not None:
        tensors.append(sinks)
    ck.require_cuda("gqa_decode", *tensors)
    out = torch.empty_like(q)
    code = ck.lib().pk_gqa_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kv_pages.data_ptr(),
        out.data_ptr(), kv_lens.data_ptr(), page_indices.data_ptr(),
        slot_mapping.data_ptr(),
        sinks.data_ptr() if sinks is not None else None,
        s, hq, hkv, d, page, page_indices.shape[1], num_pages * page,
        sliding_window or 0, float(sm_scale), float(soft_cap or 0.0),
        ck.dtype_code(kv_pages), ck.stream_of(q),
    )
    ck.check(code, "gqa_decode")
    ck.LAUNCHES["gqa_decode"] += 1
    return out, kv_pages
