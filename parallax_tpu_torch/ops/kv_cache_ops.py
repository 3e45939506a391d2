"""Paged KV cache layout and the cache-scatter op (port of
``parallax_tpu/ops/kv_cache_ops.py``).

Layout (one tensor per attention layer), identical to the JAX package's so
KV images carry over unchanged:

    kv_pages: [num_pages, page_size, 2 * num_kv_heads, head_dim]

with K at even combined-head indices and V at odd ones. ``slot_mapping`` is a
flat ``page * page_size + offset`` index per token; a negative slot marks a
padding token that must not be written. Where the JAX package donates the
cache buffer and gets a new array back, the port writes the cache IN PLACE
and returns the same tensor.
"""

from __future__ import annotations

import torch


def new_kv_pages(
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
) -> torch.Tensor:
    """Allocate one layer's empty paged KV cache."""
    return torch.zeros(
        (num_pages, page_size, 2 * num_kv_heads, head_dim),
        dtype=dtype, device=device,
    )


def interleave_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[T, H, D] x 2 -> [T, 2H, D] with K at even, V at odd combined heads."""
    t, h, d = k.shape
    return torch.stack([k, v], dim=2).reshape(t, 2 * h, d)


def gather_pages(kv_pages: torch.Tensor,
                 page_ids: torch.Tensor) -> torch.Tensor:
    """Gather whole pages into a staging buffer for D2H demotion.

    ``kv_pages`` [P, page, ...] is one layer's paged cache, ``page_ids``
    i32[n] in-range device page ids (callers own validity). Returns a
    contiguous [n, page, ...] copy, safe to copy to the host while later
    steps keep writing ``kv_pages``."""
    return kv_pages.index_select(0, page_ids.long())


def scatter_pages(kv_pages: torch.Tensor, page_ids: torch.Tensor,
                  data: torch.Tensor) -> torch.Tensor:
    """Write host-promoted pages back into the paged cache (H2D swap-in),
    IN PLACE: ``kv_pages[page_ids[i]] = data[i]``, cast to the cache's
    dtype. Captured CUDA graphs hold the cache's pointer, so the tensor
    is never reallocated. Returns ``kv_pages``."""
    kv_pages.index_copy_(0, page_ids.long(),
                         data.to(device=kv_pages.device,
                                 dtype=kv_pages.dtype))
    return kv_pages


def reshape_and_cache(
    kv_pages: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slot_mapping: torch.Tensor,
) -> torch.Tensor:
    """Scatter new K/V token vectors into the paged cache, in place.

    ``slot_mapping`` i32[T]: flat slot per token; negative (padding) and
    out-of-range slots are dropped, as the JAX scatter's ``mode="drop"``.
    Returns ``kv_pages`` (the same tensor, updated).
    """
    p, page, h2, d = kv_pages.shape
    scatter_drop(kv_pages.view(p * page, h2, d),
                 interleave_kv(k, v).to(kv_pages.dtype), slot_mapping)
    return kv_pages


def scatter_drop(flat: torch.Tensor, rows: torch.Tensor,
                 slots: torch.Tensor) -> None:
    """``flat[slots[i]] = rows[i]`` in place for every slot in range;
    negative and out-of-range slots are dropped (the JAX scatter's
    ``mode="drop"``). No shape depends on the data, so it runs inside a
    CUDA graph: a dropped row writes what the first kept row writes (with
    none kept, slot 0's own value back), so the duplicates agree."""
    if slots.numel() == 0:
        return
    slots = slots.long()
    keep = (slots >= 0) & (slots < flat.shape[0])
    first = torch.argmax(keep.to(torch.int32)).view(1)
    any_keep = keep.any()
    anchor_slot = torch.where(any_keep, slots.index_select(0, first), 0)
    anchor_row = torch.where(any_keep, rows.index_select(0, first), flat[:1])
    wide = keep.view(-1, *([1] * (rows.dim() - 1)))
    flat.index_copy_(0, torch.where(keep, slots, anchor_slot),
                     torch.where(wide, rows, anchor_row))


def check_kv_append_args(
    kv_pages: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slot_mapping: torch.Tensor,
) -> tuple[int, int, int]:
    """The A0 wrapper's checks, run before a launch: what the kernel's
    16-byte copies do not take raises. ``k`` and ``v`` must already have
    the cache's dtype and be contiguous. Returns ``(T, Hkv, D)``."""
    if kv_pages.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"kv_append: cache dtype {kv_pages.dtype} not supported "
            "(bfloat16 or float32)"
        )
    _, _, h2, d = kv_pages.shape
    t = k.shape[0]
    if k.shape != (t, h2 // 2, d) or v.shape != k.shape:
        raise ValueError(
            f"kv_append: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
            f"the cache's [T, {h2 // 2}, {d}]"
        )
    if k.dtype != kv_pages.dtype or v.dtype != kv_pages.dtype:
        raise TypeError("kv_append: k and v must have the cache's dtype")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (t,):
        raise ValueError("kv_append: slot_mapping must be i32[T]")
    per = 16 // kv_pages.element_size()
    if d % per:
        raise ValueError(
            f"kv_append: head_dim {d} must be a multiple of {per} for "
            f"{kv_pages.dtype} (16-byte copies)"
        )
    if any(x.data_ptr() % 16 for x in (kv_pages, k, v)):
        raise ValueError("kv_append: cache, k and v must be 16-byte aligned")
    return t, h2 // 2, d


def kv_append(
    kv_pages: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slot_mapping: torch.Tensor,
) -> torch.Tensor:
    """The A0 kernel wrapper (``csrc/kv_append.cu``): the same in-place
    scatter as :func:`reshape_and_cache`, which is its plain version and
    what runs for CPU tensors. On CUDA tensors it launches the kernel or
    raises. ``k`` and ``v`` are cast and made contiguous only when they are
    not already. Returns ``kv_pages``."""
    if kv_pages.device.type == "cpu":
        return reshape_and_cache(kv_pages, k, v, slot_mapping)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    dt = kv_pages.dtype
    if k.dtype != dt or not k.is_contiguous():
        k = k.to(dt).contiguous()
    if v.dtype != dt or not v.is_contiguous():
        v = v.to(dt).contiguous()
    t, hkv, d = check_kv_append_args(kv_pages, k, v, slot_mapping)
    ck.require_cuda("kv_append", kv_pages, k, v, slot_mapping)
    p, page = kv_pages.shape[:2]
    code = ck.lib().pk_kv_append(
        k.data_ptr(), v.data_ptr(), kv_pages.data_ptr(),
        slot_mapping.data_ptr(), t, hkv, d, p * page,
        ck.dtype_code(kv_pages), ck.stream_of(kv_pages),
    )
    ck.check(code, "kv_append")
    ck.count("kv_append")
    return kv_pages
