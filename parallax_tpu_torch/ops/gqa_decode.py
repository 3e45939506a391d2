"""Split GQA flash decode with attention sinks and a sliding window: the
port of ``parallax_tpu/ops/attention_pallas.py::gqa_decode_attention_pallas``
(K6).

The split path's decode kernel for sink models (gpt-oss): one query token
per row, attention only (the step's K/V are already in the cache, written
by the split path's scatter). The sink is a virtual key with logit
``sinks[h]`` and no value, seeded into the running max and denominator as
the TPU kernel seeds them. The TPU kernel takes no soft cap, and neither
does this one.

:func:`gqa_decode_attention` is the A9 wrapper (``csrc/gqa_decode.cu``,
entry ``pk_gqa_attend``): CPU tensors take :func:`gqa_decode_attention_plain`
beside it; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.ops.attention import KERNEL_NEG, paged_attention_plain
from parallax_tpu_torch.ops.decode_fused import (
    check_decode_args,
    split_scratch,
)


def gqa_decode_attention_plain(
    q, kv_pages, kv_lens, page_indices, sinks, *, sm_scale: float,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """The plain version of A9: each row's one query token at position
    ``kv_len - 1`` over its context, sinks seeding the running max and
    denominator; rows with ``kv_len = 0`` give zeros."""
    cu = torch.arange(q.shape[0] + 1, dtype=torch.int32, device=q.device)
    return paged_attention_plain(
        q, kv_pages, kv_lens, page_indices, cu,
        sm_scale=sm_scale, sliding_window=sliding_window, soft_cap=None,
        sinks=sinks, seed_sinks=True, mask_value=KERNEL_NEG,
    )


def gqa_decode_attention(
    q: torch.Tensor,             # [S, Hq, D] — ONE query token per row
    kv_pages: torch.Tensor,      # [P, page, 2*Hkv, D], this step appended
    kv_lens: torch.Tensor,       # i32[S] INCLUDING this step's token
    page_indices: torch.Tensor,  # i32[S, pages_per_seq]
    sinks: torch.Tensor | None,  # f32[Hq] or None
    *,
    sm_scale: float,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """The A9 wrapper: split GQA flash decode (split-KV over the row's pages,
    then the ordered combine; one count per call). Returns ``out [S, Hq,
    D]`` in q's dtype."""
    if q.device.type == "cpu":
        return gqa_decode_attention_plain(
            q, kv_pages, kv_lens, page_indices, sinks, sm_scale=sm_scale,
            sliding_window=sliding_window,
        )
    from parallax_tpu_torch.ops import cuda_kernels as ck

    hq, hkv, d = check_decode_args("gqa_attend", q, kv_pages, kv_lens,
                                   page_indices, sinks)
    s = q.shape[0]
    page = kv_pages.shape[1]
    tensors = [q, kv_pages, kv_lens, page_indices]
    if sinks is not None:
        tensors.append(sinks)
    ck.require_cuda("gqa_attend", *tensors)
    out = torch.empty_like(q)
    scratch, splits = split_scratch(s, hkv, hq // hkv, d, page_indices, page)
    code = ck.lib().pk_gqa_attend(
        q.data_ptr(), kv_pages.data_ptr(), out.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, scratch.data_ptr(),
        s, hq, hkv, d, page, page_indices.shape[1], splits,
        sliding_window or 0, float(sm_scale), ck.dtype_code(kv_pages),
        ck.stream_of(q),
    )
    ck.check(code, "gqa_attend")
    ck.count("gqa_attend")
    return out
