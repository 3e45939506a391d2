"""Grouped matrix product over expert-sorted rows (the port's counterpart of
``jax.experimental.pallas.ops.tpu.megablox.gmm`` as
``parallax_tpu/models/moe.py::_moe_megablox`` calls it).

``lhs[M, K]`` holds rows sorted by group; ``group_offsets i32[E + 1]`` is
the cumulative row count (``offsets[0] == 0``, ``offsets[E] == M``), so
group ``g`` owns rows ``offsets[g]:offsets[g + 1]`` and may be empty. The
weights are ``rhs[E, N, K]``, as the JAX package stacks expert weights
(``[E, I, H]`` gate/up, ``[E, H, I]`` down), and the result is
``out[rows of g] = lhs[rows of g] @ rhs[g]^T`` in f32: what
``gmm(lhs, swapaxes(rhs, 1, 2), group_sizes)`` returns.
"""

from __future__ import annotations

import torch


def _check(lhs: torch.Tensor, rhs: torch.Tensor,
           group_offsets: torch.Tensor) -> None:
    if lhs.dim() != 2 or rhs.dim() != 3 or rhs.shape[2] != lhs.shape[1]:
        raise ValueError(
            f"grouped_matmul: want lhs [M, K] and rhs [E, N, K], got "
            f"{tuple(lhs.shape)} and {tuple(rhs.shape)}"
        )
    if group_offsets.shape != (rhs.shape[0] + 1,):
        raise ValueError(
            f"grouped_matmul: group_offsets must be [E + 1] = "
            f"[{rhs.shape[0] + 1}], got {tuple(group_offsets.shape)}"
        )


def grouped_matmul_plain(
    lhs: torch.Tensor,            # [M, K]
    rhs: torch.Tensor,            # [E, N, K]
    group_offsets: torch.Tensor,  # i32[E + 1]
) -> torch.Tensor:
    """The plain version of the A4 kernel: one product per non-empty group,
    summed and returned in f32 (on the card a bf16 product keeps cuBLAS's
    f32 accumulator, ``out_dtype=float32``). Reads the offsets on the
    host."""
    _check(lhs, rhs, group_offsets)
    m = lhs.shape[0]
    e, n, _ = rhs.shape
    offs = group_offsets.tolist()
    if offs[0] != 0 or offs[-1] != m:
        raise ValueError(
            f"grouped_matmul: group_offsets must run from 0 to M = {m}"
        )
    low = lhs.is_cuda and lhs.dtype != torch.float32
    out = torch.zeros((m, n), dtype=torch.float32, device=lhs.device)
    for g in range(e):
        a, b = offs[g], offs[g + 1]
        if b <= a:
            continue
        if low:
            out[a:b] = torch.mm(lhs[a:b], rhs[g].t(), out_dtype=torch.float32)
        else:
            out[a:b] = lhs[a:b].float() @ rhs[g].float().t()
    return out


def grouped_matmul(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_offsets: torch.Tensor,
) -> torch.Tensor:
    """The A4 wrapper (``csrc/grouped_gemm.cu``): f32[M, N]. CPU tensors
    take :func:`grouped_matmul_plain`; CUDA tensors launch the kernel or
    raise. The kernel takes bf16 operands with K a multiple of 8, and reads
    the offsets on the device (no host sync)."""
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, group_offsets)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    _check(lhs, rhs, group_offsets)
    m, k = lhs.shape
    e, n, _ = rhs.shape
    if lhs.dtype != torch.bfloat16 or rhs.dtype != torch.bfloat16:
        raise TypeError(
            f"grouped_gemm: the kernel takes bf16 operands, got {lhs.dtype} "
            f"and {rhs.dtype}"
        )
    if group_offsets.dtype != torch.int32:
        raise TypeError("grouped_gemm: group_offsets must be int32")
    if k % 8:
        raise ValueError(f"grouped_gemm: K = {k} must be a multiple of 8")
    ck.require_cuda("grouped_gemm", lhs, rhs, group_offsets)
    if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("grouped_gemm: operands must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=lhs.device)
    code = ck.lib().pk_grouped_gemm(
        lhs.data_ptr(), rhs.data_ptr(), group_offsets.data_ptr(),
        out.data_ptr(), m, n, k, e, ck.stream_of(lhs),
    )
    ck.check(code, "grouped_gemm")
    ck.LAUNCHES["grouped_gemm"] += 1
    return out
