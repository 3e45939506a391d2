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

The kernel (``csrc/grouped_gemm.cu``) has two variants, picked from M on
the host: ``prefill`` cuts each group into 128-row tiles of 256 columns,
``decode`` into 16-row tiles against 64-row weight slabs. The constants
below and :func:`tile_map` are the Python twins of the kernel's; the tests
hold them to the source.
"""

from __future__ import annotations

import torch

# csrc/grouped_gemm.cu: kDecodeMaxRows, kPBM / kPBN / kPStages, kDBM /
# kDBN / kDStages, kBK.
DECODE_MAX_ROWS = 512
TILE_ROWS = {"prefill": 128, "decode": 16}
TILE_COLS = {"prefill": 256, "decode": 64}
STAGES = {"prefill": 4, "decode": 6}
BK = 64
# The C entry's ``variant`` argument; None picks by M.
VARIANTS = {None: 0, "prefill": 1, "decode": 2}


def variant_for(m: int, variant: str | None = None) -> str:
    """The variant the kernel runs for M rows (``variant`` forces one)."""
    if variant is not None:
        return variant
    return "decode" if m <= DECODE_MAX_ROWS else "prefill"


def grid_tiles(m: int, e: int, variant: str) -> int:
    """The static bound of row tiles the kernel launches: every non-empty
    group wastes less than one tile, and at most min(E, M) are non-empty."""
    bm = TILE_ROWS[variant]
    return (m + min(e, m) * (bm - 1)) // bm


def tile_map(offsets: list[int], variant: str) -> list[tuple[int, int, int]]:
    """The device-side tile map's twin: tile i's ``(group, first row, group
    end)``, groups in order, each cut into ceil(rows / BM) tiles; empty
    groups own none."""
    bm = TILE_ROWS[variant]
    tiles = []
    for g in range(len(offsets) - 1):
        a, b = offsets[g], offsets[g + 1]
        tiles.extend((g, r, b) for r in range(a, b, bm))
    return tiles


def smem_bytes(variant: str) -> int:
    """A block's dynamic shared memory: the ring (lhs and weight tiles of BK
    bf16 a row), two mbarriers a stage, and 1024 bytes of alignment."""
    rows = TILE_ROWS[variant] + TILE_COLS[variant]
    return STAGES[variant] * (rows * BK * 2 + 16) + 1024


def _check_variant(variant, name: str = "grouped_gemm") -> None:
    if variant not in VARIANTS:
        raise ValueError(
            f"{name}: variant must be None, 'prefill' or 'decode', "
            f"got {variant!r}"
        )


def _check_shapes(lhs: torch.Tensor, rhs: torch.Tensor,
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
    _check_shapes(lhs, rhs, group_offsets)
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


def check_grouped_args(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_offsets: torch.Tensor,
    variant: str | None = None,
) -> tuple[int, int, int, int]:
    """The A4 wrapper's checks, run before a launch: what the kernel does
    not take raises. Returns ``(M, N, K, E)``."""
    _check_variant(variant)
    _check_shapes(lhs, rhs, group_offsets)
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
    if lhs.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("grouped_gemm: operands must be 16-byte aligned")
    return m, n, k, e


def grouped_matmul(
    lhs: torch.Tensor,
    rhs: torch.Tensor,
    group_offsets: torch.Tensor,
    *,
    _variant: str | None = None,
) -> torch.Tensor:
    """The A4 wrapper (``csrc/grouped_gemm.cu``): f32[M, N]. CPU tensors
    take :func:`grouped_matmul_plain`; CUDA tensors launch the kernel or
    raise. The kernel takes bf16 operands with K a multiple of 8, and reads
    the offsets on the device (no host sync). ``_variant`` ("prefill" or
    "decode") forces a variant, so that both can be held against the plain
    version at one shape; the port never passes it."""
    if lhs.device.type == "cpu":
        _check_variant(_variant)
        return grouped_matmul_plain(lhs, rhs, group_offsets)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    m, n, k, e = check_grouped_args(lhs, rhs, group_offsets, _variant)
    ck.require_cuda("grouped_gemm", lhs, rhs, group_offsets)
    out = torch.empty((m, n), dtype=torch.float32, device=lhs.device)
    code = ck.lib().pk_grouped_gemm(
        lhs.data_ptr(), rhs.data_ptr(), group_offsets.data_ptr(),
        out.data_ptr(), m, n, k, e, VARIANTS[_variant], ck.stream_of(lhs),
    )
    ck.check(code, "grouped_gemm")
    ck.count("grouped_gemm")
    return out
