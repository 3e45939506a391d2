"""Products with weight-only quantized weights: A10 ``quant_linear`` (dense)
and A11 ``grouped_gemm_q`` (MoE experts), both in ``csrc/quant_linear.cu``.

The JAX package multiplies a quantized param (``ops/quant.py``: u8 values
one per byte, per-group scales and optional biases) by dequantizing it in
the consuming ``dot_general``, and XLA fuses the dequantization into the
product. The port does the same inside hand-written kernels, so HBM holds
only the quantized bytes and no bf16 weight is written per call:

- :func:`quant_linear`: ``out[M, N] = x[M, K] @ deq(q[N, K])^T``;
- :func:`grouped_matmul_q`: A4's contract (``ops/grouped_matmul.py``:
  ``lhs[M, K]`` sorted by group, ``group_offsets i32[E + 1]``, f32 out)
  over a quantized stack ``q[E, N, K]``, ``scales`` / ``biases`` ``[E, N,
  K/g]``.

``deq = bf16(f32(q) * f32(s) + f32(b))``: the weight is rounded to the
scales' dtype (bf16) before the product, as ``dequantize_weight`` does; the
products accumulate in f32. The plain versions (``dequantize_weight``,
then ``F.linear`` / ``grouped_matmul_plain``) take CPU tensors; CUDA
tensors launch the kernel or raise.

Each kernel has two variants, picked on the host from M (A10 at
:data:`DECODE_MAX_ROWS`, A11 at :data:`GROUPED_DECODE_MAX_ROWS`, both set
from ``chip_smoke.py``'s crossover sweep): ``decode`` (for A11, tiles of
up to 8 rows of one group) streams the u8 weight rows with 16-byte loads
and dequantizes in registers; ``prefill`` dequantizes 64 x 32 weight
tiles into shared memory and multiplies with ``mma.sync`` on the tensor
cores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallax_tpu_torch.ops.grouped_matmul import (
    VARIANTS,
    _check_shapes,
    _check_variant,
    grouped_matmul_plain,
)
from parallax_tpu_torch.ops.quant import dequantize_weight

# csrc/quant_linear.cu: kDecodeMaxRows (A10), kQDecodeMaxRows (A11): the
# largest M that takes the decode variant.
DECODE_MAX_ROWS = 48
GROUPED_DECODE_MAX_ROWS = 128
# The group sizes the kernels take.
GROUP_SIZES = (32, 64, 128)
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def variant_for(m: int, variant: str | None = None) -> str:
    """A10's variant for M rows (``variant`` forces one)."""
    if variant is not None:
        return variant
    return "decode" if m <= DECODE_MAX_ROWS else "prefill"


def grouped_variant_for(m: int, variant: str | None = None) -> str:
    """A11's variant for M rows (``variant`` forces one)."""
    if variant is not None:
        return variant
    return "decode" if m <= GROUPED_DECODE_MAX_ROWS else "prefill"


def _group_size(q: torch.Tensor, scales: torch.Tensor) -> int:
    k, groups = q.shape[-1], scales.shape[-1]
    if groups <= 0 or k % groups:
        raise ValueError(f"quantized weight: {groups} scale groups do not "
                         f"divide K = {k}")
    return k // groups


def _check_quant_args(name: str, x: torch.Tensor, q: torch.Tensor,
                      scales: torch.Tensor, biases, out_dtype,
                      variant) -> int:
    """The wrappers' checks before a launch: what the kernels do not take
    raises. Returns the group size."""
    _check_variant(variant, name)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 activations, got "
                        f"{x.dtype}")
    if q.dtype != torch.uint8:
        raise TypeError(f"{name}: qweight must be uint8, got {q.dtype}")
    if scales.dtype != torch.bfloat16 or (
            biases is not None and biases.dtype != torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes bf16 scales and biases, "
                        f"got {scales.dtype}")
    if biases is not None and biases.shape != scales.shape:
        raise ValueError(f"{name}: biases {tuple(biases.shape)} != scales "
                         f"{tuple(scales.shape)}")
    if out_dtype not in _OUT_CODES:
        raise TypeError(f"{name}: output dtype must be bf16 or f32, got "
                        f"{out_dtype}")
    g = _group_size(q, scales)
    if g not in GROUP_SIZES:
        raise ValueError(f"{name}: group size {g} is not one the kernel "
                         f"takes {GROUP_SIZES}")
    for t in (x, q):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    return g


def quant_linear_plain(x: torch.Tensor, q: torch.Tensor,
                       scales: torch.Tensor, biases: torch.Tensor | None,
                       out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain version of A10: dequantize, then one product, rounded once
    to ``out_dtype`` (default ``x``'s; f32 keeps the accumulator, as
    ``layers.linear_f32`` does)."""
    w = dequantize_weight({"qweight": q, "scales": scales,
                           **({} if biases is None else {"biases": biases})})
    out_dtype = out_dtype or x.dtype
    if out_dtype == torch.float32:
        if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
            # cuBLAS's f32 accumulator as the output, unrounded.
            return torch.mm(x.reshape(-1, x.shape[-1]), w.t(),
                            out_dtype=torch.float32).reshape(
                                *x.shape[:-1], w.shape[0])
        return F.linear(x.float(), w.float())
    dt = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(dt), w.to(dt)).to(out_dtype)


def quant_linear(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                 biases: torch.Tensor | None,
                 out_dtype: torch.dtype | None = None, *,
                 _variant: str | None = None) -> torch.Tensor:
    """The A10 wrapper: ``x [..., K] @ deq(q [N, K])^T`` as ``out_dtype``
    (default ``x``'s). CPU tensors take :func:`quant_linear_plain`; CUDA
    tensors launch the kernel or raise (bf16 ``x``, scales and biases; a
    group size of 32, 64 or 128, so K, which it divides, is a multiple of
    16: 16-byte rows of ``q``). ``_variant`` forces
    a variant, so that both can be held against the plain version at one
    shape; the port never passes it."""
    if x.device.type == "cpu":
        _check_variant(_variant, "quant_linear")
        return quant_linear_plain(x, q, scales, biases, out_dtype)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    out_dtype = out_dtype or x.dtype
    if q.dim() != 2 or scales.dim() != 2 or scales.shape[0] != q.shape[0] \
            or x.shape[-1] != q.shape[1]:
        raise ValueError(f"quant_linear: want x [.., K], q [N, K], scales "
                         f"[N, K/g]; got {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scales.shape)}")
    g = _check_quant_args("quant_linear", x, q, scales, biases, out_dtype,
                          _variant)
    x2 = x.reshape(-1, x.shape[-1])
    ck.require_cuda("quant_linear", x2, q, scales,
                    *(() if biases is None else (biases,)))
    m, k = x2.shape
    n = q.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m:
        code = ck.lib().pk_quant_linear(
            x2.data_ptr(), q.data_ptr(), scales.data_ptr(),
            0 if biases is None else biases.data_ptr(), out.data_ptr(),
            m, n, k, g, _OUT_CODES[out_dtype], VARIANTS[_variant],
            ck.stream_of(x2))
        ck.check(code, "quant_linear")
        ck.count("quant_linear")
    return out.reshape(*x.shape[:-1], n)


def grouped_matmul_q_plain(lhs: torch.Tensor, qrhs: dict,
                           group_offsets: torch.Tensor) -> torch.Tensor:
    """The plain version of A11: the stack dequantized
    (``dequantize_weight``), then ``grouped_matmul_plain``."""
    return grouped_matmul_plain(lhs, dequantize_weight(qrhs), group_offsets)


def grouped_matmul_q(lhs: torch.Tensor, qrhs: dict,
                     group_offsets: torch.Tensor, *,
                     _variant: str | None = None) -> torch.Tensor:
    """The A11 wrapper: f32[M, N], ``lhs`` rows of group g times
    ``deq(qrhs[g])^T``. CPU tensors take :func:`grouped_matmul_q_plain`;
    CUDA tensors launch the kernel or raise. The offsets are read on the
    device (no host sync); ``_variant`` forces a variant (tests only)."""
    q, scales, biases = qrhs["qweight"], qrhs["scales"], qrhs.get("biases")
    if lhs.device.type == "cpu":
        _check_variant(_variant, "grouped_gemm_q")
        return grouped_matmul_q_plain(lhs, qrhs, group_offsets)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    _check_shapes(lhs, q, group_offsets)
    if scales.dim() != 3 or scales.shape[:2] != q.shape[:2]:
        raise ValueError(f"grouped_gemm_q: scales must be [E, N, K/g], got "
                         f"{tuple(scales.shape)} for q {tuple(q.shape)}")
    g = _check_quant_args("grouped_gemm_q", lhs, q, scales, biases,
                          torch.float32, _variant)
    if group_offsets.dtype != torch.int32:
        raise TypeError("grouped_gemm_q: group_offsets must be int32")
    ck.require_cuda("grouped_gemm_q", lhs, q, scales, group_offsets,
                    *(() if biases is None else (biases,)))
    m, k = lhs.shape
    e, n, _ = q.shape
    out = torch.empty((m, n), dtype=torch.float32, device=lhs.device)
    code = ck.lib().pk_grouped_gemm_q(
        lhs.data_ptr(), q.data_ptr(), scales.data_ptr(),
        0 if biases is None else biases.data_ptr(), group_offsets.data_ptr(),
        out.data_ptr(), m, n, k, e, g, VARIANTS[_variant], ck.stream_of(lhs))
    ck.check(code, "grouped_gemm_q")
    ck.count("grouped_gemm_q")
    return out
