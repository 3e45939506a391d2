"""Weight-only affine quantization (int8 / int4), HF FP8 block and MXFP4
dequantization, and the per-token float8 wire format (port of
``parallax_tpu/ops/quant.py``).

A quantized parameter is a dict ``{"qweight": u8[O, I], "scales": [O,
I/g], "biases": [O, I/g]}`` in place of ``{"weight"}``: one value per byte
for int8 and int4 alike (the JAX package's layout), ``w = scales * q +
biases`` along the input dim (the MLX affine convention, so MLX community
checkpoints load bit for bit). Stacked MoE experts carry a leading expert
axis. ``models/layers.py`` multiplies such a dict with the A10 kernel
(``ops/quant_linear.py``) and ``models/moe.py`` a stacked one with A11, so
HBM holds only the quantized bytes; the plain versions dequantize with
:func:`dequantize_weight` first.

Everything here works on tensors on any device. :func:`quantize_array` is
bitwise numpy's on the same float32 input (min, max, an IEEE divide and a
round-half-even), so a tree quantized on the card equals one quantized on
the host; :func:`quantize_tree` quantizes leaf by leaf on each leaf's own
device and updates the tree's dicts in place, so a float leaf is freed as
soon as its quantized form exists (the caller holds no other reference).
"""

from __future__ import annotations

import torch


def unpack_uint32(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """MLX packed uint32 words -> u8 values, one per element (little-endian
    within each word: value j of word k is column ``k * (32/bits) + j``).
    The words may be held as ``uint32`` or as ``int32`` with the same
    bits."""
    per = 32 // bits
    mask = (1 << bits) - 1
    if packed.dtype == torch.uint32:
        packed = packed.view(torch.int32)
    # Arithmetic shifts of the int32 view: the mask drops the sign bits.
    parts = [((packed >> (bits * i)) & mask).to(torch.uint8)
             for i in range(per)]
    out = torch.stack(parts, dim=-1)             # [..., W, per]
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * per)


def pack_uint32(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`unpack_uint32`: the words as ``int32`` holding the
    uint32 bits (``.view(torch.uint32)`` names them so)."""
    per = 32 // bits
    v = values.to(torch.int64).reshape(*values.shape[:-1],
                                       values.shape[-1] // per, per)
    out = torch.zeros(v.shape[:-1], dtype=torch.int64, device=values.device)
    for i in range(per):
        out |= v[..., i] << (bits * i)
    # Words past 2**31 wrap to the int32 with the same bits.
    return (out - ((out >> 31) << 32)).to(torch.int32)


def dequant_fp8_block(w: torch.Tensor, scale_inv: torch.Tensor,
                      block: tuple[int, int] = (128, 128)) -> torch.Tensor:
    """Dequantize an HF FP8 block-quantized weight (the DeepSeek / Qwen
    ``-FP8`` checkpoints: ``weight`` float8_e4m3 + ``weight_scale_inv``
    [ceil(out/b0), ceil(in/b1)]) to float32: each (b0, b1) block times its
    scale."""
    b0, b1 = block
    out_dim, in_dim = w.shape
    scale_inv = scale_inv.float()
    want = (-(-out_dim // b0), -(-in_dim // b1))
    if tuple(scale_inv.shape) != want:
        raise ValueError(
            f"fp8 scale grid {tuple(scale_inv.shape)} != {want} for weight "
            f"{tuple(w.shape)} at block size {tuple(block)}"
        )
    s = scale_inv.repeat_interleave(b0, dim=0)[:out_dim]
    s = s.repeat_interleave(b1, dim=1)[:, :in_dim]
    return w.float() * s


def convert_gptq_weight(
    qweight: torch.Tensor,   # i32[in/(32/bits), out] packed along IN
    qzeros: torch.Tensor,    # i32[in/group, out/(32/bits)] packed zeros
    scales: torch.Tensor,    # [in/group, out]
    g_idx: torch.Tensor | None,
    bits: int,
    zero_offset: int = 1,
) -> dict:
    """GPTQ checkpoint tensors -> the affine param dict.

    GPTQ's ``w[i, o] = s[g, o] * (q[i, o] - (z[g, o] + off))`` (``off`` 1
    for AutoGPTQ v1 storage, 0 for ``gptq_v2``), transposed to the HF
    ``[out, in]`` layout, is ``w = q * scale + bias`` with ``bias = -scale
    * (z + off)``. Activation-ordered checkpoints (``desc_act``: a
    non-trivial ``g_idx``) have no contiguous groups and come back as a
    float32 ``{"weight"}``."""
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported GPTQ bit width {bits} (want 2/4/8)")
    pack = 32 // bits
    in_dim = qweight.shape[0] * pack
    groups, out_dim = scales.shape
    group_size = in_dim // groups

    q = unpack_uint32(qweight.t().contiguous(), bits).t()   # [in, out]
    z = unpack_uint32(qzeros, bits)                         # [groups, out]
    zp = z.float() + zero_offset
    scales = scales.float()

    trivial = g_idx is None or torch.equal(
        g_idx.to(torch.int64),
        torch.arange(in_dim, device=g_idx.device) // group_size,
    )
    if not trivial:
        g = g_idx.long()
        w = scales[g] * (q.float() - zp[g])               # [in, out]
        return {"weight": w.t().contiguous()}
    return {
        "qweight": q.t().contiguous(),                    # [out, in] u8
        "scales": scales.t().contiguous(),                # [out, groups]
        "biases": (-scales * zp).t().contiguous(),
    }


# Largest finite float8_e4m3fn value: per-token wire scales map each row's
# absmax to it (e4m3fn has no inf).
FP8_E4M3_MAX = 448.0


def quantize_fp8_per_token(
    arr: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token fp8 compression of activation frames: each row of ``arr``
    [..., hidden] scaled by its own absmax into float8_e4m3fn range,
    ``arr ~= q * scales[..., None]``. Returns ``(q float8_e4m3fn, scales
    float32[...])``. torch's conversion gives ml_dtypes' bytes wherever
    the scaled values stay within 448, which per-token scaling keeps for
    finite rows."""
    a = arr.float()
    if a.numel():
        amax = a.abs().amax(dim=-1)
    else:
        amax = torch.zeros(a.shape[:-1], dtype=torch.float32,
                           device=a.device)
    scales = torch.clamp_min(amax / torch.full_like(amax, FP8_E4M3_MAX),
                             1e-12)
    q = (a / scales[..., None]).to(torch.float8_e4m3fn)
    return q, scales


def dequantize_fp8_per_token(q: torch.Tensor, scales: torch.Tensor,
                             dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_fp8_per_token`."""
    return (q.float() * scales.float()[..., None]).to(dtype)


# FP4 e2m1 values by nibble (OCP MX spec; the HF gpt-oss reference's).
_FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
               -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def dequant_mxfp4(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """OCP MXFP4 -> float32: ``blocks`` u8[..., G, B] holds two e2m1
    nibbles a byte (low nibble first), ``scales`` u8[..., G] the shared
    e8m0 block exponent (value - 127). Returns [..., G * B * 2]."""
    *lead, g, b = blocks.shape
    if tuple(scales.shape) != (*lead, g):
        raise ValueError(
            f"mxfp4 scales shape {tuple(scales.shape)} != {(*lead, g)}"
        )
    table = torch.tensor(_FP4_VALUES, dtype=torch.float32,
                         device=blocks.device)
    vals = torch.empty((*lead, g, b * 2), dtype=torch.float32,
                       device=blocks.device)
    vals[..., 0::2] = table[(blocks & 0x0F).long()]
    vals[..., 1::2] = table[(blocks >> 4).long()]
    exp = scales.to(torch.int32) - 127
    vals = torch.ldexp(vals, exp[..., None])
    return vals.reshape(*lead, g * b * 2)


def quantize_array(
    w: torch.Tensor, bits: int = 8, group_size: int = 64
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Affine group quantization along the last axis, on ``w``'s device.

    Returns ``(q u8[..., I], scales f32[..., I/g], biases f32[..., I/g])``
    with ``w ~= scales * q + biases`` (MLX: scales = (max - min) / (2^b -
    1), biases = min), bitwise numpy's for the same float32 input."""
    w = w.float()
    *lead, last = w.shape
    if last % group_size:
        raise ValueError(f"last dim {last} is not a multiple of the group "
                         f"size {group_size}")
    g = w.reshape(*lead, last // group_size, group_size)
    lo = g.amin(dim=-1)
    hi = g.amax(dim=-1)
    qmax = (1 << bits) - 1
    # A tensor divisor: torch divides a CUDA tensor by a Python scalar as a
    # product with its reciprocal, which is not numpy's IEEE quotient.
    scales = torch.clamp_min((hi - lo) / torch.full_like(hi, qmax), 1e-8)
    # One group-sized temporary at a time: the leaf may be GBs.
    q = g - lo[..., None]
    q.div_(scales[..., None]).round_().clamp_(0, qmax)
    return q.to(torch.uint8).reshape(*lead, last), scales, lo


def dequantize_weight(p: dict, dtype=None) -> torch.Tensor:
    """The float weight of a quantized param dict: ``q * scale + bias`` in
    float32, rounded once to ``dtype`` (default: the scales' dtype)."""
    q = p["qweight"]
    scales = p["scales"]
    biases = p.get("biases")
    *lead, last = q.shape
    groups = scales.shape[-1]
    gsz = last // groups
    w = q.reshape(*lead, groups, gsz).float() * scales[..., None].float()
    if biases is not None:
        w = w + biases[..., None].float()
    return w.reshape(*lead, last).to(dtype or scales.dtype)


def quantize_param_dict(weight: torch.Tensor, bits: int = 8,
                        group_size: int = 64,
                        dtype=torch.bfloat16) -> dict:
    """Quantize one linear weight into the param-dict form."""
    q, scales, biases = quantize_array(weight, bits, group_size)
    return {"qweight": q, "scales": scales.to(dtype),
            "biases": biases.to(dtype)}


# Leaves eligible for on-load quantization: projection weights only; norms,
# biases, embeddings, routers and sinks stay in full precision.
_QUANT_LEAF_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj", "q_a_proj", "q_b_proj", "kv_a_proj_with_mqa", "kv_b_proj",
    "wq_b", "wk", "weights_proj", "index_q_proj", "index_k_proj",
    "lm_head",
)
_EXPERT_STACKS = ("gate_proj", "up_proj", "down_proj")


def quantize_tree(tree, bits: int = 8, group_size: int = 64,
                  dtype=torch.bfloat16, _name: str = ""):
    """Replace eligible ``{"weight": ...}`` dicts (and stacked expert
    tensors ``experts.{gate,up,down}_proj [E, ., .]``) with quantized
    params, as the JAX package's ``quantize_tree`` does, skipping weights
    whose input dim is not a multiple of ``group_size``. The tree's dicts
    and lists are updated in place, one leaf at a time on the leaf's own
    device; returns the tree."""
    if isinstance(tree, dict):
        if _name == "experts" and all(
            getattr(tree.get(k), "ndim", 0) == 3 for k in _EXPERT_STACKS
        ):
            for k in _EXPERT_STACKS:
                if tree[k].shape[-1] % group_size:
                    continue
                tree[k] = quantize_param_dict(tree[k], bits, group_size,
                                              dtype)
            return tree
        w = tree.get("weight")
        if (
            isinstance(w, torch.Tensor)
            and _name in _QUANT_LEAF_NAMES
            and w.ndim == 2
            and w.shape[-1] % group_size == 0
        ):
            tree.update(quantize_param_dict(w, bits, group_size, dtype))
            del tree["weight"], w
            return tree
        for k in list(tree):
            tree[k] = quantize_tree(tree[k], bits, group_size, dtype, k)
        return tree
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            tree[i] = quantize_tree(v, bits, group_size, dtype, _name)
        return tree
    return tree


def is_quantized(p) -> bool:
    """Whether a param (a dict or a tensor) is in the quantized form."""
    return isinstance(p, dict) and "qweight" in p
