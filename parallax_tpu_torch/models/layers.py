"""Functional building blocks of the dense decoder (port of
``parallax_tpu/models/layers.py``).

All blocks operate on a flattened ragged token batch ``x: [T, hidden]``.
Params are plain dicts of tensors keyed with HF weight names and the HF
``[out, in]`` weight layout, so ``F.linear`` applies directly (the matrix
products outside the kernels go to PyTorch, as the JAX package left them to
XLA). Rounding follows the JAX package: products accumulate in f32 and
round once to the activation dtype; norms compute in f32; logits are f32.

A weight-only quantized param (``ops/quant.py``: ``{qweight, scales,
biases?}`` in place of ``{weight}``) multiplies through the A10 kernel
(``ops/quant_linear.py``) on CUDA tensors, dequantizing inside the
product; on the CPU, and under the model's plain switch
(:func:`kernel_choice`, entered by ``StageModel.__call__`` with its
``use_kernels``), it is dequantized first and multiplied in plain PyTorch.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from parallax_tpu_torch.config import ModelConfig
from parallax_tpu_torch.ops.attention import append_and_attend
from parallax_tpu_torch.ops.kernel_select import resolve_use_kernels
from parallax_tpu_torch.ops.quant import dequantize_weight, is_quantized
from parallax_tpu_torch.ops.quant_linear import (
    quant_linear,
    quant_linear_plain,
)
from parallax_tpu_torch.ops.rope import apply_rope

# The calling thread's choice for the quantized products (the tri-state of
# ``kernel_select.resolve_use_kernels``): None = A10 on CUDA tensors.
_choice = threading.local()


@contextlib.contextmanager
def kernel_choice(use_kernels: bool | None):
    """Run the block with ``use_kernels`` as the quantized products' choice
    (False: the plain dequantize-then-multiply even on the card, the
    reference runs' path)."""
    outer = getattr(_choice, "flag", None)
    _choice.flag = use_kernels
    try:
        yield
    finally:
        _choice.flag = outer


def get_weight(p: dict) -> torch.Tensor:
    """The float weight of a param dict, dequantizing a quantized one (a
    plain dequantize: the port's hot products use A10 instead)."""
    if is_quantized(p):
        return dequantize_weight(p)
    return p["weight"]


def _quant_product(x: torch.Tensor, p: dict, out_dtype) -> torch.Tensor:
    """``x @ deq(p)^T`` as ``out_dtype``: A10, or its plain version."""
    fn = (quant_linear
          if resolve_use_kernels(getattr(_choice, "flag", None), x.device)
          else quant_linear_plain)
    return fn(x.contiguous(), p["qweight"], p["scales"], p.get("biases"),
              out_dtype)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, offset: float = 0.0
) -> torch.Tensor:
    """RMSNorm in f32, cast back; ``offset=1.0`` gives the zero-init
    ``x_hat * (1 + w)`` convention."""
    orig_dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (weight.float() + offset)).to(orig_dtype)


def full_proj_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """RMSNorm over a whole projection output ``[T, H * D]``, all heads
    concatenated (MiniMax-M2's qk norms), in f32, cast back. The JAX
    package's tensor-parallel statistic (``axis_name``) is not ported."""
    orig_dtype = x.dtype
    x = x.float()
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(ss / x.shape[-1] + eps)
    return (x * weight.float()).to(orig_dtype)


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm (mean-centred, optional bias) in f32, cast back; the DSA
    indexer's key norm (every other norm in the zoo is RMSNorm)."""
    orig_dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps) * p["weight"].float()
    if "bias" in p:
        out = out + p["bias"].float()
    return out.to(orig_dtype)


def _lora_delta(x: torch.Tensor, ab: dict) -> torch.Tensor:
    """Per-request LoRA correction ``(x @ A^T) @ B^T * scale`` in f32
    (``ops/lora.py``), over the stacked adapters ``A [n, r, in]``, ``B [n,
    out, r]``, ``s [n]`` and the batch's ``slot`` (i64[1], the batch's one
    adapter) or ``slots`` (i32[T], each token row's).

    The thin first product runs against EVERY adapter (``[T, n * r]``; r
    is small), a scale-folded mask keeps each row's adapter, and the
    second product contracts jointly over ``(n, r)`` as one ``[T, n * r] @
    [n * r, out]`` product: no ``[T, n, out]`` intermediate. The mask is a
    comparison, so a slot that matches no adapter (the null slot of base
    rows and padding) gives a zero delta, where ``F.one_hot`` would
    refuse it. The batch-uniform form (the JAX package's two products of
    the selected adapter) runs the same contraction with one slot for
    every row, so a row's delta has the same bits in a grouped batch and
    in a mixed one."""
    xf = x.float()
    a_mat = ab["A"]
    n, r, _ = a_mat.shape
    t = xf.shape[0]
    a_all = F.linear(xf, a_mat.reshape(n * r, -1))              # [T, n*r]
    key = ab["slots"][:, None] if "slots" in ab else ab["slot"].view(1, 1)
    mask = key.long() == torch.arange(n, device=key.device)[None, :]
    sel = mask.to(torch.float32) * ab["s"][None, :]               # [T|1, n]
    a_all = (a_all.view(t, n, r) * sel[:, :, None]).view(t, n * r)
    # B is the transposed view of a contiguous [n, r, out].
    return a_all @ ab["B"].transpose(1, 2).reshape(n * r, -1)


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ W^T + b`` with the HF ``[out, in]`` weight. A per-request LoRA
    delta (``p["lora"]``) is added after the base product is rounded to
    ``x``'s dtype, itself rounded to that dtype, and the bias last, as in
    the JAX package."""
    if is_quantized(p):
        out = _quant_product(x, p, x.dtype)
    else:
        out = F.linear(x, p["weight"])
    if "lora" in p:
        out = out + _lora_delta(x, p["lora"]).to(out.dtype)
    if "bias" in p:
        out = out + p["bias"].to(out.dtype)
    return out


def embed_lookup(embed, token_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding rows; a quantized table dequantizes only the
    gathered rows."""
    if is_quantized(embed):
        ids = token_ids.long()
        return dequantize_weight({k: v[ids] for k, v in embed.items()})
    w = embed["weight"] if isinstance(embed, dict) else embed
    return w[token_ids.long()]


def lm_head_logits(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Final projection with f32 logits."""
    return linear_f32(x, p if is_quantized(p) else p["weight"])


def linear_f32(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w^T`` with an f32 output (``preferred_element_type=f32`` in the
    JAX package). On the card a bf16 product keeps its f32 accumulator as
    the output (``torch.mm(..., out_dtype=f32)``) instead of rounding to
    bf16. ``w`` may be a quantized param dict."""
    if is_quantized(w):
        return _quant_product(x, w, torch.float32)
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return F.linear(x.float(), w.float())


def swiglu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU FFN (gate/up/down)."""
    gate = linear(x, p["gate_proj"])
    up = linear(x, p["up_proj"])
    return linear(F.silu(gate) * up, p["down_proj"])


def glu_mlp(x: torch.Tensor, p: dict, act_fn) -> torch.Tensor:
    """GLU FFN with a gating activation ``act_fn(gate, up)`` over f32
    operands (MiniMax-M3's clamped swiglu-oai dense layer)."""
    gate = linear(x, p["gate_proj"]).float()
    up = linear(x, p["up_proj"]).float()
    return linear(act_fn(gate, up).to(x.dtype), p["down_proj"])


def paged_attention_block(
    x: torch.Tensor,
    p: dict,
    kv_pages: torch.Tensor,
    *,
    config: ModelConfig,
    positions: torch.Tensor,
    kv_lens: torch.Tensor,
    page_indices: torch.Tensor,
    cu_q_lens: torch.Tensor,
    num_seqs: torch.Tensor,
    slot_mapping: torch.Tensor,
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    sliding_window: int | None = None,
    use_kernels: bool | None = None,
    decode_only: bool = False,
    decode_fused: bool = False,
    prefill_fused: bool = False,
    rope_fn=apply_rope,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GQA attention over the paged cache: project, qk-norm, rope, append,
    attend, project out. New K/V always enter the cache first (in place)
    and attention always reads the cache, so prefix hits and chunked
    prefill need no separate path. ``p["sinks"]`` (gpt-oss), when present,
    joins every head's softmax; ``use_kernels`` picks the split path's
    kernels or plain PyTorch; ``rope_fn`` is the model's rotary convention
    (GLM-4: ``apply_rope_interleaved``)."""
    t = x.shape[0]
    d = config.head_dim
    q = linear(x, p["q_proj"]).reshape(t, -1, d)
    k = linear(x, p["k_proj"]).reshape(t, -1, d)
    v = linear(x, p["v_proj"]).reshape(t, -1, d)
    hq = q.shape[1]
    if config.use_qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"]["weight"], config.rms_norm_eps)
        k = rms_norm(k, p["k_norm"]["weight"], config.rms_norm_eps)
    q = rope_fn(q, positions, cos_table, sin_table).contiguous()
    k = rope_fn(k, positions, cos_table, sin_table)
    out, kv_pages = append_and_attend(
        q, k, v, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs,
        slot_mapping,
        sm_scale=d ** -0.5,
        sliding_window=sliding_window,
        sinks=p.get("sinks"),
        use_kernels=use_kernels,
        decode_only=decode_only,
        decode_fused=decode_fused,
        prefill_fused=prefill_fused,
    )
    return linear(out.reshape(t, hq * d), p["o_proj"]), kv_pages
