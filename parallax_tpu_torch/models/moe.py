"""Mixture-of-experts FFN (port of ``parallax_tpu/models/moe.py``).

Params hold experts *stacked*, as in the JAX package:
``experts.gate_proj/up_proj: [E, I, H]``, ``experts.down_proj: [E, H, I]``.

Two compute paths with the same semantics:
- the grouped path (the JAX package's ``_moe_megablox``): sort the
  (token, expert) pairs by expert, gather their rows, one grouped product
  per projection (``ops/grouped_matmul.py``: the A4 kernel on CUDA tensors,
  its plain version on CPU tensors), then a weighted combine. ``moe_ffn``
  always takes it; ``kernel=False`` swaps in the plain grouped product on
  any device, as the explicit reference for comparisons on the card;
- ``_moe_fallback``: a masked loop over experts, O(E) products over every
  token. Kept for verification; serving never takes it.

Quantized expert stacks (``ops/quant.py`` dicts with a leading expert
axis) take A11 (``ops/quant_linear.py::grouped_matmul_q``) on the grouped
path, and its plain version (the stack dequantized, then the plain grouped
product) with ``kernel=False``; ``_moe_fallback`` dequantizes the stack.
A quantized shared expert multiplies through A10 (``layers.linear_f32``),
which follows the model's plain switch as every dense product does.

The router product, sort, gather and combine are plain torch ops (XLA ops
in the JAX package). Expert parallelism (``axis_name``) is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallax_tpu_torch.config import MoEConfig
from parallax_tpu_torch.models.layers import linear, linear_f32
from parallax_tpu_torch.ops.grouped_matmul import (
    grouped_matmul,
    grouped_matmul_plain,
)
from parallax_tpu_torch.ops.quant import dequantize_weight, is_quantized
from parallax_tpu_torch.ops.quant_linear import (
    grouped_matmul_q,
    grouped_matmul_q_plain,
)


def _topk_lowest_index(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries per row, ties to the lower
    index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no
    order): a stable descending sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def route_topk(
    x: torch.Tensor,
    router_weight: torch.Tensor,
    moe: MoEConfig,
    bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Router: returns (weights f32[T, K], expert_ids i32[T, K]).

    ``bias`` (e_score_correction_bias) shifts the *selection* scores only;
    gate weights come from the unbiased scores. ``n_group``/``topk_group``
    restrict selection to the best expert groups (group score = sum of each
    group's top-2 biased scores, or its best one for
    ``group_limited_greedy``)."""
    logits = linear_f32(x, router_weight)
    if moe.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)

    selection = scores if bias is None else scores + bias.float()
    if moe.n_group > 1 and moe.topk_group > 0:
        t, e = selection.shape
        per_group = selection.reshape(t, moe.n_group, e // moe.n_group)
        if moe.topk_method == "group_limited_greedy":
            group_score = per_group.amax(dim=-1)
        else:
            top2 = min(2, e // moe.n_group)
            group_score = torch.sort(per_group, dim=-1,
                                     descending=True)[0][..., :top2].sum(-1)
        top_groups = _topk_lowest_index(group_score, moe.topk_group)
        group_mask = torch.zeros((t, moe.n_group), dtype=torch.bool,
                                 device=x.device)
        group_mask.scatter_(1, top_groups, True)
        mask = group_mask.repeat_interleave(e // moe.n_group, dim=-1)
        selection = selection.masked_fill(~mask, float("-inf"))

    ids = _topk_lowest_index(selection, moe.num_experts_per_tok)
    weights = torch.gather(scores, 1, ids)
    if moe.norm_topk_prob:
        weights = weights / torch.clamp_min(
            weights.sum(dim=-1, keepdim=True), 1e-20
        )
    weights = weights * moe.routed_scaling_factor
    return weights.float(), ids.to(torch.int32)


def _silu_glu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(g) * u


def _expert_ffn(x, gate_w, up_w, down_w, act_fn=_silu_glu):
    """GLU for one expert's weight slices ([I,H],[I,H],[H,I]), each a tensor
    or a quantized param dict: f32 gate and up, the activation in f32
    rounded to ``x``'s dtype, f32 output."""
    g = linear_f32(x, gate_w)
    u = linear_f32(x, up_w)
    h = act_fn(g, u).to(x.dtype)
    return linear_f32(h, down_w)


def _moe_fallback(x, p, weights, ids, act_fn=_silu_glu):
    """Masked per-expert loop; correct for any routing, O(E) products."""
    gate_w, up_w, down_w = (
        dequantize_weight(w) if is_quantized(w) else w
        for w in (p["experts"][k] for k in ("gate_proj", "up_proj",
                                            "down_proj")))
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for e in range(gate_w.shape[0]):
        w = torch.where(ids == e, weights, 0.0).sum(dim=-1)   # [T]
        y = _expert_ffn(x, gate_w[e], up_w[e], down_w[e], act_fn)
        out = out + y * w[:, None]
    return out


def _moe_grouped(x, p, weights, ids, act_fn=_silu_glu, kernel=True):
    """Grouped path: sort the (token, expert) pairs by expert (stable, as
    ``jnp.argsort``), one grouped product per projection, then gather each
    token's K contributions back through the inverse permutation and sum
    them in f32. The group offsets stay on the device; no atomics."""
    ex = p["experts"]

    def gmm(lhs, rhs, offs):
        if is_quantized(rhs):
            fn = grouped_matmul_q if kernel else grouped_matmul_q_plain
        else:
            fn = grouped_matmul if kernel else grouped_matmul_plain
        return fn(lhs, rhs, offs)

    t, k = ids.shape
    gp = ex["gate_proj"]
    e = (gp["qweight"] if is_quantized(gp) else gp).shape[0]
    flat_ids = ids.reshape(-1).long()
    order = torch.argsort(flat_ids, stable=True)
    xs = x[order // k]                                   # [T*K, H]
    # Group g starts at the first sorted pair with id >= g. (torch.bincount
    # would read its input's maximum on the host: a sync per layer.)
    offsets = torch.searchsorted(
        flat_ids[order], torch.arange(e + 1, device=x.device)
    ).to(torch.int32)

    g = gmm(xs, ex["gate_proj"], offsets)                # f32 [T*K, I]
    u = gmm(xs, ex["up_proj"], offsets)
    h = act_fn(g, u).to(x.dtype)
    y = gmm(h, ex["down_proj"], offsets)                 # f32 [T*K, H]

    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=x.device)
    y = y[inverse].reshape(t, k, -1)                     # slot order
    return (y * weights[:, :, None]).sum(dim=1)


def moe_ffn(
    x: torch.Tensor,
    p: dict,
    moe: MoEConfig,
    act_fn=_silu_glu,
    kernel: bool = True,
) -> torch.Tensor:
    """Full MoE block: route, the routed experts on the grouped path, plus
    the optional shared expert (and its sigmoid gate, as Qwen2-MoE has).
    ``kernel=False`` runs the plain grouped product (the reference)."""
    weights, ids = route_topk(x, p["gate"]["weight"], moe,
                              bias=p["gate"].get("e_score_correction_bias"))
    out = _moe_grouped(x, p, weights, ids, act_fn, kernel)

    if "shared_expert" in p:
        se = p["shared_expert"]
        shared = _expert_ffn(x, *(
            w if is_quantized(w) else w["weight"]
            for w in (se[k] for k in ("gate_proj", "up_proj", "down_proj"))
        ), act_fn)
        if "shared_expert_gate" in p:
            shared = shared * torch.sigmoid(
                linear(x, p["shared_expert_gate"]).float()
            )
        out = out + shared
    return out.to(x.dtype)
