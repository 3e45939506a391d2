"""gpt-oss stage model (port of ``parallax_tpu/models/gpt_oss.py``): attention
sinks, alternating sliding windows and a clamped-GLU MoE.

HF conventions, as in the JAX package: per-layer ``self_attn.sinks [Hq]``
(float32; the base attention block passes them to every route);
alternating ``sliding_attention`` / ``full_attention`` ``layer_types``; an
MoE with ``mlp.router.{weight,bias}`` (top-k over the raw logits, softmax
over the top-k values) and fused expert tensors ``experts.gate_up_proj
[E, H, 2I]`` (+bias) interleaving gate (even columns) and up (odd
columns), activation ``(up + 1) * gate * sigmoid(1.702 * gate)`` with
clamping, and ``experts.down_proj [E, I, H]`` (+bias).

The MoE is a dense loop over every local expert, in plain PyTorch: the JAX
package computes it outside any Pallas kernel (no grouped GEMM). Expert
parallelism (``axis_name``) is not ported.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.models.base import StageModel
from parallax_tpu_torch.models.layers import linear, linear_f32
from parallax_tpu_torch.models.moe import _topk_lowest_index
from parallax_tpu_torch.models.registry import register_model

ALPHA = 1.702
LIMIT = 7.0


def gpt_oss_moe_ffn(x: torch.Tensor, p: dict,
                    num_experts_per_tok: int) -> torch.Tensor:
    """The gpt-oss MoE FFN of ``x [T, H]``, as the JAX package computes it:
    the router product rounded to the activation dtype, then f32; top-k
    with ``jax.lax.top_k``'s tie order; softmax over the top-k values; every
    expert over every token with f32 products and biases; the weighted sum
    accumulated in f32 in expert order."""
    t, h = x.shape
    logits = linear(x, p["router"]).float()                   # [T, E]
    top_ids = _topk_lowest_index(logits, num_experts_per_tok)
    weights = torch.softmax(logits.gather(-1, top_ids), dim=-1)
    gate_up = p["experts"]["gate_up_proj"]                    # [E, H, 2I]
    gate_up_b = p["experts"]["gate_up_proj_bias"]             # [E, 2I]
    down = p["experts"]["down_proj"]                          # [E, I, H]
    down_b = p["experts"]["down_proj_bias"]                   # [E, H]
    # Each expert's weight per token: its top-k weight, 0 where not picked
    # (the ids of a row are distinct, so this is the JAX masked sum).
    w = torch.zeros((t, gate_up.shape[0]), dtype=torch.float32,
                    device=x.device).scatter_(1, top_ids, weights)
    out = torch.zeros((t, h), dtype=torch.float32, device=x.device)
    for e in range(gate_up.shape[0]):
        gu = linear_f32(x, gate_up[e].t()) + gate_up_b[e]
        gate = gu[:, 0::2].clamp(max=LIMIT)
        up = gu[:, 1::2].clamp(-LIMIT, LIMIT)
        glu = gate * torch.sigmoid(gate * ALPHA)
        y = linear_f32(((up + 1.0) * glu).to(x.dtype), down[e].t()) + down_b[e]
        out = out + y * w[:, e:e + 1]
    return out.to(x.dtype)


@register_model("GptOssForCausalLM")
class GptOssStageModel(StageModel):
    """The base GQA block with sinks on every layer and, on every layer,
    the gpt-oss MoE FFN."""

    runs_moe = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.config.moe is None:
            raise ValueError("gpt-oss requires MoE config (num_local_experts)")

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        return gpt_oss_moe_ffn(h, lp["mlp"],
                               self.config.moe.num_experts_per_tok)

    # -- params -----------------------------------------------------------

    def _init_attention(self, layer_idx: int, normal, dense, ones) -> dict:
        """The base attention params plus ``sinks``: zeros, f32[Hq]."""
        attn = super()._init_attention(layer_idx, normal, dense, ones)
        attn["sinks"] = torch.zeros(
            (self.config.num_attention_heads,), dtype=torch.float32,
            device=attn["o_proj"]["weight"].device,
        )
        return attn

    def _init_mlp(self, layer_idx: int, normal, dense) -> dict:
        """The router ``[E, H]`` and the fused experts with the JAX
        package's shapes and scales (``N(0, 1) * in_dim**-0.5``, zero
        biases), drawn router, gate_up, down."""
        cfg = self.config
        e, hdim = cfg.moe.num_experts, cfg.hidden_size
        i = cfg.moe.moe_intermediate_size or cfg.intermediate_size
        router = normal((e, hdim), hdim ** -0.5)
        gate_up = normal((e, hdim, 2 * i), hdim ** -0.5)
        down = normal((e, i, hdim), i ** -0.5)

        def zeros(*shape):
            return torch.zeros(shape, dtype=router.dtype, device=router.device)

        return {
            "router": {"weight": router, "bias": zeros(e)},
            "experts": {
                "gate_up_proj": gate_up,
                "gate_up_proj_bias": zeros(e, 2 * i),
                "down_proj": down,
                "down_proj_bias": zeros(e, hdim),
            },
        }
