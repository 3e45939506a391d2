"""GLM-4 family stage models, dense and MoE (port of
``parallax_tpu/models/glm4.py``).

GLM-4 against the llama family: GPT-J interleaved partial rotary
(``partial_rotary_factor`` 0.5 rotates the first half of each head), a
fused ``gate_up_proj`` MLP in the dense checkpoints (split into gate / up
halves by ``finalize_params``) and sandwich norms
(``post_self_attn_layernorm`` / ``post_mlp_layernorm`` on the sublayer
outputs before the residual add). The MoE variant routes with sigmoid
scores, ``e_score_correction_bias`` and expert groups (``moe.route_topk``,
the routed experts on the grouped product, A4 on the card) beside a shared
expert.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.models.base import StageModel
from parallax_tpu_torch.models.qwen3_moe import MoEStageModel
from parallax_tpu_torch.models.registry import register_model
from parallax_tpu_torch.ops.rope import apply_rope_interleaved


class _Glm4Conventions:
    """The GLM-4 block: interleaved partial rope, the fused gate_up split,
    optional sandwich norms."""

    rope_fn = staticmethod(apply_rope_interleaved)

    def finalize_params(self, tree: dict) -> dict:
        """Split HF's fused ``gate_up_proj [2I, H]``: gate = first half,
        up = second half, so the SwiGLU path applies."""
        for layer in tree.get("layers", []):
            mlp = layer.get("mlp")
            if isinstance(mlp, dict) and "gate_up_proj" in mlp:
                w = mlp.pop("gate_up_proj")["weight"]
                half = w.shape[0] // 2
                mlp["gate_proj"] = {"weight": w[:half]}
                mlp["up_proj"] = {"weight": w[half:]}
        return super().finalize_params(tree)

    def _decoder_layer(self, lp, x, kv, inputs, window):
        h = self._rms(x, lp["input_layernorm"]["weight"])
        attn_out, kv = self._attention(lp, h, kv, inputs, window)
        if "post_self_attn_layernorm" in lp:
            attn_out = self._rms(attn_out,
                                 lp["post_self_attn_layernorm"]["weight"])
        x = x + attn_out
        h = self._rms(x, lp["post_attention_layernorm"]["weight"])
        mlp_out = self._mlp(lp, h)
        if "post_mlp_layernorm" in lp:
            mlp_out = self._rms(mlp_out, lp["post_mlp_layernorm"]["weight"])
        return x + mlp_out, kv


@register_model("Glm4ForCausalLM", "GlmForCausalLM")
class Glm4StageModel(_Glm4Conventions, StageModel):
    """Dense GLM-4 (GLM-4-9B-0414)."""

    def init_params(self, generator: torch.Generator,
                    dtype=torch.bfloat16, device="cpu") -> dict:
        """The base init (split gate / up / down) plus the sandwich norms,
        as the JAX package adds them."""
        params = super().init_params(generator, dtype, device)
        h = self.config.hidden_size
        for layer in params["layers"]:
            for name in ("post_self_attn_layernorm", "post_mlp_layernorm"):
                layer[name] = {"weight": torch.ones((h,), dtype=dtype,
                                                    device=device)}
        return params


@register_model("Glm4MoeForCausalLM", "Glm4MoeLiteForCausalLM")
class Glm4MoeStageModel(_Glm4Conventions, MoEStageModel):
    """GLM-4 MoE (GLM-4.5 / 4.6): GLM attention and rope with the
    DeepSeek-style routed FFN; HF names ``mlp.gate.{weight,
    e_score_correction_bias}``, ``mlp.experts.N.*``,
    ``mlp.shared_experts.*``."""

    def finalize_params(self, tree: dict) -> dict:
        for layer in tree.get("layers", []):
            mlp = layer.get("mlp")
            if isinstance(mlp, dict) and "shared_experts" in mlp:
                mlp["shared_expert"] = mlp.pop("shared_experts")
        return super().finalize_params(tree)

    def _init_mlp(self, layer_idx: int, normal, dense) -> dict:
        """MoE layers: the router with a zero f32 correction bias, the
        stacked experts and the shared expert; dense layers: SwiGLU."""
        mlp = super()._init_mlp(layer_idx, normal, dense)
        if "experts" not in mlp:
            return mlp
        moe = self.config.moe
        mlp["gate"]["e_score_correction_bias"] = torch.zeros(
            (moe.num_experts,), dtype=torch.float32,
            device=mlp["gate"]["weight"].device)
        if moe.num_shared_experts:
            h = self.config.hidden_size
            si = (moe.shared_expert_intermediate_size
                  or moe.moe_intermediate_size) * moe.num_shared_experts
            mlp["shared_expert"] = {"gate_proj": dense(si, h),
                                    "up_proj": dense(si, h),
                                    "down_proj": dense(h, si)}
        return mlp
