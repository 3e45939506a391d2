"""Qwen3-MoE / Qwen2-MoE family stage model (port of
``parallax_tpu/models/qwen3_moe.py``).

Dense GQA attention (the base block) plus, on the layers the config marks
as MoE, the MoE FFN of ``models/moe.py`` over stacked expert weights; the
other layers keep the dense SwiGLU FFN.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import StageModel
from parallax_tpu_torch.models.moe import moe_ffn
from parallax_tpu_torch.models.registry import register_model


@register_model("Qwen3MoeForCausalLM", "Qwen2MoeForCausalLM")
class MoEStageModel(StageModel):
    """Dense attention + (per-layer) MoE FFN. ``moe_kernel=False`` runs the
    routed experts through the plain grouped product on any device (the
    reference a card run is checked against)."""

    runs_moe = True

    def __init__(self, *args, moe_kernel: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        if self.config.moe is None:
            raise ValueError(
                f"{self.config.architecture} requires MoE config"
            )
        self.moe_kernel = moe_kernel

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        if "experts" in lp["mlp"]:
            return moe_ffn(h, lp["mlp"], self.config.moe,
                           kernel=self.moe_kernel)
        return L.swiglu_mlp(h, lp["mlp"])

    # -- params -----------------------------------------------------------

    def _init_mlp(self, layer_idx: int, normal, dense) -> dict:
        """MoE layers: router ``[E, H]`` and stacked experts (gate/up
        ``[E, I, H]`` and down ``[E, H, I]``), each ``N(0, 1) * in_dim**-0.5``
        as in the JAX package; dense layers: the base FFN."""
        cfg = self.config
        if not cfg.is_moe_layer(layer_idx):
            return super()._init_mlp(layer_idx, normal, dense)
        e, h = cfg.moe.num_experts, cfg.hidden_size
        i = cfg.moe.moe_intermediate_size
        return {
            "gate": {"weight": normal((e, h), h ** -0.5)},
            "experts": {
                "gate_proj": normal((e, i, h), h ** -0.5),
                "up_proj": normal((e, i, h), h ** -0.5),
                "down_proj": normal((e, h, i), i ** -0.5),
            },
        }

    def finalize_params(self, tree: dict) -> dict:
        """Stack per-expert HF weights: ``experts.{i}.gate_proj.weight`` ->
        ``experts.gate_proj [E, I, H]`` (the loader's hook). Quantized
        experts (``qweight`` / ``scales`` / ``biases``) stack into a
        quantized dict with a leading expert axis."""
        for layer in tree.get("layers", []):
            mlp = layer.get("mlp")
            if not isinstance(mlp, dict):
                continue
            experts = mlp.get("experts")
            if not isinstance(experts, dict) or "gate_proj" in experts:
                continue
            n = len(experts)
            stacked = {}
            for proj in ("gate_proj", "up_proj", "down_proj"):
                first = experts["0"][proj]
                if "qweight" in first:
                    stacked[proj] = {
                        k: torch.stack(
                            [experts[str(i)][proj][k] for i in range(n)])
                        for k in first
                    }
                else:
                    stacked[proj] = torch.stack(
                        [experts[str(i)][proj]["weight"] for i in range(n)])
            mlp["experts"] = stacked
        return tree
