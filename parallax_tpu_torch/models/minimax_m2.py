"""MiniMax-M2 stage model: dense GQA attention + routed MoE (port of
``parallax_tpu/models/minimax_m2.py``).

M2's differences from the llama family: the qk norms run over the FULL
projection output (all heads concatenated, before the head reshape),
partial rotary, sigmoid routing with a correction bias and routed scaling,
and the MoE under ``block_sparse_moe`` in checkpoints. MiniMax-M3
(``models/minimax_m3.py``) shares the checkpoint layout.
"""

from __future__ import annotations

from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.qwen3_moe import MoEStageModel
from parallax_tpu_torch.models.registry import register_model
from parallax_tpu_torch.ops.attention import append_and_attend
from parallax_tpu_torch.ops.rope import apply_rope


def block_sparse_moe_to_mlp(tree: dict) -> dict:
    """The MiniMax checkpoint's MoE onto the generic ``mlp`` structure:
    ``block_sparse_moe`` -> ``mlp``, ``shared_experts`` ->
    ``shared_expert`` and ``e_score_correction_bias`` into the ``gate``
    (the expert stacking of ``MoEStageModel.finalize_params`` runs after
    the rename). In place; returns ``tree``."""
    for layer in tree.get("layers", []):
        moe = layer.pop("block_sparse_moe", None)
        if moe is None:
            continue
        if "shared_experts" in moe:
            moe["shared_expert"] = moe.pop("shared_experts")
        if "e_score_correction_bias" in moe and isinstance(
            moe.get("gate"), dict
        ):
            moe["gate"]["e_score_correction_bias"] = moe.pop(
                "e_score_correction_bias"
            )
        layer["mlp"] = moe
    return tree


# No "MiniMaxForCausalLM" alias: that HF architecture is the
# MiniMax-Text-01 lightning-attention hybrid, another model family.
@register_model("MiniMaxM2ForCausalLM")
class MiniMaxM2StageModel(MoEStageModel):
    """Dense GQA with full-projection qk norms + MoE FFN."""

    def _attention(self, lp, h, kv, inputs: BatchInputs, window):
        cfg = self.config
        p = lp["self_attn"]
        t = h.shape[0]
        d = cfg.head_dim
        q = L.linear(h, p["q_proj"])
        k = L.linear(h, p["k_proj"])
        v = L.linear(h, p["v_proj"]).reshape(t, -1, d)
        if cfg.use_qk_norm and "q_norm" in p:
            q = L.full_proj_rms_norm(q, p["q_norm"]["weight"],
                                     cfg.rms_norm_eps)
            k = L.full_proj_rms_norm(k, p["k_norm"]["weight"],
                                     cfg.rms_norm_eps)
        q = q.reshape(t, -1, d)
        hq = q.shape[1]
        cos, sin = self.rope_tables(h.device)
        q = apply_rope(q, inputs.positions, cos, sin).contiguous()
        k = apply_rope(k.reshape(t, -1, d), inputs.positions, cos, sin)
        out, kv = append_and_attend(
            q, k, v, kv, inputs.kv_lens, inputs.page_indices,
            inputs.cu_q_lens, inputs.num_seqs, inputs.slot_mapping,
            sm_scale=d ** -0.5, sliding_window=window,
            use_kernels=self.use_kernels, decode_only=inputs.decode_only,
            decode_fused=inputs.decode_fused,
            prefill_fused=inputs.prefill_fused,
        )
        return L.linear(out.reshape(t, hq * d), p["o_proj"]), kv

    def finalize_params(self, tree: dict) -> dict:
        return super().finalize_params(block_sparse_moe_to_mlp(tree))

    def _init_attention(self, layer_idx: int, normal, dense, ones) -> dict:
        """The base attention with full-projection qk norm weights
        (``[Hq * D]`` and ``[Hkv * D]``)."""
        attn = super()._init_attention(layer_idx, normal, dense, ones)
        cfg = self.config
        if cfg.use_qk_norm:
            attn["q_norm"] = ones(cfg.num_attention_heads * cfg.head_dim)
            attn["k_norm"] = ones(cfg.num_key_value_heads * cfg.head_dim)
        return attn
