"""Step-3.5-Flash stage model (port of ``parallax_tpu/models/step3p5.py``).

Step-3.5 against the llama family: KV heads from ``num_attention_groups``
(``config.normalize_config`` reads it as ``num_key_value_heads``),
per-head qk norms on every layer, alternating sliding windows (the
``sliding_attention`` layers run A2 / A1 with the window), a head-wise
attention gate (``out * sigmoid(g_proj(x))`` per head), and an MoE whose
shared expert checkpoints name ``share_expert``. Small variants ship
without MoE: the model then serves dense SwiGLU layers.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import BatchInputs, StageModel
from parallax_tpu_torch.models.qwen3_moe import MoEStageModel
from parallax_tpu_torch.models.registry import register_model
from parallax_tpu_torch.ops.attention import append_and_attend


@register_model("Step3p5ForCausalLM")
class Step3p5StageModel(MoEStageModel):

    def __init__(self, *args, moe_kernel: bool = True, **kwargs):
        # Dense-only variants: no MoE config to require.
        StageModel.__init__(self, *args, **kwargs)
        self.moe_kernel = moe_kernel

    def _attention(self, lp, h, kv, inputs: BatchInputs, window):
        cfg = self.config
        p = lp["self_attn"]
        t = h.shape[0]
        d = cfg.head_dim
        q = L.linear(h, p["q_proj"]).reshape(t, -1, d)
        k = L.linear(h, p["k_proj"]).reshape(t, -1, d)
        v = L.linear(h, p["v_proj"]).reshape(t, -1, d)
        hq = q.shape[1]
        if "q_norm" in p:
            q = L.rms_norm(q, p["q_norm"]["weight"], cfg.rms_norm_eps)
            k = L.rms_norm(k, p["k_norm"]["weight"], cfg.rms_norm_eps)
        cos, sin = self.rope_tables(h.device)
        q = self.rope_fn(q, inputs.positions, cos, sin).contiguous()
        k = self.rope_fn(k, inputs.positions, cos, sin)
        out, kv = append_and_attend(
            q, k, v, kv, inputs.kv_lens, inputs.page_indices,
            inputs.cu_q_lens, inputs.num_seqs, inputs.slot_mapping,
            sm_scale=d ** -0.5, sliding_window=window,
            use_kernels=self.use_kernels, decode_only=inputs.decode_only,
            decode_fused=inputs.decode_fused,
            prefill_fused=inputs.prefill_fused,
        )
        if "g_proj" in p:
            # Head-wise gate: one sigmoid per (token, query head).
            gate = torch.sigmoid(L.linear(h, p["g_proj"]).float())
            out = (out.float() * gate[:, :, None]).to(out.dtype)
        return L.linear(out.reshape(t, hq * d), p["o_proj"]), kv

    def finalize_params(self, tree: dict) -> dict:
        for layer in tree.get("layers", []):
            mlp = layer.get("mlp")
            if isinstance(mlp, dict) and "share_expert" in mlp:
                mlp["shared_expert"] = mlp.pop("share_expert")
        return super().finalize_params(tree)

    def _init_attention(self, layer_idx: int, normal, dense, ones) -> dict:
        """The base projections plus per-head qk norms and ``g_proj [Hq,
        H]`` (``N(0, 1) * H**-0.5``) on every layer, as the JAX package
        adds them."""
        attn = super()._init_attention(layer_idx, normal, dense, ones)
        cfg = self.config
        attn["q_norm"] = ones(cfg.head_dim)
        attn["k_norm"] = ones(cfg.head_dim)
        attn["g_proj"] = dense(cfg.num_attention_heads, cfg.hidden_size)
        return attn
