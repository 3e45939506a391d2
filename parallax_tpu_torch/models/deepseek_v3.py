"""DeepSeek-V2/V3 (and Kimi-K2) stage model: MLA + sigmoid-routed MoE (port
of ``parallax_tpu/models/deepseek_v3.py``).

Decode and prefill both run in the absorbed form over the latent cache
(``ops/mla.py``): a token's cache row is ``kv_lora_rank + qk_rope_head_dim``
wide, whatever the head count. The MoE layers go through the ported
``moe_ffn`` (router with groups and the correction bias, the grouped GEMM
A4, the shared expert); the first ``first_k_dense_replace`` layers keep the
dense SwiGLU FFN.

Weight names follow HF ``DeepseekV3ForCausalLM``: q_a_proj / q_a_layernorm
/ q_b_proj (or q_proj when q_lora_rank is 0), kv_a_proj_with_mqa /
kv_a_layernorm / kv_b_proj, o_proj; mlp.gate.{weight,
e_score_correction_bias}, mlp.experts (stacked), mlp.shared_expert.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.qwen3_moe import MoEStageModel
from parallax_tpu_torch.models.registry import register_model
from parallax_tpu_torch.ops.mla import (
    mla_append_and_attend,
    mla_rope_permute,
    new_mla_pages,
)
from parallax_tpu_torch.ops.rope import (
    apply_rope,
    rope_frequencies,
    rope_table,
    yarn_mscale,
)


@register_model(
    "DeepseekV2ForCausalLM", "DeepseekV3ForCausalLM", "KimiK2ForCausalLM"
)
class DeepseekStageModel(MoEStageModel):
    """MLA attention + (mostly) MoE FFN."""

    runs_mla = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.config
        if cfg.mla is None:
            raise ValueError("DeepSeek family requires MLA config")
        # The YaRN magnitude correction folds into the softmax scale
        # (HF DeepseekV3Attention: scaling *= mscale^2 with mscale_all_dim).
        self.sm_scale = (
            cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        ) ** -0.5
        rs = cfg.rope_scaling or {}
        if rs.get("rope_type", rs.get("type")) == "yarn":
            mscale_all = float(rs.get("mscale_all_dim", 0) or 0)
            if mscale_all:
                m_ = yarn_mscale(float(rs.get("factor", 1.0)), mscale_all)
                self.sm_scale = self.sm_scale * m_ * m_

    def rope_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """Rope covers only the ``qk_rope_head_dim`` dims, without the
        attention-magnitude factor (it is in ``sm_scale``)."""
        device = torch.device(device)
        tables = self._rope_tables.get(device)
        if tables is None:
            cfg = self.config
            inv = rope_frequencies(cfg.mla.qk_rope_head_dim, cfg.rope_theta,
                                   cfg.rope_scaling, device=device)
            tables = rope_table(inv, cfg.max_position_embeddings)
            self._rope_tables[device] = tables
        return tables

    # -- cache -------------------------------------------------------------

    def new_kv_caches(self, num_pages, page_size, dtype=torch.bfloat16,
                      device="cpu"):
        m = self.config.mla
        return [
            new_mla_pages(num_pages, page_size, m.kv_lora_rank,
                          m.qk_rope_head_dim, dtype, device)
            for _ in range(self.num_local_layers)
        ]

    # -- layers ------------------------------------------------------------

    def _attention(self, lp, h, kv, inputs: BatchInputs, window):
        return self._mla_attention(lp["self_attn"], h, kv, inputs)

    def _mla_qkv(self, p, x, inputs: BatchInputs):
        """The shared MLA projections: returns the absorbed query parts, the
        new latent / rope rows to cache, the up-projection W_UV, the
        low-rank query activation ``qr`` (the DSA indexer reads it) and the
        head count."""
        cfg = self.config
        m = cfg.mla
        t = x.shape[0]
        dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                         m.v_head_dim, m.kv_lora_rank)
        if "q_a_proj" in p:
            qr = L.linear(x, p["q_a_proj"])
            qr = L.rms_norm(qr, p["q_a_layernorm"]["weight"], cfg.rms_norm_eps)
            q = L.linear(qr, p["q_b_proj"])
        else:
            qr = None
            q = L.linear(x, p["q_proj"])
        hq = q.shape[-1] // (dn + dr)
        q = q.reshape(t, hq, dn + dr)
        q_nope, q_pe = q[..., :dn], q[..., dn:]

        kv_a = L.linear(x, p["kv_a_proj_with_mqa"])
        latent, k_pe = kv_a[..., :r], kv_a[..., r:]
        latent = L.rms_norm(latent, p["kv_a_layernorm"]["weight"],
                            cfg.rms_norm_eps)

        # DeepSeek checkpoints store interleaved rope weights: permute the
        # rope dims, then the standard rotate-half rope.
        if cfg.extra.get("rope_interleave", True):
            q_pe = mla_rope_permute(q_pe)
            k_pe = mla_rope_permute(k_pe)
        cos, sin = self.rope_tables(x.device)
        q_pe = apply_rope(q_pe, inputs.positions, cos, sin).contiguous()
        k_pe = apply_rope(k_pe, inputs.positions, cos, sin)

        # Absorb W_UK into the query: kv_b_proj is [Hq * (dn + dv), R].
        w_kv_b = L.get_weight(p["kv_b_proj"]).reshape(hq, dn + dv, r)
        q_latent = torch.einsum("thd,hdr->thr", q_nope, w_kv_b[:, :dn, :])
        return (q_latent.contiguous(), q_pe, latent, k_pe, w_kv_b[:, dn:, :],
                qr, hq)

    def _mla_out(self, p, out_latent, w_uv, hq):
        """Up-project the latent attention output with W_UV, then o_proj."""
        t = out_latent.shape[0]
        out = torch.einsum("thr,hdr->thd", out_latent, w_uv)
        return L.linear(out.reshape(t, hq * w_uv.shape[1]), p["o_proj"])

    def _mla_attention(self, p, x, cache, inputs: BatchInputs):
        q_latent, q_pe, latent, k_pe, w_uv, _qr, hq = self._mla_qkv(
            p, x, inputs
        )
        out_latent, cache = mla_append_and_attend(
            q_latent, q_pe, latent, k_pe, cache,
            inputs.kv_lens, inputs.page_indices, inputs.cu_q_lens,
            inputs.num_seqs, inputs.slot_mapping,
            sm_scale=self.sm_scale,
            kv_lora_rank=self.config.mla.kv_lora_rank,
            decode_only=inputs.decode_only,
            use_kernels=self.use_kernels,
            decode_fused=inputs.decode_fused,
        )
        return self._mla_out(p, out_latent, w_uv, hq), cache

    def finalize_params(self, tree: dict) -> dict:
        tree = super().finalize_params(tree)
        # HF names the shared experts "shared_experts"; moe_ffn reads
        # "shared_expert".
        for layer in tree.get("layers", []):
            mlp = layer.get("mlp")
            if isinstance(mlp, dict) and "shared_experts" in mlp:
                mlp["shared_expert"] = mlp.pop("shared_experts")
        return tree

    # -- init --------------------------------------------------------------

    def _init_attention(self, layer_idx: int, normal, dense, ones) -> dict:
        """MLA weights with the JAX package's shapes and scales (its
        ``init_params`` draws GQA tensors first and overwrites them; here
        they are never made)."""
        cfg = self.config
        m = cfg.mla
        h, hq = cfg.hidden_size, cfg.num_attention_heads
        dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                         m.v_head_dim, m.kv_lora_rank)
        attn = {
            "kv_a_proj_with_mqa": dense(r + dr, h),
            "kv_a_layernorm": ones(r),
            "kv_b_proj": dense(hq * (dn + dv), r),
            "o_proj": dense(h, hq * dv),
        }
        if m.q_lora_rank:
            attn["q_a_proj"] = dense(m.q_lora_rank, h)
            attn["q_a_layernorm"] = ones(m.q_lora_rank)
            attn["q_b_proj"] = dense(hq * (dn + dr), m.q_lora_rank)
        else:
            attn["q_proj"] = dense(hq * (dn + dr), h)
        return attn

    def _init_mlp(self, layer_idx: int, normal, dense) -> dict:
        """MoE layers: the router with a zero f32 correction bias, the
        stacked experts and the shared expert; dense layers: SwiGLU."""
        mlp = super()._init_mlp(layer_idx, normal, dense)
        moe = self.config.moe
        if "experts" not in mlp:
            return mlp
        device = mlp["gate"]["weight"].device
        mlp["gate"]["e_score_correction_bias"] = torch.zeros(
            (moe.num_experts,), dtype=torch.float32, device=device
        )
        if moe.num_shared_experts > 0:
            h = self.config.hidden_size
            si = (moe.shared_expert_intermediate_size
                  or moe.moe_intermediate_size) * moe.num_shared_experts
            mlp["shared_expert"] = {
                "gate_proj": dense(si, h),
                "up_proj": dense(si, h),
                "down_proj": dense(h, si),
            }
        return mlp
