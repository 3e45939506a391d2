"""MiniMax-M3 stage model: block-sparse attention (MSA) + swiglu-oai MoE
(port of ``parallax_tpu/models/minimax_m3.py``).

GQA attention with per-head qk norms, partial rotary 0.5 and Gemma-style
zero-init norms (``x_hat * (1 + w)``); on the layers the config marks
sparse, an index projection pair picks blocks of the context
(``ops/msa.py``) and attention reads only their tokens; the other layers
attend densely through ``append_and_attend``. The FFN is the MoE of
``models/moe.py`` (sigmoid routing with a correction bias, routed scaling
2.0, a shared expert) with the clamped swiglu-oai activation on the MoE
layers, and the same activation in a dense GLU on the dense ones.

The cache list mixes layer types as the JAX package's does: a paged KV
tensor on a full-attention layer, a ``(kv_pages, index_pages)`` tuple on a
sparse one. Weight names follow the HF checkpoint: ``self_attn.{q,k,v,
o}_proj``, ``self_attn.{q,k}_norm``, and on sparse layers
``self_attn.index_{q,k}_proj`` + ``self_attn.index_{q,k}_norm``; MoE layers
hold ``block_sparse_moe.{gate, experts.N.*, shared_experts.*,
e_score_correction_bias}``, dense layers ``mlp.*``.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.minimax_m2 import block_sparse_moe_to_mlp
from parallax_tpu_torch.models.moe import moe_ffn
from parallax_tpu_torch.models.qwen3_moe import MoEStageModel
from parallax_tpu_torch.models.registry import register_model
from parallax_tpu_torch.ops.attention import append_and_attend
from parallax_tpu_torch.ops.dsa import new_index_pages
from parallax_tpu_torch.ops.kv_cache_ops import new_kv_pages, reshape_and_cache
from parallax_tpu_torch.ops.msa import (
    msa_store_and_positions,
    paged_sparse_gqa_attention_plain,
)
from parallax_tpu_torch.ops.rope import apply_rope


def swiglu_oai(alpha: float, limit: float, beta: float):
    """The clamped GLU of MiniMax and gpt-oss: ``clip(g, max=limit) *
    sigmoid(alpha * g) * (clip(u, -limit, limit) + beta)``."""

    def act(g, u):
        g = g.clamp(max=limit)
        u = u.clamp(-limit, limit)
        return g * torch.sigmoid(alpha * g) * (u + beta)

    return act


@register_model("MiniMaxM3SparseForCausalLM", "MiniMaxM3ForCausalLM")
class MiniMaxM3StageModel(MoEStageModel):
    """GQA + per-layer MSA sparse attention + MoE / dense FFN mix."""

    runs_msa = True
    norm_offset = 1.0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.config
        if cfg.msa is None:
            raise ValueError("MiniMax-M3 requires sparse-attention config")
        if not cfg.extra.get("use_gemma_norm", True):
            self.norm_offset = 0.0  # instance override, class default stays
        self._act = swiglu_oai(
            float(cfg.extra.get("swiglu_alpha", 1.702)),
            float(cfg.extra.get("swiglu_limit", 7.0)),
            float(cfg.extra.get("swiglu_beta", 1.0)),
        )
        # Per-call threading state, reset at every __call__.
        self._local_li = 0
        self._layer_gi = self.start_layer

    def _layer_sparse(self, gi: int) -> bool:
        mask = self.config.msa.sparse_layer_mask
        return bool(mask[gi]) if gi < len(mask) else False

    # -- cache -------------------------------------------------------------

    def new_kv_caches(self, num_pages, page_size, dtype=torch.bfloat16,
                      device="cpu"):
        cfg = self.config
        caches = []
        for li in range(self.num_local_layers):
            kv = new_kv_pages(num_pages, page_size, cfg.num_key_value_heads,
                              cfg.head_dim, dtype, device)
            if self._layer_sparse(self.start_layer + li):
                kv = (kv, new_index_pages(num_pages, page_size,
                                          cfg.msa.index_head_dim, dtype,
                                          device))
            caches.append(kv)
        return caches

    # -- forward -----------------------------------------------------------

    def __call__(self, params, kv_caches, inputs: BatchInputs):
        self._local_li = 0
        return super().__call__(params, kv_caches, inputs)

    def _decoder_layer(self, lp, x, kv, inputs: BatchInputs, window):
        self._layer_gi = self.start_layer + self._local_li
        self._local_li += 1
        return super()._decoder_layer(lp, x, kv, inputs, window)

    def _norm(self, x, p):
        return L.rms_norm(x, p["weight"], self.config.rms_norm_eps,
                          offset=self.norm_offset)

    def _indexer_topk(self, p, h, index_pages, inputs: BatchInputs):
        """The block indexer: index queries ``[T, Hi, D]`` and one index key
        ``[T, D]`` from ``h``, normed and roped like q / k; the key enters
        the index cache and the top blocks' token positions come out.
        Returns ``(positions i32[T, topk_blocks * block_size],
        index_pages)``."""
        cfg = self.config
        msa = cfg.msa
        t = h.shape[0]
        cos, sin = self.rope_tables(h.device)
        idx_q = L.linear(h, p["index_q_proj"]).reshape(
            t, msa.index_n_heads, msa.index_head_dim)
        idx_k = L.linear(h, p["index_k_proj"])
        idx_q = apply_rope(self._norm(idx_q, p["index_q_norm"]),
                           inputs.positions, cos, sin)
        idx_k = apply_rope(self._norm(idx_k, p["index_k_norm"]),
                           inputs.positions, cos, sin)
        return msa_store_and_positions(
            idx_q, idx_k, index_pages,
            inputs.kv_lens, inputs.page_indices, inputs.cu_q_lens,
            inputs.slot_mapping,
            block_size=msa.block_size, topk_blocks=msa.topk_blocks,
            init_blocks=msa.init_blocks, local_blocks=msa.local_blocks,
            sm_scale=cfg.head_dim ** -0.5,
            decode_only=inputs.decode_only, use_kernels=self.use_kernels,
            decode_fused=inputs.decode_fused,
        )

    def _attention(self, lp, h, kv, inputs: BatchInputs, window):
        cfg = self.config
        p = lp["self_attn"]
        t = h.shape[0]
        d = cfg.head_dim
        q = L.linear(h, p["q_proj"]).reshape(t, -1, d)
        k = L.linear(h, p["k_proj"]).reshape(t, -1, d)
        v = L.linear(h, p["v_proj"]).reshape(t, -1, d)
        hq = q.shape[1]
        if cfg.use_qk_norm and "q_norm" in p:
            q = self._norm(q, p["q_norm"])
            k = self._norm(k, p["k_norm"])
        cos, sin = self.rope_tables(h.device)
        q = apply_rope(q, inputs.positions, cos, sin).contiguous()
        k = apply_rope(k, inputs.positions, cos, sin)

        if self._layer_sparse(self._layer_gi):
            kv_pages, index_pages = kv
            reshape_and_cache(kv_pages, k, v, inputs.slot_mapping)
            positions, index_pages = self._indexer_topk(p, h, index_pages,
                                                        inputs)
            out = paged_sparse_gqa_attention_plain(
                q, kv_pages, inputs.kv_lens, inputs.page_indices,
                inputs.cu_q_lens, positions, sm_scale=d ** -0.5,
            )
            kv = (kv_pages, index_pages)
        else:
            out, kv = append_and_attend(
                q, k, v, kv, inputs.kv_lens, inputs.page_indices,
                inputs.cu_q_lens, inputs.num_seqs, inputs.slot_mapping,
                sm_scale=d ** -0.5, use_kernels=self.use_kernels,
                decode_only=inputs.decode_only,
                decode_fused=inputs.decode_fused,
                prefill_fused=inputs.prefill_fused,
            )
        return L.linear(out.reshape(t, hq * d), p["o_proj"]), kv

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        if "experts" in lp["mlp"]:
            return moe_ffn(h, lp["mlp"], self.config.moe, act_fn=self._act,
                           kernel=self.moe_kernel)
        return L.glu_mlp(h, lp["mlp"], self._act)

    # -- params ------------------------------------------------------------

    def finalize_params(self, tree: dict) -> dict:
        return super().finalize_params(block_sparse_moe_to_mlp(tree))

    def init_params(self, generator: torch.Generator,
                    dtype=torch.bfloat16, device="cpu") -> dict:
        """The base init with the JAX package's M3 additions: Gemma
        zero-init layer, final and qk norms (ones with ``norm_offset`` 0),
        index projections on sparse layers, a shared expert and a zero f32
        routing bias on MoE layers."""
        params = super().init_params(generator, dtype, device)
        if self.norm_offset:
            for layer in params["layers"]:
                for name in ("input_layernorm", "post_attention_layernorm"):
                    layer[name]["weight"].zero_()
            if self.is_last:
                params["norm"]["weight"].zero_()
        return params

    def _init_attention(self, layer_idx: int, normal, dense, ones) -> dict:
        attn = super()._init_attention(layer_idx, normal, dense, ones)
        cfg = self.config
        msa = cfg.msa

        def norm(n):
            p = ones(n)
            if self.norm_offset:
                p["weight"].zero_()
            return p

        if cfg.use_qk_norm:
            attn["q_norm"] = norm(cfg.head_dim)
            attn["k_norm"] = norm(cfg.head_dim)
        if self._layer_sparse(layer_idx):
            attn["index_q_proj"] = dense(
                msa.index_n_heads * msa.index_head_dim, cfg.hidden_size)
            attn["index_k_proj"] = dense(msa.index_head_dim, cfg.hidden_size)
            attn["index_q_norm"] = norm(msa.index_head_dim)
            attn["index_k_norm"] = norm(msa.index_head_dim)
        return attn

    def _init_mlp(self, layer_idx: int, normal, dense) -> dict:
        mlp = super()._init_mlp(layer_idx, normal, dense)
        cfg = self.config
        moe = cfg.moe
        if "experts" not in mlp:
            return mlp
        if moe.num_shared_experts:
            si = moe.shared_expert_intermediate_size or moe.moe_intermediate_size
            h = cfg.hidden_size
            mlp["shared_expert"] = {"gate_proj": dense(si, h),
                                    "up_proj": dense(si, h),
                                    "down_proj": dense(h, si)}
        if cfg.extra.get("use_routing_bias", True):
            gate = mlp["gate"]["weight"]
            mlp["gate"]["e_score_correction_bias"] = torch.zeros(
                (moe.num_experts,), dtype=torch.float32, device=gate.device)
        return mlp
