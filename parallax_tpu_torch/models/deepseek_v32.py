"""DeepSeek-V3.2 / GLM-MoE-DSA stage model: DeepSeek sparse attention (DSA)
over the MLA latent cache (port of ``parallax_tpu/models/deepseek_v32.py``).

Layer protocol: a "full" layer runs the lightning indexer and publishes its
top-k; "shared" layers reuse the previous full layer's top-k (GLM's
``index_topk_freq``). A stage must start at layer 0 or on a full layer,
because top-k never crosses stages.

Each layer's cache is ``(mla_pages, index_pages | None)``: the MLA latent
cache plus, on full layers, the paged index-key cache addressed by the same
page table and slot mapping. The engine treats the per-layer entries as
opaque.

Weight names follow HF ``DeepseekV32ForCausalLM``: everything of
DeepSeek-V3 plus ``self_attn.indexer.{wq_b, wk, k_norm, weights_proj}``.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.deepseek_v3 import DeepseekStageModel
from parallax_tpu_torch.models.registry import register_model
from parallax_tpu_torch.ops.dsa import (
    dsa_store_and_score,
    dsa_topk_indices,
    mla_ragged_sparse_attention_plain,
    new_index_pages,
)
from parallax_tpu_torch.ops.mla import new_mla_pages, store_mla_cache
from parallax_tpu_torch.ops.rope import apply_rope, apply_rope_interleaved


@register_model(
    "DeepseekV32ForCausalLM", "GlmMoeDsaForCausalLM", "Glm4MoeDsaForCausalLM"
)
class DeepseekV32StageModel(DeepseekStageModel):
    """MLA + lightning-indexer sparse attention + (mostly) MoE FFN."""

    runs_dsa = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.config
        if cfg.dsa is None:
            raise ValueError(
                "DeepSeek-V3.2/GLM-DSA requires index_n_heads/index_head_dim"
            )
        if self.start_layer > 0 and (
            cfg.dsa.indexer_types[self.start_layer] != "full"
        ):
            raise ValueError(
                "DSA shards must start at layer 0 or a full indexer layer; "
                f"layer {self.start_layer} is "
                f"{cfg.dsa.indexer_types[self.start_layer]!r}"
            )
        self._idx_softmax_scale = cfg.dsa.index_head_dim ** -0.5
        # Per-call threading state, reset at every __call__.
        self._prev_topk = None
        self._local_li = 0
        self._layer_is_full = False

    # -- cache -------------------------------------------------------------

    def new_kv_caches(self, num_pages, page_size, dtype=torch.bfloat16,
                      device="cpu"):
        m = self.config.mla
        d = self.config.dsa
        caches = []
        for li in range(self.num_local_layers):
            mla = new_mla_pages(num_pages, page_size, m.kv_lora_rank,
                                m.qk_rope_head_dim, dtype, device)
            # Shared layers reuse the previous full layer's top-k: an index
            # cache there would be dead memory.
            index = None
            if d.indexer_types[self.start_layer + li] == "full":
                index = new_index_pages(num_pages, page_size,
                                        d.index_head_dim, dtype, device)
            caches.append((mla, index))
        return caches

    # -- forward -----------------------------------------------------------

    def __call__(self, params, kv_caches, inputs: BatchInputs):
        self._prev_topk = None
        self._local_li = 0
        return super().__call__(params, kv_caches, inputs)

    def _decoder_layer(self, lp, x, kv, inputs: BatchInputs, window):
        self._layer_is_full = (
            self.config.dsa.indexer_types[self.start_layer + self._local_li]
            == "full"
        )
        self._local_li += 1
        return super()._decoder_layer(lp, x, kv, inputs, window)

    def _indexer_topk(self, p, x, qr, index_cache, inputs: BatchInputs):
        """Lightning indexer: queries from ``wq_b(qr)``, one shared key from
        ``wk(x)`` + LayerNorm, rope on the leading rope dims, scores
        ``sum_h w_h * relu(q_h . k)`` over the cached context. Returns the
        top-k positions and the updated index-key cache."""
        cfg = self.config
        d = cfg.dsa
        dr = cfg.mla.qk_rope_head_dim
        t = x.shape[0]

        q = L.linear(qr if qr is not None else x, p["wq_b"])
        q = q.reshape(t, d.index_n_heads, d.index_head_dim)
        q_pe, q_nope = q[..., :dr], q[..., dr:]
        k = L.layer_norm(L.linear(x, p["wk"]), p["k_norm"],
                         d.indexer_norm_eps)
        k_pe, k_nope = k[..., :dr], k[..., dr:]

        rope_fn = (apply_rope_interleaved if d.indexer_rope_traditional
                   else apply_rope)
        cos, sin = self.rope_tables(x.device)
        q_pe = rope_fn(q_pe, inputs.positions, cos, sin)
        k_pe = rope_fn(k_pe, inputs.positions, cos, sin)
        q = torch.cat([q_pe, q_nope], dim=-1)
        k = torch.cat([k_pe, k_nope], dim=-1)

        weights = L.linear(x, p["weights_proj"]).float() * (
            d.index_n_heads ** -0.5 * self._idx_softmax_scale
        )
        scores, index_cache = dsa_store_and_score(
            q, weights, k, index_cache,
            inputs.kv_lens, inputs.page_indices, inputs.cu_q_lens,
            inputs.slot_mapping,
            decode_only=inputs.decode_only,
            use_kernels=self.use_kernels,
            decode_fused=inputs.decode_fused,
        )
        return dsa_topk_indices(scores, index_topk=d.index_topk), index_cache

    def _mla_attention(self, p, x, cache, inputs: BatchInputs):
        mla_pages, index_pages = cache
        q_latent, q_pe, latent, k_pe, w_uv, qr, hq = self._mla_qkv(
            p, x, inputs
        )
        store_mla_cache(mla_pages, latent, k_pe, inputs.slot_mapping)
        if self._layer_is_full:
            topk, index_pages = self._indexer_topk(
                p["indexer"], x, qr, index_pages, inputs
            )
            self._prev_topk = topk
        else:
            if self._prev_topk is None:
                raise ValueError(
                    "DSA shared layer requires a previous full layer's "
                    "top-k in the same shard"
                )
            topk = self._prev_topk
        out_latent = mla_ragged_sparse_attention_plain(
            q_latent, q_pe, mla_pages, inputs.kv_lens, inputs.page_indices,
            inputs.cu_q_lens, topk, sm_scale=self.sm_scale,
            kv_lora_rank=self.config.mla.kv_lora_rank,
        )
        return self._mla_out(p, out_latent, w_uv, hq), (mla_pages, index_pages)

    # -- init --------------------------------------------------------------

    def _init_attention(self, layer_idx: int, normal, dense, ones) -> dict:
        """V3's MLA weights plus, on full indexer layers, the indexer."""
        attn = super()._init_attention(layer_idx, normal, dense, ones)
        cfg = self.config
        d = cfg.dsa
        if d.indexer_types[layer_idx] == "full":
            norm = ones(d.index_head_dim)
            norm["bias"] = torch.zeros_like(norm["weight"])
            attn["indexer"] = {
                "wq_b": dense(d.index_n_heads * d.index_head_dim,
                              cfg.mla.q_lora_rank or cfg.hidden_size),
                "wk": dense(d.index_head_dim, cfg.hidden_size),
                "k_norm": norm,
                "weights_proj": dense(d.index_n_heads, cfg.hidden_size),
            }
        return attn
