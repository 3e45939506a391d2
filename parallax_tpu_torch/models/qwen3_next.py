"""Qwen3-Next hybrid stage model (port of
``parallax_tpu/models/qwen3_next.py``): GatedDeltaNet linear layers, gated
full-attention layers and the sparse MoE FFN.

HF conventions, as in the JAX package: ``linear_attn.{in_proj_qkvz,
in_proj_ba, conv1d, A_log, dt_bias, norm, out_proj}``; attention
``q_proj`` fused with a per-head output gate (``[Hq * 2D, H]``: each
head's query, then its gate); zero-init Gemma-style norms ``x_hat * (1 +
w)`` everywhere but the GatedDeltaNet's gated output norm.

A linear layer's cache is its ``(conv, recurrent)`` state pair, in slots
(``ops/linear_attn.py``; slot 0 is the null slot padding rows write to);
a full-attention layer's is the paged KV, attended through A0 + A1 / A2 at
head dim 256. The step's ragged rows are densified per sequence
(``BatchInputs.dense_map``) for the conv and the recurrence; every state
write is in place (``index_copy_``), so the decode window's CUDA graphs
keep the state tensors' pointers. Tensor parallelism (``axis_name``) is
not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallax_tpu_torch.config import LAYER_LINEAR, ModelConfig
from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.models.qwen3_moe import MoEStageModel
from parallax_tpu_torch.models.registry import register_model
from parallax_tpu_torch.ops.attention import append_and_attend
from parallax_tpu_torch.ops.kv_cache_ops import new_kv_pages
from parallax_tpu_torch.ops.linear_attn import (
    causal_conv_update,
    gated_delta_rule_scan,
    l2norm,
    new_linear_state,
)


def _densify(x: torch.Tensor, dense_map: torch.Tensor) -> torch.Tensor:
    """``[T, ...]`` ragged rows -> ``[S, maxq, ...]`` per-sequence steps;
    the out-of-bounds row ``T`` reads zeros."""
    padded = torch.cat([x, x.new_zeros((1,) + x.shape[1:])], dim=0)
    return padded[torch.clamp(dense_map, 0, x.shape[0]).long()]


def _scatter_ragged(dense: torch.Tensor, dense_map: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """``[S, maxq, F]`` -> ``[T, F]`` at the mapped rows; steps mapped to
    the out-of-bounds row ``T`` are dropped (they land in a spare row)."""
    s, maxq, f = dense.shape
    out = dense.new_zeros((num_rows + 1, f))
    out.index_copy_(0, torch.clamp(dense_map.reshape(-1), 0,
                                   num_rows).long(),
                    dense.reshape(s * maxq, f))
    return out[:num_rows]


@register_model(
    "Qwen3NextForCausalLM",
    # Qwen3.5 reuses the Qwen3-Next hybrid block wholesale.
    "Qwen3_5ForConditionalGeneration",
    "Qwen3_5MoeForConditionalGeneration",
)
class Qwen3NextStageModel(MoEStageModel):
    runs_linear = True
    # Zero-init Gemma-style norms (1 + w); the gated output norm inside
    # GatedDeltaNet keeps plain weights.
    norm_offset = 1.0

    def __init__(self, config: ModelConfig, *args, **kwargs):
        super().__init__(config, *args, **kwargs)
        la = config.linear_attn
        if la is None:
            raise ValueError("Qwen3-Next requires linear_attn config")
        self.key_dim = la.num_k_heads * la.head_k_dim
        self.value_dim = la.num_v_heads * la.head_v_dim
        self.conv_dim = 2 * self.key_dim + self.value_dim

    @property
    def has_linear_layers(self) -> bool:
        return any(self.config.layer_type(i) == LAYER_LINEAR
                   for i in range(self.start_layer, self.end_layer))

    # -- caches ------------------------------------------------------------

    def new_kv_caches(self, num_pages: int, page_size: int,
                      dtype=torch.bfloat16, device="cpu",
                      num_state_slots: int = 256) -> list:
        """Per local layer: the ``(conv, recurrent)`` state of
        ``num_state_slots + 1`` slots (slot 0 is the null slot) on a linear
        layer, the paged KV on a full-attention one."""
        cfg = self.config
        la = cfg.linear_attn
        caches = []
        for i in range(self.start_layer, self.end_layer):
            if cfg.layer_type(i) == LAYER_LINEAR:
                caches.append(new_linear_state(
                    num_state_slots + 1, self.conv_dim, la.conv_kernel_size,
                    la.num_v_heads, la.head_k_dim, la.head_v_dim, device))
            else:
                caches.append(new_kv_pages(
                    num_pages, page_size, cfg.num_key_value_heads,
                    cfg.head_dim, dtype, device))
        return caches

    # -- layers ------------------------------------------------------------

    def _decoder_layer(self, lp, x, kv, inputs: BatchInputs, window):
        h = self._rms(x, lp["input_layernorm"]["weight"])
        if "linear_attn" in lp:
            attn_out, kv = self._gated_delta_net(lp["linear_attn"], h, kv,
                                                 inputs)
        else:
            attn_out, kv = self._gated_attention(lp["self_attn"], h, kv,
                                                 inputs)
        x = x + attn_out
        h = self._rms(x, lp["post_attention_layernorm"]["weight"])
        return x + self._mlp(lp, h), kv

    def _gated_attention(self, p, x, kv_pages, inputs: BatchInputs):
        """Full attention with a per-head sigmoid output gate fused into
        ``q_proj`` (HF ``Qwen3NextAttention``)."""
        t = x.shape[0]
        d = self.config.head_dim
        qg = L.linear(x, p["q_proj"]).reshape(t, -1, 2 * d)
        q, gate = qg[..., :d], qg[..., d:]
        k = L.linear(x, p["k_proj"]).reshape(t, -1, d)
        v = L.linear(x, p["v_proj"]).reshape(t, -1, d)
        q = self._rms(q, p["q_norm"]["weight"])
        k = self._rms(k, p["k_norm"]["weight"])
        cos, sin = self.rope_tables(x.device)
        q = self.rope_fn(q, inputs.positions, cos, sin).contiguous()
        k = self.rope_fn(k, inputs.positions, cos, sin)
        out, kv_pages = append_and_attend(
            q, k, v, kv_pages, inputs.kv_lens, inputs.page_indices,
            inputs.cu_q_lens, inputs.num_seqs, inputs.slot_mapping,
            sm_scale=d ** -0.5, use_kernels=self.use_kernels,
            decode_only=inputs.decode_only,
            decode_fused=inputs.decode_fused,
            prefill_fused=inputs.prefill_fused,
        )
        hq = q.shape[1]
        out = out.reshape(t, hq * d) * torch.sigmoid(
            gate.reshape(t, hq * d).float()).to(out.dtype)
        return L.linear(out, p["o_proj"]), kv_pages

    def _gated_delta_net(self, p, x, state, inputs: BatchInputs):
        """GatedDeltaNet (HF ``Qwen3NextGatedDeltaNet``): projections, the
        causal conv and the delta recurrence over each row's state slot
        (zeroed on a request's first chunk), the gated RMSNorm, the output
        projection. The slots' new states are written in place."""
        la = self.config.linear_attn
        conv_all, rec_all = state
        t = x.shape[0]
        hk, hv = la.num_k_heads, la.num_v_heads
        dk, dv = la.head_k_dim, la.head_v_dim
        r = hv // hk
        qkvz = L.linear(x, p["in_proj_qkvz"]).reshape(
            t, hk, 2 * dk + 2 * r * dv)
        ba = L.linear(x, p["in_proj_ba"]).reshape(t, hk, 2 * r)
        q = qkvz[..., :dk]
        k = qkvz[..., dk:2 * dk]
        v = qkvz[..., 2 * dk:2 * dk + r * dv].reshape(t, hv, dv)
        z = qkvz[..., 2 * dk + r * dv:].reshape(t, hv, dv)
        b = ba[..., :r].reshape(t, hv)
        a = ba[..., r:].reshape(t, hv)
        mixed = torch.cat([q.reshape(t, -1), k.reshape(t, -1),
                           v.reshape(t, -1)], dim=-1)

        dm, slots, q_lens = inputs.dense_map, inputs.state_slots, inputs.q_lens
        idx = slots.long()
        fresh = inputs.reset_state.bool()
        conv_state = torch.where(fresh[:, None, None], 0.0, conv_all[idx])
        mixed_d, new_conv = causal_conv_update(
            _densify(mixed, dm), conv_state, p["conv1d"]["weight"], q_lens)
        s, maxq, _ = mixed_d.shape
        kd_ = self.key_dim
        qd = mixed_d[..., :kd_].reshape(s, maxq, hk, dk)
        kd = mixed_d[..., kd_:2 * kd_].reshape(s, maxq, hk, dk)
        vd = mixed_d[..., 2 * kd_:].reshape(s, maxq, hv, dv)
        if r > 1:
            qd = torch.repeat_interleave(qd, r, dim=2)
            kd = torch.repeat_interleave(kd, r, dim=2)
        qd, kd = l2norm(qd), l2norm(kd)
        beta = torch.sigmoid(_densify(b, dm).float())
        g = -torch.exp(p["A_log"].float()) * F.softplus(
            _densify(a, dm).float() + p["dt_bias"].float())
        rec_state = torch.where(fresh[:, None, None, None], 0.0,
                                rec_all[idx])
        out_d, new_rec = gated_delta_rule_scan(qd, kd, vd, g, beta,
                                               rec_state, q_lens)
        conv_all.index_copy_(0, idx, new_conv)
        rec_all.index_copy_(0, idx, new_rec)

        out = _scatter_ragged(out_d.reshape(s, maxq, hv * dv), dm,
                              t).reshape(t, hv, dv)
        # Gated RMSNorm (norm, then * silu(z)) over each value head.
        normed = L.rms_norm(out.to(x.dtype), p["norm"]["weight"],
                            self.config.rms_norm_eps)
        gated = normed.float() * F.silu(z.float())
        y = L.linear(gated.reshape(t, hv * dv).to(x.dtype), p["out_proj"])
        return y, (conv_all, rec_all)

    # -- params ------------------------------------------------------------

    def finalize_params(self, tree: dict) -> dict:
        """The MoE stacking, then torch's conv1d ``[out, 1, K]`` ->
        ``[out, K]``."""
        tree = super().finalize_params(tree)
        for layer in tree.get("layers", []):
            lin = layer.get("linear_attn")
            if isinstance(lin, dict) and "conv1d" in lin:
                w = lin["conv1d"]["weight"]
                if w.dim() == 3:
                    lin["conv1d"]["weight"] = w[:, 0, :]
        return tree

    def _init_layer(self, layer_idx: int, normal, dense, ones) -> dict:
        """The JAX package's shapes and scales: a linear layer's
        GatedDeltaNet params (conv taps ``N(0, 1) * 0.2`` in f32, ``A_log``
        0, ``dt_bias`` 1) in place of attention; a full layer's fused
        ``q_proj [Hq * 2D, H]`` with its qk norms."""
        layer = super()._init_layer(layer_idx, normal, dense, ones)
        cfg = self.config
        h = cfg.hidden_size
        attn = layer.pop("self_attn")
        if cfg.layer_type(layer_idx) != LAYER_LINEAR:
            d = cfg.head_dim
            attn["q_proj"] = dense(cfg.num_attention_heads * 2 * d, h)
            attn.setdefault("q_norm", ones(d))
            attn.setdefault("k_norm", ones(d))
            layer["self_attn"] = attn
            return layer
        la = cfg.linear_attn
        hk, hv = la.num_k_heads, la.num_v_heads
        dk, dv = la.head_k_dim, la.head_v_dim
        r = hv // hk
        device = attn["o_proj"]["weight"].device
        f32 = dict(dtype=torch.float32, device=device)
        layer["linear_attn"] = {
            "in_proj_qkvz": dense(hk * (2 * dk + 2 * r * dv), h),
            "in_proj_ba": dense(2 * hv, h),
            "conv1d": {"weight": normal((self.conv_dim, la.conv_kernel_size),
                                        0.2).float()},
            "A_log": torch.zeros((hv,), **f32),
            "dt_bias": torch.ones((hv,), **f32),
            "norm": ones(dv),
            "out_proj": dense(h, hv * dv),
        }
        return layer
