"""StageModel: one pipeline stage of a dense decoder (port of
``parallax_tpu/models/base.py``).

Embedding iff first stage, final norm + lm_head iff last, decoder blocks in
between. The forward is ``(params, kv_caches, BatchInputs) -> (output,
kv_caches)`` as in the JAX package; the KV caches are updated IN PLACE
(the JAX package donates them and gets new arrays back) and the same list
is returned. The model itself holds no tensors of a device: rope tables are
built per device on first use, and ``init_params`` / ``new_kv_caches`` take
the device explicitly.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from parallax_tpu_torch.config import LAYER_SLIDING, ModelConfig
from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.ops.kv_cache_ops import new_kv_pages
from parallax_tpu_torch.ops.lora import merge_layer_lora, select_slot
from parallax_tpu_torch.ops.rope import (
    apply_rope,
    rope_frequencies,
    rope_table,
    yarn_mscale,
)

# init_params draws a tensor of up to this many elements in one call.
_WHOLE_DRAW = 1 << 30


@dataclasses.dataclass
class BatchInputs:
    """Device inputs for one engine step (fixed shapes per bucket).

    ``token_ids`` is used by the first stage, ``hidden_states`` by later
    stages; exactly one is non-None.
    """

    token_ids: torch.Tensor | None      # i32[T]
    hidden_states: torch.Tensor | None  # [T, hidden]
    positions: torch.Tensor             # i32[T] absolute positions
    kv_lens: torch.Tensor               # i32[S]
    page_indices: torch.Tensor          # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor             # i32[S+1]
    num_seqs: torch.Tensor              # i32[1]
    slot_mapping: torch.Tensor          # i32[T]
    logits_indices: torch.Tensor        # i32[S] last-token row per sequence
    # Hybrid (linear-attention) models only; None otherwise.
    state_slots: torch.Tensor | None = None  # i32[S] per-seq state slot
    dense_map: torch.Tensor | None = None    # i32[S, maxq] row per step
    q_lens: torch.Tensor | None = None       # i32[S] valid steps per row
    # 1 on a request's first chunk: its (possibly reused) slot is zeroed
    # before use.
    reset_state: torch.Tensor | None = None  # i32[S]
    # Per-request LoRA (``ops/lora.py``): ``{"slot": i64[1], "layers":
    # stacked}`` for a batch of one adapter, ``{"slots": i32[T],
    # "layers": stacked}`` for a mixed one; None for base traffic.
    lora: dict | None = None
    # Every segment is a single decode token (row i == sequence i).
    decode_only: bool = False
    # Attention layers run the fused decode kernel (append inside it).
    decode_fused: bool = False
    # Attention layers run the fused prefill kernel pair.
    prefill_fused: bool = False


class StageModel:
    """A contiguous range ``[start_layer, end_layer)`` of decoder blocks."""

    # Whether this block runs a config's MoE layers (model families that
    # do override ``_mlp``), its MLA attention, its DSA indexer and its MSA
    # block indexer.
    runs_moe = False
    runs_mla = False
    runs_dsa = False
    runs_msa = False
    # Whether this block runs a hybrid config's linear-attention layers.
    runs_linear = False
    # NeoX-halves rope; GLM-4 overrides it with the interleaved convention.
    rope_fn = staticmethod(apply_rope)
    # 0.0 = llama convention (ones-init weights); 1.0 = the Gemma zero-init
    # ``x_hat * (1 + w)`` for the layer, final and qk norms.
    norm_offset = 0.0

    def __init__(self, config: ModelConfig, start_layer: int, end_layer: int,
                 use_kernels: bool | None = None):
        self.config = config
        self.start_layer = start_layer
        self.end_layer = end_layer
        self.is_first = start_layer == 0
        self.is_last = end_layer == config.num_hidden_layers
        # Per-op choice of the split path's kernels (the JAX package's
        # ``use_pallas``): None = kernels when the tensors are on CUDA,
        # False = the plain path on any device (the card's reference).
        self.use_kernels = use_kernels
        self._rope_tables: dict[torch.device, tuple] = {}

    def rope_tables(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) f32 tables on ``device``, with the HF rope scaling and
        its attention-magnitude factor applied."""
        device = torch.device(device)
        tables = self._rope_tables.get(device)
        if tables is None:
            cfg = self.config
            inv = rope_frequencies(
                cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                cfg.partial_rotary_factor, device=device,
            )
            scaling = 1.0
            if cfg.rope_scaling:
                rs = cfg.rope_scaling
                if "attention_factor" in rs:
                    scaling = float(rs["attention_factor"])
                elif rs.get("rope_type", rs.get("type")) == "yarn":
                    scaling = yarn_mscale(float(rs.get("factor", 1.0)))
            tables = rope_table(inv, cfg.max_position_embeddings, scaling)
            self._rope_tables[device] = tables
        return tables

    # -- structure --------------------------------------------------------

    @property
    def num_local_layers(self) -> int:
        return self.end_layer - self.start_layer

    def new_kv_caches(
        self, num_pages: int, page_size: int, dtype=torch.bfloat16,
        device="cpu",
    ) -> list[torch.Tensor]:
        """One paged cache per local layer."""
        return [
            new_kv_pages(
                num_pages, page_size, self.config.num_key_value_heads,
                self.config.head_dim, dtype, device,
            )
            for _ in range(self.num_local_layers)
        ]

    # -- parameters -------------------------------------------------------

    def finalize_params(self, tree: dict) -> dict:
        """Loader hook: reshape/stack checkpoint weights into this model's
        param layout (e.g. stacking MoE experts). Default: identity."""
        return tree

    def init_params(self, generator: torch.Generator,
                    dtype=torch.bfloat16, device="cpu") -> dict:
        """Random init with the shapes and scales of the JAX package's
        ``init_params``: dense weights ``N(0, 1) * in_dim**-0.5``, zero
        biases, unit norms, embedding and lm_head ``N(0, 1) * 0.02``. Every
        draw comes from ``generator`` (which must live on ``device``)."""
        cfg = self.config

        def normal(shape, scale):
            if math.prod(shape) <= _WHOLE_DRAW:
                w = torch.randn(shape, generator=generator, device=device,
                                dtype=torch.float32)
                return (w * scale).to(dtype)
            # One leading slice at a time, so the f32 transient stays small
            # (DeepSeek-V3's stacked experts hold 3.76 G elements).
            out = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0]):
                out[i] = (torch.randn(shape[1:], generator=generator,
                                      device=device, dtype=torch.float32)
                          * scale).to(dtype)
            return out

        def dense(out_dim, in_dim, bias=False):
            p = {"weight": normal((out_dim, in_dim), in_dim ** -0.5)}
            if bias:
                p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
            return p

        def ones(n):
            return {"weight": torch.ones((n,), dtype=dtype, device=device)}

        h = cfg.hidden_size
        params: dict = {"layers": [
            self._init_layer(self.start_layer + li, normal, dense, ones)
            for li in range(self.num_local_layers)
        ]}
        # The last stage of a tied-embedding model also needs the embedding
        # matrix (it IS the lm_head).
        if self.is_first or (self.is_last and cfg.tie_word_embeddings):
            params["embed_tokens"] = {
                "weight": normal((cfg.vocab_size, h), 0.02)
            }
        if self.is_last:
            params["norm"] = ones(h)
            if not cfg.tie_word_embeddings:
                params["lm_head"] = {"weight": normal((cfg.vocab_size, h), 0.02)}
        return params

    def _init_layer(self, layer_idx: int, normal, dense, ones) -> dict:
        """The params of global layer ``layer_idx``: norms, attention,
        FFN, in ``init_params``'s draw order."""
        h = self.config.hidden_size
        return {
            "input_layernorm": ones(h),
            "post_attention_layernorm": ones(h),
            "self_attn": self._init_attention(layer_idx, normal, dense, ones),
            "mlp": self._init_mlp(layer_idx, normal, dense),
        }

    def _init_attention(self, layer_idx: int, normal, dense, ones) -> dict:
        """The attention params of global layer ``layer_idx``, drawn with
        ``init_params``'s helpers in its draw order (``ones(n)`` draws
        nothing); model families override it."""
        cfg = self.config
        h, d = cfg.hidden_size, cfg.head_dim
        attn = {
            "q_proj": dense(cfg.num_attention_heads * d, h, cfg.attention_bias),
            "k_proj": dense(cfg.num_key_value_heads * d, h, cfg.attention_bias),
            "v_proj": dense(cfg.num_key_value_heads * d, h, cfg.attention_bias),
            "o_proj": dense(h, cfg.num_attention_heads * d),
        }
        if cfg.use_qk_norm:
            attn["q_norm"] = ones(d)
            attn["k_norm"] = ones(d)
        return attn

    def _init_mlp(self, layer_idx: int, normal, dense) -> dict:
        """The FFN params of global layer ``layer_idx``, drawn with
        ``init_params``'s helpers (``normal(shape, scale)``, ``dense(out,
        in)``) in its draw order; model families override it."""
        cfg = self.config
        h = cfg.hidden_size
        return {
            "gate_proj": dense(cfg.intermediate_size, h),
            "up_proj": dense(cfg.intermediate_size, h),
            "down_proj": dense(h, cfg.intermediate_size),
        }

    # -- forward ----------------------------------------------------------

    def __call__(
        self,
        params: dict,
        kv_caches: list[torch.Tensor],
        inputs: BatchInputs,
    ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """Run the stage. Returns ``(hidden [T, hidden], kv)`` for
        intermediate stages, or ``(logits f32[S, vocab], kv)`` on the last
        stage (gathered at ``logits_indices``)."""
        with L.kernel_choice(self.use_kernels):
            return self._forward(params, kv_caches, inputs)

    def _forward(self, params, kv_caches, inputs: BatchInputs):
        cfg = self.config
        if self.is_first:
            x = L.embed_lookup(params["embed_tokens"], inputs.token_ids)
        else:
            x = inputs.hidden_states
        lora_sel = None
        if inputs.lora is not None:
            lora_sel = select_slot(inputs.lora)
        for li in range(self.num_local_layers):
            window = (
                cfg.sliding_window
                if cfg.layer_type(self.start_layer + li) == LAYER_SLIDING
                else None
            )
            lp = params["layers"][li]
            if lora_sel is not None and str(li) in lora_sel:
                lp = merge_layer_lora(lp, lora_sel[str(li)])
            x, kv_caches[li] = self._decoder_layer(
                lp, x, kv_caches[li], inputs, window
            )
        if not self.is_last:
            return x, kv_caches
        x = self._rms(x, params["norm"]["weight"])
        x = x[inputs.logits_indices.long()]
        head = params.get("lm_head") or params["embed_tokens"]
        return L.lm_head_logits(x, head), kv_caches

    def _decoder_layer(self, lp: dict, x: torch.Tensor, kv, inputs: BatchInputs,
                       window: int | None):
        """One pre-norm decoder block; returns ``(x, kv)``. Model families
        with their own attention override it (``kv`` is whatever their
        ``new_kv_caches`` made for the layer)."""
        h = self._rms(x, lp["input_layernorm"]["weight"])
        attn, kv = self._attention(lp, h, kv, inputs, window)
        x = x + attn
        h = self._rms(x, lp["post_attention_layernorm"]["weight"])
        return x + self._mlp(lp, h), kv

    def _attention(self, lp: dict, h: torch.Tensor, kv: torch.Tensor,
                   inputs: BatchInputs, window: int | None):
        cos, sin = self.rope_tables(h.device)
        return L.paged_attention_block(
            h, lp["self_attn"], kv,
            config=self.config,
            positions=inputs.positions,
            kv_lens=inputs.kv_lens,
            page_indices=inputs.page_indices,
            cu_q_lens=inputs.cu_q_lens,
            num_seqs=inputs.num_seqs,
            slot_mapping=inputs.slot_mapping,
            cos_table=cos,
            sin_table=sin,
            sliding_window=window,
            use_kernels=self.use_kernels,
            decode_only=inputs.decode_only,
            decode_fused=inputs.decode_fused,
            prefill_fused=inputs.prefill_fused,
            rope_fn=self.rope_fn,
        )

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        """The FFN of one decoder layer; model families override it."""
        return L.swiglu_mlp(h, lp["mlp"])

    def _rms(self, x, weight):
        return L.rms_norm(x, weight, self.config.rms_norm_eps,
                          offset=self.norm_offset)
