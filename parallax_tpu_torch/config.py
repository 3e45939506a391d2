"""Model configuration normalization.

Turns a HuggingFace ``config.json``-style dict into a single normalized
:class:`ModelConfig` used everywhere in the framework (models, cache sizing,
the global scheduler's FLOPs/bytes estimates).

Capability parity: reference ``src/scheduling/model_info.py:18-193`` and
``src/parallax/utils/utils.py`` (normalize_model_config, get_layer_types).
Copied unchanged from ``parallax_tpu/config.py`` so the port imports nothing
of the JAX package; the two must stay in step.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


# Per-layer cache kinds (reference: src/parallax/utils/layer_types.py).
LAYER_ATTENTION = "attention"          # full paged KV
LAYER_SLIDING = "sliding_attention"    # windowed paged KV
LAYER_MLA = "mla"                      # compressed-latent cache (DeepSeek)
LAYER_LINEAR = "linear_attention"      # conv + recurrent state slots (hybrid)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts shape info (used for EP sharding + FLOPs estimates)."""

    num_experts: int
    num_experts_per_tok: int
    moe_intermediate_size: int
    num_shared_experts: int = 0
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # Layers < this index are dense FFN even in an MoE model (DeepSeek style).
    first_k_dense_replace: int = 0
    # Every n-th layer is MoE (1 = all layers past first_k_dense_replace).
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    n_group: int = 0
    topk_group: int = 0
    scoring_func: str = "softmax"   # or "sigmoid" (DeepSeek-V3)
    # Group-selection method: "noaux_tc" (V3: sum of top-2 biased scores),
    # "group_limited_greedy" (V2: max score per group), "greedy" (no groups).
    topk_method: str = "greedy"
    # Explicit per-layer MoE mask, resolved at normalize time from the source
    # convention (DeepSeek first_k_dense_replace/moe_layer_freq vs Qwen
    # decoder_sparse_step/mlp_only_layers use different off-by-one rules).
    layer_mask: tuple[bool, ...] = ()


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention dims (DeepSeek V2/V3 family).

    Reference derives these in ``src/scheduling/model_info.py:45-60``.
    """

    kv_lora_rank: int
    q_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class DSAConfig:
    """DeepSeek Sparse Attention (V3.2 / GLM-MoE-DSA) indexer dims.

    The "lightning indexer" scores every cached token with
    ``sum_h w_h * relu(q_h . k)`` and attention runs over the top-k
    positions of the MLA latent cache. Reference:
    ``src/parallax/models/deepseek_v32.py:27-58`` (derive_indexer_types),
    ``src/parallax_extensions/ops.py:182-367``.
    """

    index_n_heads: int
    index_head_dim: int
    index_topk: int
    index_key_heads: int = 1
    # Per-layer indexer mode, length == num_hidden_layers: "full" layers run
    # the indexer; "shared" layers reuse the previous full layer's top-k.
    indexer_types: tuple[str, ...] = ()
    # Rope convention inside the indexer head (True = interleaved/GPT-J,
    # DeepSeek-V3.2 default; GLM-MoE-DSA uses half-rotation).
    indexer_rope_traditional: bool = True
    indexer_norm_eps: float = 1e-5


def derive_indexer_types(
    num_layers: int,
    index_topk_freq: int = 1,
    indexer_types=None,
    first_k_dense_replace: int = 0,
    index_skip_topk_offset: int | None = None,
) -> tuple[str, ...]:
    """Per-layer DSA indexer modes (reference deepseek_v32.py:27-58)."""
    if indexer_types is not None:
        return tuple(indexer_types)
    if index_topk_freq <= 1:
        return ("full",) * num_layers
    if index_skip_topk_offset is None:
        index_skip_topk_offset = index_topk_freq - 1
    return tuple(
        "full"
        if (
            i < first_k_dense_replace
            or (i - first_k_dense_replace) % index_topk_freq
            == index_skip_topk_offset
        )
        else "shared"
        for i in range(num_layers)
    )


@dataclasses.dataclass(frozen=True)
class MSAConfig:
    """MiniMax-M3 block-sparse attention (MSA) dims.

    A light indexer scores sparse blocks of the context (score = max over
    index heads and block tokens of ``q_idx . k_idx * scale``); attention
    then runs over the tokens of the top-k blocks, with the first
    ``init_blocks`` and the ``local_blocks`` nearest blocks always kept.
    Reference: ``src/parallax/models/minimax_m3.py:456-567``
    (_build_sparse_mask) + ``src/parallax_extensions/ops.py:594-804``.
    """

    index_n_heads: int
    index_head_dim: int
    block_size: int
    topk_blocks: int
    init_blocks: int = 0
    local_blocks: int = 1
    index_key_heads: int = 1
    # Per-layer sparse flag, length == num_hidden_layers.
    sparse_layer_mask: tuple[bool, ...] = ()


@dataclasses.dataclass(frozen=True)
class LinearAttnConfig:
    """State shapes for linear-attention / hybrid layers (Qwen3-Next style)."""

    conv_kernel_size: int
    num_k_heads: int
    num_v_heads: int
    head_k_dim: int
    head_v_dim: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Normalized, immutable model architecture description."""

    model_name: str
    architecture: str
    vocab_size: int
    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    intermediate_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: dict | None = None
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    # qk-norm per head (Qwen3 family).
    use_qk_norm: bool = False
    sliding_window: int | None = None
    # Per-layer cache kind, length == num_hidden_layers.
    layer_types: tuple[str, ...] = ()
    # Attention sinks (gpt-oss): a learned logit per head that joins the softmax.
    use_attention_sinks: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    dsa: DSAConfig | None = None
    msa: MSAConfig | None = None
    linear_attn: LinearAttnConfig | None = None
    dtype: str = "bfloat16"
    # Bytes per parameter after quantization (bf16 => 2.0).
    param_bytes_per_element: float = 2.0
    partial_rotary_factor: float = 1.0
    extra: dict = dataclasses.field(default_factory=dict)

    # ---- derived helpers -------------------------------------------------

    @property
    def q_heads_per_kv_head(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def is_mla(self) -> bool:
        return self.mla is not None

    def layer_type(self, layer_idx: int) -> str:
        if self.layer_types:
            return self.layer_types[layer_idx]
        return LAYER_ATTENTION

    def kv_bytes_per_token_per_layer(self) -> int:
        """HBM bytes of KV state one token occupies in one attention layer.

        Reference estimate: ``src/scheduling/model_info.py:87-93``.
        """
        elem = 2  # bf16 cache
        if self.mla is not None:
            # Compressed latent + rope key, shared across heads.
            base = elem * (self.mla.kv_lora_rank + self.mla.qk_rope_head_dim)
            if self.dsa is not None:
                # DSA adds a paged index-key cache alongside the latent
                # (counted on every layer even though shared-indexer layers
                # skip it — conservative for page budgeting).
                base += elem * self.dsa.index_key_heads * self.dsa.index_head_dim
            return base
        base = 2 * elem * self.num_key_value_heads * self.head_dim
        if self.msa is not None:
            # MSA index-key cache on sparse layers (conservatively counted
            # on every layer for the page budget).
            base += elem * self.msa.index_key_heads * self.msa.index_head_dim
        return base

    def embedding_params(self) -> int:
        return self.vocab_size * self.hidden_size

    def decoder_layer_params(self, layer_idx: int = 0) -> int:
        """Approximate parameter count of one decoder layer (for allocation)."""
        h = self.hidden_size
        if self.mla is not None:
            m = self.mla
            attn = (
                h * (m.q_lora_rank or h)
                + (m.q_lora_rank or h) * self.num_attention_heads
                * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + h * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_attention_heads
                * (m.qk_nope_head_dim + m.v_head_dim)
                + self.num_attention_heads * m.v_head_dim * h
            )
        else:
            attn = (
                h * self.num_attention_heads * self.head_dim      # q
                + 2 * h * self.num_key_value_heads * self.head_dim  # k, v
                + self.num_attention_heads * self.head_dim * h    # o
            )
        if self.moe is not None and self._is_moe_layer(layer_idx):
            e = self.moe
            ffn = 3 * h * e.moe_intermediate_size * e.num_experts
            ffn += 3 * h * e.shared_expert_intermediate_size * e.num_shared_experts
            ffn += h * e.num_experts  # router
        else:
            ffn = 3 * h * self.intermediate_size
        return attn + ffn + 2 * h  # + 2 rmsnorm vectors

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.layer_mask:
            return self.moe.layer_mask[layer_idx]
        return layer_idx >= self.moe.first_k_dense_replace

    # Backwards-compat internal alias.
    _is_moe_layer = is_moe_layer

    def decoder_layer_flops(self, num_tokens: int, context_len: int) -> float:
        """FLOPs of one decoder layer forward over ``num_tokens`` new tokens.

        Mirrors the roofline inputs of ``src/scheduling/model_info.py:107-144``
        (2*params matmul FLOPs + attention score FLOPs; MoE counts only the
        activated experts).
        """
        h = self.hidden_size
        attn_proj = 2 * num_tokens * (
            h * self.num_attention_heads * self.head_dim * 2
            + 2 * h * self.num_key_value_heads * self.head_dim
        )
        attn_score = (
            4 * num_tokens * context_len * self.num_attention_heads * self.head_dim
        )
        if self.moe is not None:
            e = self.moe
            active = e.num_experts_per_tok + e.num_shared_experts
            ffn = 2 * num_tokens * 3 * h * e.moe_intermediate_size * active
        else:
            ffn = 2 * num_tokens * 3 * h * self.intermediate_size
        return float(attn_proj + attn_score + ffn)

    def lm_head_flops(self, num_tokens: int) -> float:
        return float(2 * num_tokens * self.hidden_size * self.vocab_size)


def _get(cfg: dict, *names: str, default: Any = None) -> Any:
    for n in names:
        if n in cfg and cfg[n] is not None:
            return cfg[n]
    return default


# Wire dtype for inter-stage activation frames (p2p/proto.py): the
# spellings operators use, keyed to the canonical names the wire format
# understands. "fp8" compresses hidden states with per-token scales.
_WIRE_DTYPE_ALIASES = {
    "bf16": "bfloat16",
    "bfloat16": "bfloat16",
    "fp8": "float8_e4m3fn",
    "float8": "float8_e4m3fn",
    "float8_e4m3fn": "float8_e4m3fn",
    "e4m3": "float8_e4m3fn",
    "f32": "float32",
    "fp32": "float32",
    "float32": "float32",
}


def resolve_wire_dtype(
    wire_dtype: str | None, model_dtype: str | None = None
) -> str | None:
    """Canonical wire dtype for inter-stage activation frames, or None
    when activations should ship at their native precision (the default —
    bit-identical multi-stage streams). A wire dtype equal to the model's
    own dtype is also None: framing it "natively" is the same bytes, and
    None keeps the exactness guarantee explicit."""
    if wire_dtype in (None, "", "model", "native"):
        return None
    key = str(wire_dtype).lower()
    if key not in _WIRE_DTYPE_ALIASES:
        raise ValueError(
            f"unknown wire dtype {wire_dtype!r} (want one of "
            f"{sorted(set(_WIRE_DTYPE_ALIASES))})"
        )
    canon = _WIRE_DTYPE_ALIASES[key]
    if model_dtype is not None and canon == str(model_dtype):
        return None
    return canon


def resolve_speculative_tokens(
    tokens: int | None, has_draft: bool = False
) -> int:
    """Canonical speculative verify width (``--speculative-tokens`` /
    ``EngineConfig.speculative_tokens``). 0/None = off — unless a draft
    model is configured, which implies speculation at the default width
    of 4 (loading draft weights that can never fire would silently
    waste HBM). Negative widths are a config error, not a silent off."""
    n = int(tokens or 0)
    if n < 0:
        raise ValueError(
            f"speculative_tokens must be >= 0, got {tokens!r}"
        )
    if n == 0 and has_draft:
        return 4
    return n


# Disaggregated prefill/decode serving (docs/disaggregation.md): a
# worker joins the swarm tagged with the phase it specializes in. The
# scheduler keeps pipelines role-homogeneous, routes the prompt phase to
# the prefill pool, and prefill heads hand finished prompts to
# CacheIndex-scored decode replicas over the KV-transfer lane.
NODE_ROLES = ("prefill", "decode", "mixed")


def resolve_role(role: str | None) -> str:
    """Canonical phase role for a worker (``--role`` / ``WorkerNode``
    config). None/"" mean ``mixed`` — the pre-disaggregation behavior:
    the node serves both phases and never initiates handoffs."""
    if role in (None, ""):
        return "mixed"
    key = str(role).lower()
    if key not in NODE_ROLES:
        raise ValueError(
            f"unknown node role {role!r} (want one of {NODE_ROLES})"
        )
    return key


def normalize_config(raw: dict, model_name: str = "") -> ModelConfig:
    """Build a :class:`ModelConfig` from a HF ``config.json`` dict.

    Handles the key aliases the reference normalizes in
    ``src/parallax/utils/utils.py:343`` (text_config nesting, head_dim
    inference, MoE/MLA/linear detection, per-layer types).
    """
    cfg = dict(raw)
    # Multimodal wrappers nest the LM config.
    if "text_config" in cfg and isinstance(cfg["text_config"], dict):
        inner = dict(cfg["text_config"])
        inner.setdefault("architectures", cfg.get("architectures"))
        cfg = inner

    archs = cfg.get("architectures") or ["UnknownForCausalLM"]
    architecture = archs[0]
    is_glm_dsa = cfg.get("model_type") == "glm_moe_dsa"
    if is_glm_dsa and architecture == "UnknownForCausalLM":
        architecture = "GlmMoeDsaForCausalLM"

    hidden_size = int(_get(cfg, "hidden_size", "n_embd", "d_model"))
    num_layers = int(_get(cfg, "num_hidden_layers", "n_layer", "num_layers"))
    num_heads = int(_get(cfg, "num_attention_heads", "n_head"))
    # Step-3.5 names its KV-head count "num_attention_groups".
    num_kv = int(_get(cfg, "num_key_value_heads", "num_attention_groups",
                      default=num_heads))
    head_dim = int(_get(cfg, "head_dim", default=hidden_size // num_heads))
    vocab = int(_get(cfg, "vocab_size", default=32000))
    inter = int(_get(cfg, "intermediate_size", "n_inner", default=4 * hidden_size))

    moe = None
    n_experts = _get(cfg, "num_experts", "n_routed_experts",
                     "num_local_experts", "moe_num_experts")
    if n_experts:
        # Resolve the per-layer MoE mask under the source convention:
        # Qwen: MoE iff (idx+1) % decoder_sparse_step == 0 and idx not in
        # mlp_only_layers; DeepSeek: MoE iff idx >= first_k_dense_replace
        # and idx % moe_layer_freq == 0.
        first_k = int(_get(cfg, "first_k_dense_replace", default=0) or 0)
        mlp_only = set(_get(cfg, "mlp_only_layers", default=[]) or [])
        if isinstance(cfg.get("mlp_layer_types"), list):
            # MiniMax-M3: explicit per-layer "sparse"/"dense" labels.
            mask = tuple(
                t == "sparse" for t in cfg["mlp_layer_types"]
            )
        elif isinstance(cfg.get("moe_layer_freq"), list):
            freq_list = cfg["moe_layer_freq"]
            mask = tuple(
                bool(freq_list[i]) if i < len(freq_list) else True
                for i in range(num_layers)
            )
        elif "decoder_sparse_step" in cfg:
            step = int(cfg["decoder_sparse_step"] or 1)
            mask = tuple(
                (i + 1) % step == 0 and i not in mlp_only
                for i in range(num_layers)
            )
        else:
            freq = int(_get(cfg, "moe_layer_freq", default=1) or 1)
            mask = tuple(
                i >= first_k and i % freq == 0 for i in range(num_layers)
            )
        moe = MoEConfig(
            layer_mask=mask,
            num_experts=int(n_experts),
            num_experts_per_tok=int(_get(cfg, "num_experts_per_tok", "top_k",
                                         "moe_top_k", default=2)),
            moe_intermediate_size=int(_get(cfg, "moe_intermediate_size", default=inter)),
            num_shared_experts=int(_get(cfg, "n_shared_experts", "num_shared_experts", default=0) or 0),
            shared_expert_intermediate_size=int(
                _get(cfg, "shared_expert_intermediate_size",
                     "shared_intermediate_size",
                     default=_get(cfg, "moe_intermediate_size", default=inter))
            ),
            norm_topk_prob=bool(_get(cfg, "norm_topk_prob", default=True)),
            first_k_dense_replace=int(_get(cfg, "first_k_dense_replace", default=0) or 0),
            moe_layer_freq=(
                1 if isinstance(_get(cfg, "moe_layer_freq"), list)
                else int(_get(cfg, "moe_layer_freq", "decoder_sparse_step",
                              default=1) or 1)
            ),
            routed_scaling_factor=float(_get(cfg, "routed_scaling_factor", default=1.0) or 1.0),
            n_group=int(_get(cfg, "n_group", default=0) or 0),
            topk_group=int(_get(cfg, "topk_group", default=0) or 0),
            scoring_func=str(_get(
                cfg, "scoring_func",
                # HF's Glm4MoeTopkRouter hardcodes sigmoid scoring (no
                # scoring_func key in Glm4MoeConfig), as does GLM-MoE-DSA.
                default="sigmoid"
                if (is_glm_dsa or "Glm4Moe" in architecture)
                else "softmax",
            )),
            topk_method=str(_get(
                cfg, "topk_method",
                default="noaux_tc" if (is_glm_dsa or _get(cfg, "n_group"))
                else "greedy",
            )),
        )

    # MiniMax-M3: experts use intermediate_size; DENSE layers use the larger
    # dense_intermediate_size (reference ModelArgs.dense_intermediate_size).
    if _get(cfg, "dense_intermediate_size") and moe is not None:
        inter = int(cfg["dense_intermediate_size"])

    mla = None
    if _get(cfg, "kv_lora_rank"):
        mla = MLAConfig(
            kv_lora_rank=int(cfg["kv_lora_rank"]),
            q_lora_rank=int(_get(cfg, "q_lora_rank", default=0) or 0),
            qk_nope_head_dim=int(_get(cfg, "qk_nope_head_dim", default=128)),
            qk_rope_head_dim=int(_get(cfg, "qk_rope_head_dim", default=64)),
            v_head_dim=int(_get(cfg, "v_head_dim", default=128)),
        )
        head_dim = mla.qk_nope_head_dim + mla.qk_rope_head_dim

    # DSA indexer (DeepSeek-V3.2 config keys; GLM-MoE-DSA overrides the
    # rope/norm conventions — reference GLM_MOE_DSA_DEFAULTS).
    dsa = None
    if mla is not None and _get(cfg, "index_n_heads") and _get(cfg, "index_head_dim"):
        if int(_get(cfg, "index_key_heads", default=1) or 1) != 1:
            # The DSA ops store/score a single shared index key per token
            # (DeepSeek-V3.2/GLM convention); more key heads would be
            # silently ignored, so reject loudly.
            raise ValueError("DSA supports index_key_heads == 1 only")
        dsa = DSAConfig(
            index_n_heads=int(cfg["index_n_heads"]),
            index_head_dim=int(cfg["index_head_dim"]),
            index_topk=int(_get(cfg, "index_topk", default=2048)),
            index_key_heads=int(_get(cfg, "index_key_heads", default=1) or 1),
            indexer_types=derive_indexer_types(
                num_layers,
                int(_get(cfg, "index_topk_freq", default=1) or 1),
                cfg.get("indexer_types"),
                int(_get(cfg, "first_k_dense_replace", default=0) or 0),
                cfg.get("index_skip_topk_offset"),
            ),
            indexer_rope_traditional=bool(_get(
                cfg, "indexer_rope_traditional",
                default=not is_glm_dsa,
            )),
            indexer_norm_eps=float(_get(
                cfg, "indexer_norm_eps",
                default=1e-6 if is_glm_dsa else 1e-5,
            )),
        )

    # MSA block-sparse attention (MiniMax-M3). Config surface mirrors the
    # reference ModelArgs (minimax_m3.py:23-139): either a
    # ``sparse_attention_config`` dict or flat ``index_*`` keys, with the
    # per-layer sparse mask from layer_types / sparse_attention_freq.
    msa = None
    is_minimax_m3 = cfg.get("model_type") == "minimax_m3" or (
        "MiniMaxM3" in architecture
    )
    sac = cfg.get("sparse_attention_config")
    if is_minimax_m3 and (sac or _get(cfg, "index_n_heads")):
        sac = dict(sac or {})
        raw_lt = cfg.get("layer_types")
        if raw_lt:
            sparse_mask = tuple(
                t == "minimax_m3_sparse" for t in raw_lt
            )
        elif isinstance(sac.get("sparse_attention_freq"), list):
            freq = sac["sparse_attention_freq"]
            sparse_mask = tuple(
                bool(freq[i]) if i < len(freq) else False
                for i in range(num_layers)
            )
        else:
            dense_n = min(3, num_layers)
            sparse_mask = (False,) * dense_n + (True,) * (
                num_layers - dense_n
            )
        msa = MSAConfig(
            index_n_heads=int(
                sac.get("sparse_num_index_heads")
                or _get(cfg, "index_n_heads", default=4)
            ),
            index_head_dim=int(
                sac.get("sparse_index_dim")
                or _get(cfg, "index_head_dim", default=128)
            ),
            block_size=int(
                sac.get("sparse_block_size")
                or _get(cfg, "index_block_size", default=128)
            ),
            topk_blocks=int(
                sac.get("sparse_topk_blocks")
                or _get(cfg, "index_topk_blocks", default=16)
            ),
            init_blocks=int(sac.get("sparse_init_block", 0) or 0),
            local_blocks=int(
                sac.get(
                    "sparse_local_block",
                    _get(cfg, "index_local_blocks", default=1),
                ) or 0
            ),
            sparse_layer_mask=sparse_mask,
        )

    linear_attn = None
    if _get(cfg, "linear_conv_kernel_dim", "conv_kernel"):
        linear_attn = LinearAttnConfig(
            conv_kernel_size=int(_get(cfg, "linear_conv_kernel_dim", "conv_kernel", default=4)),
            num_k_heads=int(_get(cfg, "linear_num_key_heads", default=num_kv)),
            num_v_heads=int(_get(cfg, "linear_num_value_heads", default=num_heads)),
            head_k_dim=int(_get(cfg, "linear_key_head_dim", default=head_dim)),
            head_v_dim=int(_get(cfg, "linear_value_head_dim", default=head_dim)),
        )

    # Per-layer types: explicit list (gpt-oss/qwen3-next style) or uniform.
    layer_types: tuple[str, ...]
    raw_types = cfg.get("layer_types")
    sliding = _get(cfg, "sliding_window", default=None)
    if raw_types:
        mapping = {
            "full_attention": LAYER_ATTENTION,
            "attention": LAYER_ATTENTION,
            "sliding_attention": LAYER_SLIDING,
            "linear_attention": LAYER_LINEAR,
            "mla": LAYER_MLA,
        }
        layer_types = tuple(mapping.get(t, LAYER_ATTENTION) for t in raw_types)
    elif mla is not None:
        layer_types = (LAYER_MLA,) * num_layers
    elif sliding and bool(_get(cfg, "use_sliding_window", default=True)):
        # Uniform sliding window (Mistral-style), possibly with full layers
        # below max_window_layers (Qwen2 style).
        max_win_layers = int(_get(cfg, "max_window_layers", default=0) or 0)
        layer_types = tuple(
            LAYER_ATTENTION if i < max_win_layers else LAYER_SLIDING
            for i in range(num_layers)
        )
    else:
        layer_types = (LAYER_ATTENTION,) * num_layers

    quant = cfg.get("quantization_config") or cfg.get("quantization")
    pbpe = 2.0
    if isinstance(quant, dict):
        bits = quant.get("bits") or quant.get("weight_bits")
        if bits:
            pbpe = float(bits) / 8.0

    return ModelConfig(
        model_name=model_name or str(cfg.get("_name_or_path", architecture)),
        architecture=architecture,
        vocab_size=vocab,
        hidden_size=hidden_size,
        num_hidden_layers=num_layers,
        num_attention_heads=num_heads,
        num_key_value_heads=num_kv,
        head_dim=head_dim,
        intermediate_size=inter,
        rms_norm_eps=float(_get(cfg, "rms_norm_eps", "layer_norm_epsilon", default=1e-6)),
        rope_theta=float(_get(cfg, "rope_theta", default=10000.0)),
        rope_scaling=cfg.get("rope_scaling"),
        max_position_embeddings=int(_get(cfg, "max_position_embeddings", default=32768)),
        tie_word_embeddings=bool(_get(cfg, "tie_word_embeddings", default=False)),
        attention_bias=bool(_get(cfg, "attention_bias", "qkv_bias", default=False)),
        use_qk_norm=bool(_get(cfg, "use_qk_norm", default="Qwen3" in architecture)),
        sliding_window=int(sliding) if sliding else None,
        layer_types=layer_types,
        use_attention_sinks="GptOss" in architecture or bool(cfg.get("attention_sinks")),
        moe=moe,
        mla=mla,
        dsa=dsa,
        msa=msa,
        linear_attn=linear_attn,
        dtype=str(_get(cfg, "torch_dtype", "dtype", default="bfloat16")),
        param_bytes_per_element=pbpe,
        partial_rotary_factor=float(_get(cfg, "partial_rotary_factor", default=1.0)),
        extra={k: v for k, v in cfg.items()
               if k in ("moe_intermediate_size", "num_attention_groups",
                        "rotary_dim", "rope_interleave",
                        "dense_intermediate_size", "swiglu_alpha",
                        "swiglu_limit", "swiglu_beta", "use_gemma_norm",
                        "use_routing_bias")},
    )


def load_config(model_path: str, model_name: str = "") -> ModelConfig:
    """Load and normalize ``config.json`` from a local model directory."""
    path = os.path.join(model_path, "config.json")
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    return normalize_config(raw, model_name=model_name or os.path.basename(model_path))
