"""Built-in architecture presets (HF config dicts) for benchmarks, the
compile-check entry point, and offline runs without a downloaded checkpoint.

Shapes match the public HF configs of each model; weights are random unless
loaded from a real checkpoint.

Copied from ``parallax_tpu/models/presets.py`` with the import swapped to
the port's ``config``, so the port imports nothing of the JAX package; the
two tables must stay in step.
"""

from __future__ import annotations

from parallax_tpu_torch.config import ModelConfig, normalize_config

PRESETS: dict[str, dict] = {
    # https://huggingface.co/Qwen/Qwen2.5-0.5B-Instruct/blob/main/config.json
    "qwen2.5-0.5b": dict(
        architectures=["Qwen2ForCausalLM"],
        hidden_size=896,
        num_hidden_layers=24,
        num_attention_heads=14,
        num_key_value_heads=2,
        intermediate_size=4864,
        vocab_size=151936,
        max_position_embeddings=32768,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True,
        attention_bias=True,
    ),
    # https://huggingface.co/Qwen/Qwen2.5-7B-Instruct/blob/main/config.json
    "qwen2.5-7b": dict(
        architectures=["Qwen2ForCausalLM"],
        hidden_size=3584,
        num_hidden_layers=28,
        num_attention_heads=28,
        num_key_value_heads=4,
        intermediate_size=18944,
        vocab_size=152064,
        max_position_embeddings=32768,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        tie_word_embeddings=False,
        attention_bias=True,
    ),
    # https://huggingface.co/meta-llama/Meta-Llama-3-8B-Instruct config
    "llama-3-8b": dict(
        architectures=["LlamaForCausalLM"],
        hidden_size=4096,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=8,
        intermediate_size=14336,
        vocab_size=128256,
        max_position_embeddings=8192,
        rope_theta=500000.0,
        rms_norm_eps=1e-5,
        tie_word_embeddings=False,
    ),
    # https://huggingface.co/Qwen/Qwen3-8B config
    "qwen3-8b": dict(
        architectures=["Qwen3ForCausalLM"],
        hidden_size=4096,
        num_hidden_layers=36,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=128,
        intermediate_size=12288,
        vocab_size=151936,
        max_position_embeddings=40960,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        tie_word_embeddings=False,
    ),
}


# Curated model DB: HF repo name -> preset key + serving notes. The
# scheduler uses this for ModelInfo/roofline estimates when a node joins by
# model NAME rather than a local checkpoint directory (reference
# ``src/backend/server/static_config.py:11-107`` maps ~90 GPU names to MLX
# checkpoints; the TPU build maps to architecture presets — actual serving
# always reads the checkpoint's own config.json).
MODEL_DB: dict[str, dict] = {
    # Qwen dense (Qwen2.5: public HF config shapes)
    "Qwen/Qwen2.5-0.5B-Instruct": dict(preset="qwen2.5-0.5b"),
    "Qwen/Qwen2.5-1.5B-Instruct": dict(
        architectures=["Qwen2ForCausalLM"], hidden_size=1536,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        intermediate_size=8960, vocab_size=151936,
        max_position_embeddings=32768, rope_theta=1000000.0,
        tie_word_embeddings=True, attention_bias=True,
    ),
    "Qwen/Qwen2.5-3B-Instruct": dict(
        architectures=["Qwen2ForCausalLM"], hidden_size=2048,
        num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=2,
        intermediate_size=11008, vocab_size=151936,
        max_position_embeddings=32768, rope_theta=1000000.0,
        tie_word_embeddings=True, attention_bias=True,
    ),
    "Qwen/Qwen2.5-7B-Instruct": dict(preset="qwen2.5-7b"),
    "Qwen/Qwen2.5-14B-Instruct": dict(
        architectures=["Qwen2ForCausalLM"], hidden_size=5120,
        num_hidden_layers=48, num_attention_heads=40, num_key_value_heads=8,
        intermediate_size=13824, vocab_size=152064,
        max_position_embeddings=32768, rope_theta=1000000.0,
        attention_bias=True,
    ),
    "Qwen/Qwen2.5-32B-Instruct": dict(
        architectures=["Qwen2ForCausalLM"], hidden_size=5120,
        num_hidden_layers=64, num_attention_heads=40, num_key_value_heads=8,
        intermediate_size=27648, vocab_size=152064,
        max_position_embeddings=32768, rope_theta=1000000.0,
        attention_bias=True,
    ),
    "Qwen/Qwen2.5-72B-Instruct": dict(
        architectures=["Qwen2ForCausalLM"], hidden_size=8192,
        num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
        intermediate_size=29568, vocab_size=152064,
        max_position_embeddings=32768, rope_theta=1000000.0,
        attention_bias=True,
    ),
    "Qwen/Qwen3-0.6B": dict(
        architectures=["Qwen3ForCausalLM"], hidden_size=1024,
        num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, intermediate_size=3072, vocab_size=151936,
        max_position_embeddings=40960, rope_theta=1000000.0,
        tie_word_embeddings=True,
    ),
    "Qwen/Qwen3-0.6B-FP8": dict(alias="Qwen/Qwen3-0.6B"),
    "Qwen/Qwen3-1.7B": dict(
        architectures=["Qwen3ForCausalLM"], hidden_size=2048,
        num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, intermediate_size=6144, vocab_size=151936,
        max_position_embeddings=40960, rope_theta=1000000.0,
        tie_word_embeddings=True,
    ),
    "Qwen/Qwen3-1.7B-FP8": dict(alias="Qwen/Qwen3-1.7B"),
    "Qwen/Qwen3-4B": dict(
        architectures=["Qwen3ForCausalLM"], hidden_size=2560,
        num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, intermediate_size=9728, vocab_size=151936,
        max_position_embeddings=40960, rope_theta=1000000.0,
        tie_word_embeddings=True,
    ),
    "Qwen/Qwen3-4B-FP8": dict(alias="Qwen/Qwen3-4B"),
    "Qwen/Qwen3-4B-Instruct-2507": dict(
        alias="Qwen/Qwen3-4B", max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-4B-Instruct-2507-FP8": dict(
        alias="Qwen/Qwen3-4B-Instruct-2507",
        max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-4B-Thinking-2507": dict(
        alias="Qwen/Qwen3-4B", max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-4B-Thinking-2507-FP8": dict(
        alias="Qwen/Qwen3-4B-Thinking-2507",
        max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-8B": dict(preset="qwen3-8b"),
    "Qwen/Qwen3-8B-FP8": dict(preset="qwen3-8b"),
    "Qwen/Qwen3-14B": dict(
        architectures=["Qwen3ForCausalLM"], hidden_size=5120,
        num_hidden_layers=40, num_attention_heads=40, num_key_value_heads=8,
        head_dim=128, intermediate_size=17408, vocab_size=151936,
        max_position_embeddings=40960, rope_theta=1000000.0,
    ),
    "Qwen/Qwen3-14B-FP8": dict(alias="Qwen/Qwen3-14B"),
    "Qwen/Qwen3-32B-FP8": dict(alias="Qwen/Qwen3-32B"),
    "Qwen/Qwen3-32B": dict(
        architectures=["Qwen3ForCausalLM"], hidden_size=5120,
        num_hidden_layers=64, num_attention_heads=64, num_key_value_heads=8,
        head_dim=128, intermediate_size=25600, vocab_size=151936,
        max_position_embeddings=40960, rope_theta=1000000.0,
    ),
    # Qwen MoE
    "Qwen/Qwen3-30B-A3B-Instruct-2507-FP8": dict(
        alias="Qwen/Qwen3-30B-A3B", max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-30B-A3B-Thinking-2507-FP8": dict(
        alias="Qwen/Qwen3-30B-A3B", max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-235B-A22B-Instruct-2507-FP8": dict(
        alias="Qwen/Qwen3-235B-A22B", max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-235B-A22B-Thinking-2507-FP8": dict(
        alias="Qwen/Qwen3-235B-A22B", max_position_embeddings=262144,
    ),
    "Qwen/Qwen3-235B-A22B-GPTQ-Int4": dict(alias="Qwen/Qwen3-235B-A22B"),
    "Qwen/Qwen3-30B-A3B": dict(
        architectures=["Qwen3MoeForCausalLM"], hidden_size=2048,
        num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
        head_dim=128, intermediate_size=6144, moe_intermediate_size=768,
        num_experts=128, num_experts_per_tok=8, vocab_size=151936,
        max_position_embeddings=40960, rope_theta=1000000.0,
    ),
    "Qwen/Qwen3-235B-A22B": dict(
        architectures=["Qwen3MoeForCausalLM"], hidden_size=4096,
        num_hidden_layers=94, num_attention_heads=64, num_key_value_heads=4,
        head_dim=128, intermediate_size=12288, moe_intermediate_size=1536,
        num_experts=128, num_experts_per_tok=8, vocab_size=151936,
        max_position_embeddings=40960, rope_theta=1000000.0,
    ),
    "Qwen/Qwen3-Next-80B-A3B-Instruct": dict(
        architectures=["Qwen3NextForCausalLM"], hidden_size=2048,
        num_hidden_layers=48, num_attention_heads=16, num_key_value_heads=2,
        head_dim=256, intermediate_size=5120, moe_intermediate_size=512,
        num_experts=512, num_experts_per_tok=10, shared_expert_intermediate_size=512,
        n_shared_experts=1, linear_conv_kernel_dim=4, linear_num_key_heads=16,
        linear_num_value_heads=32, linear_key_head_dim=128,
        linear_value_head_dim=128, vocab_size=151936,
        max_position_embeddings=262144, rope_theta=10000000.0,
    ),
    # Qwen3.5 / 3.6 (reference static_config.py lists them; public
    # configs are not yet released, so these resolve to the nearest
    # released family for the scheduler's capacity estimates only —
    # actually serving one reads the checkpoint's own config.json, and
    # an architecture this build does not implement fails loudly there).
    "Qwen/Qwen3.5-0.8B": dict(alias="Qwen/Qwen3-0.6B"),
    "Qwen/Qwen3.5-35B-A3B": dict(alias="Qwen/Qwen3-30B-A3B"),
    "Qwen/Qwen3.6-35B-A3B": dict(alias="Qwen/Qwen3-30B-A3B"),
    "Qwen/Qwen3.6-27B": dict(alias="Qwen/Qwen3-32B"),
    "Qwen/Qwen3-Next-80B-A3B-Instruct-FP8": dict(
        alias="Qwen/Qwen3-Next-80B-A3B-Instruct",
    ),
    "Qwen/Qwen3-Next-80B-A3B-Thinking": dict(
        alias="Qwen/Qwen3-Next-80B-A3B-Instruct",
    ),
    "Qwen/Qwen3-Next-80B-A3B-Thinking-FP8": dict(
        alias="Qwen/Qwen3-Next-80B-A3B-Instruct",
    ),
    # Llama
    "meta-llama/Meta-Llama-3-8B-Instruct": dict(preset="llama-3-8b"),
    "meta-llama/Llama-3.1-8B-Instruct": dict(
        architectures=["LlamaForCausalLM"], hidden_size=4096,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        intermediate_size=14336, vocab_size=128256,
        max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=dict(
            rope_type="llama3", factor=8.0, low_freq_factor=1.0,
            high_freq_factor=4.0, original_max_position_embeddings=8192,
        ),
    ),
    "nvidia/Llama-3.1-8B-Instruct-FP8": dict(
        alias="meta-llama/Llama-3.1-8B-Instruct",
    ),
    "meta-llama/Llama-3.1-70B-Instruct": dict(
        architectures=["LlamaForCausalLM"], hidden_size=8192,
        num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
        intermediate_size=28672, vocab_size=128256,
        max_position_embeddings=131072, rope_theta=500000.0,
        rope_scaling=dict(
            rope_type="llama3", factor=8.0, low_freq_factor=1.0,
            high_freq_factor=4.0, original_max_position_embeddings=8192,
        ),
    ),
    "nvidia/Llama-3.1-70B-Instruct-FP8": dict(
        alias="meta-llama/Llama-3.1-70B-Instruct",
    ),
    "nvidia/Llama-3.3-70B-Instruct-FP8": dict(
        alias="meta-llama/Llama-3.3-70B-Instruct",
    ),
    "meta-llama/Llama-3.3-70B-Instruct": dict(
        architectures=["LlamaForCausalLM"], hidden_size=8192,
        num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
        intermediate_size=28672, vocab_size=128256,
        max_position_embeddings=131072, rope_theta=500000.0,
    ),
    # DeepSeek / Kimi (MLA)
    "deepseek-ai/DeepSeek-V3": dict(
        architectures=["DeepseekV3ForCausalLM"], hidden_size=7168,
        num_hidden_layers=61, num_attention_heads=128,
        num_key_value_heads=128, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        intermediate_size=18432, moe_intermediate_size=2048,
        n_routed_experts=256, num_experts_per_tok=8, n_shared_experts=1,
        n_group=8, topk_group=4, scoring_func="sigmoid",
        first_k_dense_replace=3, routed_scaling_factor=2.5,
        vocab_size=129280, max_position_embeddings=163840,
        rope_interleave=True,
    ),
    "deepseek-ai/DeepSeek-V3.2-Exp": dict(
        architectures=["DeepseekV32ForCausalLM"], hidden_size=7168,
        num_hidden_layers=61, num_attention_heads=128,
        num_key_value_heads=128, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        index_n_heads=64, index_head_dim=128, index_topk=2048,
        intermediate_size=18432, moe_intermediate_size=2048,
        n_routed_experts=256, num_experts_per_tok=8, n_shared_experts=1,
        n_group=8, topk_group=4, scoring_func="sigmoid",
        first_k_dense_replace=3, routed_scaling_factor=2.5,
        vocab_size=129280, max_position_embeddings=163840,
        rope_interleave=True,
    ),
    "deepseek-ai/DeepSeek-V3.1": dict(alias="deepseek-ai/DeepSeek-V3"),
    "deepseek-ai/DeepSeek-R1": dict(alias="deepseek-ai/DeepSeek-V3"),
    "deepseek-ai/DeepSeek-V3.2": dict(
        alias="deepseek-ai/DeepSeek-V3.2-Exp",
    ),
    # https://huggingface.co/deepseek-ai/DeepSeek-V2.5-1210 config
    "deepseek-ai/DeepSeek-V2.5-1210": dict(
        architectures=["DeepseekV2ForCausalLM"], hidden_size=5120,
        num_hidden_layers=60, num_attention_heads=128,
        num_key_value_heads=128, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        intermediate_size=12288, moe_intermediate_size=1536,
        n_routed_experts=160, num_experts_per_tok=6, n_shared_experts=2,
        n_group=8, topk_group=3, scoring_func="softmax",
        first_k_dense_replace=1, routed_scaling_factor=16.0,
        vocab_size=102400, max_position_embeddings=163840,
        rope_interleave=True,
    ),
    "moonshotai/Kimi-K2-Instruct-0905": dict(
        alias="moonshotai/Kimi-K2-Instruct",
    ),
    "moonshotai/Kimi-K2-Thinking": dict(
        alias="moonshotai/Kimi-K2-Instruct",
    ),
    "moonshotai/Kimi-K2-Instruct": dict(
        architectures=["DeepseekV3ForCausalLM"], hidden_size=7168,
        num_hidden_layers=61, num_attention_heads=64,
        num_key_value_heads=64, kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        intermediate_size=18432, moe_intermediate_size=2048,
        n_routed_experts=384, num_experts_per_tok=8, n_shared_experts=1,
        n_group=1, topk_group=1, scoring_func="sigmoid",
        first_k_dense_replace=1, routed_scaling_factor=2.827,
        vocab_size=163840, max_position_embeddings=131072,
        rope_interleave=True,
    ),
    # gpt-oss (sinks + alternating windows)
    "openai/gpt-oss-20b": dict(
        architectures=["GptOssForCausalLM"], hidden_size=2880,
        num_hidden_layers=24, num_attention_heads=64, num_key_value_heads=8,
        head_dim=64, intermediate_size=2880, moe_intermediate_size=2880,
        num_local_experts=32, num_experts_per_tok=4, sliding_window=128,
        layer_types=["sliding_attention", "full_attention"] * 12,
        vocab_size=201088, max_position_embeddings=131072,
    ),
    "openai/gpt-oss-120b": dict(
        architectures=["GptOssForCausalLM"], hidden_size=2880,
        num_hidden_layers=36, num_attention_heads=64, num_key_value_heads=8,
        head_dim=64, intermediate_size=2880, moe_intermediate_size=2880,
        num_local_experts=128, num_experts_per_tok=4, sliding_window=128,
        layer_types=["sliding_attention", "full_attention"] * 18,
        vocab_size=201088, max_position_embeddings=131072,
    ),
    "openai/gpt-oss-safeguard-20b": dict(alias="openai/gpt-oss-20b"),
    "openai/gpt-oss-safeguard-120b": dict(alias="openai/gpt-oss-120b"),
    # GLM
    "zai-org/GLM-4.6": dict(
        # GLM-4.5/4.6 flagship MoE shapes (https://huggingface.co/zai-org/GLM-4.6)
        architectures=["Glm4MoeForCausalLM"], hidden_size=5120,
        num_hidden_layers=92, num_attention_heads=96, num_key_value_heads=8,
        head_dim=128, intermediate_size=12288, moe_intermediate_size=1536,
        n_routed_experts=160, num_experts_per_tok=8, n_shared_experts=1,
        n_group=1, topk_group=1, scoring_func="sigmoid", norm_topk_prob=True,
        first_k_dense_replace=3, routed_scaling_factor=2.5,
        partial_rotary_factor=0.5, use_qk_norm=True,
        vocab_size=151552, max_position_embeddings=202752,
    ),
    "zai-org/GLM-4.6-FP8": dict(alias="zai-org/GLM-4.6"),
    # Post-4.6 GLM releases the reference serves from the same family
    # (static_config.py maps them alongside 4.6); shapes tracked as 4.6
    # until their configs are public.
    "zai-org/GLM-4.7": dict(alias="zai-org/GLM-4.6"),
    "zai-org/GLM-4.7-Flash": dict(alias="zai-org/GLM-4.5-Air"),
    "zai-org/GLM-5.1": dict(alias="zai-org/GLM-4.6"),
    "zai-org/GLM-5.1-FP8": dict(alias="zai-org/GLM-4.6"),
    "zai-org/GLM-5.2": dict(alias="zai-org/GLM-4.6"),
    "zai-org/GLM-4-9B-0414": dict(
        architectures=["Glm4ForCausalLM"], hidden_size=4096,
        num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=2,
        intermediate_size=13696, partial_rotary_factor=0.5,
        vocab_size=151552, max_position_embeddings=32768,
        rope_theta=10000.0,
    ),
    "zai-org/GLM-4.5-Air": dict(
        architectures=["Glm4MoeForCausalLM"], hidden_size=4096,
        num_hidden_layers=46, num_attention_heads=96, num_key_value_heads=8,
        head_dim=128, intermediate_size=10944, moe_intermediate_size=1408,
        n_routed_experts=128, num_experts_per_tok=8, n_shared_experts=1,
        n_group=1, topk_group=1, scoring_func="sigmoid", norm_topk_prob=True,
        first_k_dense_replace=1, routed_scaling_factor=1.0,
        partial_rotary_factor=0.5, use_qk_norm=True,
        vocab_size=151552, max_position_embeddings=131072,
    ),
    # StepFun (attention groups + alternating windows; shapes estimated
    # from the Step-3 family until the Flash config is public — serving
    # always reads the checkpoint's own config.json)
    "stepfun-ai/Step-3.5-Flash": dict(
        architectures=["Step3p5ForCausalLM"], hidden_size=4096,
        num_hidden_layers=45, num_attention_heads=64,
        num_attention_groups=8, head_dim=128, intermediate_size=11264,
        moe_num_experts=128, moe_top_k=6, sliding_window=4096,
        layer_types=["full_attention", "sliding_attention"] * 22
        + ["full_attention"],
        vocab_size=128896, max_position_embeddings=65536,
    ),
    # MiniMax
    "MiniMaxAI/MiniMax-M2.1": dict(alias="MiniMaxAI/MiniMax-M2"),
    "MiniMaxAI/MiniMax-M2.7": dict(alias="MiniMaxAI/MiniMax-M2"),
    # M3 adds block-sparse attention (MSA) on top of the M2 trunk; the
    # sparse geometry below mirrors our ops/msa.py serving path.
    "MiniMaxAI/MiniMax-M3": dict(
        architectures=["MiniMaxM3SparseForCausalLM"],
        model_type="minimax_m3", hidden_size=3072,
        num_hidden_layers=62, num_attention_heads=48,
        num_key_value_heads=8, head_dim=128,
        intermediate_size=1536, dense_intermediate_size=8192,
        shared_intermediate_size=1536, num_local_experts=256,
        num_experts_per_tok=8, n_shared_experts=1,
        scoring_func="sigmoid", use_routing_bias=True,
        routed_scaling_factor=2.0, use_qk_norm=True, use_gemma_norm=True,
        partial_rotary_factor=0.5, rope_theta=5000000,
        mlp_layer_types=["dense"] + ["sparse"] * 61,
        layer_types=["full_attention"] + ["minimax_m3_sparse"] * 61,
        index_n_heads=16, index_head_dim=64, index_block_size=64,
        index_topk_blocks=32, index_local_blocks=4,
        swiglu_alpha=1.702, swiglu_limit=7.0, swiglu_beta=1.0,
        vocab_size=200064, max_position_embeddings=196608,
    ),
    "MiniMaxAI/MiniMax-M2": dict(
        architectures=["MiniMaxM2ForCausalLM"], hidden_size=3072,
        num_hidden_layers=62, num_attention_heads=48, num_key_value_heads=8,
        head_dim=128, intermediate_size=1536, num_local_experts=256,
        num_experts_per_tok=8, scoring_func="sigmoid",
        use_qk_norm=True, rotary_dim=64, partial_rotary_factor=0.5,
        vocab_size=200064, max_position_embeddings=196608,
    ),
}


def get_preset(name: str) -> ModelConfig:
    key = name.lower()
    if key in PRESETS:
        return normalize_config(dict(PRESETS[key]), model_name=key)
    # HF repo names resolve through the curated DB (case-sensitive first,
    # then case-insensitive).
    entry = MODEL_DB.get(name)
    if entry is None:
        lowered = {k.lower(): v for k, v in MODEL_DB.items()}
        entry = lowered.get(key)
    if entry is not None:
        entry = dict(entry)
        alias = entry.pop("preset", None)
        if alias:
            return normalize_config(dict(PRESETS[alias]), model_name=name)
        # Size-variant / re-release of another DB model (reference maps
        # these to the same checkpoint family). Aliases may chain; later
        # overrides win over earlier bases.
        other = entry.pop("alias", None)
        while other:
            base = dict(MODEL_DB[other])
            preset = base.pop("preset", None)
            if preset:
                # The alias target is itself preset-backed: expand it so
                # the base actually carries a full architecture config.
                base = {**PRESETS[preset], **base}
            other = base.pop("alias", None)
            base.update(entry)
            entry = base
        return normalize_config(entry, model_name=name)
    raise KeyError(
        f"unknown preset {name!r}; have {sorted(PRESETS)} + "
        f"{len(MODEL_DB)} DB models"
    )
