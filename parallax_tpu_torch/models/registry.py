"""Architecture registry and weight carry-over (port of
``parallax_tpu/models/registry.py``).

Only the dense llama-family architectures are ported; they share one block
(config flags drive qk-norm / bias / sliding-window differences). Anything
else raises "not ported yet".
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.config import ModelConfig
from parallax_tpu_torch.models.base import StageModel

DENSE_ARCHITECTURES = (
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "Qwen2ForCausalLM",
    "Qwen3ForCausalLM",
)


def unported_features(config: ModelConfig) -> list[str]:
    """Model features of ``config`` that the port does not run yet."""
    feats = []
    if config.architecture not in DENSE_ARCHITECTURES:
        feats.append(f"architecture {config.architecture}")
    for name, on in (
        ("MoE", config.moe is not None),
        ("MLA", config.mla is not None),
        ("DSA", config.dsa is not None),
        ("MSA", config.msa is not None),
        ("hybrid linear attention", config.linear_attn is not None),
        ("attention sinks", config.use_attention_sinks),
    ):
        if on:
            feats.append(name)
    return feats


def create_stage_model(config: ModelConfig, start_layer: int,
                       end_layer: int) -> StageModel:
    feats = unported_features(config)
    if feats:
        raise NotImplementedError(
            f"{', '.join(feats)}: not ported yet to parallax_tpu_torch "
            f"(dense {', '.join(DENSE_ARCHITECTURES)} only)"
        )
    return StageModel(config, start_layer, end_layer)


def _leaf_to_torch(arr, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16 (ml_dtypes' is opaque to torch): carry
        # the bits across through a 16-bit integer view.
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16
        )
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(tree, device="cpu", dtype: torch.dtype | None = None):
    """The JAX package's param tree, given as nested dicts/lists of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, params)``), as the port's tree
    of tensors on ``device``. Keys are unchanged; ``dtype`` casts every
    leaf (None keeps each leaf's own type)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    return _leaf_to_torch(tree, device, dtype)


def params_to(tree, device):
    """Move a param tree to ``device`` (tensors already there are kept, so
    stages can share one set of weights)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to(v, device) for v in tree]
    return tree.to(device)
