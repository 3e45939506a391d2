"""Architecture registry and weight carry-over (port of
``parallax_tpu/models/registry.py``).

HF ``architectures[0]`` name -> StageModel class. The dense llama-family
architectures share the base block (config flags drive qk-norm / bias /
sliding-window differences; a ``sinks`` leaf in a layer's attention params
joins its softmax); model families register their class with
:func:`register_model` (``models/qwen3_moe.py``, ``models/deepseek_v3.py``,
``models/deepseek_v32.py``, ``models/gpt_oss.py``, ``models/glm4.py``,
``models/step3p5.py``, ``models/qwen3_next.py``, ...). Anything else, and
any feature a registered class does not run (its ``runs_moe`` /
``runs_mla`` / ``runs_dsa`` / ``runs_msa`` / ``runs_linear`` flags), raises
"not ported yet".
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.config import ModelConfig
from parallax_tpu_torch.models.base import StageModel

MODEL_REGISTRY: dict[str, type[StageModel]] = {}


def register_model(*architectures: str):
    def deco(cls: type[StageModel]):
        for a in architectures:
            MODEL_REGISTRY[a] = cls
        return cls
    return deco


for _arch in (
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "Qwen2ForCausalLM",
    "Qwen3ForCausalLM",
):
    MODEL_REGISTRY[_arch] = StageModel


def unported_features(config: ModelConfig,
                      cls: type[StageModel] | None = None) -> list[str]:
    """Model features of ``config`` that the port does not run yet, or,
    given a model class ``cls``, that ``cls`` does not run (default: the
    class registered for the config's architecture)."""
    feats = []
    if config.architecture not in MODEL_REGISTRY:
        feats.append(f"architecture {config.architecture}")
    cls = cls or MODEL_REGISTRY.get(config.architecture)
    for name, on in (
        ("MoE", config.moe is not None and not (cls and cls.runs_moe)),
        ("MLA", config.mla is not None and not (cls and cls.runs_mla)),
        ("DSA", config.dsa is not None and not (cls and cls.runs_dsa)),
        ("MSA", config.msa is not None and not (cls and cls.runs_msa)),
        ("hybrid linear attention",
         config.linear_attn is not None and not (cls and cls.runs_linear)),
    ):
        if on:
            feats.append(name)
    return feats


def create_stage_model(config: ModelConfig, start_layer: int,
                       end_layer: int, **kw) -> StageModel:
    feats = unported_features(config)
    if feats:
        raise NotImplementedError(
            f"{', '.join(feats)}: not ported yet to parallax_tpu_torch "
            f"(have {', '.join(sorted(MODEL_REGISTRY))})"
        )
    return MODEL_REGISTRY[config.architecture](config, start_layer,
                                               end_layer, **kw)


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
    # Integer leaves (a quantized tree's u8 ``qweight``) keep their type.
    cast = dtype is not None and t.is_floating_point()
    return t.to(device=device, dtype=dtype if cast else t.dtype)


def params_from_numpy(tree, device="cpu", dtype: torch.dtype | None = None):
    """The JAX package's param tree, given as nested dicts/lists of numpy
    arrays (e.g. ``jax.tree.map(np.asarray, params)``), as the port's tree
    of tensors on ``device``. Keys and layouts are unchanged, stacked MoE
    experts included (``[E, I, H]`` gate/up, ``[E, H, I]`` down), so one
    weight tree serves both packages; ``dtype`` casts every float leaf (None
    keeps each leaf's own type; integer leaves, such as a quantized tree's
    ``qweight``, always keep theirs) except attention sinks, which stay float32
    whatever the tree holds: the kernels take them as f32[Hq]."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(
                    v, device, torch.float32 if k == "sinks" else dtype)
                for k, v in tree.items()}
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
