"""Offline LoRA adapter fusion: checkpoint + PEFT adapter -> merged
checkpoint directory (port of ``parallax_tpu/utils/adapter.py``).

The checkpoint is processed shard by shard (host memory holds one shard
and the adapter; the multi-file layout is kept), ``W' = W + (alpha / r) *
B @ A`` is merged in float32 (a DoRA adapter then renormalizes rows to its
learned ``lora_magnitude_vector``), and the config, index and tokenizer
files the serving loader needs are copied. Files are read through
``models/loader.py::SafetensorsFile`` and written through
``utils/st_writer.py``: no ``safetensors`` package is needed. Serving can
also merge at load time (``load_stage_params(lora_path=)``) or apply an
adapter per request (``ops/lora.py``).
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)

_SIDE_FILES = (
    "config.json", "generation_config.json", "tokenizer.json",
    "tokenizer_config.json", "special_tokens_map.json", "vocab.json",
    "merges.txt", "tokenizer.model", "model.safetensors.index.json",
)
_ADAPTER_FILES = ("adapter_model.safetensors", "adapter.safetensors")


def adapter_scale(acfg: dict, module: str, rank: int) -> float:
    """``alpha / r`` of one module (``alpha / sqrt(r)`` under rsLoRA), with
    PEFT's ``alpha_pattern`` overrides matched on the module name; the rank
    is the module's own ``lora_A`` rows, so ``rank_pattern`` adapters
    scale right."""
    alpha = float(acfg.get("lora_alpha", acfg.get("r", 8)))
    for pat, a in (acfg.get("alpha_pattern") or {}).items():
        if module.endswith(pat) or pat in module:
            alpha = float(a)
            break
    return alpha / (rank ** 0.5 if acfg.get("use_rslora") else rank)


def _adapter_file(adapter_path: str) -> str:
    for name in _ADAPTER_FILES:
        p = os.path.join(adapter_path, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no adapter safetensors in {adapter_path}")


def adapter_entries(adapter_path: str):
    """``(acfg, file, [(key, module, part)])`` of a PEFT directory:
    ``part`` is ``A``, ``B`` or ``M`` (a DoRA magnitude) and ``module`` the
    key without its ``base_model.model.`` prefix and ``lora_*`` suffix."""
    from parallax_tpu_torch.models.loader import SafetensorsFile

    with open(os.path.join(adapter_path, "adapter_config.json"),
              encoding="utf-8") as f:
        acfg = json.load(f)
    st = SafetensorsFile(_adapter_file(adapter_path))
    entries = []
    for key in st.keys():
        k = key
        for prefix in ("base_model.model.", "base_model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        if ".lora_magnitude_vector" in k:
            entries.append((key, k.split(".lora_magnitude_vector")[0], "M"))
        elif ".lora_A." in k:
            entries.append((key, k.split(".lora_A.")[0], "A"))
        elif ".lora_B." in k:
            entries.append((key, k.split(".lora_B.")[0], "B"))
    return acfg, st, entries


def _load_adapter(adapter_path: str) -> tuple[dict, dict]:
    """(module -> {A, B[, M]} host f32 tensors, scales keyed by module)."""
    acfg, st, entries = adapter_entries(adapter_path)
    pairs: dict[str, dict[str, torch.Tensor]] = {}
    for key, mod, part in entries:
        pairs.setdefault(mod, {})[part] = st.get_tensor(key).float()
    scales = {}
    for mod, ab in pairs.items():
        if "A" not in ab or "B" not in ab:
            raise ValueError(f"adapter incomplete for {mod}")
        scales[mod] = adapter_scale(acfg, mod, ab["A"].shape[0])
    return pairs, scales


def apply_dora_magnitude(module: str, v: torch.Tensor,
                         ab: dict) -> torch.Tensor:
    """DoRA's closing step: renormalize the updated weight's rows to the
    learned magnitudes. ``v = W + scale * B @ A`` (f32 ``[out, in]``);
    plain LoRA modules (no magnitude) pass through unchanged."""
    if "M" not in ab:
        return v
    m = ab["M"].to(v.device, torch.float32).reshape(-1)   # [out]
    if m.shape[0] != v.shape[0]:
        raise ValueError(
            f"DoRA magnitude length {m.shape[0]} does not match output "
            f"dim {v.shape[0]} for {module}"
        )
    norm = torch.linalg.vector_norm(v, dim=1)              # per output row
    return (m / torch.clamp_min(norm, 1e-12))[:, None] * v


def merge_adapter(model_path: str, adapter_path: str, out_dir: str) -> int:
    """Write ``out_dir`` = ``model_path`` with the LoRA deltas merged.

    Returns the number of merged modules; raises if any adapter module
    has no matching base weight (a silent partial merge would serve a
    wrong model)."""
    from parallax_tpu_torch.models.loader import SafetensorsFile
    from parallax_tpu_torch.utils.st_writer import write_safetensors

    pairs, scales = _load_adapter(adapter_path)
    os.makedirs(out_dir, exist_ok=True)
    unmatched = set(pairs)

    files = sorted(
        f for f in os.listdir(model_path) if f.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(f"no safetensors under {model_path}")
    # Every adapter module must have a base weight BEFORE any output is
    # written (keys only), so a bad adapter leaves no half-written
    # checkpoint behind.
    base_mods = set()
    for name in files:
        for key in SafetensorsFile(os.path.join(model_path, name)).keys():
            if key.endswith(".weight"):
                mod = key[: -len(".weight")]
                base_mods.update((mod, f"model.{mod}",
                                  mod.removeprefix("model.")))
    missing = unmatched - base_mods
    if missing:
        raise ValueError(
            f"adapter modules with no base weight: {sorted(missing)[:5]}"
        )
    # Shard by shard: one input file's tensors in memory at a time, each
    # written to the same-named output file (the index, copied as a side
    # file, keeps pointing at the right shards).
    for name in files:
        st = SafetensorsFile(os.path.join(model_path, name))
        shard: dict[str, torch.Tensor] = {}
        for key in st.keys():
            arr = st.get_tensor(key)
            mod = key[: -len(".weight")] if key.endswith(".weight") else None
            # Checkpoints may or may not carry the "model." prefix the
            # PEFT keys use; match either.
            cand = None
            if mod is not None:
                for m in (mod, f"model.{mod}", mod.removeprefix("model.")):
                    if m in pairs:
                        cand = m
                        break
            if cand is not None:
                ab = pairs[cand]
                delta = (ab["B"] @ ab["A"]) * scales[cand]
                if tuple(delta.shape) != tuple(arr.shape):
                    raise ValueError(
                        f"{cand}: adapter delta {tuple(delta.shape)} does "
                        f"not match base weight {tuple(arr.shape)}"
                    )
                merged = apply_dora_magnitude(cand, arr.float() + delta, ab)
                arr = merged.to(arr.dtype)
                unmatched.discard(cand)
            shard[key] = arr
        write_safetensors(os.path.join(out_dir, name), shard,
                          metadata=st.metadata or None)
        del st
    if unmatched:
        raise ValueError(
            f"adapter modules with no base weight: {sorted(unmatched)[:5]}"
        )
    for name in _SIDE_FILES:
        src = os.path.join(model_path, name)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, name))
    logger.info(
        "merged %d adapter modules from %s into %s",
        len(pairs), adapter_path, out_dir,
    )
    return len(pairs)
