"""Shard-selective safetensors weight loading (port of
``parallax_tpu/models/loader.py``).

Selects only the files and keys holding the stage's layers, remaps global
layer indices to stage-local ones, handles tied embeddings, and builds the
stage param tree as tensors on the target device, in the HF ``[out, in]``
layout the models read. Safetensors files are read by this module itself
(the ``safetensors`` package is not needed): each file is memory-mapped and
every tensor goes straight to the device, one at a time, so the host never
holds the whole stage.

Quantized checkpoints load as the JAX loader loads them (``ops/quant.py``):
MLX packed ``uint32`` weights with ``.scales`` / ``.biases`` (bits from the
config's ``quantization`` dict, per-module overrides honoured) and GPTQ
quartets stay quantized at rest; HF FP8 block weights (``weight_scale_inv``)
and MXFP4 ``_blocks`` / ``_scales`` dequantize on load, on the target
device. ``quantize="int8" | "int4"`` quantizes a float checkpoint after
``finalize_params`` (group 64). ``lora_path=`` merges a PEFT adapter
(DoRA too) into the float tree before ``finalize_params`` and before
``quantize=``; a target that is already quantized is refused.
"""

from __future__ import annotations

import json
import mmap
import os
import re

import torch

from parallax_tpu_torch.models.base import StageModel
from parallax_tpu_torch.ops.quant import (
    convert_gptq_weight,
    dequant_fp8_block,
    dequant_mxfp4,
    quantize_tree,
    unpack_uint32,
)
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.utils.hw import resolve_device

logger = get_logger(__name__)

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

# Safetensors dtype names the loader takes.
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "U8": torch.uint8,
    "I32": torch.int32,
    "U32": torch.uint32,
}
_QUANT_METHODS = ("fp8", "gptq", "mxfp4")
_FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
_GPTQ_SUFFIXES = (".qweight", ".qzeros", ".scales", ".g_idx")
_ON_LOAD_BITS = {"int8": 8, "int4": 4}


class SafetensorsFile:
    """One ``.safetensors`` file: an 8-byte little-endian header length, a
    JSON header (per tensor ``dtype``, ``shape`` and ``data_offsets``
    relative to the end of the header; an optional ``__metadata__`` of
    strings) and the raw bytes. The file is memory-mapped copy-on-write;
    :meth:`get_tensor` returns a CPU tensor viewing the mapping, or a copy
    where the data is not aligned to its element size."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: not a safetensors file")
            n = int.from_bytes(f.read(8), "little")
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} past the file end")
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._set_header(header, n, size)

    @classmethod
    def from_bytes(cls, data: bytes,
                   name: str = "<bytes>") -> "SafetensorsFile":
        """The same reader over safetensors bytes in memory. ``bytes``
        are copied into a writable buffer, so the tensors it returns own
        no read-only one; a ``bytearray`` is read in place (the tensors
        view it)."""
        self = cls.__new__(cls)
        self.path = name
        size = len(data)
        if size < 8:
            raise ValueError(f"{name}: not safetensors bytes")
        n = int.from_bytes(data[:8], "little")
        if n > size - 8:
            raise ValueError(f"{name}: header length {n} past the end")
        self._map = data if isinstance(data, bytearray) else bytearray(data)
        self._set_header(json.loads(bytes(data[8:8 + n])), n, size)
        return self

    def _set_header(self, header: dict, n: int, size: int) -> None:
        self.metadata: dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries: dict[str, dict] = header
        self._data_start = 8 + n
        self._size = size

    def keys(self) -> list[str]:
        return list(self._entries)

    def get_tensor(self, key: str) -> torch.Tensor:
        entry = self._entries[key]
        name = entry["dtype"]
        dtype = SAFETENSORS_DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"{self.path}: {key} has dtype {name}, which "
                             f"the loader does not take (have "
                             f"{', '.join(SAFETENSORS_DTYPES)})")
        shape = [int(d) for d in entry["shape"]]
        begin, end = (int(x) for x in entry["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for d in shape:
            numel *= d
        if end - begin != numel * itemsize or begin < 0 or (
                self._data_start + end > self._size):
            raise ValueError(f"{self.path}: {key}: data_offsets {begin}, "
                             f"{end} do not fit {name}{shape}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        offset = self._data_start + begin
        raw = torch.frombuffer(self._map, dtype=torch.uint8,
                               count=end - begin, offset=offset)
        if offset % itemsize:
            raw = raw.clone()
        return raw.view(dtype).reshape(shape)


def _weight_files(model_path: str, key_needed=None) -> list[str]:
    """Weight files to read. A selectively-downloaded stage dir
    legitimately lacks other stages' shard files, so missing indexed
    files are tolerated ONLY when (per the index's weight_map) they hold
    no key ``key_needed`` accepts — an incomplete copy of a needed shard
    still fails fast with the file names."""
    index = os.path.join(model_path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index, encoding="utf-8") as f:
            weight_map = json.load(f)["weight_map"]
        files = sorted(set(weight_map.values()))
        present = [f for f in files
                   if os.path.exists(os.path.join(model_path, f))]
        missing = set(files) - set(present)
        if missing and key_needed is not None:
            needed_missing = sorted({
                fname for key, fname in weight_map.items()
                if fname in missing and key_needed(key)
            })
            if needed_missing:
                raise FileNotFoundError(
                    f"{model_path}: shard files holding this stage's "
                    f"weights are missing: {needed_missing}"
                )
        if not present:
            raise FileNotFoundError(
                f"index lists {len(files)} shard files but none exist "
                f"under {model_path}"
            )
        if missing:
            logger.info(
                "%s: %d/%d indexed shard files present (selective "
                "download)", model_path, len(present), len(files),
            )
        return [os.path.join(model_path, f) for f in present]
    single = os.path.join(model_path, "model.safetensors")
    if os.path.exists(single):
        return [single]
    raise FileNotFoundError(f"no safetensors weights under {model_path}")


def shard_key_filter(
    key: str, start_layer: int, end_layer: int, num_layers: int
) -> str | None:
    """Map a global HF weight key to a stage-local param path, or None if the
    key belongs to another stage."""
    m = _LAYER_RE.match(key)
    if m:
        gi = int(m.group(1))
        if start_layer <= gi < end_layer:
            return f"layers.{gi - start_layer}.{m.group(2)}"
        return None
    if key.startswith("model.embed_tokens."):
        # embed needed on first stage; also on last for tied lm_head.
        return "embed_tokens." + key.split(".", 2)[2]
    if key.startswith("model.norm."):
        return "norm." + key.split(".", 2)[2] if end_layer == num_layers else None
    if key.startswith("lm_head."):
        return key if end_layer == num_layers else None
    return None


def _assign(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for i, part in enumerate(parts[:-1]):
        if part == "layers" and i == 0:
            node = node.setdefault("layers", {})
        else:
            node = node.setdefault(part, {})
    node[parts[-1]] = value


def _leaf(t: torch.Tensor, local: str, dtype, device) -> torch.Tensor:
    """A checkpoint tensor as a param leaf on ``device``: cast to ``dtype``
    (attention sinks then to float32, the kernels' f32[Hq], as
    ``registry.params_from_numpy`` carries them), always a copy, so no leaf
    views a file's mapping."""
    out = t.to(device=device, dtype=dtype, copy=True)
    if local.rsplit(".", 1)[-1] == "sinks":
        out = out.float()
    return out


def _quant_settings_for(
    raw_cfg: dict, local_path: str, start_layer: int
) -> tuple[int, int] | None:
    """(bits, group_size) for an MLX weight, honouring per-module
    overrides: the checkpoint's ``quantization`` dict holds the defaults
    plus override dicts keyed by the global (``model.``-prefixed or bare)
    module path; an override of ``False`` keeps that module in float."""
    qcfg = raw_cfg.get("quantization") or raw_cfg.get("quantization_config")
    if not isinstance(qcfg, dict) or "bits" not in qcfg:
        return None
    module = local_path.rsplit(".", 1)[0]
    candidates = [module, f"model.{module}"]
    if module.startswith("layers."):
        parts = module.split(".")
        if len(parts) > 2 and parts[1].isdigit():
            gi = int(parts[1]) + start_layer
            candidates.append(
                "model.layers." + str(gi) + "." + ".".join(parts[2:])
            )
    for key in candidates:
        override = qcfg.get(key)
        if override is False:
            return None
        if isinstance(override, dict):
            return (
                int(override.get("bits", qcfg["bits"])),
                int(override.get("group_size", qcfg.get("group_size", 64))),
            )
    return int(qcfg["bits"]), int(qcfg.get("group_size", 64))


def load_stage_params(
    model: StageModel, model_path: str, dtype=torch.bfloat16,
    quantize: str | None = None,
    lora_path: str | None = None,
    device=None,
) -> dict:
    """Load this stage's weights from a local HF checkpoint directory onto
    ``device`` (None = ``cuda:0``). Quantized checkpoints and ``quantize=``
    as the module docstring says."""
    if quantize and quantize not in _ON_LOAD_BITS:
        raise ValueError(f"quantize={quantize!r}: want one of "
                         f"{', '.join(_ON_LOAD_BITS)}")
    device = resolve_device(device)
    cfg = model.config
    raw_cfg = {}
    cfg_path = os.path.join(model_path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            raw_cfg = json.load(f)
    qc = raw_cfg.get("quantization_config") or {}
    quant_method = qc.get("quant_method")
    if quant_method is not None and quant_method not in _QUANT_METHODS:
        # An unknown packed format (awq, compressed-tensors, ...) would
        # stream raw int tensors into float param slots and serve
        # garbage; refuse loudly instead.
        raise ValueError(
            f"quantization_config.quant_method {quant_method!r} is not "
            "supported (have: fp8, gptq, mxfp4, MLX-format, or on-load "
            "--quantization int8/int4); dequantize the checkpoint "
            "offline to serve it"
        )
    fp8_block = tuple(qc.get("weight_block_size") or (128, 128))
    gptq_mode = quant_method == "gptq"
    gptq_bits = int(qc.get("bits") or 4)
    mxfp4_mode = quant_method == "mxfp4"
    # v1 storage biases zeros by +1; gptq_v2 (GPTQModel) does not.
    gptq_zero_offset = 0 if qc.get("checkpoint_format") == "gptq_v2" else 1

    tree: dict = {}
    want_embed = model.is_first or (model.is_last and cfg.tie_word_embeddings)
    n_loaded = 0
    n_quant = 0

    def _resolve(key: str) -> str | None:
        """THE stage-ownership filter (shared by file selection and the
        tensor loop): global checkpoint key -> local param path, or None
        when another stage owns it."""
        local = shard_key_filter(
            key, model.start_layer, model.end_layer, cfg.num_hidden_layers
        )
        if local is None or (
            local.split(".")[0] == "embed_tokens" and not want_embed
        ):
            return None
        return local

    def _put(local: str, t: torch.Tensor) -> None:
        _assign(tree, local, _leaf(t, local, dtype, device))

    # The parts of a quantized tensor wait (as views of their file) until
    # every part has been seen; everything else goes straight to the
    # device, one tensor at a time.
    pending: dict[str, torch.Tensor] = {}       # MLX words / scales / biases
    fp8_weights: dict[str, torch.Tensor] = {}
    fp8_scales: dict[str, torch.Tensor] = {}
    gptq_parts: dict[str, dict[str, torch.Tensor]] = {}
    mx_blocks: dict[str, torch.Tensor] = {}
    mx_scales: dict[str, torch.Tensor] = {}

    def _fp8_emit(local: str, w: torch.Tensor, scale: torch.Tensor) -> None:
        _put(local, dequant_fp8_block(w.to(device), scale.to(device),
                                      fp8_block))

    def _mx_emit(base: str, blocks: torch.Tensor,
                 scales: torch.Tensor) -> None:
        w = dequant_mxfp4(blocks.to(device), scales.to(device))
        if w.dim() == 3:
            # Expert tensors dequantize to [E, out, in]; the serving layout
            # (and the bf16 checkpoints) use [E, in, out].
            w = w.transpose(1, 2)
        _assign(tree, base, w.to(dtype).contiguous())

    weight_files = _weight_files(
        model_path, key_needed=lambda key: _resolve(key) is not None
    )
    for path in weight_files:
        st = SafetensorsFile(path)
        for key in st.keys():
            local = _resolve(key)
            if local is None:
                continue
            t = st.get_tensor(key)
            if gptq_mode and local.endswith(_GPTQ_SUFFIXES):
                base, _, part = local.rpartition(".")
                gptq_parts.setdefault(base, {})[part] = t
                continue
            if mxfp4_mode and local.endswith(("_blocks", "_scales")):
                is_blocks = local.endswith("_blocks")
                base = local[: -len("_blocks")]
                other = (mx_scales if is_blocks else mx_blocks).pop(base,
                                                                    None)
                if other is not None:
                    _mx_emit(base, *((t, other) if is_blocks
                                     else (other, t)))
                    n_loaded += 1
                else:
                    (mx_blocks if is_blocks else mx_scales)[base] = t
                continue
            if local.endswith(".weight_scale_inv"):
                base = local[: -len("_scale_inv")]
                w = fp8_weights.pop(base, None)
                if w is not None:
                    _fp8_emit(base, w, t)
                    n_loaded += 1
                else:
                    fp8_scales[base] = t
                continue
            if t.dtype in _FP8_DTYPES:
                if quant_method != "fp8":
                    raise ValueError(
                        f"{path}: {key} is {t.dtype} but the config's "
                        "quantization_config.quant_method is not 'fp8' "
                        "(no block scales to apply)")
                scale = fp8_scales.pop(local, None)
                if scale is not None:
                    _fp8_emit(local, t, scale)
                    n_loaded += 1
                else:
                    fp8_weights[local] = t
                continue
            if local.endswith((".scales", ".biases")) or (
                local.endswith(".weight") and t.dtype == torch.uint32
            ):
                pending[local] = t
                continue
            _put(local, t)
            n_loaded += 1
        del st

    if fp8_weights:
        raise ValueError(
            f"fp8 weights with no .weight_scale_inv sibling: "
            f"{sorted(fp8_weights)[:5]}"
        )
    if fp8_scales:
        raise ValueError(
            f"orphan fp8 scales without weights: {sorted(fp8_scales)[:5]}"
        )
    if mx_blocks or mx_scales:
        raise ValueError(
            f"unpaired mxfp4 tensors: "
            f"{sorted([*mx_blocks, *mx_scales])[:5]}"
        )

    for base, parts in gptq_parts.items():
        missing = {"qweight", "qzeros", "scales"} - set(parts)
        if missing:
            raise ValueError(
                f"incomplete GPTQ tensors for {base!r}: missing "
                f"{sorted(missing)}"
            )
        out = convert_gptq_weight(
            parts["qweight"], parts["qzeros"], parts["scales"],
            parts.get("g_idx"), gptq_bits, zero_offset=gptq_zero_offset,
        )
        if "weight" in out:
            # Activation-ordered (desc_act) groups: stored float.
            _put(base + ".weight", out["weight"])
        else:
            _assign(tree, base + ".qweight", out["qweight"].to(device))
            _put(base + ".scales", out["scales"])
            _put(base + ".biases", out["biases"])
            n_quant += 1
        n_loaded += 1

    for local in [k for k in pending if k.endswith(".weight")]:
        base = local[: -len(".weight")]
        words = pending.pop(local)
        scales = pending.pop(base + ".scales", None)
        if scales is None:
            raise ValueError(
                f"packed uint32 weight {base!r} has no .scales sibling"
            )
        qs = _quant_settings_for(raw_cfg, local, model.start_layer)
        if qs is None:
            raise ValueError(
                f"quantized weight {base!r} but the checkpoint config has "
                "no usable 'quantization' dict (bits/group_size unknown)"
            )
        _assign(tree, base + ".qweight",
                unpack_uint32(words.view(torch.int32).to(device), qs[0]))
        _put(base + ".scales", scales)
        biases = pending.pop(base + ".biases", None)
        if biases is not None:
            _put(base + ".biases", biases)
        n_quant += 1
        n_loaded += 1
    if pending:
        raise ValueError(
            f"orphan quantization tensors without a weight: "
            f"{sorted(pending)[:5]}"
        )

    # layers dict {local_idx_str: {...}} -> ordered list
    layer_map = tree.get("layers", {})
    tree["layers"] = [
        layer_map[str(i)] for i in range(model.num_local_layers)
    ]
    logger.info(
        "loaded %d tensors (%d quantized) for layers [%d, %d) from %s",
        n_loaded, n_quant, model.start_layer, model.end_layer, model_path,
    )
    if lora_path:
        # Pre-finalize: fused / per-expert HF module names still exist here.
        apply_lora_adapter(model, tree, lora_path, dtype)
    tree = model.finalize_params(tree)
    if quantize:
        quantize_tree(tree, bits=_ON_LOAD_BITS[quantize], group_size=64,
                      dtype=dtype)
        logger.info("quantized stage params on load (%s)", quantize)
    return tree


def params_from_torch_state_dict(
    model: StageModel, state_dict, dtype=torch.bfloat16, device=None,
) -> dict:
    """Build stage params from an in-memory torch state dict (tests compare
    against HF transformers reference models)."""
    device = resolve_device(device)
    cfg = model.config
    tree: dict = {}
    want_embed = model.is_first or (model.is_last and cfg.tie_word_embeddings)
    for key, tensor in state_dict.items():
        local = shard_key_filter(
            key, model.start_layer, model.end_layer, cfg.num_hidden_layers
        )
        if local is None:
            continue
        if local.startswith("embed_tokens") and not want_embed:
            continue
        # Through float32, as the JAX package's numpy route goes.
        _assign(tree, local,
                _leaf(tensor.detach().to("cpu").float(), local, dtype, device))
    layer_map = tree.get("layers", {})
    tree["layers"] = [layer_map[str(i)] for i in range(model.num_local_layers)]
    return model.finalize_params(tree)


def apply_lora_adapter(
    model: StageModel, params: dict, adapter_path: str,
    dtype=torch.bfloat16,
) -> int:
    """Merge a PEFT-format LoRA adapter into this stage's weights, in
    place: ``W' = W + (alpha / r) * B @ A`` in float32 on the weight's
    device, rounded once to ``dtype``; a DoRA adapter then renormalizes
    rows to its ``lora_magnitude_vector`` (``utils/adapter.py``). Returns
    the number of merged modules.

    Call on the PRE-finalize tree (``load_stage_params(lora_path=...)``
    does) so adapters targeting fused (``gate_up_proj``) or per-expert
    modules still find their weights. A target already quantized raises.
    Incomplete pairs and targets outside the stage's params are skipped
    with a warning, as in the JAX loader."""
    from parallax_tpu_torch.utils.adapter import (
        adapter_entries,
        adapter_scale,
        apply_dora_magnitude,
    )

    acfg, st, entries = adapter_entries(adapter_path)
    cfg = model.config
    pairs: dict[str, dict[str, torch.Tensor]] = {}
    for key, mod, part in entries:
        local = shard_key_filter(mod + ".weight", model.start_layer,
                                 model.end_layer, cfg.num_hidden_layers)
        if local is None:
            continue
        pairs.setdefault(local[: -len(".weight")], {})[part] = (
            st.get_tensor(key).float())

    merged = 0
    for module, ab in pairs.items():
        if "A" not in ab or "B" not in ab:
            logger.warning("lora adapter incomplete for %s; skipped", module)
            continue
        node = params
        try:
            for part in module.split("."):
                node = node[int(part)] if part.isdigit() else node[part]
        except (KeyError, IndexError, TypeError):
            logger.warning("lora target %s not in stage params; skipped",
                           module)
            continue
        if "weight" not in node:
            raise ValueError(
                f"cannot merge LoRA into quantized module {module}; load "
                "the checkpoint in full precision (or quantize AFTER "
                "merging with --quantization)"
            )
        w = node["weight"]
        a, b = ab["A"].to(w.device), ab["B"].to(w.device)
        delta = adapter_scale(acfg, module, a.shape[0]) * (b @ a)
        if tuple(w.shape) != tuple(delta.shape):
            raise ValueError(
                f"LoRA shape mismatch for {module}: {tuple(w.shape)} vs "
                f"{tuple(delta.shape)}"
            )
        new_w = apply_dora_magnitude(module, w.float() + delta, ab)
        node["weight"] = new_w.to(dtype)
        merged += 1
    logger.info("merged %d LoRA modules from %s", merged, adapter_path)
    return merged
