"""Shard-selective safetensors weight loading (port of
``parallax_tpu/models/loader.py``).

Selects only the files and keys holding the stage's layers, remaps global
layer indices to stage-local ones, handles tied embeddings, and builds the
stage param tree as tensors on the target device, in the HF ``[out, in]``
layout the models read. Safetensors files are read by this module itself
(the ``safetensors`` package is not needed): each file is memory-mapped and
every tensor goes straight to the device, one at a time, so the host never
holds the whole stage.

Full-precision checkpoints only (BF16 / F16 / F32 tensors). The quantized
formats (fp8, GPTQ, MXFP4, MLX packed ``uint32`` + ``.scales``), on-load
quantization and LoRA merging are refused with "not ported yet".
"""

from __future__ import annotations

import json
import mmap
import os
import re

import torch

from parallax_tpu_torch.models.base import StageModel
from parallax_tpu_torch.utils import get_logger
from parallax_tpu_torch.utils.hw import resolve_device

logger = get_logger(__name__)

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")

# Safetensors dtype names the loader takes.
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
}
_QUANT_METHODS = ("fp8", "gptq", "mxfp4")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: not ported yet to parallax_tpu_torch (quantization and "
        "LoRA wait for ROADMAP queue 1 item 11)"
    )


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
        """The same reader over safetensors bytes in memory (a writable
        copy, so the tensors it returns own no read-only buffer)."""
        self = cls.__new__(cls)
        self.path = name
        size = len(data)
        if size < 8:
            raise ValueError(f"{name}: not safetensors bytes")
        n = int.from_bytes(data[:8], "little")
        if n > size - 8:
            raise ValueError(f"{name}: header length {n} past the end")
        self._map = bytearray(data)
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
            if name.startswith("F8"):
                raise _not_ported(f"{self.path}: {key} is {name} (an fp8 "
                                  "checkpoint)")
            if name in ("I32", "U32"):
                raise _not_ported(f"{self.path}: {key} is {name} (packed "
                                  "quantized weights)")
            raise _not_ported(f"{self.path}: {key} has dtype {name}")
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


def _refuse_quantized_config(raw_cfg: dict) -> None:
    qc = raw_cfg.get("quantization_config") or {}
    quant_method = qc.get("quant_method")
    if quant_method in _QUANT_METHODS:
        raise _not_ported(f"quantization_config.quant_method "
                          f"{quant_method!r}")
    if quant_method is not None:
        # An unknown packed format (awq, compressed-tensors, ...) would
        # stream raw int tensors into float param slots and serve
        # garbage; refuse loudly instead.
        raise ValueError(
            f"quantization_config.quant_method {quant_method!r} is not "
            "supported (have: fp8, gptq, mxfp4, MLX-format, or on-load "
            "--quantization int8/int4); dequantize the checkpoint "
            "offline to serve it"
        )
    mlx = raw_cfg.get("quantization")
    if isinstance(mlx, dict) and "bits" in mlx:
        raise _not_ported("an MLX quantized checkpoint (config "
                          "'quantization')")


def load_stage_params(
    model: StageModel, model_path: str, dtype=torch.bfloat16,
    quantize: str | None = None,
    lora_path: str | None = None,
    device=None,
) -> dict:
    """Load this stage's weights from a local HF checkpoint directory onto
    ``device`` (None = ``cuda:0``)."""
    if quantize:
        raise _not_ported(f"quantize={quantize!r}")
    if lora_path:
        raise _not_ported(f"lora_path={lora_path!r}")
    device = resolve_device(device)
    cfg = model.config
    raw_cfg = {}
    cfg_path = os.path.join(model_path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            raw_cfg = json.load(f)
    _refuse_quantized_config(raw_cfg)

    tree: dict = {}
    want_embed = model.is_first or (model.is_last and cfg.tie_word_embeddings)
    n_loaded = 0

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

    weight_files = _weight_files(
        model_path, key_needed=lambda key: _resolve(key) is not None
    )
    for path in weight_files:
        st = SafetensorsFile(path)
        for key in st.keys():
            local = _resolve(key)
            if local is None:
                continue
            if local.endswith((".scales", ".biases", ".weight_scale_inv",
                               "_blocks", "_scales")):
                raise _not_ported(f"{path}: quantized tensor {key}")
            _assign(tree, local, _leaf(st.get_tensor(key), local, dtype,
                                       device))
            n_loaded += 1
        del st

    # layers dict {local_idx_str: {...}} -> ordered list
    layer_map = tree.get("layers", {})
    tree["layers"] = [
        layer_map[str(i)] for i in range(model.num_local_layers)
    ]
    logger.info(
        "loaded %d tensors for layers [%d, %d) from %s",
        n_loaded, model.start_layer, model.end_layer, model_path,
    )
    return model.finalize_params(tree)


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
