"""A safetensors writer of the port's own (the reader is
``models/loader.py::SafetensorsFile``): the card may lack the
``safetensors`` package.

A file is an 8-byte little-endian header length, a JSON header (per tensor
``dtype``, ``shape`` and ``data_offsets`` from the end of the header; a
``__metadata__`` of strings), padded with spaces to 8 bytes, and the raw
bytes. One tensor at a time is copied to the host.
"""

from __future__ import annotations

import json
import os

import torch

# HF's default shard size (``max_shard_size="5GB"``).
SHARD_BYTES = 5 * 10**9

ST_DTYPES = {
    torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32",
    torch.uint32: "U32", torch.uint8: "U8", torch.int32: "I32",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def write_safetensors(path: str, tensors: dict,
                      metadata: dict | None = None) -> int:
    """Write ``tensors`` (name -> tensor, on any device) as one
    safetensors file at ``path``; returns the bytes of tensor data."""
    header: dict = {"__metadata__": dict(metadata or {"format": "pt"})}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in ST_DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name here (have {list(ST_DTYPES)})")
        n = _nbytes(t)
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-(8 + len(blob)) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).cpu()
                    .view(torch.uint8).numpy())
    return offset


def write_checkpoint(tensors: dict, raw_cfg: dict | None, path: str,
                     shard_bytes: int = SHARD_BYTES) -> int:
    """Write ``tensors`` as an HF safetensors checkpoint under ``path``:
    shards of at most about ``shard_bytes`` with
    ``model.safetensors.index.json`` when there are several, and
    ``config.json`` (``raw_cfg``; None writes none). Returns the bytes of
    tensor data written."""
    os.makedirs(path, exist_ok=True)
    groups, size = [[]], 0
    for name, t in tensors.items():
        n = _nbytes(t)
        if groups[-1] and size + n > shard_bytes:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += n
    weight_map, total = {}, 0
    for i, names in enumerate(groups):
        fname = (f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
                 if len(groups) > 1 else "model.safetensors")
        total += write_safetensors(os.path.join(path, fname),
                                   {n: tensors[n] for n in names})
        weight_map.update({n: fname for n in names})
    if len(groups) > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, f)
    if raw_cfg is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(raw_cfg, f)
    return total


def write_peft_adapter(path: str, tree: dict, start_layer: int = 0,
                       rank: int | None = None, alpha: float | None = None,
                       extra_config: dict | None = None) -> None:
    """Write an adapter tree ``{local_layer: {"group.proj": (A, B,
    scale)}}`` as a PEFT directory (``adapter_config.json`` and
    ``adapter_model.safetensors`` under
    ``base_model.model.model.layers.N.<path>.lora_{A,B}.weight``, f32).
    The config's ``r`` and ``lora_alpha`` are given, or taken from the
    first module (``alpha = scale * r``): every module must then share
    that scale at its own rank, which the caller arranges."""
    os.makedirs(path, exist_ok=True)
    tensors = {}
    first = None
    for li, layer in sorted(tree.items()):
        for mod, (a, b, s) in layer.items():
            a = torch.as_tensor(a, dtype=torch.float32)
            b = torch.as_tensor(b, dtype=torch.float32)
            if first is None:
                first = (a.shape[0], float(s))
            key = f"base_model.model.model.layers.{start_layer + li}.{mod}"
            tensors[f"{key}.lora_A.weight"] = a
            tensors[f"{key}.lora_B.weight"] = b
    if first is None:
        raise ValueError("empty adapter tree")
    r = rank if rank is not None else first[0]
    acfg = {"r": r,
            "lora_alpha": alpha if alpha is not None else first[1] * first[0],
            "peft_type": "LORA"}
    acfg.update(extra_config or {})
    write_safetensors(os.path.join(path, "adapter_model.safetensors"),
                      tensors)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump(acfg, f)
