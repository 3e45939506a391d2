"""The port's loader on quantized checkpoints against the JAX loader
(``parallax_tpu/models/loader.py``): every checkpoint is written here by
the test itself, both loaders read it, and the trees must be equal leaf for
leaf (u8 values, scales and biases bitwise; the float leaves too).

- MLX packed ``uint32`` words + ``.scales`` / ``.biases``: a dense Qwen2
  with a quantized embedding, a per-module override to 8 bits and one of
  ``False`` (that module stays float), and a Qwen3-MoE whose per-expert
  quantized weights stack into a quantized ``experts`` dict;
- GPTQ quartets: v1, ``gptq_v2`` and an activation-ordered (``desc_act``)
  module that falls back to float;
- HF FP8 block weights with ``weight_scale_inv`` (a 16 x 16 block);
- gpt-oss MXFP4 ``_blocks`` / ``_scales`` experts, swapped to [E, in, out];
- on-load ``quantize="int8" | "int4"`` on a dense and an MoE checkpoint;
- the loaders' errors: orphan, unpaired and incomplete tensors, a missing
  ``quantization`` dict, an unknown ``quant_method`` and ``quantize=``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

import _torch_cpu  # noqa: F401
from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models import loader as jloader
from parallax_tpu.models.registry import (
    create_stage_model as j_create_stage_model,
)
from parallax_tpu.ops import quant as jq
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.models import loader
from test_torch_loader import (
    DENSE,
    _assert_same_tree,
    _hf_tensors,
    _random_tree,
)
from test_torch_qwen3_moe import QWEN3_MOE

H = DENSE["hidden_size"]


def _save(path, tensors: dict, raw: dict) -> str:
    path.mkdir(exist_ok=True)
    save_file({k: (v if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(v)))
               for k, v in tensors.items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(raw))
    return str(path)


def _both(raw, path, **kw):
    """(the port's tree, the JAX loader's tree carried across), in f32."""
    n = raw["num_hidden_layers"]
    port = loader.load_stage_params(
        create_stage_model(normalize_config(raw), 0, n), path,
        dtype=torch.float32, device="cpu", **kw)
    jtree = jloader.load_stage_params(
        j_create_stage_model(j_normalize(raw), 0, n, use_pallas=False), path,
        dtype=jnp.float32, **kw)
    return port, params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _mlx(tensors: dict, name: str, bits: int, g: int) -> None:
    """Replace ``name``.weight by MLX's packed words + scales + biases."""
    w = tensors.pop(f"{name}.weight")
    q, s, b = jq.quantize_array(w, bits, g)
    tensors[f"{name}.weight"] = torch.from_numpy(
        jq.pack_uint32(q, bits).view(np.int32)).view(torch.uint32)
    tensors[f"{name}.scales"] = s.astype(np.float16)
    tensors[f"{name}.biases"] = b.astype(np.float16)


def test_mlx_dense_with_overrides_matches_jax(tmp_path):
    tensors = _hf_tensors(_random_tree(DENSE))
    raw = dict(DENSE, quantization={
        "bits": 4, "group_size": 32,
        "model.layers.1.self_attn.o_proj": {"bits": 8, "group_size": 64},
        "model.layers.0.mlp.down_proj": False,
    })
    for li in range(2):
        for mod in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                    "mlp.down_proj"):
            name = f"model.layers.{li}.{mod}"
            if name == "model.layers.0.mlp.down_proj":
                continue                         # the False override: float
            bits, g = (8, 64) if name.endswith("1.self_attn.o_proj") \
                else (4, 32)
            _mlx(tensors, name, bits, g)
    _mlx(tensors, "model.embed_tokens", 4, 32)
    port, want = _both(raw, _save(tmp_path, tensors, raw))
    _assert_same_tree(port, want)
    layers = port["layers"]
    assert port["embed_tokens"]["qweight"].dtype == torch.uint8
    assert "weight" in layers[0]["mlp"]["down_proj"]
    assert layers[1]["self_attn"]["o_proj"]["qweight"].max() > 15   # 8 bits
    assert layers[0]["self_attn"]["q_proj"]["qweight"].max() <= 15  # 4 bits
    # The loaded tree serves through the port's stage model.
    model = create_stage_model(normalize_config(raw), 0, 2)
    assert "qweight" in model.finalize_params(port)["layers"][0][
        "mlp"]["up_proj"]


def test_mlx_moe_experts_stack_quantized_like_jax(tmp_path):
    raw = dict(QWEN3_MOE, num_hidden_layers=2, mlp_only_layers=[],
               quantization={"bits": 8, "group_size": 32})
    tensors = _hf_tensors(_random_tree(raw))
    for k in [k for k in tensors if k.endswith("proj.weight")]:
        _mlx(tensors, k[: -len(".weight")], 8, 32)
    port, want = _both(raw, _save(tmp_path, tensors, raw))
    _assert_same_tree(port, want)
    ex = port["layers"][0]["mlp"]["experts"]
    e, i, h = raw["num_experts"], raw["moe_intermediate_size"], \
        raw["hidden_size"]
    assert ex["gate_proj"]["qweight"].shape == (e, i, h)
    assert ex["down_proj"]["scales"].shape == (e, h, i // 32)


def _gptq(tensors, name, bits, group, rng, desc_act=False):
    w = tensors.pop(f"{name}.weight")
    out_dim, in_dim = w.shape
    q = rng.integers(0, 1 << bits, (in_dim, out_dim)).astype(np.uint8)
    z = rng.integers(0, (1 << bits) - 1, (in_dim // group, out_dim)).astype(
        np.uint8)
    tensors[f"{name}.qweight"] = jq.pack_uint32(q.T, bits).T.copy().view(
        np.int32)
    tensors[f"{name}.qzeros"] = jq.pack_uint32(z, bits).view(np.int32)
    tensors[f"{name}.scales"] = rng.uniform(
        0.01, 0.1, (in_dim // group, out_dim)).astype(np.float16)
    g_idx = np.arange(in_dim, dtype=np.int32) // group
    tensors[f"{name}.g_idx"] = rng.permutation(g_idx) if desc_act else g_idx


@pytest.mark.parametrize("fmt", [None, "gptq_v2"], ids=["v1", "v2"])
def test_gptq_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(5)
    qc = {"quant_method": "gptq", "bits": 4, "group_size": 32}
    if fmt:
        qc["checkpoint_format"] = fmt
    raw = dict(DENSE, quantization_config=qc)
    tensors = _hf_tensors(_random_tree(DENSE))
    for mod in ("self_attn.q_proj", "self_attn.o_proj", "mlp.up_proj",
                "mlp.down_proj"):
        _gptq(tensors, f"model.layers.0.{mod}", 4, 32, rng,
              desc_act=mod == "mlp.up_proj")
    port, want = _both(raw, _save(tmp_path, tensors, raw))
    _assert_same_tree(port, want)
    mlp = port["layers"][0]["mlp"]
    assert "weight" in mlp["up_proj"]                 # desc_act: float
    assert mlp["down_proj"]["qweight"].dtype == torch.uint8


def test_fp8_block_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    raw = dict(DENSE, quantization_config={"quant_method": "fp8",
                                           "weight_block_size": [16, 16]})
    tensors = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in _hf_tensors(_random_tree(DENSE)).items()}
    for k in [k for k in tensors if k.endswith("proj.weight")]:
        w = tensors[k].float() * 16
        tensors[k] = w.to(torch.float8_e4m3fn)
        grid = (-(-w.shape[0] // 16), -(-w.shape[1] // 16))
        tensors[k + "_scale_inv"] = torch.from_numpy(
            rng.uniform(0.01, 0.2, grid).astype(np.float32))
    port, want = _both(raw, _save(tmp_path, tensors, raw))
    _assert_same_tree(port, want)
    assert port["layers"][1]["mlp"]["gate_proj"]["weight"].dtype == \
        torch.float32


GPTOSS = dict(
    architectures=["GptOssForCausalLM"], hidden_size=64,
    num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=32, num_local_experts=4,
    num_experts_per_tok=2, sliding_window=8, layer_types=["full_attention"],
    vocab_size=199, max_position_embeddings=512, tie_word_embeddings=False,
    attention_bias=True, quantization_config={"quant_method": "mxfp4"},
)


def test_mxfp4_gptoss_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    h, inter, e = 64, 32, 4
    tensors = _hf_tensors(_random_tree(GPTOSS))
    pre = "model.layers.0.mlp.experts"
    for name, out_dim, in_dim in (("gate_up_proj", 2 * inter, h),
                                  ("down_proj", h, inter)):
        del tensors[f"{pre}.{name}"]
        tensors[f"{pre}.{name}_blocks"] = rng.integers(
            0, 256, (e, out_dim, in_dim // 32, 16)).astype(np.uint8)
        tensors[f"{pre}.{name}_scales"] = rng.integers(
            118, 126, (e, out_dim, in_dim // 32)).astype(np.uint8)
    port, want = _both(GPTOSS, _save(tmp_path, tensors, GPTOSS))
    _assert_same_tree(port, want)
    assert port["layers"][0]["mlp"]["experts"]["gate_up_proj"].shape == (
        e, h, 2 * inter)


@pytest.mark.parametrize("quantize,raw", [
    ("int8", DENSE), ("int4", DENSE),
    ("int4", dict(QWEN3_MOE, num_hidden_layers=2)),
], ids=["dense-int8", "dense-int4", "moe-int4"])
def test_quantize_on_load_matches_jax(tmp_path, quantize, raw):
    tensors = _hf_tensors(_random_tree(raw))
    port, want = _both(raw, _save(tmp_path, tensors, raw), quantize=quantize)
    _assert_same_tree(port, want)
    layer = port["layers"][0]
    assert "qweight" in layer["self_attn"]["q_proj"]
    assert "qweight" in port["lm_head"]
    assert "weight" in port["embed_tokens"]
    if "experts" in layer["mlp"]:
        assert layer["mlp"]["experts"]["gate_proj"]["qweight"].dim() == 3


def _error_case(tmp_path, case):
    tensors = {k: torch.from_numpy(v)
               for k, v in _hf_tensors(_random_tree(DENSE)).items()}
    q_proj = "model.layers.0.self_attn.q_proj"
    w = tensors[f"{q_proj}.weight"]
    raw = DENSE
    if case == "fp8-no-scale":
        raw = dict(DENSE, quantization_config={"quant_method": "fp8"})
        tensors[f"{q_proj}.weight"] = w.to(torch.float8_e4m3fn)
    elif case == "fp8-orphan-scale":
        raw = dict(DENSE, quantization_config={"quant_method": "fp8"})
        tensors["model.layers.0.self_attn.k_proj.weight_scale_inv"] = \
            torch.ones(1, 1)
    elif case == "mxfp4-unpaired":
        raw = dict(DENSE, quantization_config={"quant_method": "mxfp4"})
        tensors[f"{q_proj}.weight_blocks"] = torch.zeros(
            (64, 2, 16), dtype=torch.uint8)
    elif case == "gptq-incomplete":
        raw = dict(DENSE, quantization_config={"quant_method": "gptq",
                                               "bits": 4})
        tensors[f"{q_proj}.qweight"] = torch.zeros((8, 64), dtype=torch.int32)
    elif case in ("mlx-no-config", "mlx-no-scales", "mlx-orphan"):
        q, s, b = jq.quantize_array(w.numpy(), 4, 32)
        tensors[f"{q_proj}.weight"] = torch.from_numpy(
            jq.pack_uint32(q, 4).view(np.int32)).view(torch.uint32)
        if case != "mlx-no-scales":
            tensors[f"{q_proj}.scales"] = torch.from_numpy(s)
        if case == "mlx-orphan":
            raw = dict(DENSE, quantization={"bits": 4, "group_size": 32})
            tensors["model.layers.0.mlp.up_proj.biases"] = torch.zeros(128, 2)
        elif case == "mlx-no-scales":
            raw = dict(DENSE, quantization={"bits": 4, "group_size": 32})
    elif case == "awq":
        raw = dict(DENSE, quantization_config={"quant_method": "awq",
                                               "bits": 4})
    return raw, _save(tmp_path, {k: v.contiguous() for k, v in
                                 tensors.items()}, raw)


@pytest.mark.parametrize("case,match", [
    ("fp8-no-scale", "weight_scale_inv"),
    ("fp8-orphan-scale", "orphan fp8 scales"),
    ("mxfp4-unpaired", "unpaired mxfp4"),
    ("gptq-incomplete", "incomplete GPTQ"),
    ("mlx-no-config", "quantization"),
    ("mlx-no-scales", "no .scales sibling"),
    ("mlx-orphan", "orphan quantization tensors"),
    ("awq", "awq"),
])
def test_loader_errors_match_jax(tmp_path, case, match):
    raw, path = _error_case(tmp_path, case)
    n = raw["num_hidden_layers"]
    with pytest.raises(ValueError, match=match):
        loader.load_stage_params(
            create_stage_model(normalize_config(raw), 0, n), path,
            dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match=match):
        jloader.load_stage_params(
            j_create_stage_model(j_normalize(raw), 0, n, use_pallas=False),
            path, dtype=jnp.float32)


def test_fp8_tensor_outside_an_fp8_checkpoint_and_bad_quantize_raise(
        tmp_path):
    tensors = {k: torch.from_numpy(v)
               for k, v in _hf_tensors(_random_tree(DENSE)).items()}
    tensors["model.norm.weight"] = tensors["model.norm.weight"].to(
        torch.float8_e4m3fn)
    path = _save(tmp_path, tensors, DENSE)
    model = create_stage_model(normalize_config(DENSE), 0, 2)
    with pytest.raises(ValueError, match="not 'fp8'"):
        loader.load_stage_params(model, path, device="cpu")
    with pytest.raises(ValueError, match="quantize='int3'"):
        loader.load_stage_params(model, path, device="cpu", quantize="int3")
