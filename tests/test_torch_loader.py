"""The port's checkpoint loader (``parallax_tpu_torch/models/loader.py``)
against ``parallax_tpu/models/loader.py`` on checkpoints written here with
the ``safetensors`` package (an independent writer).

- The port's own safetensors reader gives ``safe_open``'s tensors bitwise:
  bf16, f16, f32, a 0-d and an empty tensor, the ``__metadata__``, and data
  not aligned to its element size.
- ``load_stage_params`` equals the JAX loader's tree carried across with
  ``registry.params_from_numpy``, leaf by leaf and bitwise: dense Qwen2
  (tied / untied, bf16 / f32 checkpoints and loads, one file / two shards
  with an index), a 2-stage split, selective-download shard dirs, and one
  tiny tree of each family the port registers (Qwen3-MoE with per-expert
  HF keys, DeepSeek-V3 and V3.2 with ``shared_experts``, gpt-oss).
- The quantized formats and ``quantize=`` load into the JAX loader's tree
  (``test_torch_quant_loader.py`` has each format in full); ``lora_path=``
  is refused with "not ported yet"; an unknown ``quant_method`` raises
  ValueError.
- ``params_from_torch_state_dict`` equals the JAX one on a transformers
  Qwen2, and an engine stream served from a loaded checkpoint equals the
  JAX engine's on its own load (greedy, tie-tolerant against transformers).
"""

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from parallax_tpu.config import normalize_config as j_normalize
from parallax_tpu.models import loader as jloader
from parallax_tpu.models.registry import (
    create_stage_model as j_create_stage_model,
)
from parallax_tpu.ops import quant as jq
from parallax_tpu.runtime.engine import EngineConfig as JEngineConfig
from parallax_tpu.runtime.engine import StageEngine as JStageEngine
from parallax_tpu.runtime.request import Request as JRequest
from parallax_tpu.runtime.request import SamplingParams as JSampling
from parallax_tpu_torch.config import normalize_config
from parallax_tpu_torch.models import create_stage_model, params_from_numpy
from parallax_tpu_torch.models import loader
from parallax_tpu_torch.runtime.engine import EngineConfig, StageEngine
from parallax_tpu_torch.runtime.request import Request, SamplingParams
from test_engine_e2e import TINY_QWEN2 as HF_QWEN2
from test_engine_e2e import assert_greedy_matches
from test_torch_deepseek import TINY_V3, TINY_V32
from test_torch_gpt_oss import TINY as TINY_GPTOSS
from test_torch_qwen3_moe import QWEN3_MOE

DENSE = dict(
    architectures=["Qwen2ForCausalLM"], hidden_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
    vocab_size=266, max_position_embeddings=512, attention_bias=True,
    tie_word_embeddings=False, torch_dtype="float32",
)
FAMILIES = {
    "qwen3-moe": QWEN3_MOE,
    "deepseek-v3": TINY_V3,
    "deepseek-v3.2": TINY_V32,
    "gpt-oss": TINY_GPTOSS,
}
_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}


# -- writing checkpoints ------------------------------------------------------


def _random_tree(raw):
    """A JAX ``init_params`` tree of the whole model as numpy, with random
    values where the init leaves zeros or ones (biases, norms, sinks), so a
    misplaced leaf cannot hide."""
    cfg = j_normalize(raw)
    model = j_create_stage_model(cfg, 0, cfg.num_hidden_layers,
                                 use_pallas=False)
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.key(0),
                                                      dtype=jnp.float32))
    rng = np.random.default_rng(3)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if a.ndim <= 1 or not a.any() else a, tree)


def _hf_tensors(tree, family: str = "") -> dict[str, np.ndarray]:
    """The tree under HF checkpoint names: ``model.`` prefixed, ``lm_head``
    outside it; MoE experts per expert (``experts.{i}.gate_proj.weight``)
    and DeepSeek's ``shared_experts``, which the models' ``finalize_params``
    stack and rename back."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            node = dict(node)
            experts = node.get("experts")
            if (isinstance(experts, dict) and "gate_proj" in experts
                    and not isinstance(experts["gate_proj"], dict)):
                node["experts"] = {
                    str(i): {p: {"weight": experts[p][i]} for p in experts}
                    for i in range(experts["gate_proj"].shape[0])
                }
            if family.startswith("deepseek") and "shared_expert" in node:
                node["shared_experts"] = node.pop("shared_expert")
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}.{i}", v)
        else:
            key = prefix if prefix.startswith("lm_head") else f"model.{prefix}"
            out[key] = np.asarray(node)

    walk("", tree)
    return out


def _write(path, tensors: dict, raw: dict, dtype: str = "f32",
           shards: list[list[str]] | None = None) -> None:
    """Write ``tensors`` as an HF checkpoint in ``dtype``: one
    ``model.safetensors``, or one file per key list in ``shards`` plus the
    ``model.safetensors.index.json``."""
    os.makedirs(path, exist_ok=True)
    tdtype = _DT[dtype][0]
    as_torch = {k: torch.from_numpy(np.array(v)).to(tdtype)
                for k, v in tensors.items()}
    if shards is None:
        save_file(as_torch, os.path.join(path, "model.safetensors"),
                  metadata={"format": "pt"})
    else:
        weight_map = {}
        for i, keys in enumerate(shards):
            name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
            save_file({k: as_torch[k] for k in keys},
                      os.path.join(path, name), metadata={"format": "pt"})
            weight_map.update({k: name for k in keys})
        with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f)


def _two_shards(tensors: dict) -> list[list[str]]:
    """Layer 0 and the embedding in one file, the rest in the other."""
    first = sorted(k for k in tensors if k.startswith(
        ("model.embed_tokens.", "model.layers.0.")))
    return [first, sorted(set(tensors) - set(first))]


# -- loading both ways --------------------------------------------------------


def _load_both(raw, path, start, end, dtype: str):
    """(the port's tree, JAX's tree carried across) for one stage."""
    tdt, jdt = _DT[dtype]
    port = loader.load_stage_params(
        create_stage_model(normalize_config(raw), start, end), path,
        dtype=tdt, device="cpu")
    jtree = jloader.load_stage_params(
        j_create_stage_model(j_normalize(raw), start, end, use_pallas=False),
        path, dtype=jdt)
    return port, params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _assert_same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(got), sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}.{i}")
    else:
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert torch.equal(got, want), path


# -- the reader ---------------------------------------------------------------


def test_reader_matches_safe_open(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(5, 7, generator=gen).to(torch.bfloat16),
        "f16": torch.randn(3, 4, 2, generator=gen).to(torch.float16),
        "f32": torch.randn(9, generator=gen),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4, dtype=torch.bfloat16),
        "odd_bf16": torch.randn(3, generator=gen).to(torch.bfloat16),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt", "note": "x y"})
    st = loader.SafetensorsFile(path)
    with safe_open(path, framework="pt") as ref:
        assert sorted(st.keys()) == sorted(ref.keys())
        assert st.metadata == ref.metadata()
        for k in ref.keys():
            want = ref.get_tensor(k)
            got = st.get_tensor(k)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert torch.equal(got, want), k
            assert torch.equal(got, tensors[k]), k


def test_reader_takes_unaligned_data(tmp_path):
    """Offsets count from the end of the header, whose length need not keep
    the data aligned: an f32 tensor at an odd file offset reads right."""
    a = np.arange(3, dtype=np.float32) + 0.25
    b = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
    header = json.dumps({
        "a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 12]},
        "b": {"dtype": "BF16", "shape": [2], "data_offsets": [12, 16]},
    }).encode()
    if (8 + len(header)) % 2 == 0:
        header += b" "
    path = tmp_path / "u.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + a.tobytes()
                     + b.view(torch.int16).numpy().tobytes())
    st = loader.SafetensorsFile(str(path))
    assert torch.equal(st.get_tensor("a"), torch.from_numpy(a))
    assert torch.equal(st.get_tensor("b"), b)
    assert st.metadata == {}


@pytest.mark.parametrize("dtype,shape,offsets", [
    ("F32", [3], [0, 8]),          # too few bytes for the shape
    ("F32", [2], [0, 64]),         # past the end of the file
])
def test_reader_refuses_bad_offsets(tmp_path, dtype, shape, offsets):
    header = json.dumps({"a": {"dtype": dtype, "shape": shape,
                               "data_offsets": offsets}}).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + bytes(8))
    with pytest.raises(ValueError, match="data_offsets"):
        loader.SafetensorsFile(str(path)).get_tensor("a")


# -- load_stage_params against the JAX loader ----------------------------------


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("ckpt_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("sharded", [False, True], ids=["one-file", "shards"])
def test_dense_load_matches_jax(tmp_path, tied, ckpt_dtype, sharded):
    raw = dict(DENSE, tie_word_embeddings=tied)
    tensors = _hf_tensors(_random_tree(raw))
    assert ("lm_head.weight" in tensors) is not tied
    _write(tmp_path, tensors, raw, ckpt_dtype,
           _two_shards(tensors) if sharded else None)
    for load_dtype in ("bf16", "f32"):
        port, want = _load_both(raw, str(tmp_path), 0, 2, load_dtype)
        _assert_same_tree(port, want)
    # The loaded bf16 leaves are the checkpoint's bits.
    if ckpt_dtype == "bf16":
        w = torch.from_numpy(tensors["model.layers.1.mlp.up_proj.weight"])
        assert torch.equal(port["layers"][1]["mlp"]["up_proj"]["weight"],
                           w.to(torch.bfloat16).float())


def test_two_stage_split_matches_jax(tmp_path):
    raw = dict(DENSE, tie_word_embeddings=True)
    tensors = _hf_tensors(_random_tree(raw))
    _write(tmp_path, tensors, raw, "bf16")
    for start, end in ((0, 1), (1, 2)):
        port, want = _load_both(raw, str(tmp_path), start, end, "bf16")
        _assert_same_tree(port, want)
        assert len(port["layers"]) == 1
    # The tied last stage carries the embedding (its lm_head) but no
    # first-stage leaves beyond it.
    assert set(port) == {"layers", "embed_tokens", "norm"}


def test_selective_download_shard_rule(tmp_path):
    """A stage dir missing another stage's shard loads; one missing its
    own shard fails fast naming it, in both packages."""
    raw = DENSE
    tensors = _hf_tensors(_random_tree(raw))
    shards = _two_shards(tensors)
    _write(tmp_path, tensors, raw, "f32", shards)
    os.remove(tmp_path / "model-00002-of-00002.safetensors")
    port, want = _load_both(raw, str(tmp_path), 0, 1, "f32")
    _assert_same_tree(port, want)
    assert set(port) == {"layers", "embed_tokens"}
    for load in (
        lambda: loader.load_stage_params(
            create_stage_model(normalize_config(raw), 1, 2), str(tmp_path),
            device="cpu"),
        lambda: jloader.load_stage_params(
            j_create_stage_model(j_normalize(raw), 1, 2, use_pallas=False),
            str(tmp_path)),
    ):
        with pytest.raises(FileNotFoundError, match="00002"):
            load()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_load_matches_jax(tmp_path, family):
    raw = FAMILIES[family]
    tensors = _hf_tensors(_random_tree(raw), family)
    if family in ("qwen3-moe", "deepseek-v3"):
        assert any(".experts.0." in k for k in tensors)
    _write(tmp_path, tensors, raw, "f32")
    n = raw["num_hidden_layers"]
    port, want = _load_both(raw, str(tmp_path), 0, n, "f32")
    _assert_same_tree(port, want)
    mlps = [layer["mlp"] for layer in port["layers"]]
    if family == "gpt-oss":
        # No finalize step: the HF tensors are the param layout, and the
        # sinks are float32 whatever the load dtype.
        assert port["layers"][0]["self_attn"]["sinks"].dtype == torch.float32
        port_bf16, want_bf16 = _load_both(raw, str(tmp_path), 0, n, "bf16")
        _assert_same_tree(port_bf16, want_bf16)
    elif family.startswith("deepseek"):
        assert any("shared_expert" in m for m in mlps)
        assert not any("shared_experts" in m for m in mlps)
    if "experts" in mlps[0] and family != "gpt-oss":
        assert mlps[0]["experts"]["gate_proj"].dim() == 3


# -- refusals -----------------------------------------------------------------


def _dense_ckpt(path, raw=DENSE, extra=None):
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in
               _hf_tensors(_random_tree(DENSE)).items()}
    for k, v in (extra or {}).items():
        if v is None:
            del tensors[k]
        else:
            tensors[k] = v
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f)


def _port_load(path, **kw):
    return loader.load_stage_params(
        create_stage_model(normalize_config(DENSE), 0, 2), str(path),
        device="cpu", **kw)


@pytest.mark.parametrize("case,reason", [
    ("fp8", "'fp8'"), ("gptq", "'gptq'"), ("mxfp4", "'mxfp4'"),
    ("mlx", "MLX"), ("f8-tensor", "F8_E4M3"), ("u32-tensor", "U32"),
    ("quantize", "quantize='int8'"), ("lora", "lora_path="),
])
def test_unported_formats_are_refused(tmp_path, case, reason):
    """Nothing is refused now: each quantized format that once was (fp8
    block weights, GPTQ, MXFP4, MLX packed words, their F8_E4M3 / U32
    tensors, on-load ``quantize=``) loads into the JAX loader's tree, u8
    values and scales bitwise, and so does a ``lora_path=`` merge (a rank-1
    adapter at a power-of-two scale: every delta entry is one exact
    product, so the merged f32 weights are bitwise)."""
    kw, raw, extra = {}, DENSE, {}
    up = "model.layers.0.mlp.up_proj"
    w = _random_tree(DENSE)["layers"][0]["mlp"]["up_proj"]["weight"]
    if case in ("fp8", "f8-tensor"):
        raw = dict(DENSE, quantization_config={"quant_method": "fp8"})
        extra = {f"{up}.weight": torch.from_numpy(w * 8).to(
                     torch.float8_e4m3fn),
                 f"{up}.weight_scale_inv": torch.tensor([[0.125]])}
    elif case == "gptq":
        raw = dict(DENSE, quantization_config={"quant_method": "gptq",
                                               "bits": 4})
        q, s, b = jq.quantize_array(w, 4, 32)
        zeros = np.full((2, w.shape[0]), 7, np.uint8)
        extra = {f"{up}.qweight": torch.from_numpy(
                     jq.pack_uint32(q.T, 4).T.copy().view(np.int32)),
                 f"{up}.qzeros": torch.from_numpy(
                     jq.pack_uint32(zeros, 4).view(np.int32)),
                 f"{up}.scales": torch.from_numpy(s.T.copy())}
    elif case == "mxfp4":
        raw = dict(DENSE, quantization_config={"quant_method": "mxfp4"})
        rng = np.random.default_rng(1)
        extra = {f"{up}.weight_blocks": torch.from_numpy(rng.integers(
                     0, 256, (w.shape[0], 2, 16)).astype(np.uint8)),
                 f"{up}.weight_scales": torch.full((w.shape[0], 2), 124,
                                                   dtype=torch.uint8)}
    elif case in ("mlx", "u32-tensor"):
        raw = dict(DENSE, quantization={"bits": 4, "group_size": 64})
        q, s, b = jq.quantize_array(w, 4, 64)
        extra = {f"{up}.weight": torch.from_numpy(
                     jq.pack_uint32(q, 4).view(np.int32)).view(torch.uint32),
                 f"{up}.scales": torch.from_numpy(s),
                 f"{up}.biases": torch.from_numpy(b)}
    elif case == "quantize":
        kw = {"quantize": "int8"}
    else:
        from parallax_tpu_torch.utils.st_writer import write_peft_adapter

        rng = np.random.default_rng(3)
        write_peft_adapter(str(tmp_path / "adapter"), {
            li: {"self_attn.q_proj": (
                     rng.standard_normal((1, w.shape[1])).astype(np.float32),
                     rng.standard_normal((w.shape[1], 1)).astype(np.float32),
                     0.5),
                 "mlp.up_proj": (
                     rng.standard_normal((1, w.shape[1])).astype(np.float32),
                     rng.standard_normal((w.shape[0], 1)).astype(np.float32),
                     0.5)}
            for li in (0, 1)})
        kw = {"lora_path": str(tmp_path / "adapter")}
    if case in ("gptq", "mxfp4"):
        extra[f"{up}.weight"] = None
    _dense_ckpt(tmp_path, raw, extra)
    got = _port_load(tmp_path, dtype=torch.float32, **kw)
    jtree = jloader.load_stage_params(
        j_create_stage_model(j_normalize(raw), 0, 2, use_pallas=False),
        str(tmp_path), dtype=jnp.float32, **kw)
    _assert_same_tree(got, params_from_numpy(
        jax.tree.map(np.asarray, jtree), "cpu"))
    mlp = got["layers"][0]["mlp"]
    assert ("qweight" in mlp["up_proj"]) == (
        case in ("gptq", "mlx", "u32-tensor", "quantize"))
    if case == "lora":
        # The merge moved both targets, in both layers.
        base = _port_load(tmp_path, dtype=torch.float32)
        for li in (0, 1):
            for grp, proj in (("self_attn", "q_proj"), ("mlp", "up_proj")):
                assert not torch.equal(
                    got["layers"][li][grp][proj]["weight"],
                    base["layers"][li][grp][proj]["weight"])


def test_unknown_quant_method_is_a_value_error(tmp_path):
    raw = dict(DENSE, quantization_config={"quant_method": "awq"})
    _dense_ckpt(tmp_path, raw)
    with pytest.raises(ValueError, match="awq"):
        _port_load(tmp_path)
    with pytest.raises(ValueError, match="awq"):
        jloader.load_stage_params(
            j_create_stage_model(j_normalize(raw), 0, 2, use_pallas=False),
            str(tmp_path))


def test_loader_needs_a_device_or_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        loader.load_stage_params(
            create_stage_model(normalize_config(DENSE), 0, 2), "/nonexistent")


# -- transformers state dicts and an engine stream ---------------------------


@pytest.fixture(scope="module")
def hf_qwen2():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.Qwen2Config(**{k: v for k, v in HF_QWEN2.items()
                                      if k != "architectures"})
    return transformers.Qwen2ForCausalLM(cfg).eval()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_params_from_torch_state_dict_matches_jax(hf_qwen2, dtype):
    tdt, jdt = _DT[dtype]
    sd = hf_qwen2.state_dict()
    for start, end in ((0, 4), (0, 2), (2, 4)):
        port = loader.params_from_torch_state_dict(
            create_stage_model(normalize_config(HF_QWEN2), start, end), sd,
            dtype=tdt, device="cpu")
        jtree = jloader.params_from_torch_state_dict(
            j_create_stage_model(j_normalize(HF_QWEN2), start, end,
                                 use_pallas=False), sd, dtype=jdt)
        _assert_same_tree(
            port, params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu"))


def test_engine_stream_from_loaded_checkpoint_matches_jax(tmp_path,
                                                          hf_qwen2):
    """transformers' weights written as a checkpoint, loaded by each
    package into its engine (f32, one stage, the engines' defaults): the
    port's greedy stream equals the JAX engine's and passes the
    tie-tolerant rule against transformers."""
    save_file({k: v.contiguous() for k, v in hf_qwen2.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(HF_QWEN2, f)
    prompt = [int(x) for x in np.random.default_rng(5).integers(1, 198, 29)]
    n_new = 12
    engine_kw = dict(page_size=8, num_pages=64, max_model_len=128,
                     kv_dtype="float32")

    model = create_stage_model(normalize_config(HF_QWEN2), 0, 4)
    engine = StageEngine(
        model, loader.load_stage_params(model, str(tmp_path),
                                        dtype=torch.float32, device="cpu"),
        EngineConfig(**engine_kw), device="cpu")
    req = Request("r", prompt_ids=list(prompt), sampling_params=SamplingParams(
        temperature=0.0, max_new_tokens=n_new))
    engine.submit(req)
    while engine.has_work():
        engine.step()

    jmodel = j_create_stage_model(j_normalize(HF_QWEN2), 0, 4,
                                  use_pallas=False)
    jengine = JStageEngine(
        jmodel, jloader.load_stage_params(jmodel, str(tmp_path),
                                          dtype=jnp.float32),
        JEngineConfig(**engine_kw))
    jreq = JRequest("r", prompt_ids=list(prompt),
                    sampling_params=JSampling(temperature=0.0,
                                              max_new_tokens=n_new))
    jengine.submit(jreq)
    while jengine.has_work():
        jengine.step()

    assert req.output_ids == jreq.output_ids
    assert_greedy_matches(hf_qwen2, prompt, req.output_ids, n_new)


# -- chip_smoke.py's own writer -------------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shard_bytes", [10**9, 60_000],
                         ids=["one-file", "shards"])
def test_chip_smoke_writer_reads_back(tmp_path, shard_bytes):
    """The writer ``chip_smoke.py`` uses on the card (which may lack the
    ``safetensors`` package): ``safe_open`` reads every tensor back
    bitwise, the index maps every key, and the port's loader gives the
    tree that was written."""
    cs = _chip_smoke()
    raw = dict(DENSE, tie_word_embeddings=False)
    model = create_stage_model(normalize_config(raw), 0, 2)
    tree = model.init_params(torch.Generator().manual_seed(0),
                             torch.bfloat16, "cpu")
    tree["layers"][1]["self_attn"]["q_proj"]["bias"] = torch.randn(
        256, dtype=torch.float32)    # an f32 leaf among bf16 ones
    tensors = cs.hf_tensors(tree)
    total = cs.write_checkpoint(tensors, raw, str(tmp_path), shard_bytes)
    assert total == sum(t.numel() * t.element_size()
                        for t in tensors.values())
    files = sorted(p.name for p in tmp_path.glob("*.safetensors"))
    index = tmp_path / "model.safetensors.index.json"
    if shard_bytes > total:
        assert files == ["model.safetensors"] and not index.exists()
        weight_map = {k: files[0] for k in tensors}
    else:
        assert len(files) > 1
        weight_map = json.loads(index.read_text())["weight_map"]
        assert json.loads(index.read_text())["metadata"]["total_size"] == total
    assert set(weight_map) == set(tensors)
    for fname in files:
        with safe_open(str(tmp_path / fname), framework="pt") as f:
            assert f.metadata() == {"format": "pt"}
            for k in f.keys():
                assert weight_map[k] == fname
                assert torch.equal(f.get_tensor(k), tensors[k]), k
        head = (tmp_path / fname).read_bytes()[:8]
        assert int.from_bytes(head, "little") % 8 == 0
    assert json.loads((tmp_path / "config.json").read_text()) == raw
    loaded = loader.load_stage_params(model, str(tmp_path),
                                      dtype=torch.bfloat16, device="cpu")
    for k, t in cs.hf_tensors(loaded).items():
        assert torch.equal(t, tensors[k].to(torch.bfloat16)), k
