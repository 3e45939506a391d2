"""The port's weight-only quantization (``parallax_tpu_torch/ops/quant.py``)
and the plain versions of its quantized products (``ops/quant_linear.py``:
A10 ``quant_linear``, A11 ``grouped_gemm_q``) against
``parallax_tpu/ops/quant.py`` and the JAX package's consumers, on the same
numpy inputs (CPU).

- pack / unpack, ``quantize_array``, ``convert_gptq_weight`` (v1, v2,
  desc_act) and ``quantize_tree`` (dense leaves, stacked experts, the
  group-divisibility skips): bitwise;
- ``dequantize_weight``, ``dequant_fp8_block``, ``dequant_mxfp4``: f32
  allclose (1e-6: XLA may fuse the multiply and add);
- per-token fp8 frames: data and scales byte-equal to ml_dtypes';
- A10's plain version against JAX ``linear(get_weight)`` and
  ``lm_head_logits`` (f32 out), A11's inside ``moe_ffn`` against the JAX
  MoE on both of its paths (megablox ``gmm`` in interpret mode): f32
  allclose 1e-5, bits 8 and 4, g 32 / 64 / 128, with and without biases;
- the wrappers' checks and the kernel source's constants (the kernels run
  only on the card: chip_smoke.py holds them against these plain
  versions).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import megablox

import _torch_cpu  # noqa: F401
from parallax_tpu.config import MoEConfig as JMoEConfig
from parallax_tpu.models import layers as jlayers
from parallax_tpu.models import moe as jmoe
from parallax_tpu.ops import quant as jq
from parallax_tpu_torch.config import MoEConfig
from parallax_tpu_torch.models import layers as L
from parallax_tpu_torch.models import moe as tmoe
from parallax_tpu_torch.models.registry import params_from_numpy
from parallax_tpu_torch.ops import cuda_kernels as ck
from parallax_tpu_torch.ops import quant as tq
from parallax_tpu_torch.ops import quant_linear as ql

TOL = dict(atol=1e-5, rtol=1e-5)
QUANT = [(bits, g) for bits in (8, 4) for g in (32, 64, 128)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_match_jax(bits):
    rng = np.random.default_rng(bits)
    v = rng.integers(0, 1 << bits, size=(6, 64)).astype(np.uint8)
    words = jq.pack_uint32(v, bits)
    got = tq.pack_uint32(_t(v), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.view(torch.uint32).numpy()
                                  .astype(np.uint32), words)
    # Unpack from uint32 words and from their int32 view, as JAX does.
    for w in (_t(words.view(np.int32)).view(torch.uint32),
              _t(words.view(np.int32))):
        back = tq.unpack_uint32(w, bits)
        assert back.dtype == torch.uint8
        np.testing.assert_array_equal(back.numpy(),
                                      jq.unpack_uint32(words, bits))
        np.testing.assert_array_equal(back.numpy(), v)


@pytest.mark.parametrize("bits,g", QUANT)
def test_quantize_array_is_bitwise_numpys(bits, g):
    w = _weights((3, 5, 256), seed=bits + g)
    w[0, 0, :g] = 0.25                 # a constant group: the 1e-8 floor
    q, s, b = jq.quantize_array(w, bits, g)
    tq_, ts, tb = tq.quantize_array(_t(w), bits, g)
    np.testing.assert_array_equal(tq_.numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), s)
    np.testing.assert_array_equal(tb.numpy(), b)
    p = {"qweight": q, "scales": s, "biases": b}
    ref = np.asarray(jq.dequantize_weight(
        {k: jnp.asarray(v) for k, v in p.items()}))
    got = tq.dequantize_weight({k: _t(v) for k, v in p.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    # Without biases, and rounded to bf16 scales' dtype.
    bf = {"qweight": _t(q), "scales": _t(s).to(torch.bfloat16)}
    jbf = {"qweight": jnp.asarray(q),
           "scales": jnp.asarray(s).astype(jnp.bfloat16)}
    got = tq.dequantize_weight(bf)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jq.dequantize_weight(jbf)).astype(np.float32))


def test_quantize_array_rejects_a_ragged_group():
    with pytest.raises(ValueError, match="group size"):
        tq.quantize_array(torch.zeros(4, 48), 8, 32)


@pytest.mark.parametrize("offset,desc_act", [(1, False), (0, False),
                                             (1, True)],
                         ids=["v1", "gptq_v2", "desc_act"])
@pytest.mark.parametrize("bits", [4, 8])
def test_convert_gptq_weight_matches_jax(bits, offset, desc_act):
    rng = np.random.default_rng(bits)
    in_dim, out_dim, group = 64, 24, 16
    pack = 32 // bits
    q = rng.integers(0, 1 << bits, size=(in_dim, out_dim)).astype(np.uint8)
    z = rng.integers(0, 1 << bits, size=(in_dim // group, out_dim)).astype(
        np.uint8)
    qweight = jq.pack_uint32(q.T, bits).T.copy().view(np.int32)
    qzeros = jq.pack_uint32(z, bits).view(np.int32)
    assert qweight.shape == (in_dim // pack, out_dim)
    scales = (rng.random((in_dim // group, out_dim)) * 0.1).astype(
        np.float16)
    g_idx = (rng.permutation(in_dim) // group).astype(np.int32) \
        if desc_act else (np.arange(in_dim) // group).astype(np.int32)
    ref = jq.convert_gptq_weight(qweight, qzeros, scales, g_idx, bits,
                                 zero_offset=offset)
    got = tq.convert_gptq_weight(_t(qweight), _t(qzeros), _t(scales),
                                 _t(g_idx), bits, zero_offset=offset)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    with pytest.raises(ValueError, match="bit width"):
        tq.convert_gptq_weight(_t(qweight), _t(qzeros), _t(scales), None, 3)


def test_dequant_fp8_block_matches_jax():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((200, 136)).astype(
        np.float32) * 4).to(torch.float8_e4m3fn)
    scale = (rng.random((2, 2)) + 0.5).astype(np.float32)
    ref = jq.dequant_fp8_block(w.float().numpy(), scale, (128, 128))
    got = tq.dequant_fp8_block(w, _t(scale), (128, 128))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="scale grid"):
        tq.dequant_fp8_block(w, _t(scale[:1]), (128, 128))


def test_dequant_mxfp4_matches_jax():
    rng = np.random.default_rng(4)
    blocks = rng.integers(0, 256, size=(3, 5, 4, 16)).astype(np.uint8)
    scales = rng.integers(100, 140, size=(3, 5, 4)).astype(np.uint8)
    ref = jq.dequant_mxfp4(blocks, scales)
    got = tq.dequant_mxfp4(_t(blocks), _t(scales))
    assert got.shape == ref.shape == (3, 5, 128)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="mxfp4 scales"):
        tq.dequant_mxfp4(_t(blocks), _t(scales[:, :2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_per_token_frames_are_byte_equal(dtype):
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((64, 512)) * np.exp(
        rng.standard_normal((64, 1)))).astype(np.float32)
    a[3] = 0.0                                      # an all-zero row
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    q, s = jq.quantize_fp8_per_token(t.float().numpy())
    tq8, ts = tq.quantize_fp8_per_token(t)
    assert tq8.dtype == torch.float8_e4m3fn and ts.dtype == torch.float32
    assert tq8.view(torch.uint8).numpy().tobytes() == q.tobytes()
    assert ts.numpy().tobytes() == s.tobytes()
    back = tq.dequantize_fp8_per_token(tq8, ts)
    np.testing.assert_array_equal(back.numpy(),
                                  jq.dequantize_fp8_per_token(q, s))
    empty = tq.quantize_fp8_per_token(torch.zeros(0, 8))
    assert empty[0].shape == (0, 8) and empty[1].shape == (0,)


def _tree(e=4, h=64, i=96):
    """A JAX-layout tree: dense projections, a lm_head, norms, an
    embedding (never quantized), a stacked expert set and one whose down
    projection's K (40) no group divides."""
    rng = np.random.default_rng(7)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(
            np.float32)

    return {
        "embed_tokens": {"weight": w(50, h)},
        "layers": [
            {"self_attn": {"q_proj": {"weight": w(h, h), "bias": w(h)},
                           "o_proj": {"weight": w(h, h)}},
             "input_layernorm": {"weight": np.ones(h, np.float32)},
             "mlp": {"gate": {"weight": w(e, h)},
                     "experts": {"gate_proj": w(e, i, h),
                                 "up_proj": w(e, i, h),
                                 "down_proj": w(e, h, i)}}},
            {"mlp": {"experts": {"gate_proj": w(e, 40, h),
                                 "up_proj": w(e, 40, h),
                                 "down_proj": w(e, h, 40)},
                     "down_proj": {"weight": w(h, 40)}}},
        ],
        "lm_head": {"weight": w(70, h)},
    }


@pytest.mark.parametrize("bits,g", [(8, 32), (4, 64)])
def test_quantize_tree_matches_jax(bits, g):
    import jax

    tree = _tree()
    ref = jax.tree.map(np.asarray, jq.quantize_tree(
        jax.tree.map(jnp.asarray, tree), bits=bits, group_size=g,
        dtype=jnp.bfloat16))
    port = params_from_numpy(tree, "cpu")
    f32_leaf = port["embed_tokens"]["weight"]
    got = tq.quantize_tree(port, bits=bits, group_size=g,
                           dtype=torch.bfloat16)
    assert got is port                              # in place
    assert got["embed_tokens"]["weight"] is f32_leaf

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}.{i}")
        else:
            want = params_from_numpy(a)
            assert b.dtype == want.dtype, path
            assert torch.equal(b, want), path

    walk(ref, got)
    layer0 = got["layers"][0]
    assert tq.is_quantized(layer0["mlp"]["experts"]["gate_proj"])
    # K = 96: a group of 32 divides it, one of 64 does not.
    assert tq.is_quantized(layer0["mlp"]["experts"]["down_proj"]) == (g == 32)
    assert not tq.is_quantized(layer0["mlp"]["gate"])
    # K = 40: no group of 32 or 64 divides it.
    assert isinstance(got["layers"][1]["mlp"]["experts"]["down_proj"],
                      torch.Tensor)
    assert tq.is_quantized(got["layers"][1]["mlp"]["experts"]["gate_proj"])
    assert "weight" in got["layers"][1]["mlp"]["down_proj"]
    assert got["layers"][0]["self_attn"]["q_proj"]["qweight"].dtype == \
        torch.uint8


def test_params_from_numpy_keeps_integer_leaves():
    q, s, b = jq.quantize_array(_weights((8, 64)), 4, 32)
    tree = params_from_numpy({"w": {"qweight": q, "scales": s, "biases": b},
                              "ids": np.arange(3, dtype=np.int32)},
                             dtype=torch.bfloat16)
    assert tree["w"]["qweight"].dtype == torch.uint8
    assert torch.equal(tree["w"]["qweight"], _t(q))
    assert tree["ids"].dtype == torch.int32
    assert tree["w"]["scales"].dtype == torch.bfloat16


def _qparam(n, k, bits, g, biases=True, seed=0):
    q, s, b = jq.quantize_array(_weights((n, k), seed), bits, g)
    p = {"qweight": q, "scales": s}
    if biases:
        p["biases"] = b
    return p


@pytest.mark.parametrize("biases", [True, False], ids=["biases", "none"])
@pytest.mark.parametrize("bits,g", QUANT)
def test_quant_linear_plain_matches_jax_linear(bits, g, biases):
    rng = np.random.default_rng(bits * g)
    x = rng.standard_normal((7, 256)).astype(np.float32)
    p = _qparam(48, 256, bits, g, biases, seed=g)
    p["bias"] = rng.standard_normal(48).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    ref = np.asarray(jlayers.linear(jnp.asarray(x), jp))
    got = L.linear(_t(x), tp)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # The wrapper on CPU tensors is the plain version, bit for bit.
    plain = ql.quant_linear_plain(_t(x), tp["qweight"], tp["scales"],
                                  tp.get("biases"))
    assert torch.equal(ql.quant_linear(_t(x), tp["qweight"], tp["scales"],
                                       tp.get("biases")), plain)
    # lm_head: f32 logits from bf16 activations and bf16 scales.
    hp = {k: v for k, v in p.items() if k != "bias"}
    jh = {k: (jnp.asarray(v).astype(jnp.bfloat16) if k != "qweight"
              else jnp.asarray(v)) for k, v in hp.items()}
    th = {k: (_t(v).to(torch.bfloat16) if k != "qweight" else _t(v))
          for k, v in hp.items()}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(jlayers.lm_head_logits(xb, jh))
    got = L.lm_head_logits(_t(x).to(torch.bfloat16), th)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert torch.equal(L.linear_f32(_t(x).to(torch.bfloat16), th), got)


def test_quantized_embedding_dequantizes_the_gathered_rows():
    p = _qparam(50, 64, 4, 32, seed=9)
    ids = np.array([3, 0, 49, 3], np.int32)
    ref = np.asarray(jlayers.embed_lookup(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(ids)))
    got = L.embed_lookup({k: _t(v) for k, v in p.items()}, _t(ids))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_kernel_choice_picks_the_plain_product(monkeypatch):
    """Under ``kernel_choice(False)`` (the model's plain switch) a
    quantized product never reaches the A10 wrapper; with None it does on
    a CUDA device (faked here by the resolver)."""
    calls = []
    monkeypatch.setattr(L, "quant_linear",
                        lambda *a: calls.append(1) or ql.quant_linear(*a))
    monkeypatch.setattr(L, "resolve_use_kernels",
                        lambda flag, dev: flag is None or bool(flag))
    p = {k: _t(v) for k, v in _qparam(16, 64, 8, 32).items()}
    x = torch.ones(2, 64)
    with L.kernel_choice(False):
        L.linear(x, p)
        with L.kernel_choice(None):
            L.linear(x, p)
        L.linear(x, p)
    assert calls == [1]
    L.linear(x, p)
    assert calls == [1, 1]


MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128)
H_MOE = 128


def _interpret_gmm(tile_m=8):
    gmm = megablox.gmm

    def run(lhs, rhs, group_sizes, **kw):
        return gmm(lhs, rhs, group_sizes, interpret=True,
                   tiling=(tile_m, rhs.shape[1], rhs.shape[2]), **kw)

    return run


def _moe_params(bits, g, biases):
    e, h, i = MOE["num_experts"], H_MOE, MOE["moe_intermediate_size"]
    rng = np.random.default_rng(bits + g)
    p = {"gate": {"weight": _weights((e, h), 1)}, "experts": {}}
    for name, shape in (("gate_proj", (e, i, h)), ("up_proj", (e, i, h)),
                        ("down_proj", (e, h, i))):
        q, s, b = jq.quantize_array(
            (rng.standard_normal(shape) * shape[-1] ** -0.5).astype(
                np.float32), bits, g)
        p["experts"][name] = {"qweight": q, "scales": s,
                              **({"biases": b} if biases else {})}
    p["shared_expert"] = {
        k: _qparam(*shape, bits, g, biases, seed=j)
        for j, (k, shape) in enumerate((("gate_proj", (128, h)),
                                        ("up_proj", (128, h)),
                                        ("down_proj", (h, 128))))}
    return p


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("biases", [True, False], ids=["biases", "none"])
@pytest.mark.parametrize("bits,g", QUANT)
def test_quantized_moe_matches_jax(monkeypatch, bits, g, biases):
    p = _moe_params(bits, g, biases)
    x = np.random.default_rng(5).standard_normal((16, H_MOE)).astype(
        np.float32)
    jcfg, tcfg = JMoEConfig(**MOE), MoEConfig(**MOE)
    jp, tp = _to(p, jnp.asarray), _to(p, _t)
    ref_fb = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jp, jcfg,
                                     use_megablox=False))
    monkeypatch.setattr(megablox, "gmm", _interpret_gmm())
    ref_mb = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jp, jcfg,
                                     use_megablox=True))
    got = tmoe.moe_ffn(_t(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), ref_mb, **TOL)
    np.testing.assert_allclose(got.numpy(), ref_fb, **TOL)
    assert torch.equal(tmoe.moe_ffn(_t(x), tp, tcfg, kernel=False), got)
    w, ids = tmoe.route_topk(_t(x), tp["gate"]["weight"], tcfg)
    jw, jids = jmoe.route_topk(jnp.asarray(x), jp["gate"]["weight"], jcfg)
    np.testing.assert_allclose(
        tmoe._moe_fallback(_t(x), tp, w, ids).numpy(),
        np.asarray(jmoe._moe_fallback(jnp.asarray(x), jp, jw, jids, 8, 0)),
        **TOL)


def test_quantized_shared_expert_multiplies_through_the_a10_wrapper(
        monkeypatch):
    """A quantized shared expert's three products go to the A10 wrapper
    when kernels are chosen (a CUDA device, faked here by the resolver)
    and never dequantize its weights first (``get_weight``); under the
    model's plain switch they take the plain version, with the same
    result."""
    calls = []
    monkeypatch.setattr(L, "quant_linear",
                        lambda *a: calls.append(1) or ql.quant_linear(*a))
    monkeypatch.setattr(L, "resolve_use_kernels",
                        lambda flag, dev: flag is None or bool(flag))
    dequantized = []
    monkeypatch.setattr(L, "dequantize_weight", lambda p: (
        dequantized.append(p) or tq.dequantize_weight(p)))
    p = _to(_moe_params(8, 64, True), _t)
    x = _t(np.random.default_rng(6).standard_normal((5, H_MOE)).astype(
        np.float32))
    got = tmoe.moe_ffn(x, p, MoEConfig(**MOE))
    assert calls == [1, 1, 1] and not dequantized
    with L.kernel_choice(False):
        plain = tmoe.moe_ffn(x, p, MoEConfig(**MOE))
    assert calls == [1, 1, 1]
    assert torch.equal(got, plain)


def test_grouped_matmul_q_plain_is_the_dequantized_product():
    p = _moe_params(4, 32, True)["experts"]["up_proj"]
    tp = {k: _t(v) for k, v in p.items()}
    lhs = torch.randn(10, H_MOE, generator=torch.Generator().manual_seed(0))
    offs = torch.tensor([0, 0, 3, 3, 4, 9, 9, 10, 10], dtype=torch.int32)
    got = ql.grouped_matmul_q(lhs, tp, offs)
    w = tq.dequantize_weight(tp)
    for gi in range(8):
        a, b = int(offs[gi]), int(offs[gi + 1])
        torch.testing.assert_close(got[a:b], lhs[a:b] @ w[gi].t(),
                                   atol=1e-5, rtol=1e-5)


def test_wrapper_checks_raise_by_name():
    """What the kernels do not take raises before a launch (checked on CPU
    tensors through the shared checker)."""
    bf = torch.bfloat16

    def check(k=64, g=32, x_dtype=bf, s_dtype=bf, out=bf, variant=None,
              q_dtype=torch.uint8, biases=True):
        x = torch.zeros(3, k, dtype=x_dtype)
        q = torch.zeros(8, k, dtype=q_dtype)
        s = torch.zeros(8, k // g, dtype=s_dtype)
        return ql._check_quant_args("quant_linear", x, q, s,
                                    s if biases else None, out, variant)

    assert check() == 32
    assert check(k=256, g=128, out=torch.float32, biases=False) == 128
    with pytest.raises(ValueError, match="group size 16"):
        check(g=16)
    with pytest.raises(ValueError, match="group size 48"):
        check(k=96, g=48)
    with pytest.raises(TypeError, match="bf16 activations"):
        check(x_dtype=torch.float32)
    with pytest.raises(TypeError, match="bf16 scales"):
        check(s_dtype=torch.float32)
    with pytest.raises(TypeError, match="uint8"):
        check(q_dtype=torch.int8)
    with pytest.raises(TypeError, match="output dtype"):
        check(out=torch.float16)
    with pytest.raises(ValueError, match="variant"):
        check(variant="fast")
    assert ql.variant_for(7) == "decode" and ql.variant_for(749) == "prefill"
    assert ql.variant_for(7, "prefill") == "prefill"
    assert ql.grouped_variant_for(56) == "decode"
    assert ql.grouped_variant_for(16384) == "prefill"


def test_kernel_constants_match_the_source():
    with open(os.path.join(ck.CSRC, "quant_linear.cu")) as f:
        src = f.read()
    c = {m.group(1): int(m.group(2)) for m in
         re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert c["kDecodeMaxRows"] == ql.DECODE_MAX_ROWS
    assert c["kQDecodeMaxRows"] == ql.GROUPED_DECODE_MAX_ROWS
    assert "quant_linear" in ck.KERNELS and "grouped_gemm_q" in ck.KERNELS
    for name in ("pk_quant_linear", "pk_grouped_gemm_q"):
        params = re.search(name + r"\(([^)]*)\)", src).group(1)
        assert params.split(",")[-2].split()[-1] == "variant", name
