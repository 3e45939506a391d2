"""The port's MoE FFN (parallax_tpu_torch/models/moe.py) and its grouped
product (ops/grouped_matmul.py) against parallax_tpu/models/moe.py on the
same numpy inputs, in float32 on the CPU.

- ``route_topk``: softmax and sigmoid scoring, the correction bias,
  ``n_group``/``topk_group`` (both group scores) and forced ties; the expert
  ids must be EQUAL (ties to the lower index, as ``jax.lax.top_k``) and the
  weights within 1e-5.
- the plain grouped product against megablox ``gmm`` in interpret mode,
  with empty and 1-row groups: within 1e-5 (f32 summation order).
- ``moe_ffn`` against the JAX ``moe_ffn`` on its masked-loop path and on
  its megablox path (``gmm`` run in interpret mode by a test-side patch),
  with and without a Qwen2-MoE shared expert and gate: within 1e-5.
- the A4 kernel's tiling (csrc/grouped_gemm.cu) through its Python twins:
  each variant's tile map covers every row once without straddling a group
  and within the launch's static bound, a product computed tile by tile
  along it equals megablox ``gmm`` (1e-5), and each ring fits the H100's
  shared memory. The kernel itself runs only on the card (chip_smoke.py).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st
from jax.experimental.pallas.ops.tpu import megablox

from parallax_tpu.config import MoEConfig as JMoEConfig
from parallax_tpu.models import moe as jmoe
from parallax_tpu_torch.config import MoEConfig
from parallax_tpu_torch.models import moe as tmoe
from parallax_tpu_torch.ops import grouped_matmul as gm
from parallax_tpu_torch.ops.grouped_matmul import (
    grouped_matmul,
    grouped_matmul_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)
H, T = 32, 16


def _configs(**kw):
    return JMoEConfig(**kw), MoEConfig(**kw)


ROUTES = {
    # Qwen3-MoE: softmax, renormalised top-k.
    "softmax-norm": (dict(num_experts=8, num_experts_per_tok=2,
                          moe_intermediate_size=16), None),
    # Qwen2-MoE: softmax, raw top-k probabilities, a scaling factor.
    "softmax-raw-scaled": (dict(num_experts=8, num_experts_per_tok=3,
                                moe_intermediate_size=16,
                                norm_topk_prob=False,
                                routed_scaling_factor=2.5), None),
    # DeepSeek-V3: sigmoid + correction bias + noaux_tc group limit.
    "sigmoid-bias-groups": (dict(num_experts=16, num_experts_per_tok=4,
                                 moe_intermediate_size=16, n_group=4,
                                 topk_group=2, scoring_func="sigmoid",
                                 topk_method="noaux_tc",
                                 routed_scaling_factor=2.5), "bias"),
    # DeepSeek-V2: a group scores as its best expert.
    "softmax-group-greedy": (dict(num_experts=16, num_experts_per_tok=3,
                                  moe_intermediate_size=16, n_group=4,
                                  topk_group=2,
                                  topk_method="group_limited_greedy"), None),
    "sigmoid-bias": (dict(num_experts=8, num_experts_per_tok=2,
                          moe_intermediate_size=16,
                          scoring_func="sigmoid"), "bias"),
}


def _route_inputs(e, seed=0, tie_rows=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, H)).astype(np.float32)
    w = (rng.standard_normal((e, H)) * H ** -0.5).astype(np.float32)
    if tie_rows is not None:
        w = w[np.asarray(tie_rows)]          # duplicated rows: exact ties
    bias = (rng.standard_normal(e) * 0.1).astype(np.float32)
    return x, w, bias


def _route_both(kw, x, w, bias):
    jcfg, tcfg = _configs(**kw)
    jw, jids = jmoe.route_topk(jnp.asarray(x), jnp.asarray(w), jcfg,
                               bias=None if bias is None
                               else jnp.asarray(bias))
    tw, tids = tmoe.route_topk(torch.from_numpy(x), torch.from_numpy(w),
                               tcfg, bias=None if bias is None
                               else torch.from_numpy(bias))
    return np.asarray(jw), np.asarray(jids), tw.numpy(), tids.numpy()


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_topk_matches_jax(name):
    kw, bias_on = ROUTES[name]
    x, w, bias = _route_inputs(kw["num_experts"])
    jw, jids, tw, tids = _route_both(kw, x, w,
                                     bias if bias_on else None)
    assert tids.dtype == np.int32 and tw.dtype == np.float32
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tw, jw, **TOL)


@pytest.mark.parametrize("kw,rows", [
    # Experts 0, 2, 4, 7 share one router row, 1 and 5 another: every
    # token's scores hold exact ties, many at the k-th place.
    (dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16),
     [0, 1, 0, 2, 0, 1, 2, 0]),
    (dict(num_experts=8, num_experts_per_tok=3, moe_intermediate_size=16,
          scoring_func="sigmoid"), [0, 1, 0, 2, 0, 1, 2, 0]),
    # Two groups with identical scores: the lower group must win.
    (dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=16,
          n_group=2, topk_group=1, scoring_func="sigmoid",
          topk_method="noaux_tc"), [0, 1, 2, 3, 0, 1, 2, 3]),
], ids=["softmax-ties", "sigmoid-ties", "group-tie"])
def test_route_topk_forced_ties_take_the_lower_index(kw, rows):
    x, w, _ = _route_inputs(kw["num_experts"], seed=3, tie_rows=rows)
    jw, jids, tw, tids = _route_both(kw, x, w, None)
    # Premise: the top k + 1 scores really hold exact ties.
    logits = x @ w.T
    k = kw["num_experts_per_tok"]
    srt = -np.sort(-logits, axis=-1)
    assert (np.diff(srt[:, :k + 1], axis=-1) == 0).any()
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tw, jw, **TOL)
    # Among tied experts the lower index comes first.
    sel = np.take_along_axis(logits, tids.astype(np.int64), axis=-1)
    for r in range(T):
        for a in range(k - 1):
            if sel[r, a] == sel[r, a + 1]:
                assert tids[r, a] < tids[r, a + 1]


def _interpret_gmm(tile_m=8):
    """megablox gmm in interpret mode with one tile over K and N (the test
    shapes are far below its default 128 tiles)."""
    gmm = megablox.gmm

    def run(lhs, rhs, group_sizes, **kw):
        return gmm(lhs, rhs, group_sizes, interpret=True,
                   tiling=(tile_m, rhs.shape[1], rhs.shape[2]), **kw)

    return run


def test_grouped_matmul_plain_matches_megablox_gmm():
    rng = np.random.default_rng(1)
    sizes = np.array([5, 0, 1, 10, 0, 8], np.int32)    # empty, 1-row groups
    m, k, n = int(sizes.sum()), 32, 40
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), n, k)).astype(np.float32)
    ref = np.asarray(_interpret_gmm()(
        jnp.asarray(lhs), jnp.swapaxes(jnp.asarray(rhs), 1, 2),
        jnp.asarray(sizes),
    ))
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                               .astype(np.int32))
    got = grouped_matmul_plain(torch.from_numpy(lhs), torch.from_numpy(rhs),
                               offsets)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # On CPU tensors the wrapper IS the plain version.
    assert torch.equal(grouped_matmul(torch.from_numpy(lhs),
                                      torch.from_numpy(rhs), offsets), got)


@pytest.mark.parametrize("bad,match", [
    (dict(offsets=[0, 3, 20]), "from 0 to M"),
    (dict(offsets=[0, 24]), r"\[E \+ 1\]"),
    (dict(rhs_k=16), "lhs"),
])
def test_grouped_matmul_plain_rejects_bad_shapes(bad, match):
    lhs = torch.zeros((24, 32))
    rhs = torch.zeros((2, 8, bad.get("rhs_k", 32)))
    offsets = torch.tensor(bad.get("offsets", [0, 10, 24]),
                           dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        grouped_matmul_plain(lhs, rhs, offsets)


VARIANTS = ["prefill", "decode"]


def _offsets(sizes) -> list[int]:
    return [0] + np.cumsum(np.asarray(sizes, np.int64)).tolist()


# Group sizes: skewed, with empty and 1-row groups, M < E, E = 1 and every
# row in one group; either side of both tile heights and of the variant
# threshold.
_SIZES = st.lists(
    st.one_of(st.just(0), st.just(1), st.integers(0, 20),
              st.integers(100, 400)),
    min_size=1, max_size=40,
)


@pytest.mark.parametrize("variant", VARIANTS)
@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(sizes=_SIZES)
@example(sizes=[0, 5, 0, 1, 1, 0])              # M < E
@example(sizes=[7])                             # E = 1
@example(sizes=[0, 0, 300, 0])                  # every row in one group
@example(sizes=[128, 129, 1, 16, 17, 0, 256])   # tile-height edges
@example(sizes=[0, 0, 0])                       # M = 0
def test_grouped_gemm_tile_map_covers_every_row_once(variant, sizes):
    offs = _offsets(sizes)
    m, e = offs[-1], len(sizes)
    bm = gm.TILE_ROWS[variant]
    tiles = gm.tile_map(offs, variant)
    seen = np.zeros(m, np.int64)
    for g, r0, end in tiles:
        # No tile straddles two groups: it starts inside group g and its
        # stored rows end with the group.
        assert offs[g] <= r0 < end == offs[g + 1]
        seen[r0:min(r0 + bm, end)] += 1
    assert (seen == 1).all()
    assert [t[0] for t in tiles] == sorted(t[0] for t in tiles)
    assert len(tiles) <= gm.grid_tiles(m, e, variant)


def _tiled_plain(lhs, rhs, offsets, variant):
    """The product as the kernel cuts it: per tile of the twin's map and
    per column tile, all BM rows multiplied (rows past the group's end are
    the next group's, or zeros past M, as TMA loads them) and only the
    group's rows stored; the N tail is a shorter weight slice."""
    m, k = lhs.shape
    n = rhs.shape[1]
    bm, bn = gm.TILE_ROWS[variant], gm.TILE_COLS[variant]
    rows = torch.cat([lhs, torch.zeros((bm, k), dtype=lhs.dtype)])
    out = torch.full((m, n), float("nan"))
    for g, r0, end in gm.tile_map(offsets.tolist(), variant):
        keep = min(r0 + bm, end) - r0
        for c0 in range(0, n, bn):
            y = rows[r0:r0 + bm] @ rhs[g, c0:c0 + bn].t()
            out[r0:r0 + keep, c0:c0 + bn] = y[:keep]
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_grouped_gemm_tiles_match_megablox_gmm(variant):
    rng = np.random.default_rng(3)
    # Empty and 1-row groups, groups of 17 and 150 rows (two decode /
    # prefill tiles), N over two 256-column tiles, K not a multiple of 64.
    sizes = np.array([5, 0, 1, 17, 0, 150, 1, 10], np.int32)   # M 184: gmm takes M in 8s
    m, k, n = int(sizes.sum()), 40, 300
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), n, k)).astype(np.float32)
    ref = np.asarray(_interpret_gmm()(
        jnp.asarray(lhs), jnp.swapaxes(jnp.asarray(rhs), 1, 2),
        jnp.asarray(sizes),
    ))
    offsets = torch.tensor(_offsets(sizes), dtype=torch.int32)
    got = _tiled_plain(torch.from_numpy(lhs), torch.from_numpy(rhs), offsets,
                       variant)
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _source_constants() -> dict[str, int]:
    from parallax_tpu_torch.ops import cuda_kernels as ck

    with open(os.path.join(ck.CSRC, "grouped_gemm.cu")) as f:
        src = f.read()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}


def test_grouped_gemm_twins_use_the_kernel_constants():
    c = _source_constants()
    assert c["kDecodeMaxRows"] == gm.DECODE_MAX_ROWS
    assert c["kBK"] == gm.BK
    for v, p in (("prefill", "kP"), ("decode", "kD")):
        assert c[p + "BM"] == gm.TILE_ROWS[v]
        assert c[p + "BN"] == gm.TILE_COLS[v]
        assert c[p + "Stages"] == gm.STAGES[v]
    assert gm.variant_for(56) == "decode"          # a 7-row decode step
    assert gm.variant_for(64 * 8) == "decode"      # max_batch_size 64, top-8
    assert gm.variant_for(gm.DECODE_MAX_ROWS + 1) == "prefill"
    assert gm.variant_for(2048 * 8) == "prefill"   # a prefill step
    assert gm.variant_for(56, "prefill") == "prefill"


@pytest.mark.parametrize("variant", VARIANTS)
def test_grouped_gemm_ring_fits_shared_memory(variant):
    """Each variant's ring fits the 227 KB a block may use; the decode
    variant's blocks are small enough that three share an SM (228 KB, 1 KB
    reserved a block), keeping 32 KB or more of weights in flight there."""
    from parallax_tpu_torch.ops.decode_fused import SMEM_LIMIT

    smem = gm.smem_bytes(variant)
    assert smem <= SMEM_LIMIT
    # TMA writes whole 1024-byte swizzle atoms: every tile of a stage.
    for rows in (gm.TILE_ROWS[variant], gm.TILE_COLS[variant], 64):
        assert rows * gm.BK * 2 % 1024 == 0
    if variant == "decode":
        assert 3 * (smem + 1024 + 16) <= 228 * 1024
        weights = gm.STAGES[variant] * gm.TILE_COLS[variant] * gm.BK * 2
        assert 3 * weights >= 32 * 1024
    else:
        assert gm.STAGES[variant] >= 4


def _moe_params(e, i, shared, seed=2):
    rng = np.random.default_rng(seed)

    def nrm(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)

    p = {"gate": {"weight": nrm((e, H), H)},
         "experts": {"gate_proj": nrm((e, i, H), H),
                     "up_proj": nrm((e, i, H), H),
                     "down_proj": nrm((e, H, i), i)}}
    if shared:
        si = 24
        p["shared_expert"] = {"gate_proj": {"weight": nrm((si, H), H)},
                              "up_proj": {"weight": nrm((si, H), H)},
                              "down_proj": {"weight": nrm((H, si), si)}}
        p["shared_expert_gate"] = {"weight": nrm((1, H), H)}
    return p


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


MOES = {
    "qwen3": dict(num_experts=8, num_experts_per_tok=2,
                  moe_intermediate_size=16),
    "qwen2": dict(num_experts=8, num_experts_per_tok=3,
                  moe_intermediate_size=16, norm_topk_prob=False),
}


def _moe_case(name, shared):
    kw = MOES[name]
    p = _moe_params(kw["num_experts"], kw["moe_intermediate_size"], shared)
    x = np.random.default_rng(5).standard_normal((T, H)).astype(np.float32)
    jcfg, tcfg = _configs(**kw)
    return x, p, jcfg, tcfg


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("name", sorted(MOES))
def test_moe_ffn_matches_jax_fallback(name, shared):
    x, p, jcfg, tcfg = _moe_case(name, shared)
    ref = np.asarray(jmoe.moe_ffn(jnp.asarray(x), _to(p, jnp.asarray), jcfg,
                                  use_megablox=False))
    tp = _to(p, torch.from_numpy)
    tx = torch.from_numpy(x)
    got = tmoe.moe_ffn(tx, tp, tcfg)
    assert got.dtype == torch.float32 and got.shape == (T, H)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # The explicit plain reference is the same computation on the CPU, and
    # the masked loop agrees with the JAX package's masked loop.
    assert torch.equal(tmoe.moe_ffn(tx, tp, tcfg, kernel=False), got)
    jw, jids = jmoe.route_topk(jnp.asarray(x), jnp.asarray(p["gate"]["weight"]),
                               jcfg)
    jfb = jmoe._moe_fallback(jnp.asarray(x), _to(p, jnp.asarray), jw, jids,
                             tcfg.num_experts, 0)
    tw, tids = tmoe.route_topk(tx, tp["gate"]["weight"], tcfg)
    np.testing.assert_allclose(
        tmoe._moe_fallback(tx, tp, tw, tids).numpy(), np.asarray(jfb), **TOL)


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_moe_ffn_matches_jax_megablox_path(monkeypatch, shared):
    x, p, jcfg, tcfg = _moe_case("qwen3", shared)
    assert (T * tcfg.num_experts_per_tok) % 8 == 0      # gmm's m tiling
    monkeypatch.setattr(megablox, "gmm", _interpret_gmm())
    ref = np.asarray(jmoe.moe_ffn(jnp.asarray(x), _to(p, jnp.asarray), jcfg,
                                  use_megablox=True))
    got = tmoe.moe_ffn(torch.from_numpy(x), _to(p, torch.from_numpy), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_moe_ffn_bf16_rounds_like_the_grouped_reference():
    """In bf16 the port rounds where ``_moe_megablox`` does: gate/up in
    f32, the activation rounded to bf16, the down product and the combine
    in f32, one final cast. Checked against that arithmetic written out."""
    x, p, _, tcfg = _moe_case("qwen3", False)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tp = _to(p, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    got = tmoe.moe_ffn(tx, tp, tcfg)
    assert got.dtype == torch.bfloat16
    w, ids = tmoe.route_topk(tx, tp["gate"]["weight"], tcfg)
    ex = tp["experts"]
    want = torch.zeros((T, H))
    for t in range(T):
        for s in range(tcfg.num_experts_per_tok):
            e = int(ids[t, s])
            xf = tx[t].float()
            g = ex["gate_proj"][e].float() @ xf
            u = ex["up_proj"][e].float() @ xf
            h = (torch.nn.functional.silu(g) * u).to(torch.bfloat16)
            want[t] += (ex["down_proj"][e].float() @ h.float()) * w[t, s]
    np.testing.assert_allclose(got.float().numpy(),
                               want.to(torch.bfloat16).float().numpy(),
                               atol=1e-2, rtol=1e-2)
