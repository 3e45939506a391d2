"""Plain ops of the PyTorch port against parallax_tpu's on the same inputs:
rope (incl. scaled variants and partial rotary), the KV cache layout and
scatter, ragged indexing, RMSNorm and the SwiGLU MLP (f32, atol = rtol =
1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.models import layers as jl
from parallax_tpu.ops import kv_cache_ops as jkv
from parallax_tpu.ops import ragged as jragged
from parallax_tpu.ops import rope as jrope
from parallax_tpu_torch.models import layers as tl
from parallax_tpu_torch.ops import kv_cache_ops as tkv
from parallax_tpu_torch.ops import ragged as tragged
from parallax_tpu_torch.ops import rope as trope

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("scaling,partial", [
    (None, 1.0),
    ({"rope_type": "linear", "factor": 4.0}, 1.0),
    ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
      "high_freq_factor": 4.0, "original_max_position_embeddings": 64}, 1.0),
    ({"rope_type": "yarn", "factor": 4.0,
      "original_max_position_embeddings": 64}, 1.0),
    (None, 0.5),
])
def test_rope_tables_and_rotation(scaling, partial):
    head_dim, theta, max_pos = 32, 10000.0, 128
    inv_j = jrope.rope_frequencies(head_dim, theta, scaling, partial)
    inv_t = trope.rope_frequencies(head_dim, theta, scaling, partial)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), **TOL)
    cos_j, sin_j = jrope.rope_table(inv_j, max_pos, 1.3)
    cos_t, sin_t = trope.rope_table(inv_t, max_pos, 1.3)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, max_pos, size=9).astype(np.int32)
    for jf, tf in ((jrope.apply_rope, trope.apply_rope),
                   (jrope.apply_rope_interleaved, trope.apply_rope_interleaved)):
        ref = np.asarray(jf(jnp.asarray(x), jnp.asarray(pos), cos_j, sin_j))
        got = tf(_t(x), _t(pos), cos_t, sin_t).numpy()
        np.testing.assert_allclose(got, ref, **TOL)
        # 2-D form (MLA rope parts).
        ref2 = np.asarray(jf(jnp.asarray(x[:, 0]), jnp.asarray(pos),
                             cos_j, sin_j))
        got2 = tf(_t(x[:, 0]), _t(pos), cos_t, sin_t).numpy()
        np.testing.assert_allclose(got2, ref2, **TOL)


def test_kv_cache_layout_and_scatter():
    rng = np.random.default_rng(1)
    p, page, hkv, d, t = 6, 4, 2, 8, 7
    assert tuple(tkv.new_kv_pages(p, page, hkv, d, torch.float32).shape) == (
        jkv.new_kv_pages(p, page, hkv, d, jnp.float32).shape
    )
    cache = rng.standard_normal((p, page, 2 * hkv, d)).astype(np.float32)
    k = rng.standard_normal((t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((t, hkv, d)).astype(np.float32)
    # Padding (-1), an out-of-range slot (dropped), page-boundary slots.
    slots = np.array([5, -1, 3, 4, p * page + 2, 23, 0], np.int32)
    np.testing.assert_array_equal(
        tkv.interleave_kv(_t(k), _t(v)).numpy(),
        np.asarray(jkv.interleave_kv(jnp.asarray(k), jnp.asarray(v))),
    )
    ref = np.asarray(jkv.reshape_and_cache(
        jnp.asarray(cache), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(slots),
    ))
    mine = _t(cache.copy())
    out = tkv.reshape_and_cache(mine, _t(k), _t(v), _t(slots))
    assert out is mine                      # in place
    np.testing.assert_array_equal(mine.numpy(), ref)   # bitwise
    # The A0 wrapper takes the same plain scatter on CPU tensors.
    mine2 = _t(cache.copy())
    tkv.kv_append(mine2, _t(k), _t(v), _t(slots))
    np.testing.assert_array_equal(mine2.numpy(), ref)


@pytest.mark.parametrize("q_lens,kv_lens", [
    ([3, 1, 4], [5, 9, 4]),
    ([1, 1, 1, 0], [7, 1, 16, 0]),
    ([8], [8]),
])
def test_ragged_positions_and_page_chunks(q_lens, kv_lens):
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    t = int(cu[-1]) + 3                      # padding tokens past the end
    kl = np.asarray(kv_lens, np.int32)
    s_ref, p_ref = jragged.ragged_token_positions(
        jnp.asarray(kl), jnp.asarray(cu), t, len(q_lens)
    )
    s_got, p_got = tragged.ragged_token_positions(_t(kl), _t(cu), t,
                                                  len(q_lens))
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_ref))
    pages = np.arange(len(q_lens) * 5, dtype=np.int32).reshape(-1, 5)
    for rows in (None, 8, 16):
        ref = jragged.page_chunks(jnp.asarray(pages), 4, rows)
        got = tragged.page_chunks(_t(pages), 4, rows)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert tuple(got[1:]) == tuple(ref[1:])


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5, 48)) * 3).astype(np.float32)
    w = rng.standard_normal((48,)).astype(np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                 offset=offset))
    got = tl.rms_norm(_t(x), _t(w), 1e-6, offset=offset).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_linear_and_swiglu_mlp():
    rng = np.random.default_rng(3)
    h, inter = 32, 64
    x = rng.standard_normal((6, h)).astype(np.float32)

    def dense(o, i, bias=False):
        p = {"weight": (rng.standard_normal((o, i)) * i ** -0.5)
             .astype(np.float32)}
        if bias:
            p["bias"] = rng.standard_normal((o,)).astype(np.float32)
        return p

    mlp = {"gate_proj": dense(inter, h), "up_proj": dense(inter, h),
           "down_proj": dense(h, inter)}
    jt = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in mlp.items()}
    tt = {k: {n: _t(a) for n, a in v.items()} for k, v in mlp.items()}
    ref = np.asarray(jl.swiglu_mlp(jnp.asarray(x), jt))
    np.testing.assert_allclose(tl.swiglu_mlp(_t(x), tt).numpy(), ref, **TOL)
    biased = dense(16, h, bias=True)
    ref = np.asarray(jl.linear(jnp.asarray(x),
                               {n: jnp.asarray(a) for n, a in biased.items()}))
    got = tl.linear(_t(x), {n: _t(a) for n, a in biased.items()}).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    ref = np.asarray(jl.lm_head_logits(
        jnp.asarray(x), {"weight": jnp.asarray(biased["weight"])}
    ))
    got = tl.lm_head_logits(_t(x), {"weight": _t(biased["weight"])}).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
