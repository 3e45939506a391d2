"""The port's samplers against parallax_tpu's on shared noise.

The JAX side's noise comes from its own ``row_gumbel`` and is handed to the
port as numpy, so both packages sample from the same logits and noise and
must pick exactly the same tokens: the plain version of the fused sampler
(A3, what the wrapper runs on CPU tensors) against
``fused_sample_topk_pallas`` in interpret mode and ``sample_tokens``, and
the port's ``sample_tokens`` against JAX's, k-th-value ties included. Also:
``top_p >= 1`` is an exact no-op, and seeded rows are reproducible across
batch compositions inside the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops.decode_fused_pallas import fused_sample_topk_pallas
from parallax_tpu.ops.sampling import row_gumbel as j_row_gumbel
from parallax_tpu.ops.sampling import sample_tokens as j_sample_tokens
from parallax_tpu_torch.ops.sampling import (
    fused_sample_topk,
    fused_sample_topk_plain,
    greedy_tokens,
    row_gumbel,
    sample_tokens,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(logits, temp, top_k, top_p, min_p, key, seeds=None, steps=None):
    """JAX sample_tokens and its noise, as numpy."""
    b, v = logits.shape
    kw = {} if seeds is None else dict(seeds=jnp.asarray(seeds),
                                       out_steps=jnp.asarray(steps))
    ref = j_sample_tokens(
        jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), jnp.asarray(min_p), **kw,
    )
    g = j_row_gumbel(key, b, v,
                     None if seeds is None else jnp.asarray(seeds),
                     None if steps is None else jnp.asarray(steps))
    return np.asarray(ref), np.asarray(g)


@pytest.mark.parametrize("seeded", [False, True])
def test_fused_and_split_samplers_match_jax_exactly(seeded):
    rng = np.random.default_rng(3)
    b, v = 8, 257
    logits = (rng.standard_normal((b, v)) * 3.0).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.0, 0.5, 2.0, 1.0], np.float32)
    top_k = np.array([0, 5, 1, 50, 0, 0, 400, 7], np.int32)
    ones, zeros = np.ones((b,), np.float32), np.zeros((b,), np.float32)
    seeds = steps = None
    if seeded:
        seeds = np.array([3, 7, -1, 11, -1, 5, -1, 9], np.int32)
        steps = np.arange(b, dtype=np.int32)
    key = jax.random.key(42)
    ref, g = _both(logits, temp, top_k, ones, zeros, key, seeds, steps)
    pallas = np.asarray(fused_sample_topk_pallas(
        jnp.asarray(logits), jnp.asarray(g), jnp.asarray(temp),
        jnp.asarray(top_k), interpret=True,
    ))
    assert np.array_equal(pallas, ref)
    plain = fused_sample_topk_plain(_t(logits), _t(g), _t(temp), _t(top_k))
    assert np.array_equal(plain.numpy(), ref)
    wrapped = fused_sample_topk(_t(logits), _t(g), _t(temp), _t(top_k))
    assert np.array_equal(wrapped.numpy(), ref)
    split = sample_tokens(_t(logits), _t(temp), _t(top_k), _t(ones),
                          _t(zeros), _t(g))
    assert np.array_equal(split.numpy(), ref)
    greedy = greedy_tokens(_t(logits)).numpy()
    assert np.array_equal(greedy[temp <= 0], ref[temp <= 0])


def test_split_sampler_top_p_min_p_match_jax():
    rng = np.random.default_rng(11)
    b, v = 6, 300
    logits = (rng.standard_normal((b, v)) * 2.5).astype(np.float32)
    temp = np.array([0.9, 1.0, 0.6, 1.2, 0.8, 1.0], np.float32)
    top_k = np.array([0, 20, 0, 0, 8, 0], np.int32)
    top_p = np.array([0.9, 0.5, 1.0, 0.95, 1.0, 0.7], np.float32)
    min_p = np.array([0.0, 0.0, 0.05, 0.0, 0.1, 0.02], np.float32)
    key = jax.random.key(9)
    ref, g = _both(logits, temp, top_k, top_p, min_p, key)
    got = sample_tokens(_t(logits), _t(temp), _t(top_k), _t(top_p),
                        _t(min_p), _t(g))
    assert np.array_equal(got.numpy(), ref)


def test_topk_tie_semantics_match_jax():
    """Value-threshold top-k keeps ties at the k-th value in every sampler."""
    v = 64
    row = np.full((v,), -5.0, np.float32)
    row[[4, 9, 23]] = 2.0          # three-way tie at the top
    row[30] = 1.0
    logits = np.stack([row, row, row])
    temp = np.ones((3,), np.float32)
    top_k = np.array([2, 1, 3], np.int32)   # k-th value tied every way
    ones, zeros = np.ones((3,), np.float32), np.zeros((3,), np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        ref, g = _both(logits, temp, top_k, ones, zeros, key)
        pallas = np.asarray(fused_sample_topk_pallas(
            jnp.asarray(logits), jnp.asarray(g), jnp.asarray(temp),
            jnp.asarray(top_k), interpret=True,
        ))
        plain = fused_sample_topk_plain(_t(logits), _t(g), _t(temp),
                                        _t(top_k)).numpy()
        split = sample_tokens(_t(logits), _t(temp), _t(top_k), _t(ones),
                              _t(zeros), _t(g)).numpy()
        assert np.array_equal(pallas, ref)
        assert np.array_equal(plain, ref)
        assert np.array_equal(split, ref)
        assert set(plain.tolist()) <= {4, 9, 23}


def test_top_p_one_is_an_exact_no_op():
    """f32 cumsum can reach 1.0 before the last rank; top_p >= 1 must still
    keep every token. Noise that is huge on one tail token makes it the
    draw exactly when the tail is kept."""
    b, v = 2, 4096
    logits = np.full((b, v), -30.0, np.float32)
    logits[:, 0] = 40.0                       # probability ~1 at rank 0
    tail = np.array([4000, 17])
    g = np.zeros((b, v), np.float32)
    g[np.arange(b), tail] = 1e9
    temp = np.ones((b,), np.float32)
    top_k = np.zeros((b,), np.int32)
    for top_p in (1.0, 1.5):
        got = sample_tokens(_t(logits), _t(temp), _t(top_k),
                            torch.full((b,), top_p), torch.zeros(b), _t(g))
        assert got.tolist() == tail.tolist()
    ref = j_sample_tokens(
        jnp.asarray(logits), jax.random.key(0), jnp.asarray(temp),
        jnp.asarray(top_k), jnp.ones((b,)), jnp.zeros((b,)),
    )
    # JAX draws its own noise, so it cannot be steered to the tail token;
    # its rank-0 pick confirms the logits are as peaked as intended.
    assert np.asarray(ref).tolist() == [0, 0]
    plain = fused_sample_topk_plain(_t(logits), _t(g), _t(temp), _t(top_k))
    assert plain.tolist() == tail.tolist()


def test_seeded_rows_reproducible_across_batch_compositions():
    v = 97
    rng = np.random.default_rng(5)
    row = (rng.standard_normal(v) * 2).astype(np.float32)
    # Row with seed 7 at output step 3: alone at step 0 ...
    g_a = row_gumbel(1, v, base_seed=0, step=0, seeds=[7], out_steps=[3])
    # ... and third in a batch of four at another engine step and seed.
    g_b = row_gumbel(4, v, base_seed=123, step=55, seeds=[-1, 2, 7, -1],
                     out_steps=[0, 9, 3, 0])
    assert torch.equal(g_a[0], g_b[2])
    # Unseeded rows depend on (engine seed, step), seeded rows do not.
    g_c = row_gumbel(4, v, base_seed=123, step=56, seeds=[-1, 2, 7, -1],
                     out_steps=[0, 9, 3, 0])
    assert not torch.equal(g_b[0], g_c[0])
    assert torch.equal(g_b[1], g_c[1])
    logits_a = _t(row[None])
    logits_b = _t(np.stack([row * 0.5, row * 2, row, row - 1]))
    kw = dict(top_p=torch.ones(1), min_p=torch.zeros(1))
    tok_a = sample_tokens(logits_a, torch.tensor([0.8]),
                          torch.tensor([5], dtype=torch.int32),
                          kw["top_p"], kw["min_p"], g_a)
    tok_b = sample_tokens(logits_b, torch.full((4,), 0.8),
                          torch.full((4,), 5, dtype=torch.int32),
                          torch.ones(4), torch.zeros(4), g_b)
    assert int(tok_a[0]) == int(tok_b[2])
    # The gumbel transform matches JAX's: finite, and a standard Gumbel's
    # mean (Euler-Mascheroni) within sampling error.
    big = row_gumbel(64, 1024, base_seed=1, step=2)
    assert torch.isfinite(big).all()
    assert abs(float(big.mean()) - 0.5772) < 0.02
