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
    FUSED_SAMPLE_TOPK_MAX,
    fused_sample_topk,
    fused_sample_topk_chunked,
    fused_sample_topk_plain,
    greedy_tokens,
    row_gumbel,
    sample_chunks,
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


def _chunked_case(v: int, chunks: int, seed: int):
    """Rows whose k-th values are tied across A3's chunk boundaries (chunks
    of sample_chunks(., v, chunks)), for k in {0, 1, 2, 63, 64, >= V}; a row
    with fewer than k finite logits; greedy rows with their maximum in two
    chunks."""
    rng = np.random.default_rng(seed)
    _, length = sample_chunks(12, v, chunks)
    last = (v - 1) // length * length          # first index of the last chunk
    b = min(length, v - 1)                     # a boundary (or the last index)
    logits = (rng.standard_normal((12, v)) * 2.0).astype(np.float32)
    temp = np.array([0.0, 0.0, 1.0, 0.7, 1.3, 0.9, 1.0, 0.6, 1.1, 0.8, 1.0,
                     1.0], np.float32)
    top_k = np.array([0, 5, 1, 2, 63, 64, 0, v, v + 9, 10, 64, 2], np.int32)
    # Greedy: one maximum in chunk 0 and the last chunk (first index wins).
    for row in (0, 1):
        logits[row, [3, last]] = logits[row].max() + 1.0
    # k = 1: the top value twice, across the first boundary.
    logits[2, [b - 1, b]] = logits[2].max() + 0.5
    # k = 2: one top value, then the 2nd value tied across the boundary.
    top = logits[3].max()
    logits[3, 0] = top + 2.0
    logits[3, [b - 1, b, last]] = top + 1.0
    # k = 63 / 64: a run of equal values around rank k over a boundary.
    for row, k in ((4, 63), (5, 64), (10, 64)):
        top = logits[row].max()
        lo = max(b - k // 2, 0)
        logits[row, lo:lo + k - 3] = top + 3.0
        logits[row, lo + k - 3:lo + k + 4] = top + 1.0   # ranks k-2 .. k+4
    # Fewer than k finite logits: 4 finite, k = 10.
    logits[9, :] = -np.inf
    logits[9, [1, b, last, v - 1]] = [0.5, 2.0, 2.0, -1.0]
    # k = 2 where the row's two largest values sit in the last chunk.
    logits[11, [last, v - 1]] = logits[11].max() + 1.0
    g = rng.gumbel(size=(12, v)).astype(np.float32)
    return logits, g, temp, top_k


@pytest.mark.parametrize("chunks", [1, 2, 3, 5, 8])
def test_chunked_sampler_matches_plain_and_pallas(chunks):
    """A3's decomposition (per-chunk top-k candidates, their merge, the
    threshold rule, the chunk-ordered argmax merge) picks exactly the plain
    version's and the TPU kernel's tokens at several chunk counts."""
    v = 300
    logits, g, temp, top_k = _chunked_case(v, chunks, seed=chunks)
    args = (_t(logits), _t(g), _t(temp), _t(top_k))
    ref = np.asarray(fused_sample_topk_pallas(
        jnp.asarray(logits), jnp.asarray(g), jnp.asarray(temp),
        jnp.asarray(top_k), interpret=True,
    ))
    plain = fused_sample_topk_plain(*args).numpy()
    got = fused_sample_topk_chunked(*args, chunks=chunks).numpy()
    assert np.array_equal(plain, ref)
    assert np.array_equal(got, ref)
    first = min(3, (v - 1) // sample_chunks(12, v, chunks)[1]
                * sample_chunks(12, v, chunks)[1])
    assert got[0] == first and got[1] == first   # greedy ties: first index


def test_chunked_sampler_ties_decide_the_draw():
    """Noise that favours one tied token at the k-th value: the tie is kept
    in every chunking (value threshold, multiplicity across chunks), and a
    token just below it is not."""
    v, k = 96, 4
    row = np.full((v,), -3.0, np.float32)
    row[[0, 1, 2]] = 5.0
    row[[31, 32, 64]] = 4.0                    # k-th value, three chunks
    row[40] = 3.9
    logits = np.stack([row, row])
    g = np.zeros((2, v), np.float32)
    g[0, 64] = 2.0                             # a tied token: kept
    g[1, 40] = 50.0                            # just below: filtered
    temp = np.ones((2,), np.float32)
    top_k = np.full((2,), k, np.int32)
    ref = fused_sample_topk_plain(_t(logits), _t(g), _t(temp), _t(top_k))
    assert ref.tolist() == [64, 0]
    for chunks in (1, 2, 3, 4, 7):
        got = fused_sample_topk_chunked(_t(logits), _t(g), _t(temp),
                                        _t(top_k), chunks=chunks)
        assert got.tolist() == ref.tolist(), chunks


def test_sample_chunks_follow_the_kernel_rule():
    """A3's chunking: about two waves of 132 SMs, chunks of at most 8,192
    and at least 1,024 logits, at most 128; C chunks of L cover V exactly
    (the C entry refuses anything else); FUSED_SAMPLE_TOPK_MAX is the
    kernel's candidate count."""
    import os
    import re

    from parallax_tpu_torch.ops import cuda_kernels as ck
    from parallax_tpu_torch.ops import sampling

    with open(os.path.join(ck.CSRC, "sample_topk.cu")) as f:
        src = f.read()
    consts = {m.group(1): int(m.group(2)) for m in
              re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kMaxK"] == FUSED_SAMPLE_TOPK_MAX
    assert consts["kMaxChunks"] == sampling.SAMPLE_MAX_CHUNKS
    assert sample_chunks(8, 152064) == (33, 4608)
    assert sample_chunks(64, 152064) == (19, 8004)
    assert sample_chunks(1, 201088) == (128, 1571)
    assert sample_chunks(64, 129280) == (16, 8080)
    assert sample_chunks(8, 300) == (1, 300)
    for s in (1, 3, 8, 33, 64, 256):
        for v in (5, 1000, 4097, 129280, 151936, 152064, 201088):
            c, length = sample_chunks(s, v)
            assert 1 <= c <= sampling.SAMPLE_MAX_CHUNKS
            assert c * length >= v > (c - 1) * length
            assert length <= sampling.SAMPLE_MAX_CHUNK
            if v >= sampling.SAMPLE_MIN_CHUNK:
                assert length >= sampling.SAMPLE_MIN_CHUNK


# -- the noise kernel's twin (gumbel_rows, csrc/gumbel.cu) --------------------


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
], ids=["zero", "ones", "pi"])
def test_philox4x32_10_known_answers(counter, key, want):
    """Random123's known answers for Philox4x32-10, through the int64 torch
    arithmetic the noise twin uses (also vectorized: the same answer in
    every lane of a batch)."""
    from parallax_tpu_torch.ops.sampling import philox4x32_10

    lanes = [torch.full((3,), c, dtype=torch.int64) for c in counter]
    keys = [torch.full((3,), k, dtype=torch.int64) for k in key]
    out = philox4x32_10(*lanes, *keys)
    for word, w in zip(out, want):
        assert word.tolist() == [w] * 3


def _noise(seeds, steps, base_seed, v):
    from parallax_tpu_torch.ops.sampling import gumbel_rows

    return gumbel_rows(torch.tensor(seeds, dtype=torch.int64),
                       torch.tensor(steps, dtype=torch.int64), base_seed, v)


def test_gumbel_rows_seeded_row_independent_of_row_and_batch():
    """Bitwise: a seeded row's noise is a function of (seed, output step)
    alone: not of its row, its batch, the engine seed or the engine
    step."""
    v = 1001
    alone = _noise([7], [3], 0, v)
    batch = _noise([-1, 2, 7, -1], [55, 9, 3, 55], 123, v)
    other = _noise([7, -1], [3, 1 << 40], 9, v)
    assert torch.equal(alone[0], batch[2])
    assert torch.equal(alone[0], other[0])


def test_gumbel_rows_differ_across_steps_and_rows():
    v = 4096
    g = _noise([-1, -1, 5, 5], [10, 10, 0, 1], 0, v)
    assert not torch.equal(g[0], g[1])       # unseeded rows: by row
    assert not torch.equal(g[2], g[3])       # seeded rows: by output step
    h = _noise([-1, -1], [11, 11], 0, v)
    assert not torch.equal(g[0], h[0])       # unseeded rows: by step
    assert not torch.equal(_noise([-1], [10], 1, v)[0], g[0])  # engine seed
    # The engine's unseeded window steps sit apart from the K = 1 steps.
    assert not torch.equal(_noise([-1], [(1 << 40) + 10], 0, v)[0], g[0])


def test_gumbel_rows_mean_is_euler_gamma():
    """A standard Gumbel's mean is Euler's constant (0.5772); over 65,536
    tokens the standard error is 0.005, so 0.03 is about 6 of them."""
    g = _noise([3], [0], 0, 65536)
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.03


def test_gumbel_rows_words_and_transform():
    """The twin's words are 32-bit and token t takes word t % 4 of counter
    t // 4; the noise is -log(-log(u)) of their top 24 bits (a vocabulary
    that is not a multiple of 4 cuts the last group)."""
    from parallax_tpu_torch.ops.sampling import (
        gumbel_bits_plain,
        gumbel_from_bits,
        mix_seed,
        philox4x32_10,
    )

    seeds = torch.tensor([-1, 4], dtype=torch.int64)
    steps = torch.tensor([6, 2], dtype=torch.int64)
    bits = gumbel_bits_plain(seeds, steps, 17, 10)
    assert bits.shape == (2, 10)
    assert int(bits.min()) >= 0 and int(bits.max()) < (1 << 32)
    key = mix_seed(4, 2)
    t = torch.tensor(2, dtype=torch.int64)       # tokens 8, 9: counter 2
    zero = torch.tensor(0, dtype=torch.int64)
    words = philox4x32_10(t, zero, zero, zero,
                          torch.tensor(key & 0xFFFFFFFF),
                          torch.tensor(key >> 32))
    assert bits[1, 8:].tolist() == [int(words[0]), int(words[1])]
    key0 = mix_seed(mix_seed(17, 6), 0)
    w0 = philox4x32_10(zero, zero, zero, zero,
                       torch.tensor(key0 & 0xFFFFFFFF),
                       torch.tensor(key0 >> 32))
    assert bits[0, :4].tolist() == [int(w) for w in w0]
    u = (bits >> 8).float() * 2.0 ** -24
    assert torch.equal(gumbel_from_bits(bits),
                       -torch.log(-torch.log(u.clamp_min(
                           torch.finfo(torch.float32).tiny))))
    assert torch.equal(_noise([-1, 4], [6, 2], 17, 10),
                       gumbel_from_bits(bits))


def test_samplers_agree_on_the_twins_noise():
    """A3's plain version and ``sample_tokens`` pick the same token from the
    twin's noise (top-k rows, greedy rows, ties at the k-th value)."""
    rng = np.random.default_rng(11)
    b, v = 6, 257
    logits = _t((rng.standard_normal((b, v)) * 2).astype(np.float32))
    logits[2, [10, 20, 30]] = logits[2].max() + 1.0     # a tie at k = 2
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.9, 0.0])
    top_k = torch.tensor([0, 5, 2, 64, 0, 3], dtype=torch.int32)
    g = _noise([-1, 8, 9, -1, 3, -1], [4, 0, 1, 4, 2, 4], 5, v)
    fused = fused_sample_topk_plain(logits, g, temp, top_k)
    split = sample_tokens(logits, temp, top_k, torch.ones(b), torch.zeros(b),
                          g)
    assert fused.tolist() == split.tolist()
    assert fused[0] == torch.argmax(logits[0])


# -- sampling features: the port's ops against parallax_tpu.ops.sampling ------

from parallax_tpu.ops import sampling as js  # noqa: E402
from parallax_tpu_torch.ops import sampling as ps  # noqa: E402


def _feature_inputs(b=6, v=50, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3.0).astype(np.float32)
    # Generated-id lists, -1 padded, one row empty and one with repeats.
    ids = rng.integers(0, v, size=(b, 9)).astype(np.int32)
    ids[1] = -1
    ids[2, 4:] = -1
    ids[3, :5] = 7
    pres = rng.uniform(0.0, 1.0, b).astype(np.float32)
    freq = rng.uniform(0.0, 0.5, b).astype(np.float32)
    rep = rng.uniform(0.8, 1.5, b).astype(np.float32)
    pres[0], freq[0], rep[0] = 0.0, 0.0, 1.0       # a neutral row
    return rng, logits, ids, pres, freq, rep


def test_output_token_counts_bitwise():
    _, _, ids, *_ = _feature_inputs()
    want = np.asarray(js.output_token_counts(jnp.asarray(ids), 50))
    got = ps.output_token_counts(_t(ids), 50)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # -1 padding is dropped, never counted at the last token.
    assert got[1].sum() == 0 and got[:, -1].sum() == (ids == 49).sum()


def test_penalties_match_jax():
    _, logits, ids, pres, freq, rep = _feature_inputs()
    want = np.asarray(js.penalize_logits(
        jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(pres),
        jnp.asarray(freq), jnp.asarray(rep)))
    got = ps.penalize_logits(_t(logits), _t(ids), _t(pres), _t(freq),
                             _t(rep))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    counts = js.output_token_counts(jnp.asarray(ids), 50)
    want2 = np.asarray(js.apply_penalties(
        jnp.asarray(logits), counts, jnp.asarray(pres), jnp.asarray(freq),
        jnp.asarray(rep)))
    got2 = ps.apply_penalties(_t(logits), _t(np.asarray(counts)), _t(pres),
                              _t(freq), _t(rep))
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-6, atol=1e-6)
    # The neutral row passes through bit for bit.
    assert np.array_equal(got[0].numpy(), logits[0])


def test_bias_logits_drops_padding_rows():
    """Against JAX with the engine's padding (zero vectors); and padding
    rows are dropped, not wrapped to the last row, whatever they hold (JAX
    wraps -1 to the last row: ROADMAP queue 3)."""
    rng, logits, *_ = _feature_inputs()
    rows = np.array([4, -1, 0, -1], np.int32)
    vecs = rng.standard_normal((4, 50)).astype(np.float32)
    vecs[rows < 0] = 0.0
    want = np.asarray(js.bias_logits(jnp.asarray(logits), jnp.asarray(rows),
                                     jnp.asarray(vecs)))
    got = ps.bias_logits(_t(logits), _t(rows), _t(vecs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    vecs[rows < 0] = 5.0
    got = ps.bias_logits(_t(logits), _t(rows), _t(vecs))
    assert np.array_equal(got[-1].numpy(), logits[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_apply_grammar_mask_drops_padding_rows():
    """Against JAX with the engine's padding (all-True rows); and a padding
    row never overwrites the last row's own mask. JAX wraps -1 to the last
    row, so there the all-True padding unmasks a constrained last row of a
    full batch (ROADMAP queue 3); the port keeps its mask."""
    rng, logits, *_ = _feature_inputs()
    rows = np.array([2, -1, 4, -1], np.int32)
    allowed = rng.random((4, 50)) < 0.3
    allowed[rows < 0] = True
    want = np.asarray(js.apply_grammar_mask(
        jnp.asarray(logits), jnp.asarray(rows), jnp.asarray(allowed)))
    got = ps.apply_grammar_mask(_t(logits), _t(rows), _t(allowed))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == np.float32(ps.NEG_INF)).sum() == (
        ~allowed[[0, 2]]).sum()
    last = np.array([5, -1], np.int32)
    pair = np.stack([allowed[2], allowed[1]])      # a mask, then padding
    got = ps.apply_grammar_mask(_t(logits), _t(last), _t(pair))
    masked = got[5].numpy() == np.float32(ps.NEG_INF)
    np.testing.assert_array_equal(masked, ~allowed[2])
    assert masked.any()
    jax_last = np.asarray(js.apply_grammar_mask(
        jnp.asarray(logits), jnp.asarray(last), jnp.asarray(pair)))
    assert not (jax_last[5] == np.float32(ps.NEG_INF)).any()


@pytest.mark.parametrize("v", [40, 64, 100, 130], ids=lambda v: f"v{v}")
def test_unpack_and_packed_mask_bitwise(v):
    """Packed width (3 words = 96 ids) above and below the vocab."""
    from parallax_tpu.constrained.device_table import pack_bool_rows

    rng, *_ = _feature_inputs()
    mask = rng.random((5, 96)) < 0.5
    bits = pack_bool_rows(mask)                    # u32[5, 3]
    want = np.asarray(js.unpack_token_masks(jnp.asarray(bits), v))
    got = ps.unpack_token_masks(_t(bits.view(np.int32)), v)
    np.testing.assert_array_equal(got.numpy(), want)
    logits = (rng.standard_normal((5, v)) * 2).astype(np.float32)
    constrained = np.array([True, False, True, True, False])
    want = np.asarray(js.mask_logits_packed(
        jnp.asarray(logits), jnp.asarray(bits), jnp.asarray(constrained)))
    got = ps.mask_logits_packed(_t(logits), _t(bits.view(np.int32)),
                                _t(constrained))
    np.testing.assert_array_equal(got.numpy(), want)


def test_token_logprobs_match_jax():
    rng, logits, *_ = _feature_inputs()
    logits[2, 5:] = np.float32(ps.NEG_INF)         # a masked row
    toks = rng.integers(0, 50, size=6).astype(np.int32)
    toks[2] = 3
    want = np.asarray(js.token_logprobs(jnp.asarray(logits),
                                        jnp.asarray(toks)))
    got = ps.token_logprobs(_t(logits), _t(toks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got <= 0).all()


@pytest.mark.parametrize("allowed", [1, 3, 20])
def test_fused_sampler_on_masked_rows_matches_pallas(allowed):
    """A3's plain version on grammar-masked rows (the k-th value tied
    across the masked tail whenever fewer than top-k tokens are allowed)
    picks what the Pallas kernel and the split sampler pick."""
    rng = np.random.default_rng(allowed)
    b, v = 6, 300
    logits = np.full((b, v), np.float32(ps.NEG_INF))
    for row in range(b):
        ids = rng.choice(v, size=allowed, replace=False)
        logits[row, ids] = rng.standard_normal(allowed) * 3
    temp = np.array([0.0, 0.8, 0.8, 1.0, 0.0, 0.8], np.float32)
    top_k = np.array([1, 1, 40, 64, 40, 0], np.int32)
    key = jax.random.key(allowed)
    ref, g = _both(logits, temp, top_k, np.ones(b, np.float32),
                   np.zeros(b, np.float32), key)
    pallas = np.asarray(fused_sample_topk_pallas(
        jnp.asarray(logits), jnp.asarray(g), jnp.asarray(temp),
        jnp.asarray(top_k), interpret=True))
    plain = fused_sample_topk_plain(_t(logits), _t(g), _t(temp), _t(top_k))
    np.testing.assert_array_equal(plain.numpy(), pallas)
    np.testing.assert_array_equal(plain.numpy(), ref)
    assert (logits[np.arange(b), plain.numpy()] > ps.NEG_INF).all()
