"""The port's attention against parallax_tpu's on the same inputs.

The plain versions of the fused decode kernel (K2) and the fused prefill
pair (K1) — what the wrappers run on CPU tensors — against the TPU kernels
in Pallas interpret mode, and the split path against the XLA reference.
Ragged lengths, page-exact boundaries, cached prefixes (chunked prefill),
padding rows and tokens, slot -1 rows, attend-only mode, sinks, sliding
windows, soft caps and a non-power-of-two group. Outputs: f32 allclose
(atol = rtol = 2e-5); the cache after the append: bitwise equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.ops.attention import _ragged_paged_attention_xla
from parallax_tpu.ops.decode_fused_pallas import gqa_fused_decode_pallas
from parallax_tpu.ops.kv_cache_ops import reshape_and_cache as j_scatter
from parallax_tpu.ops.prefill_fused_pallas import gqa_fused_prefill_pallas
from parallax_tpu_torch.ops import ragged
from parallax_tpu_torch.ops.attention import append_and_attend
from parallax_tpu_torch.ops.decode_fused import gqa_fused_decode
from parallax_tpu_torch.ops.prefill_fused import gqa_fused_prefill

TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Decode: one query token per row (K2).
# ---------------------------------------------------------------------------

PAGE = 8
LENS = np.array([5, 17, 48, 0, 9, 16], np.int32)   # 48, 16: page-exact
FROZEN_ROW = 4                                     # live row, slot -1


def _decode_case(hq, hkv, d, sinks_on, seed=0):
    rng = np.random.default_rng(seed)
    s, pps = len(LENS), 6
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(LENS):
        npg = (int(n) + PAGE - 1) // PAGE
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    slot = np.full((s,), -1, np.int32)
    for i, n in enumerate(LENS):
        if n > 0 and i != FROZEN_ROW:
            slot[i] = pages[i, (int(n) - 1) // PAGE] * PAGE + (int(n) - 1) % PAGE
    f = np.float32
    return dict(
        q=rng.standard_normal((s, hq, d)).astype(f),
        k=rng.standard_normal((s, hkv, d)).astype(f),
        v=rng.standard_normal((s, hkv, d)).astype(f),
        cache=rng.standard_normal((used, PAGE, 2 * hkv, d)).astype(f),
        lens=LENS.copy(), pages=pages, slot=slot,
        sinks=rng.standard_normal((hq,)).astype(f) if sinks_on else None,
    )


@pytest.mark.parametrize("hq,hkv,window,sinks_on,cap", [
    (4, 2, None, False, None),
    (4, 2, 16, False, None),
    (4, 2, None, True, None),
    (4, 2, None, False, 30.0),
    (6, 2, 16, True, 30.0),          # G = 3 with sinks + window + soft cap
], ids=["plain", "window", "sinks", "softcap", "g3-sinks-window-softcap"])
def test_decode_plain_matches_pallas_kernel(hq, hkv, window, sinks_on, cap):
    d = 16
    c = _decode_case(hq, hkv, d, sinks_on)
    kw = dict(sm_scale=d ** -0.5, sliding_window=window, soft_cap=cap)
    ref_out, ref_cache = gqa_fused_decode_pallas(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["slot"]),
        None if c["sinks"] is None else jnp.asarray(c["sinks"]),
        use_sinks=sinks_on, interpret=True, **kw,
    )
    cache = _t(c["cache"])
    out, cache_out = gqa_fused_decode(
        _t(c["q"]), _t(c["k"]), _t(c["v"]), cache, _t(c["lens"]),
        _t(c["pages"]), _t(c["slot"]),
        None if c["sinks"] is None else _t(c["sinks"]), **kw,
    )
    assert cache_out is cache
    np.testing.assert_array_equal(cache.numpy(), np.asarray(ref_cache))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    assert np.all(out.numpy()[3] == 0.0)          # kv_len 0: exact zeros

    # The facade routes a decode-only batch to the same wrapper.
    cache2 = _t(c["cache"])
    s = len(LENS)
    out2, _ = append_and_attend(
        _t(c["q"]), _t(c["k"]), _t(c["v"]), cache2, _t(c["lens"]),
        _t(c["pages"]), torch.arange(s + 1, dtype=torch.int32),
        torch.tensor([s], dtype=torch.int32), _t(c["slot"]),
        sinks=None if c["sinks"] is None else _t(c["sinks"]),
        decode_only=True, decode_fused=True, **kw,
    )
    np.testing.assert_array_equal(out2.numpy(), out.numpy())


# ---------------------------------------------------------------------------
# Prefill: ragged chunks over cached prefixes (K1), and the split path.
# ---------------------------------------------------------------------------

PPS = 12


def _prefill_case(q_lens, cached, hq, hkv, d, sinks_on, seed=0):
    rng = np.random.default_rng(seed)
    s = len(q_lens)
    kv_lens = np.array([c + q for c, q in zip(cached, q_lens)], np.int32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    t = int(cu[-1])
    tp = max(64, 1 << (t - 1).bit_length())     # token-bucket padding
    f = np.float32
    pages = np.arange(s * PPS, dtype=np.int32).reshape(s, PPS) + 1
    slots = np.full((tp,), -1, np.int32)
    for i in range(s):
        for j in range(q_lens[i]):
            pos = cached[i] + j
            slots[cu[i] + j] = pages[i, pos // PAGE] * PAGE + pos % PAGE
    return dict(
        q=rng.standard_normal((tp, hq, d)).astype(f),
        k=rng.standard_normal((tp, hkv, d)).astype(f),
        v=rng.standard_normal((tp, hkv, d)).astype(f),
        cache=rng.standard_normal((s * PPS + 1, PAGE, 2 * hkv, d)).astype(f),
        kv_lens=kv_lens, pages=pages, cu=cu,
        nseq=np.array([s], np.int32), slots=slots, t=t,
        sinks=rng.standard_normal((hq,)).astype(f) if sinks_on else None,
    )


def _jargs(c, names):
    return [None if c[n] is None else jnp.asarray(c[n]) for n in names]


def _targs(c, names):
    return [None if c[n] is None else _t(c[n]) for n in names]


PREFILL_CASES = [
    ([17, 8, 33], [0, 0, 0], 4, 2, False, None, None),
    ([17, 8, 33], [0, 16, 5], 4, 2, False, None, None),
    ([16, 8, 8], [8, 0, 24], 4, 2, False, None, None),
    ([17, 8, 33], [3, 16, 5], 4, 2, True, 11, 30.0),
    ([1, 1, 1], [40, 7, 0], 4, 2, False, None, None),
    ([17, 8, 33], [3, 16, 5], 6, 2, True, 11, 30.0),
]
PREFILL_IDS = ["ragged", "cached", "page-aligned", "sinks-window-softcap",
               "decode-shaped", "g3-sinks-window-softcap"]


@pytest.mark.parametrize("q_lens,cached,hq,hkv,sinks_on,window,cap",
                         PREFILL_CASES, ids=PREFILL_IDS)
def test_prefill_plain_matches_pallas_kernel(q_lens, cached, hq, hkv,
                                             sinks_on, window, cap):
    d = 32
    c = _prefill_case(q_lens, cached, hq, hkv, d, sinks_on)
    kw = dict(sm_scale=d ** -0.5, sliding_window=window, soft_cap=cap)
    names = ["q", "k", "v", "cache", "kv_lens", "pages", "cu", "nseq",
             "slots", "sinks"]
    ref_out, ref_cache = gqa_fused_prefill_pallas(
        *_jargs(c, names), use_sinks=sinks_on, q_block=32, interpret=True,
        **kw,
    )
    targs = _targs(c, names)
    out, cache = gqa_fused_prefill(*targs, **kw)
    assert cache is targs[3]
    np.testing.assert_array_equal(cache.numpy(), np.asarray(ref_cache))
    t = c["t"]
    np.testing.assert_allclose(out.numpy()[:t], np.asarray(ref_out)[:t],
                               **TOL)
    assert np.all(out.numpy()[t:] == 0.0)          # padding tokens: zeros


def test_prefill_attend_only_mode():
    d = 32
    c = _prefill_case([17, 8, 33], [0, 16, 5], 4, 2, 32, True)
    cache_j = j_scatter(jnp.asarray(c["cache"]), jnp.asarray(c["k"]),
                        jnp.asarray(c["v"]), jnp.asarray(c["slots"]))
    no_slots = np.full_like(c["slots"], -1)
    ref_out, _ = gqa_fused_prefill_pallas(
        jnp.asarray(c["q"]), None, None, cache_j, jnp.asarray(c["kv_lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["cu"]),
        jnp.asarray(c["nseq"]), jnp.asarray(no_slots),
        jnp.asarray(c["sinks"]), sm_scale=d ** -0.5, use_sinks=True,
        q_block=32, interpret=True,
    )
    cache = _t(np.asarray(cache_j))
    before = cache.clone()
    out, cache_out = gqa_fused_prefill(
        _t(c["q"]), None, None, cache, _t(c["kv_lens"]), _t(c["pages"]),
        _t(c["cu"]), _t(c["nseq"]), _t(no_slots), _t(c["sinks"]),
        sm_scale=d ** -0.5,
    )
    assert torch.equal(cache_out, before)          # untouched
    t = c["t"]
    np.testing.assert_allclose(out.numpy()[:t], np.asarray(ref_out)[:t],
                               **TOL)


@pytest.mark.parametrize("q_lens,cached,hq,hkv,sinks_on,window,cap",
                         [PREFILL_CASES[1], PREFILL_CASES[5]],
                         ids=["cached", "g3-sinks-window-softcap"])
def test_split_path_matches_xla_reference(q_lens, cached, hq, hkv,
                                          sinks_on, window, cap):
    d = 32
    c = _prefill_case(q_lens, cached, hq, hkv, d, sinks_on)
    kw = dict(sm_scale=d ** -0.5, sliding_window=window, soft_cap=cap)
    cache_j = j_scatter(jnp.asarray(c["cache"]), jnp.asarray(c["k"]),
                        jnp.asarray(c["v"]), jnp.asarray(c["slots"]))
    ref = _ragged_paged_attention_xla(
        jnp.asarray(c["q"]), cache_j, jnp.asarray(c["kv_lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["cu"]),
        jnp.asarray(c["nseq"]),
        sinks=None if c["sinks"] is None else jnp.asarray(c["sinks"]), **kw,
    )
    targs = _targs(c, ["q", "k", "v", "cache", "kv_lens", "pages", "cu",
                       "nseq", "slots"])
    out, cache = append_and_attend(*targs, sinks=_targs(c, ["sinks"])[0],
                                   **kw)
    np.testing.assert_array_equal(cache.numpy(), np.asarray(cache_j))
    t = c["t"]
    np.testing.assert_allclose(out.numpy()[:t], np.asarray(ref)[:t], **TOL)


@pytest.mark.parametrize("rows", [1, 5], ids=["rows-1", "rows-5"])
def test_plain_attention_row_passes_match_xla(rows, monkeypatch):
    """The plain attention in passes of a few query rows (the bound on a
    long prefill's transient; a pass of 5 crosses sequence boundaries)
    matches the XLA reference as the single pass does."""
    monkeypatch.setattr(ragged, "QUERY_ROWS", rows)
    test_split_path_matches_xla_reference(*PREFILL_CASES[5])


# ---------------------------------------------------------------------------
# The split path's kernels: K6 (sinks decode) and K9's route (A1 attend-only).
# ---------------------------------------------------------------------------

K6_LENS = np.array([5, 17, 48, 0, 1, 13], np.int32)   # 48: page-exact


def _k6_case(sinks_on, seed=1):
    rng = np.random.default_rng(seed)
    hq, hkv, d, s, pps = 6, 2, 16, len(K6_LENS), 6
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(K6_LENS):
        npg = (int(n) + PAGE - 1) // PAGE
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    f = np.float32
    return dict(
        q=rng.standard_normal((s, hq, d)).astype(f),
        cache=rng.standard_normal((used, PAGE, 2 * hkv, d)).astype(f),
        lens=K6_LENS.copy(), pages=pages,
        sinks=rng.standard_normal((hq,)).astype(f) if sinks_on else None,
    ), d


@pytest.mark.parametrize("window", [None, 5, 11],
                         ids=["full", "window-in-page", "window-spans-pages"])
@pytest.mark.parametrize("sinks_on", [True, False], ids=["sinks", "no-sinks"])
def test_split_decode_plain_matches_pallas_kernel(sinks_on, window):
    """K6's plain version (what A9's wrapper runs on CPU tensors) against
    ``gqa_decode_attention_pallas`` in interpret mode: kv_len 0 and 1 rows,
    contexts ending mid-page and page-exact, G = 3; f32 within 1e-5."""
    from parallax_tpu.ops.attention_pallas import gqa_decode_attention_pallas
    from parallax_tpu_torch.ops.gqa_decode import gqa_decode_attention

    c, d = _k6_case(sinks_on)
    kw = dict(sm_scale=d ** -0.5, sliding_window=window)
    ref = gqa_decode_attention_pallas(
        jnp.asarray(c["q"]), jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
        jnp.asarray(c["pages"]),
        None if c["sinks"] is None else jnp.asarray(c["sinks"]),
        use_sinks=sinks_on, interpret=True, **kw,
    )
    out = gqa_decode_attention(
        _t(c["q"]), _t(c["cache"]), _t(c["lens"]), _t(c["pages"]),
        None if c["sinks"] is None else _t(c["sinks"]), **kw,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    assert np.all(out.numpy()[3] == 0.0)          # kv_len 0: exact zeros


def _route_case(decode_only, sinks_on):
    """A batch of 3 rows: one token each (decode-shaped) or a ragged
    prefill over cached prefixes; the step's K/V already scattered."""
    q_lens = [1, 1, 1] if decode_only else [9, 1, 6]
    c = _prefill_case(q_lens, [12, 3, 0], 4, 2, 16, sinks_on, seed=3)
    cache = j_scatter(jnp.asarray(c["cache"]), jnp.asarray(c["k"]),
                      jnp.asarray(c["v"]), jnp.asarray(c["slots"]))
    c["cache"] = np.asarray(cache)
    if decode_only:      # exactly one token per row, no bucket padding
        for k in ("q", "k", "v", "slots"):
            c[k] = c[k][:3]
    return c


@pytest.mark.parametrize("use_kernels", [None, False, True])
@pytest.mark.parametrize("decode_only", [True, False],
                         ids=["decode-only", "multi-token"])
@pytest.mark.parametrize("sinks_on", [True, False], ids=["sinks", "no-sinks"])
def test_split_route_table(monkeypatch, sinks_on, decode_only, use_kernels):
    """``ragged_paged_attention``'s branches, as
    ``parallax_tpu/ops/attention.py:175-239`` takes them: with kernels on,
    sinks + decode-only go to the split decode kernel (K6 -> A9) without
    the soft cap, everything else to A1 attend-only (K9's counterpart, and
    the sinks prefill); with kernels off (``None`` on CPU tensors, or
    ``False``), the plain path. Every branch gives the plain path's
    numbers."""
    from parallax_tpu_torch.ops import gqa_decode, prefill_fused
    from parallax_tpu_torch.ops.attention import ragged_paged_attention

    calls = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls.append((name, sorted(kwargs)))
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(gqa_decode, "gqa_decode_attention")
    spy(prefill_fused, "gqa_prefill_attend")
    c = _route_case(decode_only, sinks_on)
    d = 16
    args = _targs(c, ["q", "cache", "kv_lens", "pages", "cu", "nseq"])
    kw = dict(sm_scale=d ** -0.5, sliding_window=5,
              sinks=_targs(c, ["sinks"])[0])
    out = ragged_paged_attention(*args, use_kernels=use_kernels,
                                 decode_only=decode_only, **kw)
    ref = ragged_paged_attention(*args, use_kernels=False,
                                 decode_only=decode_only, **kw)
    if not use_kernels:
        want = []
    elif sinks_on and decode_only:
        want = [("gqa_decode_attention", ["sliding_window", "sm_scale"])]
    else:
        want = [("gqa_prefill_attend",
                 ["sliding_window", "sm_scale", "soft_cap"])]
    assert calls == want
    t = c["t"]
    np.testing.assert_allclose(out.numpy()[:t], ref.numpy()[:t], **TOL)
    # A sinks decode-only flag on a batch that is not one token per row
    # takes A1, as in the JAX package.
    if use_kernels and sinks_on and not decode_only:
        calls.clear()
        ragged_paged_attention(*args, use_kernels=True, decode_only=True, **kw)
        assert [n for n, _ in calls] == ["gqa_prefill_attend"]


def test_prefill_attend_on_decode_steps_matches_xla():
    """K9's route on a dense model's decode step: A1's plain version on a
    one-token-per-row batch (cu_q_lens = arange, bucket padding past the
    live rows, no sinks) against ``_ragged_paged_attention_xla``, real
    tokens only (A1 writes zeros on the padding, the XLA path does not)."""
    from parallax_tpu_torch.ops.prefill_fused import gqa_prefill_attend

    c = _prefill_case([1] * 5, [40, 7, 0, 16, 23], 7, 1, 32, False, seed=5)
    cache = j_scatter(jnp.asarray(c["cache"]), jnp.asarray(c["k"]),
                      jnp.asarray(c["v"]), jnp.asarray(c["slots"]))
    assert c["t"] == 5 and c["q"].shape[0] == 64
    kw = dict(sm_scale=32 ** -0.5, sliding_window=None, soft_cap=None)
    ref = _ragged_paged_attention_xla(
        jnp.asarray(c["q"]), cache, jnp.asarray(c["kv_lens"]),
        jnp.asarray(c["pages"]), jnp.asarray(c["cu"]),
        jnp.asarray(c["nseq"]), sinks=None, **kw,
    )
    out = gqa_prefill_attend(
        _t(c["q"]), _t(np.asarray(cache)),
        *_targs(c, ["kv_lens", "pages", "cu", "nseq"]), None, **kw,
    )
    np.testing.assert_allclose(out.numpy()[:5], np.asarray(ref)[:5], **TOL)
    assert np.all(out.numpy()[5:] == 0.0)


# ---------------------------------------------------------------------------
# The decode kernels' split-KV arithmetic (A2, A9 and A1's one-token rows):
# the split partition and the plain split form, against the TPU kernels.
# ---------------------------------------------------------------------------

SPLIT_PAGE = 16
# 300 and 200: several splits of 8 pages; 45, 129: mid-page ends; 0, 1.
SPLIT_LENS = np.array([300, 0, 1, 45, 129, 200], np.int32)


def _split_case(hq, hkv, sinks_on, seed=7):
    rng = np.random.default_rng(seed)
    d, s = 16, len(SPLIT_LENS)
    pps = int(SPLIT_LENS.max() + SPLIT_PAGE - 1) // SPLIT_PAGE + 1
    pages = np.zeros((s, pps), np.int32)
    used = 1
    for i, n in enumerate(SPLIT_LENS):
        npg = (int(n) + SPLIT_PAGE - 1) // SPLIT_PAGE
        pages[i, :npg] = np.arange(used, used + npg)
        used += npg
    slot = np.full((s,), -1, np.int32)
    for i, n in enumerate(SPLIT_LENS):
        if n > 0:
            p = int(n) - 1
            slot[i] = pages[i, p // SPLIT_PAGE] * SPLIT_PAGE + p % SPLIT_PAGE
    f = np.float32
    return dict(
        q=rng.standard_normal((s, hq, d)).astype(f),
        k=rng.standard_normal((s, hkv, d)).astype(f),
        v=rng.standard_normal((s, hkv, d)).astype(f),
        cache=rng.standard_normal((used, SPLIT_PAGE, 2 * hkv, d)).astype(f),
        lens=SPLIT_LENS.copy(), pages=pages, slot=slot,
        sinks=rng.standard_normal((hq,)).astype(f) if sinks_on else None,
    ), d


# window 40: the window's first key (260 of 300) sits inside the first
# split's first page; window 150: a clipped range of several splits.
SPLIT_CASES = [
    ("fused", 6, 2, True, None, False),
    ("fused", 7, 1, True, 40, False),
    ("fused", 6, 2, False, 150, True),
    ("split", 7, 1, True, None, True),
    ("split", 6, 2, True, 40, False),
    ("split", 7, 1, False, 150, False),
    ("split", 6, 2, True, 150, True),
]
SPLIT_IDS = ["a2-g3-sinks", "a2-g7-sinks-window-in-split",
             "a2-g3-window-splits-empty", "a9-g7-sinks-empty",
             "a9-g3-sinks-window-in-split", "a9-g7-window-splits",
             "a9-g3-sinks-window-empty"]


@pytest.mark.parametrize("kernel,hq,hkv,sinks_on,window,pad", SPLIT_CASES,
                         ids=SPLIT_IDS)
def test_split_decode_form_matches_pallas_kernels(kernel, hq, hkv, sinks_on,
                                                  window, pad):
    """The plain split-KV form (per-split online softmax over 64-key tiles,
    then the ordered combine with the sinks folded in once; ``pad`` adds
    empty splits up to the grid's bound) against
    ``gqa_fused_decode_pallas`` (after the same append) and
    ``gqa_decode_attention_pallas`` in interpret mode: f32 within 1e-5,
    kv_len 0 rows exactly zero."""
    from parallax_tpu.ops.attention_pallas import gqa_decode_attention_pallas
    from parallax_tpu_torch.ops.decode_fused import (
        gqa_split_decode_plain,
        split_ranges,
    )
    from parallax_tpu_torch.ops.kv_cache_ops import reshape_and_cache

    c, d = _split_case(hq, hkv, sinks_on)
    assert len(split_ranges(300, SPLIT_PAGE, None)) == 3
    sinks_j = None if c["sinks"] is None else jnp.asarray(c["sinks"])
    kw = dict(sm_scale=d ** -0.5, sliding_window=window)
    cache = _t(c["cache"])
    if kernel == "fused":
        ref, ref_cache = gqa_fused_decode_pallas(
            jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
            jnp.asarray(c["cache"]), jnp.asarray(c["lens"]),
            jnp.asarray(c["pages"]), jnp.asarray(c["slot"]), sinks_j,
            use_sinks=sinks_on, interpret=True, soft_cap=None, **kw,
        )
        reshape_and_cache(cache, _t(c["k"]), _t(c["v"]), _t(c["slot"]))
        np.testing.assert_array_equal(cache.numpy(), np.asarray(ref_cache))
    else:
        ref = gqa_decode_attention_pallas(
            jnp.asarray(c["q"]), jnp.asarray(c["cache"]),
            jnp.asarray(c["lens"]), jnp.asarray(c["pages"]), sinks_j,
            use_sinks=sinks_on, interpret=True, **kw,
        )
    out = gqa_split_decode_plain(
        _t(c["q"]), cache, _t(c["lens"]), _t(c["pages"]),
        None if c["sinks"] is None else _t(c["sinks"]), pad_splits=pad,
        **kw,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    assert np.all(out.numpy()[1] == 0.0)          # kv_len 0: exact zeros


@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("window", [None, 5, 200, 3000],
                         ids=["full", "w5", "w200", "w3000"])
def test_split_partition_covers_each_row_once(page, window):
    """``split_ranges`` (the Python twin of the kernels' partition) covers
    each row's valid pages ``[max(kv_len - W, 0) // page, ceil(kv_len /
    page))`` exactly once, in order, with non-empty runs of at least 128
    keys (all but the last) and at most ``MAX_SPLITS`` of them; a row's
    ranges are the same whatever the batch (page-table width, batch-mates),
    and fit the grid bound of every batch that holds the row."""
    from parallax_tpu_torch.ops.decode_fused import (
        MAX_SPLITS,
        SPLIT_KEYS,
        num_splits_bound,
        split_ranges,
    )

    rng = np.random.default_rng(page)
    lens = [0, 1, page - 1, page, page + 1, 127, 128, 129, 4096, 4097,
            8192, 16000] + [int(x) for x in rng.integers(1, 20000, 40)]
    for n in lens:
        ranges = split_ranges(n, page, window)
        if n == 0:
            assert ranges == []
            continue
        lo_page = max(n - window, 0) // page if window else 0
        hi_page = -(-n // page)
        covered = [p for lo, hi in ranges for p in range(lo, hi)]
        assert covered == list(range(lo_page, hi_page))
        assert all(hi > lo for lo, hi in ranges)
        assert all((hi - lo) * page >= SPLIT_KEYS for lo, hi in ranges[:-1])
        assert len(ranges) <= MAX_SPLITS
        for extra in (0, 1, 37):          # wider page tables: other batches
            pps = hi_page + extra
            assert len(ranges) <= num_splits_bound(pps, page)
            assert split_ranges(n, page, window) == ranges
