"""Batched sampling: greedy, temperature / top-k / top-p / min-p, and the
fused sort-free top-k sampler (port of ``parallax_tpu/ops/sampling.py`` and
of ``decode_fused_pallas.fused_sample_topk_pallas``).

Gumbel noise is indexed by TOKEN ID and made outside the samplers, so the
split sampler (:func:`sample_tokens`) and the fused kernel
(:func:`fused_sample_topk`) pick the same token on the same logits and
noise. The port makes the noise from tensors (:func:`gumbel_rows`, the
``csrc/gumbel.cu`` kernel on the card): a counter-based Philox4x32-10 draw
keyed per row by ``(seed, output step)`` for a seeded row and by ``(engine
seed, step, row)`` for an unseeded one, so a seeded stream is reproducible
within the port whatever the batch, the step or the decode window it rides
in, and the noise can be made inside a replayed CUDA graph. It does not
reproduce JAX's threefry bits.
"""

from __future__ import annotations

import torch

NEG_INF = -1e10
# The fused kernel's removed-maximum marker (decode_fused_pallas._NEG).
_NEG = -1e30
# Largest per-row top_k the fused sampler accepts (A3 keeps each chunk's k
# largest values as candidates); larger rows take the split sampler.
FUSED_SAMPLE_TOPK_MAX = 64
# A3's chunking of a row (csrc/sample_topk.cu): about two waves of the H100's
# 132 SMs, chunks of at most 8,192 and at least 1,024 logits, at most 128.
SAMPLE_SMS = 132
SAMPLE_MAX_CHUNK = 8192
SAMPLE_MIN_CHUNK = 1024
SAMPLE_MAX_CHUNKS = 128

_MASK64 = (1 << 64) - 1
# Philox4x32-10 (Salmon et al., SC 2011; Random123's constants).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def mix_seed(a: int, b: int) -> int:
    """A 63-bit key from an ordered pair (splitmix64 finalizer), so
    ``(seed, step)`` pairs map to well-separated streams. The noise kernel
    computes the same function on the device."""
    z = (int(a) * 0x9E3779B97F4A7C15 + int(b) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _mulhilo32(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``a * b`` for ``a`` and int64 ``b`` in
    [0, 2^32), without leaving int64: ``b`` is split into 16-bit halves so
    every partial product stays below 2^49 (and non-negative, so each shift
    is logical)."""
    x = a * (b >> 16)                          # < 2^48
    z = ((x & 0xFFFF) << 16) + a * (b & 0xFFFF)  # < 2^49
    return ((x >> 16) + (z >> 32)) & _U32, z & _U32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words:
    counter ``(c0, c1, c2, c3)``, key ``(k0, k1)``; returns the 4 output
    words. Gives Random123's known answers (tests/test_torch_sampling.py)."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _row_keys(seeds: torch.Tensor, steps: torch.Tensor,
              base_seed: int) -> list[int]:
    """Each row's 64-bit noise key: ``mix_seed(seed, step)`` for a seeded
    row, ``mix_seed(mix_seed(base_seed, step), row)`` for an unseeded one."""
    return [
        mix_seed(seed, step) if seed >= 0
        else mix_seed(mix_seed(base_seed, step), row)
        for row, (seed, step) in enumerate(zip(seeds.tolist(),
                                               steps.tolist()))
    ]


def gumbel_bits_plain(seeds: torch.Tensor, steps: torch.Tensor,
                      base_seed: int, v: int) -> torch.Tensor:
    """The noise kernel's random words, int64[S, V] in [0, 2^32): token t of
    row r is word ``t % 4`` of Philox4x32-10 at counter ``(t // 4, 0, 0,
    0)`` under row r's key (low word, high word)."""
    dev = seeds.device
    keys = torch.tensor(_row_keys(seeds, steps, base_seed),
                        dtype=torch.int64, device=dev)[:, None]
    groups = torch.arange((v + 3) // 4, dtype=torch.int64, device=dev)[None]
    zero = torch.zeros_like(groups)
    words = philox4x32_10(groups, zero, zero, zero, keys & _U32,
                          (keys >> 32) & _U32)
    return torch.stack(words, dim=-1).reshape(keys.shape[0], -1)[:, :v]


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` with ``u = (bits >> 8) * 2^-24`` floored at the
    smallest normal f32, as ``jax.random.gumbel`` floors its uniform."""
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp_min(u, tiny)))


def gumbel_rows_plain(seeds: torch.Tensor, steps: torch.Tensor,
                      base_seed: int, v: int) -> torch.Tensor:
    """The plain version of the noise kernel: f32[S, V]."""
    return gumbel_from_bits(gumbel_bits_plain(seeds, steps, base_seed, v))


def gumbel_rows(
    seeds: torch.Tensor,   # i64[S]; < 0 = unseeded row
    steps: torch.Tensor,   # i64[S]; the output step (seeded) or engine step
    base_seed: int,
    v: int,
    bits: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-row gumbel noise indexed by token id, f32[S, V], from tensors
    (``csrc/gumbel.cu``). CPU tensors take :func:`gumbel_rows_plain`; CUDA
    tensors launch the kernel or raise. ``bits`` (i32[S, V], CUDA only)
    also receives the random words, for the card's check."""
    if seeds.device.type == "cpu":
        return gumbel_rows_plain(seeds, steps, base_seed, v)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    s = seeds.shape[0]
    if seeds.dtype != torch.int64 or steps.dtype != torch.int64:
        raise TypeError("gumbel_rows: seeds and steps must be int64")
    if steps.shape != (s,) or seeds.dim() != 1:
        raise ValueError(f"gumbel_rows: seeds and steps must be [{s}]")
    if bits is not None and (bits.dtype != torch.int32
                             or bits.shape != (s, v)):
        raise ValueError(f"gumbel_rows: bits must be i32[{s}, {v}]")
    ck.require_cuda("gumbel_rows", seeds, steps,
                    *(() if bits is None else (bits,)))
    out = torch.empty((s, v), dtype=torch.float32, device=seeds.device)
    code = ck.lib().pk_gumbel_rows(
        seeds.data_ptr(), steps.data_ptr(), out.data_ptr(),
        None if bits is None else bits.data_ptr(), int(base_seed), s, v,
        ck.stream_of(seeds),
    )
    ck.check(code, "gumbel_rows")
    ck.count("gumbel_rows")
    return out


def row_gumbel(
    b: int,
    v: int,
    *,
    base_seed: int,
    step: int,
    seeds=None,       # sequence of ints per row; < 0 = unseeded
    out_steps=None,   # sequence of ints per row: output index of the draw
    device="cpu",
) -> torch.Tensor:
    """Per-row gumbel noise indexed by token id, f32[b, v], from host
    lists: a seeded row keyed by ``(seed, its output step)``, an unseeded
    row by ``(base_seed, step, row)`` (:func:`gumbel_rows`)."""
    seeds_t = torch.full((b,), -1, dtype=torch.int64)
    steps_t = torch.full((b,), int(step), dtype=torch.int64)
    if seeds is not None:
        seeds_t = torch.tensor([int(x) for x in seeds], dtype=torch.int64)
        steps_t = torch.where(
            seeds_t >= 0,
            torch.tensor([int(x) for x in out_steps], dtype=torch.int64),
            steps_t)
    return gumbel_rows(seeds_t.to(device), steps_t.to(device), base_seed, v)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """All-greedy fast path: a single argmax (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_tokens(
    logits: torch.Tensor,       # [B, V] float
    temperature: torch.Tensor,  # f32[B]; <= 0 means greedy
    top_k: torch.Tensor,        # i32[B]; <= 0 disables
    top_p: torch.Tensor,        # f32[B] in (0, 1]; 1 disables
    min_p: torch.Tensor,        # f32[B] in [0, 1); 0 disables
    gumbel: torch.Tensor,       # f32[B, V] token-id-indexed noise
) -> torch.Tensor:
    """Sample one token per row: i32[B]. The filter masks are built in
    sorted space (one stable descending sort powers top-k, top-p and
    min-p) and the gumbel-max draw happens in token-id space. Top-k keeps
    by value threshold (ties at the k-th value included); ``top_p >= 1`` is
    an exact no-op."""
    b, v = logits.shape
    logits = logits.float()
    greedy_ids = torch.argmax(logits, dim=-1)
    temp = torch.clamp_min(temperature.float(), 1e-6)[:, None]
    scaled = logits / temp

    neg_sorted, sorted_idx = torch.sort(-scaled, dim=-1, stable=True)
    sorted_logits = -neg_sorted
    probs = torch.softmax(sorted_logits, dim=-1)

    k = torch.clamp(torch.where(top_k <= 0, v, top_k).long(), 1, v)
    kth = torch.gather(sorted_logits, 1, (k - 1)[:, None])
    keep = sorted_logits >= kth
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p.float()[:, None]
    keep &= ((cum - probs) < tp) | (tp >= 1.0)
    keep &= probs >= min_p.float()[:, None] * probs[:, 0:1]

    keep_tok = torch.zeros_like(keep).scatter(1, sorted_idx, keep)
    filtered = torch.where(keep_tok, scaled, NEG_INF)
    sampled = torch.argmax(filtered + gumbel.float(), dim=-1)
    return torch.where(temperature <= 0.0, greedy_ids, sampled).to(torch.int32)


def fused_sample_topk_plain(
    logits: torch.Tensor,       # [S, V] float
    gumbel: torch.Tensor,       # f32[S, V]
    temperature: torch.Tensor,  # f32[S]; <= 0 = greedy
    top_k: torch.Tensor,        # i32[S]; <= 0 disables the filter
) -> torch.Tensor:
    """The plain version of the A3 kernel: the TPU kernel's arithmetic,
    vectorised over rows. The k-th value comes from k - 1 single-occurrence
    removals of the current maximum (first index), ties kept by the value
    threshold."""
    s, v = logits.shape
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1)
    t = temperature.float()
    k = top_k.long()
    scaled = lg / torch.clamp_min(t, 1e-6)[:, None]
    need = (k > 0) & (k < v)
    iters = torch.where(need, torch.clamp_min(k - 1, 0), 0)
    red = scaled.clone()
    rows = torch.arange(s, device=lg.device)
    for it in range(int(iters.max()) if s else 0):
        idx = torch.argmax(red, dim=-1)
        active = it < iters
        red[rows[active], idx[active]] = _NEG
    kth = red.amax(dim=-1)
    thresh = torch.where(need, kth, _NEG)
    filtered = torch.where(scaled >= thresh[:, None], scaled, NEG_INF)
    choice = torch.argmax(filtered + gumbel.float(), dim=-1)
    return torch.where(t <= 0.0, greedy, choice).to(torch.int32)


def sample_chunks(s: int, v: int, chunks: int | None = None
                  ) -> tuple[int, int]:
    """A3's chunking of an ``[s, v]`` batch: ``(C, L)``, C chunks of L
    logits (the last one shorter), from S and V alone; ``chunks`` forces C
    (the tests)."""
    if chunks is None:
        chunks = max(-(-2 * SAMPLE_SMS // max(s, 1)), -(-v // SAMPLE_MAX_CHUNK))
        chunks = max(1, min(chunks, SAMPLE_MAX_CHUNKS,
                            v // SAMPLE_MIN_CHUNK))
    length = -(-v // chunks)
    return -(-v // length), length


def fused_sample_topk_chunked(
    logits: torch.Tensor,       # [S, V] float
    gumbel: torch.Tensor,       # f32[S, V]
    temperature: torch.Tensor,  # f32[S]; <= 0 = greedy
    top_k: torch.Tensor,        # i32[S]; <= 0 disables the filter
    chunks: int | None = None,
) -> torch.Tensor:
    """The A3 kernel's decomposition, for the tests: per chunk of
    :func:`sample_chunks`, the min(k, L) largest scaled values (with
    multiplicity) as candidates; v_k the k-th largest candidate; thresh =
    ``max(v_k, -1e30)`` for k >= 2, ``v_1`` for k = 1; then each chunk's
    argmax (first index) of filtered + gumbel, or of the logits for greedy
    rows, merged in chunk order keeping the first of equal values. Gives
    :func:`fused_sample_topk_plain`'s tokens; nothing on the card runs it."""
    s, v = logits.shape
    _, length = sample_chunks(s, v, chunks)
    bounds = [(x0, min(x0 + length, v)) for x0 in range(0, v, length)]
    lg = logits.float()
    out = torch.empty((s,), dtype=torch.int32)
    for row in range(s):
        t, k = temperature[row:row + 1].float(), int(top_k[row])
        if float(t) <= 0.0:
            vals = lg[row]
        else:
            scaled = lg[row] / torch.clamp_min(t, 1e-6)
            thresh = torch.tensor(_NEG, dtype=torch.float32)
            if 0 < k < v:
                cand = torch.cat([torch.topk(scaled[a:b], min(k, b - a)).values
                                  for a, b in bounds])
                vk = torch.topk(cand, k).values[k - 1]
                thresh = torch.clamp_min(vk, _NEG) if k >= 2 else vk
            vals = (torch.where(scaled >= thresh, scaled, NEG_INF)
                    + gumbel[row].float())
        best_v, best_i = None, None
        for a, b in bounds:
            i = a + int(torch.argmax(vals[a:b]))
            if best_v is None or vals[i] > best_v:
                best_v, best_i = vals[i], i
        out[row] = best_i
    return out


def fused_sample_topk(
    logits: torch.Tensor,
    gumbel: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
) -> torch.Tensor:
    """The A3 wrapper (``csrc/sample_topk.cu``): one token per row, i32[S].
    CPU tensors take :func:`fused_sample_topk_plain`; CUDA tensors launch
    the kernel (two launches, one count) or raise. Rows need ``top_k <=
    FUSED_SAMPLE_TOPK_MAX``: the kernel gives a sampled row with a larger
    ``top_k < V`` the token -1."""
    if logits.device.type == "cpu":
        return fused_sample_topk_plain(logits, gumbel, temperature, top_k)
    from parallax_tpu_torch.ops import cuda_kernels as ck

    s, v = logits.shape
    if logits.dtype != torch.float32 or gumbel.dtype != torch.float32:
        raise TypeError("sample_topk: logits and gumbel must be float32")
    if gumbel.shape != (s, v):
        raise ValueError("sample_topk: gumbel must match logits [S, V]")
    if temperature.dtype != torch.float32 or temperature.shape != (s,):
        raise ValueError(f"sample_topk: temperature must be f32[{s}]")
    if top_k.dtype != torch.int32 or top_k.shape != (s,):
        raise ValueError(f"sample_topk: top_k must be i32[{s}]")
    ck.require_cuda("sample_topk", logits, gumbel, temperature, top_k)
    out = torch.empty((s,), dtype=torch.int32, device=logits.device)
    chunks, length = sample_chunks(s, v)
    workspace = torch.empty(
        (s * (chunks * (FUSED_SAMPLE_TOPK_MAX + 2) + 1),), dtype=torch.int32,
        device=logits.device)
    code = ck.lib().pk_sample_topk(
        logits.data_ptr(), gumbel.data_ptr(), temperature.data_ptr(),
        top_k.data_ptr(), out.data_ptr(), workspace.data_ptr(), s, v, chunks,
        length, ck.stream_of(logits),
    )
    ck.check(code, "sample_topk")
    ck.count("sample_topk")
    return out


# -- sampling features: penalties, logit_bias, grammar masks, logprobs ------
#
# Elementwise work the JAX package leaves to XLA outside any Pallas kernel,
# so it stays as PyTorch ops (inside a window's CUDA graph too). Every one
# runs without a host sync or a data-dependent shape, and a -1 padded row
# or id is dropped, never wrapped to the last row or token as a negative
# index would be.


def output_token_counts(out_ids: torch.Tensor, v: int) -> torch.Tensor:
    """Padded per-row generated-id lists (i32[B, L], -1 padded) -> a dense
    i32[B, V] count matrix. The decode window also calls this once at
    dispatch to seed the count table its steps advance."""
    valid = out_ids >= 0
    ids = torch.where(valid, out_ids, 0).long()
    counts = torch.zeros((out_ids.shape[0], v), dtype=torch.int32,
                         device=out_ids.device)
    return counts.scatter_add_(1, ids, valid.to(torch.int32))


def apply_penalties(
    logits: torch.Tensor,               # [B, V]
    counts: torch.Tensor,               # i32[B, V] generated-token counts
    presence_penalty: torch.Tensor,     # f32[B]
    frequency_penalty: torch.Tensor,    # f32[B]
    repetition_penalty: torch.Tensor,   # f32[B]; 1.0 disables
) -> torch.Tensor:
    """OpenAI presence / frequency and HF repetition penalties, f32[B, V].
    The multiplicative repetition penalty applies to the raw logits; the
    additive shifts come after, so the penalties compose linearly."""
    logits = logits.float()
    present = (counts > 0).float()
    rep = repetition_penalty.float()[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(present > 0, penalized, logits)
    logits = logits - presence_penalty.float()[:, None] * present
    return logits - frequency_penalty.float()[:, None] * counts.float()


def penalize_logits(logits, out_ids, presence_penalty, frequency_penalty,
                    repetition_penalty) -> torch.Tensor:
    """:func:`apply_penalties` with the counts built from padded id lists
    (the host path's form)."""
    counts = output_token_counts(out_ids, logits.shape[1])
    return apply_penalties(logits, counts, presence_penalty,
                           frequency_penalty, repetition_penalty)


def bias_logits(logits: torch.Tensor, rows: torch.Tensor,
                bias_rows: torch.Tensor) -> torch.Tensor:
    """OpenAI logit_bias: add per-row bias vectors to the given rows.
    ``rows`` i32[G] (-1 = padding, dropped), ``bias_rows`` f32[G, V]. A
    padding row adds zeros to row 0, which leaves every value as it was."""
    valid = rows >= 0
    vecs = torch.where(valid[:, None], bias_rows.to(logits.dtype), 0.0)
    return logits.index_add(0, torch.where(valid, rows, 0).long(), vecs)


def apply_grammar_mask(logits: torch.Tensor, rows: torch.Tensor,
                       allowed: torch.Tensor) -> torch.Tensor:
    """Constrained decoding: disallowed tokens of the given rows go to
    NEG_INF. ``rows`` i32[G] (-1 = padding, dropped), ``allowed``
    bool[G, V]. Rows not listed pass through."""
    b, v = logits.shape
    full = torch.ones((b + 1, v), dtype=torch.bool, device=logits.device)
    full.index_copy_(0, torch.where(rows >= 0, rows, b).long(), allowed)
    return torch.where(full[:b], logits, NEG_INF)


def unpack_token_masks(bits: torch.Tensor, v: int) -> torch.Tensor:
    """Packed per-row token bitsets (i32[B, W] holding the u32 words of
    ``constrained/device_table.pack_bool_rows``) -> bool[B, v]. Bit ``t %
    32`` of word ``t // 32`` is token ``t``; tokens at or past the packed
    width unpack to False, as the host sampler masks columns past the
    token table."""
    b, w = bits.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    unpacked = ((bits.to(torch.int32)[:, :, None] >> shifts) & 1).bool()
    unpacked = unpacked.reshape(b, w * 32)
    if w * 32 >= v:
        return unpacked[:, :v]
    pad = torch.zeros((b, v - w * 32), dtype=torch.bool, device=bits.device)
    return torch.cat([unpacked, pad], dim=1)


def mask_logits_packed(logits: torch.Tensor, bits: torch.Tensor,
                       constrained: torch.Tensor) -> torch.Tensor:
    """The decode window's grammar mask: disallowed tokens of constrained
    rows go to NEG_INF, other rows pass through — the same ``where(allowed,
    logits, NEG_INF)`` as :func:`apply_grammar_mask`, so streams stay bit
    for bit those of the host path."""
    allowed = unpack_token_masks(bits, logits.shape[1])
    full = allowed | ~constrained[:, None]
    return torch.where(full, logits, NEG_INF)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """Log-probability of the chosen token per row, f32[B]:
    ``logits[token] - logsumexp(logits)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return chosen - lse


def speculative_accept(
    targets: torch.Tensor,      # i32[S, 1+P] verified token per fed position
    proposals: torch.Tensor,    # i32[S, P] fed proposal tokens (-1 = none)
    produced: torch.Tensor,     # i32[S] tokens committed so far this window
    stop_tokens: torch.Tensor,  # i32[S, J] stop/EOS sets, -1 padded
    min_req: torch.Tensor,      # i32[S] min_new_tokens gate on stop finishes
    limit: torch.Tensor,        # i32[S] remaining max_new budget
    stopped: torch.Tensor,      # bool[S] rows frozen before this round
) -> tuple[torch.Tensor, torch.Tensor]:
    """The vectorized speculative acceptance rule of one verify round
    (``parallax_tpu/ops/sampling.py::speculative_accept``): a proposal is
    accepted while it equals the target at its position, the first
    disagreeing position's target commits as the correction / bonus token,
    and the run is truncated by the window's stop predicate (a stop token
    gated by ``min_new_tokens``, or the length budget; the stopping token
    itself commits). Returns ``(commit_count i32[S], froze bool[S])``, 0
    commits for frozen rows. Static shapes and no host sync, so it runs
    inside a captured window step."""
    w = targets.shape[1]
    js = torch.arange(w, dtype=torch.int32, device=targets.device)
    match = (proposals == targets[:, : w - 1]).to(torch.int32)
    agree = torch.cumprod(match, dim=1).sum(dim=1)
    cand = js[None, :] <= agree[:, None]
    prod_j = produced[:, None] + js[None, :] + 1
    hit = (targets[:, :, None] == stop_tokens[:, None, :]).any(dim=2) & (
        prod_j >= min_req[:, None])
    stops = (hit | (prod_j >= limit[:, None])).to(torch.int32)
    prior = torch.cumsum(stops, dim=1) - stops
    commit = cand & (prior == 0) & ~stopped[:, None]
    c = commit.sum(dim=1).to(torch.int32)
    froze = (commit & (stops > 0)).any(dim=1)
    return c, froze


def token_in_mask(bits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-row single-token bit test against packed masks (i32[B, W] of u32
    words): bool[B]. The speculative window counts proposals the grammar
    mask rejected with it. Out-of-range tokens (the -1 no-proposal sentinel
    included) test False."""
    w = bits.shape[1]
    tok = torch.clamp(tokens, 0, w * 32 - 1).long()
    word = torch.gather(bits.to(torch.int64) & 0xFFFFFFFF, 1,
                        (tok // 32)[:, None])[:, 0]
    bit = (word >> (tok % 32)) & 1
    return bit.bool() & (tokens >= 0) & (tokens < w * 32)
