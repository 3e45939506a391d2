"""StageEngine: the per-node execution engine around one stage (port of
``parallax_tpu/runtime/engine.py``).

Continuous batching, paged KV with the radix prefix cache, chunked prefill,
per-step sampling and the pipeline ring protocol (head commits, mirrors on
later stages), with the JAX package's two-phase step and K-step decode
window:

- ``dispatch()`` forms the plan, assembles device inputs through pinned
  staging buffers and enqueues the forward and the sampler; ``resolve()``
  waits on an event behind the pinned copy of the sampled tokens, then
  commits. ``drive_step`` keeps one step in flight, and a single-stage
  engine feeds each decode row's sampled token back on the device (a
  slot-indexed last-token array), so the host builds step N+1 while the
  card computes step N. ``step()`` is ``resolve(dispatch())``.
- A decode-only batch on a single-stage engine runs a chain of windows of
  K steps (``decode_lookahead``; None = adaptive, K = 8) with an on-device
  stop mask, one D2H pass a chain and commits bounded by each row's
  produced count. On a CUDA device each window step is a replayed CUDA
  graph (``runtime/step_graph.py``; ``cuda_graphs``); elsewhere the same
  step function runs in an eager loop.
- Sampling features (presence / frequency / repetition penalties,
  ``logit_bias``, ``logprobs`` and JSON-schema grammar masks) run in the
  JAX engine's order — penalties, bias, grammar mask, sampler, logprob — on
  the host-synchronous single-step path (``sync_only`` tickets) and inside
  the window, where the per-row counts, DFA rows and logprobs are carried
  state (``WindowState``), so a window commits the K = 1 stream bit for
  bit.
- Speculative decoding (``speculative_tokens``): n-gram or draft-model
  (:class:`DraftProposer`) proposals verify in one multi-token forward
  (the fused prefill path, A0 + A1) — inside the K-step window, where the
  accept rule and the context rewind stay on the device, on the
  host-synchronous K = 1 fallback, and across a pipeline (the head extends
  its decode rows, the last stage verifies, the ring returns
  ``spec_accepted``).
- The host-DRAM KV tier (``host_cache_bytes``; ``runtime/host_cache.py``):
  radix eviction demotes pages to host memory, a host prefix hit swaps
  them back in, a decode short of pages preempts the latest arrival to
  host instead of aborting it, and live migration extracts a request
  (``extract``), harvests its parked image (``harvest_kv_image``) and
  adopts a peer's (``adopt_checkpoint_kv``).
- Hybrid (linear-attention) models (``model.has_linear_layers``): every
  request holds a conv / recurrent state slot beside its pages (null slot
  0 | active ``[1, 2B]`` | prefix snapshots ``(2B, 2B + P]``); prefix hits
  restore from snapshots copied at page boundaries
  (``_maybe_snapshot_state``). Every state copy is in place, so captured
  window graphs keep their pointers. Hybrids take no host tier, no
  speculation and no KV image (recurrent state has no page image and
  cannot be rewound).

Construction raises on every configuration the port does not run yet, and
``submit`` raises on every per-request feature it does not run yet — nothing
is silently ignored.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import random
import time

import numpy as np
import torch

from parallax_tpu_torch.analysis.sanitizer import make_lock

from parallax_tpu_torch.models.base import BatchInputs, StageModel
from parallax_tpu_torch.models.registry import params_to, unported_features
from parallax_tpu_torch.obs import names as mnames
from parallax_tpu_torch.ops import kernel_select
from parallax_tpu_torch.ops.lora import AdapterSet, adapter_tree_from_peft
from parallax_tpu_torch.ops.sampling import (
    FUSED_SAMPLE_TOPK_MAX,
    apply_grammar_mask,
    apply_penalties,
    bias_logits,
    fused_sample_topk,
    greedy_tokens,
    gumbel_rows,
    mask_logits_packed,
    output_token_counts,
    penalize_logits,
    sample_tokens,
    speculative_accept,
    token_in_mask,
    token_logprobs,
)
from parallax_tpu_torch.runtime.batch import (
    BucketSpec,
    HostStaging,
    assemble,
    next_bucket,
    substitute_device_tokens,
)
from parallax_tpu_torch.runtime.allocator import OutOfPages, SlotAllocator
from parallax_tpu_torch.runtime.cache_manager import make_cache_manager
from parallax_tpu_torch.runtime.request import (
    IntermediateRequest,
    Request,
    RequestStatus,
    SamplingParams,
)
from parallax_tpu_torch.runtime.scheduler import (
    BatchPlan,
    ScheduledSeq,
    Scheduler,
)
from parallax_tpu_torch.utils.hw import resolve_device

logger = logging.getLogger(__name__)

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Adaptive multi-step decode: K used per host visit when
# ``EngineConfig.decode_lookahead`` is None and the batch qualifies.
ADAPTIVE_DECODE_LOOKAHEAD = 8
# Unseeded rows of a window draw their noise at steps of a range of their
# own, (1 << 40) + (engine step << 20) + window step, apart from the K=1
# path's engine steps.
_WINDOW_NOISE_STEPS = 1 << 40
# Unseeded rows of a host-synchronous speculative verify (single stage or
# a pipeline's last stage) draw at (1 << 41) + engine step, one row of
# noise per fed position.
_VERIFY_NOISE_STEPS = 1 << 41


@dataclasses.dataclass
class EngineConfig:
    """The JAX package's ``EngineConfig`` field names and defaults. Live in
    the port: page/batch/bucket sizing, the prefix cache, chunked prefill
    and chunk skipping, ``kv_dtype``, ``seed``, ``request_timeout_s``, the
    overlapped step (``overlap_steps``), the K-step decode window
    (``decode_lookahead``, ``decode_pipeline``), the ``decode_fused`` /
    ``prefill_fused`` kernel switches, speculation (``speculative_tokens``,
    ``speculative_ngram``), ``cache_digests`` (the radix
    tree's digest log for cache-aware routing), ``constrained_window``
    (grammar batches ride the decode window; off, they decode on the
    host-synchronous path), ``host_cache_bytes`` (the host KV tier's
    budget; 0 = off), ``trace_sample_rate`` (the share of head requests
    whose lifecycle spans ``obs/trace.py`` records; 0 = off),
    ``slow_request_ms`` (the flight recorder's slow-request threshold) and
    ``qos`` (the multi-tenant QoS spec of ``qos/classes.parse_qos_spec``;
    None or ``off`` wires no policy).
    ``linear_prefix_slots`` / ``linear_decode_snapshot_stride`` size a
    hybrid model's prefix snapshots. The fields listed in ``_UNPORTED``
    must keep their defaults (construction raises otherwise).
    ``wire_dtype`` is read by the swarm worker (``p2p/node.py``), not the
    engine, as in the JAX package; its float8 link mode raises here."""

    page_size: int = 64
    num_pages: int = 1024
    max_batch_size: int = 64
    max_num_tokens_per_batch: int = 2048
    prefill_chunk_size: int = 1024
    max_model_len: int = 8192
    enable_prefix_cache: bool = True
    linear_prefix_slots: int = 32
    linear_decode_snapshot_stride: int = 4
    kv_dtype: str = "bfloat16"
    host_cache_bytes: int = 0
    seed: int = 0
    request_timeout_s: float = 600.0
    sp_threshold: int | None = None
    # Decode steps per host visit: None = adaptive
    # (ADAPTIVE_DECODE_LOOKAHEAD whenever the batch qualifies), an int pins
    # K, 1 = off. Pages for the whole window are reserved up front; the
    # engine falls back to K=1 when they cannot be.
    decode_lookahead: int | None = None
    # Windows chained per host visit off the device-resident state, before
    # any of their tokens is read back. 1 = off.
    decode_pipeline: int = 1
    # Speculative decoding: verify up to this many proposed tokens per
    # decode step (0 = off), proposed by n-gram lookup over the committed
    # context (``speculative_ngram``-grams) or by the engine's ``draft``.
    speculative_tokens: int = 0
    speculative_ngram: int = 3
    constrained_window: bool = True
    # Overlapped decode: dispatch() enqueues, resolve() commits, and the
    # step loops keep one step in flight. False = every ticket resolves at
    # once (the synchronous engine).
    overlap_steps: bool = True
    wire_dtype: str | None = None
    trace_sample_rate: float = 0.0
    slow_request_ms: float = 30_000.0
    # None = the CUDA kernels when the engine's device is CUDA; True = the
    # kernels (raises on a CPU device); False = the split plain path.
    decode_fused: bool | None = None
    prefill_fused: bool | None = None
    prefill_chunk_skip: bool = True
    prefill_seq_parallel: bool = False
    cache_digests: bool = False
    qos: str | None = None
    lora_max_adapters: int = 0


# Engine features not ported yet: field -> the only value accepted.
_UNPORTED = {
    "sp_threshold": None,
    "prefill_seq_parallel": False,
}


@dataclasses.dataclass
class StepOutputs:
    """What one engine step produced."""

    # Packets to forward to the next stage (hidden) or back to the head
    # (sampled token).
    forward: list[IntermediateRequest]
    # Head only: requests that finished this step.
    finished: list[Request]
    num_tokens: int = 0
    step_time_ms: float = 0.0
    # Two-phase step telemetry: ms the host spent on this step (plan,
    # assembly, enqueue, commit and any wait for the device), the wait
    # for the device's results within it, and whether the step's resolve
    # came after a later dispatch.
    host_ms: float = 0.0
    device_ms: float = 0.0
    overlapped: bool = False


@dataclasses.dataclass(eq=False)
class StepTicket:
    """A dispatched step: the plan plus what its dispatch enqueued;
    ``resolve`` completes it. ``outputs`` is pre-filled for empty plans;
    ``sync_only`` marks tickets the step loop must resolve before dispatching
    again."""

    plan: BatchPlan
    step_idx: int
    t0: float
    host_ms: float = 0.0
    sync_only: bool = False
    # Dispatch-entry stamp: resolve compares it with the engine's counter
    # to report whether a later dispatch ran while this one was in flight.
    dispatch_seq: int = 0
    inputs: BatchInputs | None = None
    out: torch.Tensor | None = None
    # The sampled tokens on the device (enqueued at dispatch) and their
    # pinned host copy, started at dispatch.
    tokens_dev: torch.Tensor | None = None
    tokens_host: torch.Tensor | None = None
    # A ``host_hidden`` stage's hidden rows: their pinned host copy,
    # started at dispatch.
    hidden_host: torch.Tensor | None = None
    # Window chain: pinned host copies, started at dispatch, of its
    # [rows, S] token buffer (row j = chain step j) and of the final
    # per-row produced counts, which bound the commits.
    ms_windows: torch.Tensor | None = None
    ms_state: torch.Tensor | None = None
    # Chosen-token logprobs: the single-step path's f32[S] and a window
    # chain's f32[rows, S] pinned host copies (None when no row asked).
    lp_host: torch.Tensor | None = None
    ms_lp: torch.Tensor | None = None
    # Speculative window chain: the pinned [rows, S] commit counts (its
    # ms_windows are then [rows, S, 1 + P]), the grammar-mask rejection
    # flags [rows, S] of a grammar window, and the staging metadata
    # (width, per-row source, the staged proposals) for the resolve-side
    # counters.
    ms_counts: torch.Tensor | None = None
    ms_rej: torch.Tensor | None = None
    spec_meta: dict | None = None
    # Host-synchronous speculative verify: (spec_plan, proposals, source);
    # tokens_host then holds the target token of every fed position.
    spec_verify: tuple | None = None
    # Pipeline last stage: {plan row: fed tokens} of the rows carrying
    # unverified proposals; tokens_host holds every fed position's target
    # and rest_host the other rows' sampled tokens (rest_lp their
    # logprobs).
    spec_rows: dict | None = None
    rest_host: torch.Tensor | None = None
    rest_lp: torch.Tensor | None = None
    # The event behind the ticket's host copies (None on a CPU device).
    ready: object = None
    outputs: StepOutputs | None = None
    # Device-time attribution: the program family this ticket dispatched
    # and, on a CUDA device, timing events recorded on the step's stream
    # at dispatch entry and behind its last enqueue (the ready event when
    # there is one).
    program: str = ""
    ev0: object = None
    ev1: object = None


def drive_step(
    engine: "StageEngine", pending: StepTicket | None
) -> tuple[list[StepOutputs], StepTicket | None]:
    """One iteration of the overlapped step loop (the one-in-flight
    pattern every step loop uses): dispatch step N+1 FIRST — its host work
    runs while the device still computes step N — then resolve step N.
    Tickets that resolved inside dispatch or that are ``sync_only``
    resolve at once; with ``overlap_steps`` off every ticket does.

    Returns (resolved StepOutputs in completion order, the new in-flight
    ticket or None)."""
    outs: list[StepOutputs] = []
    ticket = engine.dispatch() if engine.has_work() else None
    if pending is not None:
        try:
            outs.append(engine.resolve(pending))
        except Exception:
            # The just-dispatched ticket would otherwise be orphaned in
            # the engine's in-flight list, wedging every later dispatch
            # on the one-in-flight invariant.
            if ticket is not None:
                engine.discard(ticket)
            raise
    if ticket is not None:
        if (
            ticket.outputs is not None
            or ticket.sync_only
            or not engine.cfg.overlap_steps
        ):
            outs.append(engine.resolve(ticket))
            ticket = None
    return outs, ticket


@dataclasses.dataclass(eq=False)
class WindowState:
    """Everything a decode window's step reads and writes, as tensors: the
    per-dispatch batch fields, the carry (fed token, context, stop mask,
    produced count, step counter) and the token buffer the step writes at
    the counter's row. Sampler fields are None on an all-greedy window,
    and each sampling feature's fields are None unless a row of the
    window uses it (``StageEngine._pack_window_features``)."""

    page_indices: torch.Tensor     # i32[S, pages_per_seq]
    cu_q_lens: torch.Tensor        # i32[S+1]
    num_seqs: torch.Tensor         # i32[1]
    logits_indices: torch.Tensor   # i32[S]
    feed: torch.Tensor             # i32[S] token fed at the next step
    ctx: torch.Tensor              # i32[S] context after the next step
    stopped: torch.Tensor          # bool[S]
    produced: torch.Tensor         # i32[S]
    counter: torch.Tensor          # i64[1] steps taken in the chain
    tokens: torch.Tensor           # i32[R, S] sampled token per step
    stop_tokens: torch.Tensor      # i32[S, J] (-1 padded)
    limit: torch.Tensor            # i32[S] tokens left before a length stop
    min_req: torch.Tensor          # i32[S] min_new_tokens left
    temp: torch.Tensor | None = None
    top_k: torch.Tensor | None = None
    top_p: torch.Tensor | None = None
    min_p: torch.Tensor | None = None
    seeds: torch.Tensor | None = None   # i64[S]; < 0 = unseeded
    steps0: torch.Tensor | None = None  # i64[S] noise step at counter 0
    # Penalties: per-row strengths (neutral 0 / 0 / 1.0) and the carried
    # generated-token counts.
    pen_pres: torch.Tensor | None = None    # f32[S]
    pen_freq: torch.Tensor | None = None    # f32[S]
    pen_rep: torch.Tensor | None = None     # f32[S]
    pen_counts: torch.Tensor | None = None  # i32[S, V]
    # logit_bias: the biased rows (-1 padded) and their dense vectors.
    bias_rows: torch.Tensor | None = None   # i32[G]
    bias_vecs: torch.Tensor | None = None   # f32[G, V]
    # Grammar: the batch's combined dense tables, per-row flags and dead
    # rows, and the carried DFA row of each row.
    g_trans: torch.Tensor | None = None     # i32[R, Vg]
    g_allowed: torch.Tensor | None = None   # i32[R, ceil(Vg / 32)] bits
    g_constrained: torch.Tensor | None = None  # bool[S]
    g_dead: torch.Tensor | None = None      # i32[S]
    dfa: torch.Tensor | None = None         # i32[S]
    # Logprobs: written at the counter's row, like ``tokens``.
    lps: torch.Tensor | None = None         # f32[R, S] (f32[R, S, W] spec)
    # Speculative window: the staged proposals, read at each row's produced
    # count, and per step the commit counts and the grammar-mask
    # rejection flags. ``tokens`` is then i32[R, S, W], W = 1 + P.
    props: torch.Tensor | None = None       # i32[S, L] (-1 = none)
    counts: torch.Tensor | None = None      # i32[R, S]
    rejs: torch.Tensor | None = None        # i32[R, S]
    # Hybrid models: the batch's dense view, constant over the window (one
    # step a row, no reset: every row is decoding).
    state_slots: torch.Tensor | None = None  # i32[S]
    dense_map: torch.Tensor | None = None    # i32[S, 1]
    q_lens: torch.Tensor | None = None       # i32[S]
    reset_state: torch.Tensor | None = None  # i32[S]
    # Per-request LoRA: the batch's adapter slot (one adapter) or every
    # token row's slot (a mixed batch), read by each step from the state,
    # so a graph of the key serves whichever adapter the window carries.
    lora_slot: torch.Tensor | None = None    # i64[1]
    lora_slots: torch.Tensor | None = None   # i32[T]

    def _tensors(self):
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]

    def clone(self) -> "WindowState":
        return dataclasses.replace(
            self, **{name: t.clone() for name, t in self._tensors()})

    def copy_(self, other: "WindowState") -> None:
        for name, t in self._tensors():
            t.copy_(getattr(other, name))


def _fit(x: torch.Tensor, t: int, fill: int) -> torch.Tensor:
    """``x [S]`` cut or padded with ``fill`` to ``t`` rows."""
    s = x.shape[0]
    if t <= s:
        return x[:t]
    return torch.cat([x, x.new_full((t - s,), fill)])


def window_feature_logits(st: WindowState,
                          logits: torch.Tensor) -> torch.Tensor:
    """A window step's feature pass before the sampler, in the host
    sampler's order (``StageEngine._apply_features``): penalties from the
    carried counts, then the bias rows, then the packed grammar mask at
    each row's carried DFA row. Every feature the window carries applies to
    every row, neutral rows with neutral values."""
    if st.pen_counts is not None:
        logits = apply_penalties(logits, st.pen_counts, st.pen_pres,
                                 st.pen_freq, st.pen_rep)
    if st.bias_rows is not None:
        logits = bias_logits(logits, st.bias_rows, st.bias_vecs)
    if st.dfa is not None:
        logits = mask_logits_packed(logits, st.g_allowed[st.dfa.long()],
                                    st.g_constrained)
    return logits


def window_feature_advance(st: WindowState, logits: torch.Tensor,
                           nxt: torch.Tensor, live: torch.Tensor) -> None:
    """A window step's feature pass after the sampler: the chosen token's
    logprob off the FINAL logits (as the host path takes it) at the
    counter's row, the live rows' counts, and each live constrained row's
    DFA row, which goes to its dead row for a token at or past the grammar
    vocabulary (``TokenTable.advance``; the mask keeps live constrained
    rows from sampling one)."""
    if st.lps is not None:
        st.lps.index_copy_(0, st.counter, token_logprobs(logits, nxt)[None])
    if st.pen_counts is not None:
        st.pen_counts.scatter_add_(1, nxt.long()[:, None],
                                   live.to(torch.int32)[:, None])
    if st.dfa is not None:
        vg = st.g_trans.shape[1]
        adv = st.g_trans[st.dfa.long(), torch.clamp(nxt, 0, vg - 1).long()]
        adv = torch.where(nxt < vg, adv, st.g_dead)
        st.dfa.copy_(torch.where(st.g_constrained & live, adv, st.dfa))


def _pow2(n: int) -> int:
    """The smallest power of 2 >= n (the feature rows' bucket)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _pad_id_lists(gen: dict[int, list[int]], s: int) -> np.ndarray:
    """Per-row id lists as i32[s, L], -1 padded, L a power of 2 >= 8 (the
    JAX engine's lattice for penalty histories)."""
    out = np.full((s, max(8, _pow2(max(map(len, gen.values()),
                                       default=0)))), -1, np.int32)
    for i, ids in gen.items():
        out[i, : len(ids)] = ids
    return out


class DraftProposer:
    """Draft-model proposal source for speculative decoding (the JAX
    package's ``DraftProposer``).

    Wraps a single-stage engine (prefix cache on) serving the same
    vocabulary: each proposal round submits every row's committed context
    and decodes up to its budget of greedy draft tokens, all rows in one
    draft-engine run, driven synchronously on the caller's thread (the
    target's step thread, the only thread that touches the card). The
    draft's prefix cache makes consecutive rounds incremental. The target
    verifies every proposal, so draft quality moves speed, never outputs.

    Proposal wall time is bounded (``max_propose_ms``): on the deadline the
    run stops and whatever each draft produced so far becomes its (shorter)
    proposal; unfinished drafts are aborted and released, never left
    queued. ``propose_s`` / ``rounds`` total the rounds' host wall time.

    The draft engine may be built on the target's own parameter tensors
    (``StageEngine`` keeps tensors already on its device), so a draft that
    is the served tree, or its first layers, costs no second copy of the
    weights.
    """

    def __init__(self, engine: "StageEngine", max_propose_ms: float = 250.0):
        if not (engine.model.is_first and engine.model.is_last):
            raise ValueError("draft engine must be a full single stage")
        self.engine = engine
        # The target prices the draft's bytes (spec_draft); the draft's
        # own ledger classes would overwrite the target's.
        engine._obs_draft = True
        # The proposal loop drives step() synchronously: the deferred
        # sampler would be pure overhead inside the propose budget.
        engine.cfg.overlap_steps = False
        # The draft's kernels load from whatever compilation cache the
        # process already chose (the serving entry points choose it before
        # building the proposer): the proposer records that directory and
        # never re-points it.
        from parallax_tpu_torch.utils.compile_cache import active_cache_dir

        self.compile_cache_dir = active_cache_dir()
        self.max_propose_ms = max_propose_ms
        self._counter = 0
        self.propose_s = 0.0
        self.rounds = 0

    def propose_batch(
        self, contexts: list[list[int]], budgets: list[int]
    ) -> list[list[int]]:
        t0 = time.perf_counter()
        reqs: list[Request | None] = []
        for ctx, budget in zip(contexts, budgets):
            k = min(budget, self.engine.cfg.max_model_len - len(ctx) - 1)
            if k <= 0 or len(ctx) >= self.engine.cfg.max_model_len:
                reqs.append(None)
                continue
            req = Request(
                f"__draft{self._counter}",
                prompt_ids=list(ctx),
                sampling_params=SamplingParams(
                    temperature=0.0, max_new_tokens=k, ignore_eos=True
                ),
            )
            self._counter += 1
            if not self.engine.submit(req):
                reqs.append(None)
                continue
            reqs.append(req)
        if any(r is not None for r in reqs):
            deadline = time.perf_counter() + self.max_propose_ms / 1000.0
            guard = 0
            while self.engine.has_work() and guard < 10_000:
                self.engine.step()
                guard += 1
                if time.perf_counter() >= deadline:
                    break
            for req in reqs:
                if req is not None and not req.status.is_finished:
                    self.engine.release(req.request_id, abort=True)
        self.propose_s += time.perf_counter() - t0
        self.rounds += 1
        return [list(r.output_ids) if r is not None else [] for r in reqs]


class StageEngine:
    """Continuous-batching engine for one pipeline stage.

    ``cuda_graphs`` follows ``decode_fused``'s rule: None = the decode
    window's steps replay CUDA graphs when the device is CUDA, True = they
    do (raises on another device), False = the eager loop.

    ``host_hidden`` (a stage that is not the last): each step's hidden
    rows leave the card in one pinned D2H copy started at dispatch, and
    ``resolve`` hands the forwards CPU tensors of their own, as the JAX
    engine hands back host arrays. The swarm worker sets it, so its sender
    threads never touch a CUDA tensor; off, the forwards are views of the
    step's output on the device (the in-process pipeline).

    ``draft`` (a :class:`DraftProposer`) proposes the speculative tokens
    instead of n-gram lookup; ``use_native`` picks the cache manager
    (``make_cache_manager``: None = the native one unless a gate says
    otherwise, True = the native one or raise)."""

    def __init__(
        self,
        model: StageModel,
        params: dict,
        config: EngineConfig | None = None,
        device=None,
        cuda_graphs: bool | None = None,
        host_hidden: bool = False,
        draft: DraftProposer | None = None,
        use_native: bool | None = None,
    ):
        self.cfg = config or EngineConfig()
        for name, want in _UNPORTED.items():
            got = getattr(self.cfg, name)
            if got != want:
                raise NotImplementedError(
                    f"EngineConfig.{name}={got!r}: not ported yet to "
                    f"parallax_tpu_torch (only {want!r})"
                )
        # The model's own class decides: a base block built around an MSA
        # config would serve dense attention in silence.
        feats = unported_features(model.config, type(model))
        if feats:
            raise NotImplementedError(
                f"{', '.join(feats)}: not ported yet to parallax_tpu_torch"
            )
        if self.cfg.kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"kv_dtype {self.cfg.kv_dtype!r}: want one of "
                f"{sorted(_KV_DTYPES)}"
            )
        self.device = resolve_device(device)
        if cuda_graphs is None:
            cuda_graphs = self.device.type == "cuda"
        elif cuda_graphs and self.device.type != "cuda":
            raise ValueError(
                f"cuda_graphs=True needs a CUDA device, got {self.device}"
            )
        self.model = model
        # The stage label every observability surface carries (metric
        # labels, trace-span lanes, flight events).
        self._obs_stage = f"{model.start_layer}-{model.end_layer}"
        self.host_hidden = host_hidden and not model.is_last
        self.params = params_to(params, self.device)
        # Hybrid (linear-attention) stages carry per-request state slots:
        # null (0) | active [1, 2B] | prefix snapshots (2B, 2B + P].
        self._needs_state = bool(getattr(model, "has_linear_layers", False))
        n_prefix_slots = (self.cfg.linear_prefix_slots
                          if self._needs_state and self.cfg.enable_prefix_cache
                          else 0)
        state_kw = {}
        if self._needs_state:
            active = 2 * self.cfg.max_batch_size
            self._slot_alloc = SlotAllocator(active)
            self._prefix_slot_base = active + 1
            self._prefix_slot_alloc = SlotAllocator(n_prefix_slots)
            state_kw["num_state_slots"] = active + n_prefix_slots
            if self.cfg.speculative_tokens > 0:
                # Rejected proposals would leave the recurrent state past
                # the committed context, with no way to rewind it.
                logger.warning(
                    "speculative decoding disabled: a hybrid linear-state "
                    "model cannot rewind rejected proposals")
                self.cfg = dataclasses.replace(self.cfg,
                                               speculative_tokens=0)
        # One cache per local layer (a paged KV, or a linear layer's state
        # pair), updated in place by every step.
        self.kv = model.new_kv_caches(
            self.cfg.num_pages, self.cfg.page_size,
            _KV_DTYPES[self.cfg.kv_dtype], self.device, **state_kw,
        )
        # An attention-only head of a hybrid pipeline must not skip a
        # prefix: it would pick page boundaries the linear stages after it
        # hold no snapshot for. Attention-only later stages match on pages
        # alone (the mirror clamp keeps their skip equal to the head's).
        hybrid_attention_only_head = (
            model.config.linear_attn is not None and model.is_first
            and not model.is_last and not self._needs_state)
        # Host-DRAM KV tier: demotion target for radix eviction and
        # preemption; its transfers read and write self.kv in place (the
        # captured window graphs hold the cache tensors' pointers).
        self.host_tier = None
        if self.cfg.host_cache_bytes > 0 and self._needs_state:
            logger.warning(
                "host KV tier disabled: hybrid linear-state KV cannot be "
                "paged to host (recurrent state has no page image)")
        elif self.cfg.host_cache_bytes > 0:
            from parallax_tpu_torch.runtime.host_cache import (
                tier_from_paged_kv,
            )

            self.host_tier = tier_from_paged_kv(
                self.cfg.host_cache_bytes, lambda: self.kv,
                self.cfg.num_pages,
            )
            if self.host_tier is None:
                logger.warning(
                    "host KV tier disabled: unsupported KV layout or "
                    "budget below one page",
                )
        self.cache = make_cache_manager(
            self.cfg.page_size,
            self.cfg.num_pages,
            enable_prefix_cache=(
                self.cfg.enable_prefix_cache
                and (not self._needs_state or n_prefix_slots > 0)
                and not hybrid_attention_only_head),
            max_model_len=self.cfg.max_model_len,
            prefill_chunk_skip=self.cfg.prefill_chunk_skip,
            track_digests=self.cfg.cache_digests,
            host_tier=self.host_tier,
            use_native=use_native,
            linear_state=self._needs_state,
            on_slot_free=(self._on_prefix_slot_free if self._needs_state
                          else None),
        )
        qos_policy = None
        if self.cfg.qos:
            from parallax_tpu_torch.qos import QoSPolicy, parse_qos_spec

            qos_config = parse_qos_spec(self.cfg.qos)
            if qos_config is not None:
                qos_policy = QoSPolicy(qos_config, stage_name=self._obs_stage)
        self.scheduler = Scheduler(
            self.cache,
            max_batch_size=self.cfg.max_batch_size,
            max_num_tokens_per_batch=self.cfg.max_num_tokens_per_batch,
            prefill_chunk_size=self.cfg.prefill_chunk_size,
            request_timeout_s=self.cfg.request_timeout_s,
            stage_name=self._obs_stage,
            qos=qos_policy,
            snapshot_page_align=(
                self.cfg.page_size
                if self._needs_state and self.cache.enable_prefix_cache
                else None),
        )
        self.spec = BucketSpec.build(
            self.cfg.max_num_tokens_per_batch,
            self.cfg.max_batch_size,
            self.cfg.max_model_len,
            self.cfg.page_size,
        )
        self._decode_fused = kernel_select.resolve_decode_fused(
            self.cfg.decode_fused, self.device
        )
        self._prefill_fused = kernel_select.resolve_prefill_fused(
            self.cfg.prefill_fused, self.device
        )
        # The fused prefill kernels are GQA's; MLA and MSA families keep
        # their split prefill chain, as in the JAX package.
        is_mla = model.config.is_mla
        if is_mla or model.config.msa is not None:
            self._prefill_fused = False
        # Models with a decode-specialized split kernel (MLA: A6; the DSA
        # indexer: A8; sinks: A9) mark one-token batches decode_only even
        # when fused decode is off, as the JAX package does
        # (``is_mla or msa or use_attention_sinks``); fused decode marks
        # them for every model.
        cfg_m = model.config
        self._use_decode_flag = (
            is_mla or cfg_m.msa is not None or cfg_m.use_attention_sinks
            or self._decode_fused
        )
        self._attn_impl = kernel_select.decode_attn_impl(
            self._decode_fused, model.use_kernels, self.device
        )
        self._prefill_impl = kernel_select.prefill_attn_impl(
            self._prefill_fused, model.use_kernels, self.device
        )
        # Bumped on the step thread, summarized from heartbeat and status
        # threads.
        self._kernel_lock = make_lock("engine.kernel_counts")
        self._kernel_counts: dict[tuple[str, str], int] = {}
        self._step_count = 0
        # Non-head stages: hidden rows waiting per request id (tensors on
        # this engine's device, in the model's dtype).
        self._pending_hidden: dict[str, torch.Tensor] = {}
        # Overlapped two-phase stepping: at most ONE unresolved ticket may
        # be outstanding when dispatch() is entered (the one-in-flight
        # invariant); the device-resident last-token array feeds decode
        # rows whose sampled token has not reached the host yet. Its last
        # entry takes the scatter's dropped rows.
        self._inflight: list[StepTicket] = []
        # EWMA per-layer decode latency published to the global scheduler
        # (reference base_executor.py:716-732); host-side, read by the
        # worker's heartbeat thread.
        self.layer_latency_ms_ewma: float | None = None
        self._dispatch_seq = 0
        self._last_token_dev = torch.zeros(
            (self.cfg.max_batch_size + 1,), dtype=torch.int32,
            device=self.device,
        )
        self._token_slots: dict[str, int] = {}
        self._free_token_slots = list(range(self.cfg.max_batch_size))
        self._staging = HostStaging(self.device)
        self._graphs = None
        if cuda_graphs:
            from parallax_tpu_torch.runtime.step_graph import WindowGraphs

            self._graphs = WindowGraphs(self.device)
        self._last_fused_steps = 0
        # Per-request LoRA adapters (ops/lora.py); None until the first
        # load_adapter, so base-only serving never touches the machinery.
        self._adapters = None
        # The adapter stack generation the window graphs were captured
        # over (graphs of an older stack are dropped, never replayed).
        self._graph_lora_gen = None
        # Grammar-constrained decoding (json_schema): set by the serving
        # layer on the LAST stage via set_grammar_vocab(); per-request
        # (TokenTable, DFA state) entries keyed by request id.
        self.grammar = None
        self._grammar_states: dict[str, tuple] = {}
        # Per-request dense logit_bias vectors (built once per request).
        self._bias_cache: dict[str, np.ndarray] = {}
        # Combined grammar tables on the device, per grammar combination.
        self._gram_combo_cache: dict[tuple, tuple] = {}
        self._constrained_stats: dict[str, int] = {}
        self._constrained_lock = make_lock("engine.constrained")
        self._warned_constrained_off = False
        # Decode windows enqueued per sampling-feature set (() = none).
        self.window_feature_counts: dict[tuple, int] = {}
        # Speculative decoding: the draft proposer (None = n-gram lookup),
        # per-source proposed / accepted / rejected totals, and the
        # pipeline last stage's verify rounds and tokens accepted.
        if self.cfg.speculative_tokens < 0:
            raise ValueError("speculative_tokens must be >= 0")
        self.draft = draft
        self._spec_lock = make_lock("engine.spec_counts")
        self._spec_stats: dict[str, dict[str, int]] = {}
        self._spec_t0 = time.monotonic()
        self.pp_spec_rounds = 0
        self.pp_spec_tokens = 0
        if self.cfg.speculative_tokens > 0 and not (
            model.is_first and model.is_last
        ):
            logger.warning(
                "speculative decode windows disabled: multi-stage "
                "pipeline verifies proposals via pp-spec with a "
                "synchronous resolve",
            )
        # host_ms / device_ms / overlap EWMAs for heartbeats and
        # /cluster/status, the same samples feeding the registry's
        # histograms.
        from parallax_tpu_torch.utils.request_metrics import (
            StepTimingAggregator,
        )

        self._init_obs()
        self.step_timing = StepTimingAggregator(
            host_hist=self._h_step_host, device_hist=self._h_step_device,
            per_token_hist=self._h_step_per_token,
        )
        if self._graphs is not None:
            self._graphs.on_capture = self._on_graph_capture

    # -- intake -----------------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Head node: accept a fresh user request."""
        if not self.model.is_first:
            raise ValueError("submit() is for the head stage")
        if not request.prompt_ids:
            raise ValueError("prompt must contain at least one token")
        if request.num_prompt_tokens >= self.cfg.max_model_len:
            raise ValueError(
                f"prompt length {request.num_prompt_tokens} exceeds "
                f"max_model_len {self.cfg.max_model_len}"
            )
        # Clamp generation to the context budget so oversized max_tokens
        # finish at the length limit instead of dying on KV exhaustion.
        cap = (
            self.cfg.max_model_len - request.num_prompt_tokens
            + request.output_offset
        )
        sp = request.sampling_params
        if sp.max_new_tokens > cap:
            sp.max_new_tokens = cap
        # Lifecycle-trace sampling: the head decides, and the flag rides
        # the FORWARD frames so later stages join the same trace.
        if request.traced or (
            self._trace_rate > 0.0 and random.random() < self._trace_rate
        ):
            self._trace_begin(request)
        return self.scheduler.enqueue(request)

    def submit_intermediate(self, ireq: IntermediateRequest) -> None:
        """Non-head stage: accept an inter-stage packet, building/extending
        a mirror Request that tracks this stage's KV state."""
        rid = ireq.request_id
        req = self.scheduler.running.get(rid) or self.scheduler.wait_queue.get(rid)
        if ireq.abort:
            if req is not None:
                req.abort("upstream")
            return
        new_tokens = ireq.token_ids or [0] * ireq.num_new_tokens
        if req is None:
            # Head-side prefix-cache skip: prepend the skipped ids so this
            # stage's own prefix match aligns to the same absolute positions.
            prefix = list(ireq.cached_prefix_ids or [])
            req = Request(
                request_id=rid,
                prompt_ids=prefix + list(new_tokens),
                sampling_params=SamplingParams.from_dict(
                    ireq.sampling_params or {}
                ),
                routing_table=list(ireq.routing_table),
                # The adapter rides the wire: this stage groups, applies
                # and namespaces by it as the head does.
                lora_id=ireq.lora_id,
                # The class rides the wire so this stage's EDF order (when
                # QoS is on here) matches the head's.
                qos_class=ireq.qos_class,
            )
            req.is_mirror = True  # type: ignore[attr-defined]
            # This stage MUST start computing at exactly this offset: rows
            # before it never arrive.
            req.mirror_head_cached = len(prefix)  # type: ignore[attr-defined]
            if prefix:
                req.mirror_prefix_ids = prefix  # type: ignore[attr-defined]
            self.scheduler.enqueue(req)
        else:
            # Pipeline speculation: the packet's context_len -
            # num_new_tokens is the head's context before these tokens. A
            # longer mirror can only hold the previous round's rejected
            # proposals: drop them (their KV lies past the live context
            # and is overwritten position by position).
            prior = ireq.context_len - ireq.num_new_tokens
            if 0 <= prior < len(req.prompt_ids):
                excess = len(req.prompt_ids) - prior
                del req.prompt_ids[prior:]
                gen = getattr(req, "mirror_gen_ids", None)
                if gen:
                    del gen[max(0, len(gen) - excess):]
                req.num_computed_tokens = min(req.num_computed_tokens, prior)
            if getattr(req, "last_chunk_flag", False):
                # The prompt was complete before this packet: these tokens
                # are generated ones.
                req.mirror_gen_ids = (  # type: ignore[attr-defined]
                    getattr(req, "mirror_gen_ids", []) + list(new_tokens)
                )
            req.prompt_ids.extend(new_tokens)
            req.set_status(RequestStatus.PREFILLING, "mirror-chunk")
            req.ready_for_step = True
        if ireq.trace and req.request_id not in self._traced:
            # An upstream stage sampled this request: record this stage's
            # spans under the same trace id (begin() is idempotent, so an
            # in-process pipeline shares one span list).
            self._trace_begin(req)
        if ireq.spec_len > 0:
            # The last spec_len tokens are unverified proposals; the last
            # stage verifies them against its own logits.
            req.pp_spec_fed = list(new_tokens)  # type: ignore[attr-defined]
        elif hasattr(req, "pp_spec_fed"):
            del req.pp_spec_fed
        req.last_chunk_flag = ireq.is_last_chunk  # type: ignore[attr-defined]
        if ireq.hidden_states is not None:
            h = ireq.hidden_states.to(self.device)
            prev = self._pending_hidden.get(rid)
            self._pending_hidden[rid] = (
                h if prev is None else torch.cat([prev, h], dim=0)
            )

    # -- per-request LoRA -------------------------------------------------

    def load_adapter(self, name: str, source) -> None:
        """Register a LoRA adapter for per-request serving.

        ``source``: a PEFT adapter directory (this stage slices out its
        own layers) or a prebuilt tree ``{local_layer: {"group.proj": (A,
        B, scale)}}`` of numpy arrays or tensors. Requests carrying
        ``lora_id=name`` are then batch-grouped by the scheduler and served
        with the adapter's delta applied in the step."""
        if self._adapters is None:
            self._adapters = AdapterSet(
                max_adapters=self.cfg.lora_max_adapters, device=self.device)
        tree = source
        if isinstance(source, str):
            tree = adapter_tree_from_peft(
                source, self.model.start_layer, self.model.end_layer)
        # The LRU must never evict an adapter with in-flight requests:
        # their next batch would have no weights to select. Hot-loads
        # arrive on a control thread while the step thread mutates the
        # scheduler dicts, so the snapshot retries on a concurrent resize
        # and degrades to "everything is active" (no eviction this round)
        # if it keeps racing. A request submitted after the snapshot can
        # still lose its adapter: it is aborted with the reason at batch
        # formation, never served on other weights.
        active = None
        for _ in range(8):
            try:
                active = {
                    r.lora_id
                    for r in (list(self.scheduler.running.values())
                              + list(self.scheduler.wait_queue.values()))
                    if r.lora_id is not None
                }
                break
            except RuntimeError:   # dict resized mid-snapshot
                continue
        if active is None:
            active = set(self._adapters.names)
        self._adapters.register(name, tree, active=active)

    def has_adapter(self, name: str) -> bool:
        return self._adapters is not None and name in self._adapters

    def adapter_names(self) -> list[str]:
        """Registered per-request adapters (frontend advertising)."""
        return self._adapters.names if self._adapters is not None else []

    def _drop_unknown_adapters(self, plan: BatchPlan) -> BatchPlan:
        """Abort the rows whose adapter this stage does not hold, with the
        reason, instead of serving them on the base weights: the whole
        batch of a single-adapter plan, only the bad rows of a mixed
        one."""
        if plan.mixed_lora:
            bad = [seg for seg in plan.seqs
                   if seg.request.lora_id is not None
                   and not self.has_adapter(seg.request.lora_id)]
            if not bad:
                return plan
            for seg in bad:
                seg.request.abort(
                    f"unknown lora adapter {seg.request.lora_id!r}")
            return BatchPlan([s for s in plan.seqs if s not in bad],
                             mixed_lora=True)
        if plan.lora_id is not None and not self.has_adapter(plan.lora_id):
            for seg in plan.seqs:
                seg.request.abort(f"unknown lora adapter {plan.lora_id!r}")
            return BatchPlan([])
        return plan

    def _mixed_slots(self, plan: BatchPlan, t: int) -> np.ndarray:
        """A mixed batch's per-token slots for a bucket of ``t`` token
        rows: each row's adapter slot over its tokens, the null slot on
        padding."""
        null = self._adapters.token_slot(None)
        slots = np.full((t,), null, np.int32)
        row = 0
        for seg in plan.seqs:
            n = seg.num_new_tokens
            slots[row : row + n] = self._adapters.token_slot(
                seg.request.lora_id)
            row += n
        return slots

    def _lora_field(self, plan: BatchPlan, inputs: BatchInputs):
        """The step's ``BatchInputs.lora`` (None for base traffic). The
        slot(s) go to the device through the staging buffers. A mixed
        batch's slot vector is sized by the bucket's token rows
        (``positions``: a non-head stage has no ``token_ids``)."""
        if self._adapters is None:
            return None
        if plan.mixed_lora:
            t = int(inputs.positions.shape[0])
            return self._adapters.mixed_batch_field(self._staging.put(
                "lora_slots", self._mixed_slots(plan, t)))
        if plan.lora_id is None:
            return None
        return self._adapters.batch_field(
            plan.lora_id, self._staging.put(
                "lora_slot",
                np.array([self._adapters.slot_of(plan.lora_id)], np.int64)))

    def release(self, request_id: str, abort: bool = False) -> None:
        """Finish/abort broadcast: free this stage's state for a request.
        On a normal finish the mirror's full pages are donated to this
        stage's prefix cache; on abort they are freed."""
        req = self.scheduler.running.get(request_id) or (
            self.scheduler.wait_queue.get(request_id)
        )
        self._pending_hidden.pop(request_id, None)
        self._grammar_states.pop(request_id, None)
        self._bias_cache.pop(request_id, None)
        self._free_token_slot(request_id)
        self._traced.discard(request_id)
        if req is not None:
            req.device_feed_ready = False
            if not req.status.is_finished:
                if abort:
                    req.abort("released")
                else:
                    req.set_status(RequestStatus.FINISHED_EOS, "release")
            self.scheduler.release_request(req)
            self._free_state_slot(req)

    def on_weights_replaced(self) -> int:
        """The stage's weights were overwritten in place (a refit,
        ``p2p/refit.py::apply_prefetched``), on the thread that steps
        this engine: from now on no admission reuses KV computed under
        the old weights. The prefix cache is invalidated in every adapter
        namespace, with the host tier's pages and the hybrid models'
        linear-state snapshots it holds (``invalidate_prefix_cache``;
        the draft's too). Requests in flight keep their own pages and
        finish, as in the JAX package, but their pre-refit pages never
        enter the prefix cache. The window graphs stay valid: the weights
        kept their addresses. Returns the pages invalidated, also counted
        in ``cache_stats()["pages_invalidated"]``."""
        n = self.cache.invalidate_prefix_cache()
        if self.draft is not None:
            self.draft.engine.on_weights_replaced()
        return n

    def has_work(self) -> bool:
        return self.scheduler.num_requests() > 0

    def cache_stats(self) -> dict:
        """The JAX ``cache_stats_summary`` payload: tokens admitted,
        reused (from device and host pages) and skipped, hit rates, pages
        evicted, preemptions, resumes, KV-exhaustion aborts, page
        occupancy and cached pages; with a tier, its occupancy and its
        demotion / swap-in / eviction counts."""
        from types import SimpleNamespace

        from parallax_tpu_torch.utils.request_metrics import (
            cache_stats_summary,
        )

        # Occupancy and the cached-page count come from the step thread's
        # snapshot: a heartbeat thread calls this, and the native
        # manager's counts are ctypes calls with no lock.
        snap = self._obs_snap
        out = cache_stats_summary(SimpleNamespace(
            stats=self.cache.stats, num_pages=snap["num_pages"],
            num_free_pages=snap["free_pages"],
            prefix_cache=SimpleNamespace(
                num_cached_pages=snap["cached_pages"]),
            host_tier=self.host_tier,
        ))
        if out is not None:
            # Tree pages weight refits made unmatchable (port only: the
            # JAX refit keeps its prefix cache).
            out["pages_invalidated"] = self.cache.stats.pages_invalidated
        return out

    # -- live migration (runtime/checkpoint.py) ----------------------------

    def inflight_rids(self) -> set[str]:
        """Request ids scheduled in a dispatched-but-unresolved step or
        window chain — their KV pages are being written on the device."""
        out: set[str] = set()
        for t in self._inflight:
            out.update(s.request.request_id for s in t.plan.seqs)
        return out

    def extract(self, request_id: str, force: bool = False) -> Request | None:
        """Remove a request from this stage WITHOUT finishing it: the
        migration flow parks it into a checkpoint instead. Refuses while
        the request rides an in-flight step or window (its pages are being
        written) unless ``force`` (the engine is being discarded
        wholesale). Drops the same per-request state ``release`` does. The
        caller owns the cache cleanup (harvest the KV image first, then
        ``cache.release``)."""
        if not force and request_id in self.inflight_rids():
            return None
        sched = self.scheduler
        req = sched.running.pop(request_id, None) or sched.wait_queue.pop(
            request_id, None
        )
        if req is None:
            return None
        self._pending_hidden.pop(request_id, None)
        self._grammar_states.pop(request_id, None)
        self._bias_cache.pop(request_id, None)
        self._free_token_slot(request_id)
        self._traced.discard(request_id)
        self._free_state_slot(req)
        req.device_feed_ready = False
        return req

    def handoff_ready_rids(self) -> list[str]:
        """Head-owned requests past the prefill / decode boundary (prompt
        KV fully computed, first token committed): the set a prefill-role
        head hands to the decode pool each step-loop pass. Excludes
        mirrors, finished rows and rows already flagged for migration or
        handoff (``migrating`` also stops the local scheduler from
        planning them into further steps and windows, so the park lands
        once the window in flight resolves)."""
        return [
            rid for rid, req in self.scheduler.running.items()
            if req.status is RequestStatus.DECODING
            and req.is_prefill_done
            and not req.migrating
            and not getattr(req, "is_mirror", False)
        ]

    def kv_page_signature(self) -> tuple | None:
        """Shape/dtype identity of one KV page across this stage's layers,
        in the JAX engine's form (dtype names included), so a port
        signature equals a JAX one for the same layout. Two engines may
        exchange raw KV images only when these match exactly; None when
        the layout has no page-granular image (tuple caches, a hybrid's
        linear state)."""
        from parallax_tpu_torch.p2p.proto import dtype_name

        kv = self.kv
        if self._needs_state or not isinstance(kv, (list, tuple)) or not kv:
            return None
        sig = []
        for a in kv:
            if (
                not isinstance(a, torch.Tensor)
                or a.dim() < 2
                or a.shape[0] != self.cfg.num_pages
            ):
                return None
            sig.append((tuple(int(x) for x in a.shape[1:]),
                        dtype_name(a.dtype)))
        return (
            self.cfg.page_size, self.model.start_layer,
            self.model.end_layer, self.cfg.kv_dtype, tuple(sig),
        )

    def harvest_kv_image(self, request: Request):
        """Serialize a just-preempted request's pinned host image into a
        checkpoint :class:`KVImage` (live migration). The handles stay
        owned by the request — ``cache.release`` frees them after the
        checkpoint ships. None when the image is unavailable (no host
        tier, partial demotion, unsupported layout)."""
        from parallax_tpu_torch.runtime.checkpoint import KVImage

        handles = getattr(request, "host_page_handles", None)
        tier = self.host_tier
        if not handles or tier is None or any(h is None for h in handles):
            return None
        if self.kv_page_signature() is None:
            return None
        shared_fn = getattr(self.cache, "shared_prefix_tokens", None)
        prefix = shared_fn(request.request_id) if shared_fn else 0
        datas = [tier.pool.load(h) for h in handles]
        layers = [
            torch.stack([d[i] for d in datas])
            for i in range(len(datas[0]))
        ]
        return KVImage(
            page_size=self.cfg.page_size,
            start_layer=self.model.start_layer,
            end_layer=self.model.end_layer,
            kv_dtype=self.cfg.kv_dtype,
            prefix_tokens=prefix,
            computed_tokens=request.num_computed_tokens,
            layers=layers,
        )

    def adopt_checkpoint_kv(self, request: Request, image) -> bool:
        """Adopt a migrated-in KV image: park it pinned in the host tier and
        register the request as PREEMPTED, so the ordinary
        ``resume_from_host`` admission swaps it onto the device — no
        re-prefill. False (request untouched, image dropped) when the
        layouts mismatch or the local radix does not cover the image's
        shared prefix; the caller then re-prefills, which is always
        correct."""
        tier = self.host_tier
        adopt = getattr(self.cache, "adopt_migrated", None)
        if tier is None or adopt is None:
            return False
        if image.signature != self.kv_page_signature():
            return False
        total = request.num_prompt_tokens + request.num_output_tokens
        computed = min(int(image.computed_tokens), total - 1)
        if computed < image.prefix_tokens:
            return False
        handles = tier.store_image(image.layers)
        if handles is None:
            return False
        if not adopt(request, handles, image.prefix_tokens):
            tier.free(handles)
            return False
        request.num_computed_tokens = computed
        request.set_status(RequestStatus.PREEMPTED, "restore-adopt")
        return True

    def cache_digest_payload(self, full: bool = False) -> dict | None:
        """Prefix-digest delta / snapshot for cache-aware routing
        heartbeats (None when ``cfg.cache_digests`` is off or the manager
        tracks no digests, as the native one). Host state only: a heartbeat
        thread may call it."""
        fn = getattr(self.cache, "digest_payload", None)
        return fn(full=full) if fn is not None else None

    # -- sampling features: grammar state and telemetry -------------------

    def set_grammar_vocab(self, vocab: list[bytes], eos_token_id: int) -> None:
        """Enable grammar-constrained decoding (json_schema) on this
        stage. Call on the last stage with the tokenizer's raw token byte
        strings; without it, constrained requests are aborted."""
        from parallax_tpu_torch.constrained import GrammarCompiler

        self.grammar = GrammarCompiler(vocab, eos_token_id)

    def _grammar_entry(self, req: Request) -> tuple | None:
        """(TokenTable, state) for a constrained request, created on first
        sight; None for unconstrained. Aborts the request if no grammar
        vocabulary is wired or the schema does not compile. The first
        state is recomputed from the tokens already in the stream (the DFA
        state is a function of the schema and the committed stream)."""
        sp = req.sampling_params
        if not sp.json_schema:
            return None
        ent = self._grammar_states.get(req.request_id)
        if ent is None:
            if self.grammar is None:
                req.abort("json_schema requires a tokenizer-wired last "
                          "stage (set_grammar_vocab)")
                return None
            try:
                table = self.grammar.compile(sp.json_schema)
            except ValueError as e:
                req.abort(f"json_schema rejected: {e}")
                return None
            ent = (table, self._grammar_initial_state(req, table))
            self._grammar_states[req.request_id] = ent
        return ent

    def _grammar_initial_state(self, req: Request, table) -> int:
        """First-sight DFA state for a constrained request. Fresh requests
        start at 0. A migrated-in request restores the checkpointed
        ``dfa_state`` when its grammar hash matches the schema this stage
        compiled (state numbering is schema-derived, so a match makes the
        int portable); otherwise — stale hash, out-of-range state, or no
        checkpointed state — it is recomputed by advancing from 0 through
        the tokens already in the stream (adopt mode folds prior outputs
        into ``full_output_ids``; replay mode starts empty and advances
        per commit like any live request)."""
        from parallax_tpu_torch.constrained import grammar_state_hash

        ckpt_state = getattr(req, "grammar_dfa_state", None)
        if ckpt_state is not None:
            sp = req.sampling_params
            if (
                getattr(req, "grammar_hash", "")
                == grammar_state_hash(sp.json_schema)
                and -1 <= int(ckpt_state) < table.dfa.n_states
            ):
                return int(ckpt_state)
        state = 0
        for tok in self._generated_ids(req):
            state = table.advance(state, int(tok))
        return state

    def grammar_checkpoint_fields(
        self, request_id: str
    ) -> tuple[int, str] | None:
        """(dfa_state, grammar_hash) for a live constrained request, or
        None when this stage holds no grammar state for it (not
        constrained, or a multi-stage head whose grammar lives on the last
        stage — the restoring side then recomputes from the token stream).
        Read before ``extract``, which drops the state."""
        ent = self._grammar_states.get(request_id)
        if ent is None:
            return None
        from parallax_tpu_torch.constrained import grammar_state_hash

        _table, state = ent
        req = self.scheduler.running.get(request_id) or (
            self.scheduler.wait_queue.get(request_id))
        schema = req.sampling_params.json_schema if req is not None else None
        if not schema:
            return None
        return int(state), grammar_state_hash(schema)

    def _advance_grammar(self, req: Request, token: int) -> None:
        """Advance a request's host DFA state by one committed token (no-op
        for unconstrained requests). It must track the COMMITTED stream:
        the host sampler and the next window's first row read it."""
        ent = self._grammar_states.get(req.request_id)
        if ent is not None:
            table, state = ent
            self._grammar_states[req.request_id] = (
                table, table.advance(state, int(token)))

    def _warn_constrained_off(self, reason: str) -> None:
        """Warn once: a grammar batch cannot ride the decode window and
        decodes on the host-synchronous path instead."""
        if self._warned_constrained_off:
            return
        self._warned_constrained_off = True
        logger.warning(
            "constrained decode windows disabled: %s — grammar batches "
            "decode on the host-synchronous path (config: "
            "constrained_window / constrained.DEVICE_TABLE_MAX_CELLS)",
            reason,
        )

    @staticmethod
    def _row_has_features(req: Request) -> bool:
        """Does this request sample with any sampling feature (penalties,
        logprobs, grammar, logit_bias)?"""
        sp = req.sampling_params
        return bool(
            sp.presence_penalty or sp.frequency_penalty
            or sp.repetition_penalty != 1.0 or sp.logprobs
            or sp.json_schema or sp.logit_bias
        )

    def _count_constrained(
        self, *, rows: int = 0, mask_steps: int = 0, builds: int = 0,
        cache_hits: int = 0, fallbacks: int = 0,
        spec_mask_rejections: int = 0,
    ) -> None:
        """Bump the constrained-decoding ledger: ``rows`` / ``mask_steps``
        at window dispatch (feature rows entering a window; grammar-mask
        applications its steps will run), table builds / hits when a
        grammar's device table is resolved, ``spec_mask_rejections`` at a
        speculative window's resolve (proposals the grammar mask
        excluded), ``fallbacks`` when a feature batch dropped to the
        host-synchronous sampler."""
        for counter, n in ((self._c_con_rows, rows),
                           (self._c_con_masks, mask_steps),
                           (self._c_con_builds, builds),
                           (self._c_con_hits, cache_hits),
                           (self._c_con_fallbacks, fallbacks),
                           (self._c_con_spec_rej, spec_mask_rejections)):
            if n:
                counter.inc(n)
        with self._constrained_lock:
            st = self._constrained_stats
            for key, n in (
                ("window_rows", rows), ("mask_steps", mask_steps),
                ("table_builds", builds), ("table_cache_hits", cache_hits),
                ("fallbacks", fallbacks),
                ("spec_mask_rejections", spec_mask_rejections),
            ):
                if n:
                    st[key] = st.get(key, 0) + int(n)

    def constrained_summary(self) -> dict | None:
        """How much structured-output / penalised / logprob traffic rode
        the decode window, and the grammar device-table cache's behaviour.
        None until the stage has seen a feature row in a window or a
        fallback. The JAX engine's payload."""
        with self._constrained_lock:
            if not self._constrained_stats:
                return None
            stats = dict(self._constrained_stats)
        return {
            "enabled": bool(self.cfg.constrained_window),
            "active_rows": sum(
                1 for rid in list(self._grammar_states)
                if rid in self.scheduler.running
            ),
            "window_rows": stats.get("window_rows", 0),
            "mask_steps": stats.get("mask_steps", 0),
            "table_builds": stats.get("table_builds", 0),
            "table_cache_hits": stats.get("table_cache_hits", 0),
            "spec_mask_rejections": stats.get("spec_mask_rejections", 0),
            "fallbacks": stats.get("fallbacks", 0),
        }

    def _record_latency(self, plan: BatchPlan, ms: float) -> None:
        """Per-layer decode latency EWMA published to the global
        scheduler (reference base_executor.py:716-732); prefill steps and
        empty plans do not count."""
        if plan.has_prefill or plan.is_empty:
            return
        per_layer = ms / max(1, self.model.num_local_layers)
        if self.layer_latency_ms_ewma is None:
            self.layer_latency_ms_ewma = per_layer
        else:
            self.layer_latency_ms_ewma = (
                0.8 * self.layer_latency_ms_ewma + 0.2 * per_layer
            )

    # -- speculative decoding: counters ------------------------------------

    def _count_spec_proposed(self, source: str, n: int) -> None:
        """``n`` proposal tokens staged from ``source`` ({ngram, draft}),
        with the host milliseconds the staging pass took."""
        if n <= 0:
            return
        self._c_spec_proposed.labels(
            stage=self._obs_stage, source=source).inc(n)
        self._h_spec_propose.labels(
            stage=self._obs_stage, source=source).observe(
                self._last_propose_ms)
        with self._spec_lock:
            ent = self._spec_stats.setdefault(
                source, {"proposals": 0, "accepted": 0, "rejected": 0})
            ent["proposals"] += int(n)

    def _count_spec_result(self, source: str, accepted: int,
                           rejected: int) -> None:
        """Verification outcome for one row's window or round: ``accepted``
        proposal tokens survived (committed), ``rejected`` fed proposals
        were computed and discarded."""
        if accepted:
            self._c_spec_accepted.labels(
                stage=self._obs_stage, source=source).inc(accepted)
        if rejected:
            self._c_spec_rejected.labels(
                stage=self._obs_stage, source=source).inc(rejected)
        with self._spec_lock:
            ent = self._spec_stats.setdefault(
                source, {"proposals": 0, "accepted": 0, "rejected": 0})
            ent["accepted"] += int(accepted)
            ent["rejected"] += int(rejected)

    def spec_summary(self) -> dict | None:
        """The ``spec`` payload for /status, heartbeats and /cluster/status
        (the JAX engine's): per-source proposed / accepted / rejected
        totals, the acceptance rate and accepted tokens per second since
        the engine started. None while speculation is off."""
        if self.cfg.speculative_tokens <= 0:
            return None
        with self._spec_lock:
            by_source = {k: dict(v) for k, v in self._spec_stats.items()}
        acc = sum(v["accepted"] for v in by_source.values())
        rej = sum(v["rejected"] for v in by_source.values())
        elapsed = max(1e-9, time.monotonic() - self._spec_t0)
        return {
            "enabled": True,
            "width": self.cfg.speculative_tokens,
            "proposals": sum(v["proposals"] for v in by_source.values()),
            "accepted": acc,
            "rejected": rej,
            "acceptance_rate": (
                round(acc / (acc + rej), 4) if acc + rej else 0.0
            ),
            "accepted_tokens_per_chip_second": round(acc / elapsed, 3),
            "by_source": by_source,
        }

    # -- kernel accounting -------------------------------------------------

    def _count_kernel_dispatch(self, path: str, impl: str, n: int = 1) -> None:
        self._c_kernel.labels(stage=self._obs_stage, impl=impl,
                              path=path).inc(n)
        key = (impl, path)
        with self._kernel_lock:
            self._kernel_counts[key] = self._kernel_counts.get(key, 0) + n

    def kernel_dispatch_summary(self) -> dict:
        """The active impls and per-(impl, path) dispatch counts, so a run
        shows which path served it (``cuda-fused``, ``cuda-split`` or
        ``torch``). Paths: ``prefill`` and ``decode`` count forward steps
        of the single-step path, ``multistep`` the forward steps of decode
        windows (m * k a chain), ``spec`` the verify forwards of
        speculative windows (m * k a chain), ``spec_verify`` those of the
        host-synchronous speculative fallback, ``sample`` the sampler's
        calls. With CUDA
        graphs on, ``graphs`` counts the captured graphs, the window steps
        they replayed, the host seconds their warm-up, recording and
        instantiation took and the kernel launches of the warm-up steps
        (one eager step a graph)."""
        with self._kernel_lock:
            counts = list(self._kernel_counts.items())
        out = {
            "impl": self._attn_impl,
            "decode_fused": self._decode_fused,
            "prefill_impl": self._prefill_impl,
            "prefill_fused": self._prefill_fused,
            "cuda_graphs": self._graphs is not None,
            "dispatch_total": {
                f"{impl}/{path}": n for (impl, path), n in sorted(counts)
            },
        }
        if self._graphs is not None:
            out["graphs"] = {
                "captured": self._graphs.captured,
                "replays": self._graphs.replays,
                "capture_s": self._graphs.capture_s,
                "capture_parts_s": dict(self._graphs.capture_parts_s),
                "warmup_launches": dict(self._graphs.warmup_launches),
            }
        return out

    # -- observability (obs/: registry series, tracing, flight recorder,
    #    goodput, the device plane) ---------------------------------------

    # Seconds between the step thread's obs refreshes: the host snapshot
    # the scrape / heartbeat threads read, the HBM ledger and the harvest
    # of finished device-time spans.
    OBS_REFRESH_S = 0.5

    def _init_obs(self) -> None:
        """Register this stage's metric series and trace state.

        Cost contract (the JAX engine's): with ``trace_sample_rate=0`` the
        ``_traced`` set stays empty and every per-step tracing hook sits
        behind an emptiness check; goodput and device time cost a few dict
        and integer adds a host visit; gauges are pulled by a registry
        collector at scrape time from a snapshot the step thread keeps.
        Scrape and heartbeat threads make no CUDA call and no call into the
        native cache manager: the snapshot, the HBM refresh and the CUDA
        timing events all live on the step thread (``obs_tick``)."""
        from parallax_tpu_torch.obs.device import get_device_plane
        from parallax_tpu_torch.obs.goodput import get_goodput
        from parallax_tpu_torch.obs.registry import (
            DEFAULT_COUNT_BUCKETS,
            get_registry,
        )

        self._trace_rate = min(
            1.0, max(0.0, float(self.cfg.trace_sample_rate or 0.0)))
        self._traced: set[str] = set()
        # Goodput ledger: every device-step token this engine resolves
        # lands in exactly one usefulness bucket; binding eagerly puts the
        # zero-valued families in /metrics from the first scrape.
        self._goodput = get_goodput()
        self._goodput.bind_registry()
        # Device plane: HBM ledger, compile observatory (graph captures)
        # and the per-program device-time split.
        self._device_plane = get_device_plane()
        self._device_plane.bind_registry()
        self._dev_time = self._device_plane.time
        self._compile_obs = self._device_plane.compile
        self._noted_program_keys: set[tuple] = set()
        # (program, start event, end event) of resolved CUDA tickets whose
        # end event may not have completed yet, oldest first.
        self._dev_pending: collections.deque = collections.deque()
        self._last_propose_ms = 0.0
        self._obs_next = 0.0
        # A draft engine's bytes are priced by its target (spec_draft).
        self._obs_draft = False
        reg = get_registry()
        st = ("stage",)
        lbl = {"stage": self._obs_stage}
        self._h_step_host = reg.histogram(
            mnames.STEP_HOST_MS,
            "Host-blocking milliseconds per engine step",
            labelnames=st,
        ).labels(**lbl)
        self._h_step_device = reg.histogram(
            mnames.STEP_DEVICE_MS,
            "Device-readback milliseconds per engine step",
            labelnames=st,
        ).labels(**lbl)
        # Per-token twin of the per-visit host histogram: a window commits
        # K tokens a host visit.
        self._h_step_per_token = reg.histogram(
            mnames.STEP_PER_TOKEN_HOST_MS,
            "Host-blocking milliseconds per committed token (host-visit "
            "cost amortized over the tokens that visit committed)",
            labelnames=st,
        ).labels(**lbl)
        self._h_batch_tokens = reg.histogram(
            mnames.STEP_BATCH_TOKENS,
            "New tokens per dispatched engine step",
            buckets=DEFAULT_COUNT_BUCKETS, labelnames=st,
        ).labels(**lbl)
        self._g_queue = reg.gauge(
            mnames.QUEUE_DEPTH,
            "Requests parked in the stage wait queue", labelnames=st,
        ).labels(**lbl)
        self._g_running = reg.gauge(
            mnames.RUNNING_REQUESTS,
            "Requests admitted into the running set", labelnames=st,
        ).labels(**lbl)
        self._g_occupancy = reg.gauge(
            mnames.KV_PAGE_OCCUPANCY,
            "Fraction of KV pages in use (0..1)", labelnames=st,
        ).labels(**lbl)
        self._c_preempt = reg.counter(
            mnames.KV_PREEMPTIONS_TOTAL,
            "Decode-OOM preemptions to the host KV tier", labelnames=st,
        ).labels(**lbl)
        self._c_resumes = reg.counter(
            mnames.KV_RESUMES_TOTAL,
            "Preempted requests swapped back in", labelnames=st,
        ).labels(**lbl)
        self._c_kv_oom = reg.counter(
            mnames.KV_OOM_TOTAL,
            "Last-resort kv_oom aborts", labelnames=st,
        ).labels(**lbl)
        self._c_evicted = reg.counter(
            mnames.KV_PAGES_EVICTED_TOTAL,
            "Device pages reclaimed from the prefix tree", labelnames=st,
        ).labels(**lbl)
        self._c_chunk_skip = reg.counter(
            mnames.PREFILL_TOKENS_SKIPPED_TOTAL,
            mnames.help_text(mnames.PREFILL_TOKENS_SKIPPED_TOTAL),
            labelnames=st,
        ).labels(**lbl)
        # Which attention implementation served each dispatch (impl:
        # cuda-fused / cuda-split / torch; path: prefill / decode /
        # multistep / spec / spec_verify / sample).
        self._c_kernel = reg.counter(
            mnames.ATTN_KERNEL_DISPATCH_TOTAL,
            "Engine dispatches by attention kernel implementation",
            labelnames=("stage", "impl", "path"),
        )
        spec_lbl = ("stage", "source")
        self._c_spec_proposed = reg.counter(
            mnames.SPEC_PROPOSALS_TOTAL,
            mnames.help_text(mnames.SPEC_PROPOSALS_TOTAL),
            labelnames=spec_lbl,
        )
        self._c_spec_accepted = reg.counter(
            mnames.SPEC_ACCEPTED_TOTAL,
            mnames.help_text(mnames.SPEC_ACCEPTED_TOTAL),
            labelnames=spec_lbl,
        )
        self._c_spec_rejected = reg.counter(
            mnames.SPEC_REJECTED_TOTAL,
            mnames.help_text(mnames.SPEC_REJECTED_TOTAL),
            labelnames=spec_lbl,
        )
        self._h_spec_propose = reg.histogram(
            mnames.SPEC_PROPOSE_MS,
            mnames.help_text(mnames.SPEC_PROPOSE_MS),
            labelnames=spec_lbl,
        )
        self._g_spec_accept = reg.gauge(
            mnames.SPEC_ACCEPTANCE_RATE,
            mnames.help_text(mnames.SPEC_ACCEPTANCE_RATE),
            labelnames=st,
        ).labels(**lbl)
        con = {}
        for attr, name in (
            ("rows", mnames.CONSTRAINED_WINDOW_ROWS_TOTAL),
            ("masks", mnames.CONSTRAINED_MASK_STEPS_TOTAL),
            ("builds", mnames.CONSTRAINED_TABLE_BUILDS_TOTAL),
            ("hits", mnames.CONSTRAINED_TABLE_CACHE_HITS_TOTAL),
            ("spec_rej", mnames.CONSTRAINED_SPEC_MASK_REJECTIONS_TOTAL),
            ("fallbacks", mnames.CONSTRAINED_FALLBACKS_TOTAL),
        ):
            con[attr] = reg.counter(
                name, mnames.help_text(name), labelnames=st).labels(**lbl)
        self._c_con_rows = con["rows"]
        self._c_con_masks = con["masks"]
        self._c_con_builds = con["builds"]
        self._c_con_hits = con["hits"]
        self._c_con_spec_rej = con["spec_rej"]
        self._c_con_fallbacks = con["fallbacks"]
        self._g_con_active = reg.gauge(
            mnames.CONSTRAINED_ACTIVE_ROWS,
            mnames.help_text(mnames.CONSTRAINED_ACTIVE_ROWS),
            labelnames=st,
        ).labels(**lbl)
        if self.model.is_first:
            self._h_ttft = reg.histogram(
                mnames.TTFT_MS,
                "Time to first token, milliseconds", labelnames=st,
            ).labels(**lbl)
            self._h_tpot = reg.histogram(
                mnames.TPOT_MS,
                "Time per output token after the first, milliseconds",
                labelnames=st,
            ).labels(**lbl)
            self._h_e2e = reg.histogram(
                mnames.E2E_MS,
                "End-to-end request latency, milliseconds", labelnames=st,
            ).labels(**lbl)
        self._snapshot_host()
        # The registry holds a weakref to this bound method; the engine's
        # own reference keeps collection alive exactly as long as it.
        reg.register_collector(self._collect_obs)

    def _snapshot_host(self) -> None:
        """The host state the collectors and ``cache_stats`` read (step
        thread: the native cache manager's counts are ctypes calls)."""
        sched = self.scheduler
        pc = getattr(self.cache, "prefix_cache", None)
        self._obs_snap = {
            "queue": len(sched.wait_queue),
            "running": len(sched.running),
            "num_pages": int(getattr(self.cache, "num_pages", 0) or 0),
            "free_pages": int(self.cache.num_free_pages),
            "cached_pages": int(getattr(pc, "num_cached_pages", 0) or 0),
            "constrained_active": sum(
                1 for rid in self._grammar_states if rid in sched.running),
        }

    def obs_snapshot(self) -> dict:
        """The host state the step thread recorded last (queue and running
        counts, page counts, constrained rows); safe from any thread."""
        return self._obs_snap

    def obs_tick(self, force: bool = False) -> None:
        """The step thread's obs refresh, at most every ``OBS_REFRESH_S``
        (every call with ``force``): the host snapshot, the harvest of
        finished device-time spans and the HBM ledger. The step loops call
        it between steps; ``dispatch`` calls it too. Never raises."""
        now = time.monotonic()
        if not force and now < self._obs_next:
            return
        self._obs_next = now + self.OBS_REFRESH_S
        try:
            self._snapshot_host()
            self._harvest_device_time()
            if not self._obs_draft:
                self._refresh_hbm()
        except Exception:  # pragma: no cover - obs must never take
            logger.debug("obs refresh failed", exc_info=True)  # down the path

    def _collect_obs(self) -> None:
        """Pull-style series, refreshed at render / snapshot time from the
        step thread's snapshot and the cache's Python counters."""
        snap = self._obs_snap
        self._g_queue.set(snap["queue"])
        self._g_running.set(snap["running"])
        num_pages, free = snap["num_pages"], snap["free_pages"]
        self._g_occupancy.set(
            round(1.0 - free / num_pages, 4) if num_pages else 0.0)
        stats = self.cache.stats
        self._c_preempt.set_total(stats.preemptions)
        self._c_resumes.set_total(stats.resumes)
        self._c_kv_oom.set_total(stats.kv_oom_aborts)
        self._c_evicted.set_total(stats.pages_evicted)
        self._c_chunk_skip.set_total(stats.tokens_chunk_skipped)
        with self._spec_lock:
            acc = sum(s.get("accepted", 0)
                      for s in self._spec_stats.values())
            rej = sum(s.get("rejected", 0)
                      for s in self._spec_stats.values())
        if acc + rej:
            self._g_spec_accept.set(round(acc / (acc + rej), 6))
        self._g_con_active.set(snap["constrained_active"])

    def _refresh_hbm(self) -> None:
        """Re-measure this stage's device allocation classes into the HBM
        ledger, then read the allocator's in-use bytes (step thread: a
        CUDA call). The classes: ``weights_<dtype>`` (the parameter
        tensors), ``kv_pages`` (the paged cache), ``spec_draft`` (a draft
        engine's tensors the target does not share), ``grammar_tables``,
        ``host_staging`` (the host tier's parked pages, as the JAX engine
        declares them), ``graph_pool`` (the bytes the window graphs hold
        live) and the declared ``sampling_workspace`` and
        ``compile_headroom``."""
        hbm = self._device_plane.hbm
        owner = self._obs_stage
        by_dtype: dict[str, int] = {}
        own = set()
        for t in _tensor_leaves(self.params):
            dt = str(t.dtype).replace("torch.", "")
            by_dtype[dt] = by_dtype.get(dt, 0) + t.nbytes
            own.add(t.data_ptr())
        for dt, nb in by_dtype.items():
            hbm.set_class(f"weights_{dt}", nb, owner=owner)
        hbm.set_class("kv_pages",
                      sum(t.nbytes for t in _tensor_leaves(self.kv)),
                      owner=owner)
        if self.draft is not None:
            de = self.draft.engine
            hbm.set_class("spec_draft", sum(
                t.nbytes for t in _tensor_leaves((de.params, de.kv))
                if t.data_ptr() not in own), owner=owner)
        if self.grammar is not None:
            hbm.set_class("grammar_tables", self.grammar.device_table_bytes(),
                          owner=owner)
        tier = self.host_tier
        if tier is not None:
            hbm.set_class("host_staging",
                          tier.num_host_pages * tier.pool.page_nbytes,
                          owner=owner)
        if self._graphs is not None:
            hbm.set_class("graph_pool", self._graphs.pool_bytes, owner=owner)
        vocab = int(getattr(self.model.config, "vocab_size", 0) or 0)
        hbm.set_class("sampling_workspace",
                      self.cfg.max_batch_size * vocab * 4, owner=owner)
        hbm.set_class("compile_headroom", int(os.environ.get(
            "PARALLAX_TPU_COMPILE_HEADROOM_BYTES", 0) or 0), owner=owner)
        hbm.refresh_from_device(self.device)

    def _note_program(self, family: str, **key) -> None:
        """Declare a program key to the compile observatory the first time
        this engine runs it; steady state pays one set lookup."""
        kt = (family, tuple(sorted(key.items())))
        if kt in self._noted_program_keys:
            return
        self._noted_program_keys.add(kt)
        self._compile_obs.note_program(family, key)
        self._compile_obs.set_live_executables(
            family,
            sum(1 for f, _ in self._noted_program_keys if f == family),
        )

    def _on_graph_capture(self, key: tuple, seconds: float) -> None:
        """A window step's CUDA graph was captured: one compile of the
        ``decode_window`` / ``spec_window`` family, its host seconds in
        the goodput ledger's compile bucket."""
        t, spec, sampled, fused_sample, feats, shapes = key
        self._note_program(
            "spec_window" if spec else "decode_window", tokens=t,
            spec=spec, sampled=sampled, fused_sample=fused_sample,
            feats=feats, rows=shapes)
        # Counted against this engine's own keys: another engine in the
        # process capturing the same keys is no shape-lattice leak.
        self._compile_obs.on_compile(seconds, owner=self, key=key)
        self._goodput.add_time("compile", seconds)

    def _device_mark(self):
        """A timing event recorded on the current stream (CUDA devices;
        None elsewhere). Never called inside a graph capture."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _seal(self, ticket: StepTicket, ev0) -> StepTicket:
        """Close a dispatched ticket's device-time span: from ``ev0`` to
        its ready event (behind its host copies), or to a new mark."""
        if ev0 is not None and ticket.outputs is None:
            ticket.ev0 = ev0
            ticket.ev1 = (ticket.ready if ticket.ready is not None
                          else self._device_mark())
        return ticket

    def _account_time(self, ticket: StepTicket, host_ms: float,
                      device_ms: float) -> None:
        """Serve time into the goodput ledger and the ticket's device time
        into its program: the CUDA events' span on a CUDA device (read
        once the end event completes, with no sync of its own; the span
        includes any time the stream waited on the host, so it bounds busy
        time from above), the host + readback wall time elsewhere."""
        secs = (host_ms + device_ms) / 1e3
        self._goodput.add_time("serve", secs)
        program = ticket.program or "decode"
        if ticket.ev0 is None:
            self._dev_time.add(program, secs)
            return
        self._dev_pending.append((program, ticket.ev0, ticket.ev1))
        self._harvest_device_time()

    def _harvest_device_time(self) -> None:
        pend = self._dev_pending
        while pend and pend[0][2].query():
            program, e0, e1 = pend.popleft()
            self._dev_time.add(program, e0.elapsed_time(e1) / 1e3)

    def flush_device_time(self) -> None:
        """Wait for every resolved ticket's end event and attribute its
        span (step thread; for a reading at the end of a run)."""
        for _program, _e0, e1 in self._dev_pending:
            e1.synchronize()
        self._harvest_device_time()

    def _trace_begin(self, req: Request) -> None:
        from parallax_tpu_torch.obs.trace import get_trace_store

        req.traced = True
        self._traced.add(req.request_id)
        get_trace_store().begin(req.request_id)

    def _trace_queue_wait(self, plan: BatchPlan) -> None:
        """First time a traced request is scheduled: close its
        enqueue -> admit span (wait-queue time)."""
        from parallax_tpu_torch.obs.trace import get_trace_store

        store = get_trace_store()
        now_pc = time.perf_counter()
        now_mono = time.monotonic()
        for seg in plan.seqs:
            req = seg.request
            if req.traced and not getattr(req, "_trace_scheduled", False):
                req._trace_scheduled = True  # type: ignore[attr-defined]
                wait = max(0.0, now_mono - req.arrival_time)
                store.add(
                    req.request_id, self._obs_stage, "queue_wait",
                    t0=now_pc - wait, dur=wait,
                    args={"prompt_tokens": req.num_prompt_tokens},
                )

    def _trace_plan(self, plan: BatchPlan, t0: float, t1: float) -> None:
        """Per-step spans for traced rows; decode steps coalesce into
        epochs (obs/trace.py merge) so long generations stay bounded."""
        from parallax_tpu_torch.obs.trace import get_trace_store

        store = get_trace_store()
        # Counter tracks (ph "C" in the Chrome export): HBM headroom and
        # the per-program device-time share, once per traced host visit.
        hbm = self._device_plane.hbm.snapshot()
        share = self._dev_time.snapshot()["share"]
        counter_values = {
            "hbm_headroom_mb": round(hbm["headroom_bytes"] / 2**20, 3),
            "hbm_tracked_mb": round(hbm["tracked_bytes"] / 2**20, 3),
            **{f"device_share_{prog}": frac for prog, frac in share.items()},
        }
        for seg in plan.seqs:
            req = seg.request
            if not req.traced:
                continue
            store.counter(
                req.request_id, self._obs_stage, "device", t0=t1,
                values=counter_values,
            )
            if getattr(req, "is_mirror", False):
                decode = seg.num_new_tokens == 1 and getattr(
                    req, "last_chunk_flag", False)
            else:
                decode = (seg.num_new_tokens == 1
                          and seg.context_len > req.num_prompt_tokens)
            store.add(
                req.request_id, self._obs_stage,
                "decode" if decode else "prefill",
                t0=t0, dur=t1 - t0,
                args={"tokens": seg.num_new_tokens}, merge=decode,
            )

    def _obs_finish(self, req: Request) -> None:
        """Finish bookkeeping: the finish span and traced-set cleanup (every
        stage); TTFT / TPOT / e2e histograms, the SLO availability count
        and the flight recorder's request ring (head stage). Internal
        requests (the draft's) skip the head part."""
        rid = req.request_id
        traced = rid in self._traced
        store = None
        if traced:
            from parallax_tpu_torch.obs.trace import get_trace_store

            self._traced.discard(rid)
            store = get_trace_store()
            store.add(
                rid, self._obs_stage, "finish",
                t0=time.perf_counter(), dur=0.0,
                args={"status": req.status.value},
            )
        if not self.model.is_first or rid.startswith("__"):
            return
        self._goodput.count_request(req.status.value)
        from parallax_tpu_torch.obs.flight import get_flight

        now = time.monotonic()
        e2e_ms = (now - req.arrival_time) * 1e3
        ttft_ms = None
        if req.first_token_time is not None:
            ttft_ms = (req.first_token_time - req.arrival_time) * 1e3
            self._h_ttft.observe(ttft_ms)
            n = req.num_output_tokens
            if n > 1:
                self._h_tpot.observe(
                    (now - req.first_token_time) * 1e3 / (n - 1))
        self._h_e2e.observe(e2e_ms)
        if self.scheduler.qos is not None:
            # Per-class TTFT and the admission controller's burn input.
            self.scheduler.qos.observe_finish(req, ttft_ms)
        breakdown = store.breakdown(rid) if store is not None else None
        if breakdown is None and ttft_ms is not None:
            breakdown = {
                "ttft_ms": round(ttft_ms, 3),
                "decode_ms": round(e2e_ms - ttft_ms, 3),
            }
        get_flight().record_request(
            rid,
            status=req.status.value,
            e2e_ms=e2e_ms,
            ttft_ms=ttft_ms,
            prompt_tokens=req.num_prompt_tokens,
            output_tokens=req.num_output_tokens,
            abort_reason=req.abort_reason,
            stage=self._obs_stage,
            breakdown=breakdown,
            slow_threshold_ms=self.cfg.slow_request_ms,
            trace_id=rid if traced else None,
        )

    # -- stepping ---------------------------------------------------------

    def step(self) -> StepOutputs:
        """One fully synchronous engine step (dispatch + resolve)."""
        return self.resolve(self.dispatch())

    @torch.no_grad()
    def dispatch(self) -> StepTicket:
        """Phase 1: form the plan, assemble device inputs and ENQUEUE the
        forward (and, on the last stage, the sampler); returns without
        waiting for the device. At most one unresolved ticket may be
        outstanding when dispatch is entered.

        A failure anywhere in here leaves the scheduler consistent: no
        bookkeeping advances until the forward is enqueued, so the same
        rows are re-schedulable on the next call."""
        if len(self._inflight) > 1:
            raise RuntimeError(
                "dispatch() with two steps already in flight — resolve() "
                "the oldest ticket first (one-in-flight invariant)"
            )
        self.obs_tick()
        t0 = time.perf_counter()
        self._dispatch_seq += 1
        self._staging.begin()
        plan = self._drop_unknown_adapters(self._form_plan())
        if plan.is_empty:
            return StepTicket(
                plan=plan, step_idx=self._step_count, t0=t0,
                outputs=StepOutputs(forward=[],
                                    finished=self._collect_finished()),
            )
        if self._traced:
            # Tracing off keeps the set empty: one falsy check here.
            self._trace_queue_wait(plan)
        ev0 = self._device_mark()
        ticket = self._dispatch_multistep(plan, t0)
        if ticket is not None:
            return self._seal(ticket, ev0)
        # Host-synchronous speculative verify (K = 1, or a window the
        # planner could not page). Rows fed from the device's last-token
        # array are excluded: no proposal can continue a context whose
        # last token the host does not know yet.
        fed_rows = any(seg.device_token for seg in plan.seqs)
        if (not fed_rows and self.cfg.speculative_tokens > 0
                and self.model.is_first):
            if self.model.is_last:
                ticket = self._dispatch_speculative(plan, t0)
                if ticket is not None:
                    return self._seal(ticket, ev0)
            else:
                self._extend_plan_pp_spec(plan)
        # Last stage of a pipeline: rows carrying unverified proposals are
        # verified at every fed position.
        spec_rows: dict[int, list[int]] = {}
        if self.model.is_last and not self.model.is_first:
            for i, seg in enumerate(plan.seqs):
                fed = getattr(seg.request, "pp_spec_fed", None)
                if fed is not None and seg.num_new_tokens == len(fed):
                    spec_rows[i] = fed
        hidden = None
        if not self.model.is_first:
            hidden = torch.cat([
                self._take_hidden(s.request.request_id, s.num_new_tokens)
                for s in plan.seqs
            ], dim=0)
        one_token = all(s.num_new_tokens == 1 for s in plan.seqs)
        decode_only = self._use_decode_flag and one_token
        self._assign_state_slots(plan)
        inputs = assemble(
            plan, self.spec, self.cfg.page_size, self.device,
            hidden_states=hidden, with_dense_map=self._needs_state,
            decode_only=decode_only, gather_all_logits=bool(spec_rows),
            decode_fused=self._decode_fused,
            prefill_fused=self._prefill_fused, staging=self._staging,
        )
        inputs.lora = self._lora_field(plan, inputs)
        if fed_rows:
            inputs = self._substitute_feed(plan, inputs)
        out = self._forward(inputs)
        self._count_kernel_dispatch(
            "decode" if one_token else "prefill",
            self._attn_impl if decode_only else self._prefill_impl,
        )
        self.scheduler.on_batch_computed(plan)
        if self._needs_state and self.cache.enable_prefix_cache:
            self._maybe_snapshot_state(plan)
        step_idx = self._step_count
        self._step_count += 1
        ticket = StepTicket(plan=plan, step_idx=step_idx, t0=t0,
                            inputs=inputs, out=out,
                            dispatch_seq=self._dispatch_seq,
                            program="decode" if one_token else "prefill")
        if self.host_hidden:
            (ticket.hidden_host,), ticket.ready = self._to_host(
                out[:plan.total_new_tokens])
        if spec_rows:
            self._enqueue_pp_verify(ticket, spec_rows)
        elif self.model.is_last:
            ticket.tokens_dev, lp_dev = self._enqueue_sample(
                plan, inputs, out, step_idx)
            host, ticket.ready = self._to_host(
                ticket.tokens_dev, *(() if lp_dev is None else (lp_dev,)))
            ticket.tokens_host = host[0]
            if lp_dev is not None:
                ticket.lp_host = host[1]
            if not self._overlap_sample_ok(plan):
                ticket.sync_only = True
            elif self.model.is_first and self.cfg.overlap_steps:
                # Park the sampled tokens in the last-token array so the
                # NEXT dispatch can feed eligible rows before they reach
                # the host.
                self._mark_device_feed(plan, ticket.tokens_dev)
        ticket.host_ms = (time.perf_counter() - t0) * 1000.0
        self._inflight.append(ticket)
        return self._seal(ticket, ev0)

    @torch.no_grad()
    def resolve(self, ticket: StepTicket) -> StepOutputs:
        """Phase 2: wait for the ticket's tokens (an event behind their
        pinned copy), emit tokens or hidden states, and collect finished
        requests. Tickets resolve in dispatch order."""
        if ticket in self._inflight:
            self._inflight.remove(ticket)
        if ticket.outputs is not None:
            return ticket.outputs
        if ticket.ms_counts is not None:
            return self._resolve_spec_multistep(ticket)
        if ticket.ms_windows is not None:
            return self._resolve_multistep(ticket)
        if ticket.spec_verify is not None:
            return self._resolve_speculative(ticket)
        plan = ticket.plan
        t_r0 = time.perf_counter()
        device_ms = 0.0
        try:
            if self.host_hidden:
                tb = time.perf_counter()
                self._wait(ticket.ready)
                device_ms = (time.perf_counter() - tb) * 1000.0
                # Rows of their own in pageable memory: a queued frame
                # pins no staging block, and dropping it makes no CUDA call.
                host = torch.empty(ticket.hidden_host.shape,
                                   dtype=ticket.hidden_host.dtype)
                host.copy_(ticket.hidden_host)
                forwards = self._emit_hidden(plan, host)
            elif not self.model.is_last:
                forwards = self._emit_hidden(plan, ticket.out)
            elif ticket.spec_rows:
                tb = time.perf_counter()
                self._wait(ticket.ready)
                device_ms = (time.perf_counter() - tb) * 1000.0
                forwards = self._verify_and_emit(plan, ticket)
            else:
                tb = time.perf_counter()
                self._wait(ticket.ready)
                device_ms = (time.perf_counter() - tb) * 1000.0
                forwards = self._emit_tokens(
                    plan, ticket.tokens_host.numpy(),
                    None if ticket.lp_host is None
                    else ticket.lp_host.numpy())
        except Exception:
            self._abandon(plan)
            raise
        now = time.perf_counter()
        host_ms = ticket.host_ms + (now - t_r0) * 1000.0
        overlapped = self._dispatch_seq != ticket.dispatch_seq
        # An overlapped ticket's t0-to-resolve span covers the next
        # dispatch too: the EWMA reads the host-blocking time, as the JAX
        # engine's does.
        self._record_latency(plan, host_ms)
        # The per-token series count tokens emitted toward output streams
        # (one per sampling row), not prefill chunk tokens.
        emitted = sum(1 for seg in plan.seqs if self._needs_token(seg))
        self.step_timing.update(host_ms, device_ms, overlapped,
                                tokens=emitted)
        self._account_time(ticket, host_ms, device_ms)
        # Goodput: a replay-restored request's prompt re-prefill
        # recomputes positions the dead pipeline already computed — the
        # price of a churn event, counted as rework (head stage only).
        if self.model.is_first:
            for seg in plan.seqs:
                if (seg.request.replay_ids
                        and seg.context_len
                        <= seg.request.num_prompt_tokens):
                    self._goodput.count("preempted_rework",
                                        seg.num_new_tokens)
        if plan.total_new_tokens:
            self._h_batch_tokens.observe(plan.total_new_tokens)
        if self._traced:
            self._trace_plan(plan, ticket.t0, now)
        return StepOutputs(
            forward=forwards,
            finished=self._collect_finished(),
            num_tokens=plan.total_new_tokens,
            step_time_ms=(now - ticket.t0) * 1000.0,
            host_ms=host_ms,
            device_ms=device_ms,
            overlapped=overlapped,
        )

    def is_inflight(self, ticket: StepTicket) -> bool:
        """True while the ticket has been dispatched but not resolved
        (nor discarded). A failed resolve() removes the ticket, so error
        handlers can use this to tell whether a retry is meaningful."""
        return ticket in self._inflight

    def discard(self, ticket: StepTicket) -> None:
        """Drop an in-flight ticket that can no longer be resolved (e.g. an
        earlier ticket's resolve failed mid-loop): its rows' pending tokens
        are lost, so abort them to keep the scheduler consistent."""
        if ticket in self._inflight:
            self._inflight.remove(ticket)
        if ticket.outputs is None:
            self._abandon(ticket.plan)

    # -- the overlapped step ----------------------------------------------

    def _forward(self, inputs: BatchInputs) -> torch.Tensor:
        out, self.kv = self.model(self.params, self.kv, inputs)
        return out

    def _overlap_sample_ok(self, plan: BatchPlan) -> bool:
        """May this batch's rows be fed from the device and its ticket stay
        in flight? Not with rows that need host-synchronous logits
        processing (penalties read the committed stream, a grammar mask
        the host DFA state; logprobs and logit_bias follow the JAX
        engine) nor with teacher-forced replay rows, whose next step must
        be fed from the host commit."""
        return not any(self._row_has_features(seg.request)
                       or seg.request.replay_ids for seg in plan.seqs)

    def _to_host(self, *tensors: torch.Tensor) -> tuple:
        """Start pinned, non-blocking D2H copies of ``tensors``; returns
        them and an event recorded behind them (on a CPU device the
        tensors themselves and None)."""
        if self.device.type != "cuda":
            return tensors, None
        host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True)
            for t in tensors
        )
        # A timing event: it also ends the ticket's device-time span.
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return host, event

    @staticmethod
    def _wait(event) -> None:
        """Wait for a ticket's host copies (never the whole device)."""
        if event is not None:
            event.synchronize()

    def _enqueue_sample(self, plan: BatchPlan, inputs: BatchInputs,
                        logits: torch.Tensor, step_idx: int):
        """Sample one token per row on the device, after the rows'
        sampling features: (tokens i32[S], chosen-token logprobs f32[S] or
        None when no row asked for them). Seeded rows' noise is keyed by
        (seed, output step), unseeded rows' by (engine seed, step_idx,
        row)."""
        s = int(inputs.kv_lens.shape[0])
        temp, top_k, top_p, min_p, seeds, steps = self._pack_base_sampling(
            plan, s)
        logits = self._apply_features(plan, logits)
        if not np.any(temp > 0.0):
            # All-greedy batch (padding rows are greedy): argmax only, no
            # noise.
            tokens = greedy_tokens(logits)
        else:
            put = self._staging.put
            gumbel = gumbel_rows(
                put("seeds", seeds),
                put("steps", np.where(seeds >= 0, steps, step_idx)),
                self.cfg.seed, logits.shape[-1],
            )
            temp_t, top_k_t = put("temp", temp), put("top_k", top_k)
            if self._fused_sample_ok(plan):
                self._count_kernel_dispatch("sample",
                                            kernel_select.IMPL_FUSED)
                tokens = fused_sample_topk(logits, gumbel, temp_t, top_k_t)
            else:
                self._count_kernel_dispatch("sample",
                                            kernel_select.IMPL_TORCH)
                tokens = sample_tokens(logits, temp_t, top_k_t,
                                       put("top_p", top_p),
                                       put("min_p", min_p), gumbel)
        if not any(seg.request.sampling_params.logprobs
                   for seg in plan.seqs):
            return tokens, None
        return tokens, token_logprobs(logits, tokens)

    def _apply_features(self, plan: BatchPlan,
                        logits: torch.Tensor) -> torch.Tensor:
        """The host path's feature pass, in the JAX engine's order and
        packing: penalties from each penalised row's generated ids (-1
        padded on a power-of-2 lattice), then logit_bias rows, then the
        grammar mask of each constrained row's host DFA state (columns past
        the token table masked). Rows without a feature pass through."""
        s, v = logits.shape
        put = self._staging.put
        pen = [i for i, seg in enumerate(plan.seqs)
               if self._row_penalised(seg.request)]
        if pen:
            pres = np.zeros((s,), np.float32)
            freq = np.zeros((s,), np.float32)
            rep = np.ones((s,), np.float32)
            gen = {}
            for i in pen:
                sp = plan.seqs[i].request.sampling_params
                pres[i], freq[i] = sp.presence_penalty, sp.frequency_penalty
                rep[i] = sp.repetition_penalty
                gen[i] = self._generated_ids(plan.seqs[i].request)
            logits = penalize_logits(
                logits, put("pen_ids", _pad_id_lists(gen, s)),
                put("pen_pres", pres), put("pen_freq", freq),
                put("pen_rep", rep))
        b_rows = [i for i, seg in enumerate(plan.seqs)
                  if seg.request.sampling_params.logit_bias
                  and self._needs_token(seg)]
        if b_rows:
            # Bias BEFORE the grammar mask so masked tokens stay masked.
            rows, vecs = self._bias_pack(plan, b_rows, v)
            logits = bias_logits(logits, put("bias_rows", rows),
                                 put("bias_vecs", vecs))
        g_rows, g_masks = [], []
        for i, seg in enumerate(plan.seqs):
            if not self._needs_token(seg):
                continue
            ent = self._grammar_entry(seg.request)
            if ent is not None and not seg.request.status.is_finished:
                g_rows.append(i)
                g_masks.append(ent[0].allowed_mask(ent[1]))
        if g_rows:
            rows = np.full((_pow2(len(g_rows)),), -1, np.int32)
            rows[: len(g_rows)] = g_rows
            allowed = np.ones((rows.shape[0], v), bool)
            for j, m in enumerate(g_masks):
                allowed[j, : m.shape[0]] = m[:v]
                allowed[j, m.shape[0]:] = False
            logits = apply_grammar_mask(logits, put("gram_rows", rows),
                                        put("gram_allowed", allowed))
        return logits

    @staticmethod
    def _row_penalised(req: Request) -> bool:
        sp = req.sampling_params
        return bool(sp.presence_penalty or sp.frequency_penalty
                    or sp.repetition_penalty != 1.0)

    def _bias_pack(self, plan: BatchPlan, b_rows: list[int], v: int):
        """The logit_bias rows (-1 padded to a power of 2) and their dense
        f32[G, V] vectors, each built once per request."""
        rows = np.full((_pow2(len(b_rows)),), -1, np.int32)
        rows[: len(b_rows)] = b_rows
        vecs = np.zeros((rows.shape[0], v), np.float32)
        for j, i in enumerate(b_rows):
            req = plan.seqs[i].request
            vec = self._bias_cache.get(req.request_id)
            if vec is None or vec.shape[0] != v:
                vec = np.zeros((v,), np.float32)
                for tid, bias in req.sampling_params.logit_bias.items():
                    tid = int(tid)
                    if 0 <= tid < v:
                        vec[tid] = float(bias)
                self._bias_cache[req.request_id] = vec
            vecs[j] = vec
        return rows, vecs

    def _fused_sample_ok(self, plan: BatchPlan) -> bool:
        """The fused sampler (A3) covers greedy and plain temperature /
        top-k rows with a bounded k; a top-p, min-p or large-top-k row
        sends the batch to the split sampler."""
        return self._decode_fused and all(
            seg.request.sampling_params.top_p >= 1.0
            and seg.request.sampling_params.min_p <= 0.0
            and seg.request.sampling_params.top_k <= FUSED_SAMPLE_TOPK_MAX
            for seg in plan.seqs
        )

    def _mark_device_feed(self, plan: BatchPlan,
                          tokens_dev: torch.Tensor) -> None:
        """Single-stage overlap: scatter this step's sampled tokens into
        the slot-indexed last-token array and mark the rows device-feed
        ready, so the NEXT dispatch can schedule them before these tokens
        ever reach the host."""
        s = int(tokens_dev.shape[0])
        # The out-of-range slot: the scatter drops the row there.
        slots = np.full((s,), self.cfg.max_batch_size, np.int32)
        marked = False
        for i, seg in enumerate(plan.seqs):
            req = seg.request
            if not self._needs_token(seg) or req.status.is_finished:
                continue
            # A row whose NEXT commit ends it (max_new reached) never
            # needs the device round trip; skipping it also bounds every
            # device-fed position strictly inside max_model_len.
            pending = 1 if seg.device_token else 0
            if (
                req.num_generated + pending + 1
                >= req.sampling_params.max_new_tokens
            ):
                continue
            slot = self._token_slots.get(req.request_id)
            if slot is None:
                if not self._free_token_slots:
                    continue
                slot = self._free_token_slots.pop()
                self._token_slots[req.request_id] = slot
            slots[i] = slot
            req.device_feed_ready = True
            marked = True
        if marked:
            self._last_token_dev.index_copy_(
                0, self._staging.put("mark_slots", slots).long(),
                tokens_dev)

    def _substitute_feed(self, plan: BatchPlan,
                         inputs: BatchInputs) -> BatchInputs:
        """Swap device-fed rows' placeholder token ids for a gather from
        the last-token array (enqueued between the previous step's sampler
        and this step's forward — no host round trip)."""
        feed_slots = np.full((int(inputs.token_ids.shape[0]),), -1, np.int32)
        row = 0
        for seg in plan.seqs:
            if seg.device_token:
                feed_slots[row] = self._token_slots[seg.request.request_id]
            row += seg.num_new_tokens
        return substitute_device_tokens(
            inputs, self._last_token_dev,
            self._staging.put("feed_slots", feed_slots))

    def _abandon(self, plan: BatchPlan) -> None:
        """A resolve failed mid-step: the sampled tokens (and any pending
        device-feed state) for these rows are lost — abort them so the
        scheduler never re-schedules rows whose token stream has a
        hole."""
        for seg in plan.seqs:
            req = seg.request
            if not req.status.is_finished:
                req.abort("step_resolve_failed")
            req.device_feed_ready = False

    def _free_token_slot(self, request_id: str) -> None:
        slot = self._token_slots.pop(request_id, None)
        if slot is not None:
            self._free_token_slots.append(slot)

    # -- the K-step decode window -----------------------------------------

    def _effective_lookahead(self) -> int:
        """Resolved K for this dispatch: an explicit config value wins; the
        adaptive default (None/0) runs ADAPTIVE_DECODE_LOOKAHEAD whenever
        the batch qualifies (``_fused_common_ok``)."""
        k = self.cfg.decode_lookahead
        if not k:
            k = ADAPTIVE_DECODE_LOOKAHEAD
        return max(1, int(k))

    def _fused_common_ok(self, plan: BatchPlan,
                         allow_features: bool = False) -> bool:
        """A window needs a single-stage engine (the ring is local) and
        decode rows only. ``allow_features`` (the window path) admits rows
        with sampling features, which the window carries as state
        (``_pack_window_features``)."""
        if not (self.model.is_first and self.model.is_last):
            return False
        return all(
            seg.num_new_tokens == 1
            # A 1-token PROMPT's first forward also has num_new == 1; it
            # stays on the normal path (prefill bookkeeping differs).
            and seg.request.status is RequestStatus.DECODING
            # Replay rows commit RECORDED tokens; an on-device window
            # would feed its own samples forward instead.
            and not seg.request.replay_ids
            and (allow_features or not self._row_has_features(seg.request))
            for seg in plan.seqs
        )

    def _window_feature_flags(self, plan: BatchPlan) -> tuple | None:
        """The batch's sampling-feature set as a sorted name tuple, part of
        the window graph's key: ``()`` = none. None = this batch cannot
        ride the window (constrained decoding off, no grammar vocabulary,
        or a grammar too large for a dense device table) and falls back to
        the host-synchronous sampler."""
        feats = set()
        for seg in plan.seqs:
            sp = seg.request.sampling_params
            if self._row_penalised(seg.request):
                feats.add("pen")
            if sp.logit_bias:
                feats.add("bias")
            if sp.logprobs:
                feats.add("lp")
            if sp.json_schema:
                feats.add("gram")
        if "gram" in feats:
            if not self.cfg.constrained_window or self.grammar is None:
                self._warn_constrained_off(
                    "constrained_window is off" if self.grammar is not None
                    else "no grammar vocabulary wired")
                self._count_constrained(fallbacks=1)
                return None
            for seg in plan.seqs:
                sp = seg.request.sampling_params
                if not sp.json_schema:
                    continue
                # The host entry first (it aborts on a bad schema, and the
                # single-step path then owns the finish).
                if self._grammar_entry(seg.request) is None:
                    return None
                try:
                    dev, built = self.grammar.device_table(sp.json_schema)
                except ValueError:
                    return None
                self._count_constrained(builds=int(built),
                                        cache_hits=int(not built))
                if dev is None:
                    self._warn_constrained_off(
                        "grammar state x vocab exceeds the device-table "
                        "budget")
                    self._count_constrained(fallbacks=1)
                    return None
        return tuple(sorted(feats))

    def _grammar_combined_tables(self, plan: BatchPlan):
        """The batch's dense grammar tables on the device: distinct
        grammars concatenate along the state axis (each one's row offset
        baked into its rows and its transition values), so ONE [R, Vg]
        gather serves every row whichever schema it decodes. Cached per
        grammar combination (one H2D per new combination); a window copies
        them into its graph's own buffers, so a cached tensor is only ever
        read. Returns ({key: device table}, (trans, allowed, offsets))."""
        from parallax_tpu_torch.constrained import grammar_cache_key

        tables = {}
        for seg in plan.seqs:
            schema = seg.request.sampling_params.json_schema
            if schema:
                key = grammar_cache_key(schema)
                if key not in tables:
                    tables[key] = self.grammar.device_table(schema)[0]
        combo = tuple(sorted(tables))
        cached = self._gram_combo_cache.get(combo)
        if cached is None:
            trans, allowed, offsets, off = [], [], {}, 0
            for key in combo:
                dev = tables[key]
                offsets[key] = off
                trans.append(dev.trans + np.int32(off))
                allowed.append(dev.allowed)
                off += dev.trans.shape[0]
            cached = (
                torch.from_numpy(np.concatenate(trans)).to(self.device),
                torch.from_numpy(
                    np.concatenate(allowed).view(np.int32)).to(self.device),
                offsets,
            )
            if len(self._gram_combo_cache) >= 16:
                self._gram_combo_cache.pop(next(iter(self._gram_combo_cache)))
            self._gram_combo_cache[combo] = cached
        return tables, cached

    def _pack_window_features(self, plan: BatchPlan, st: WindowState,
                              feats: tuple) -> None:
        """Fill a window's feature fields, packed as the host sampler
        packs them: penalty strengths and the count table seeded from each
        penalised row's committed stream, the bias rows, the combined
        grammar tables with each constrained row's DFA row and dead row,
        and the logprob buffer. Neutral rows carry neutral values (0 / 0 /
        1.0 penalties, no bias row, unconstrained), which the feature math
        leaves bit for bit unchanged."""
        from parallax_tpu_torch.constrained import grammar_cache_key

        s = int(st.feed.shape[0])
        v = int(self.model.config.vocab_size)
        put = self._staging.put
        if "pen" in feats:
            pres = np.zeros((s,), np.float32)
            freq = np.zeros((s,), np.float32)
            rep = np.ones((s,), np.float32)
            gen = {}
            for i, seg in enumerate(plan.seqs):
                if self._row_penalised(seg.request):
                    sp = seg.request.sampling_params
                    pres[i], freq[i] = (sp.presence_penalty,
                                        sp.frequency_penalty)
                    rep[i] = sp.repetition_penalty
                    gen[i] = self._generated_ids(seg.request)
            st.pen_pres, st.pen_freq = put("ms_pres", pres), put("ms_freq",
                                                                 freq)
            st.pen_rep = put("ms_rep", rep)
            st.pen_counts = output_token_counts(
                put("ms_pen_ids", _pad_id_lists(gen, s)), v)
        if "bias" in feats:
            rows, vecs = self._bias_pack(
                plan, [i for i, seg in enumerate(plan.seqs)
                       if seg.request.sampling_params.logit_bias], v)
            st.bias_rows = put("ms_bias_rows", rows)
            st.bias_vecs = put("ms_bias_vecs", vecs)
        if "gram" in feats:
            tables, (trans, allowed, offsets) = (
                self._grammar_combined_tables(plan))
            dfa0 = np.zeros((s,), np.int32)
            dead = np.zeros((s,), np.int32)
            constrained = np.zeros((s,), bool)
            for i, seg in enumerate(plan.seqs):
                schema = seg.request.sampling_params.json_schema
                ent = self._grammar_states.get(seg.request.request_id)
                if not schema or ent is None:
                    continue
                key = grammar_cache_key(schema)
                dev, off = tables[key], offsets[key]
                dfa0[i] = off + dev.device_state(int(ent[1]))
                dead[i] = off + dev.dead_state
                constrained[i] = True
            st.g_trans, st.g_allowed = trans, allowed
            st.g_constrained = put("ms_constrained", constrained)
            st.g_dead, st.dfa = put("ms_dead", dead), put("ms_dfa", dfa0)
        if "lp" in feats:
            st.lps = torch.zeros(tuple(st.tokens.shape), dtype=torch.float32,
                                 device=self.device)

    def _pack_stop_state(self, plan: BatchPlan, s: int):
        """Per-row stop state for a window chain: the combined EOS +
        stop-token set (-1 padded; empty under ``ignore_eos``, matching
        commit_token which ignores both then), the remaining generation
        budget before a length freeze, and the min_new_tokens gate.
        Budgets count the pending device-fed token of overlap-fed rows.
        Padded bucket rows keep limit 0 and freeze at step one."""
        limits = np.zeros((s,), np.int32)
        min_req = np.zeros((s,), np.int32)
        sets: list[tuple[int, ...]] = []
        jmax = 1
        for i, seg in enumerate(plan.seqs):
            req = seg.request
            sp = req.sampling_params
            pending = int(
                seg.device_token and req.total_len < seg.context_len
            )
            n_out = req.num_generated + pending
            limits[i] = max(0, sp.max_new_tokens - n_out)
            min_req[i] = max(0, sp.min_new_tokens - n_out)
            stop: tuple[int, ...] = ()
            if not sp.ignore_eos:
                stop = tuple(dict.fromkeys(
                    tuple(req.eos_token_ids) + tuple(sp.stop_token_ids)
                ))
            sets.append(stop)
            jmax = max(jmax, len(stop))
        j = 1
        while j < jmax:     # pow2 lattice bounds the graph keys
            j *= 2
        stop_tokens = np.full((s, j), -1, np.int32)
        for i, stop in enumerate(sets):
            stop_tokens[i, : len(stop)] = stop
        return stop_tokens, limits, min_req

    def _window_lora(self, st: WindowState) -> dict | None:
        """A window step's ``BatchInputs.lora``: the state's slot tensor(s)
        over the current adapter stack (a graph bakes the stack's
        addresses; the engine drops it when the stack changes)."""
        if st.lora_slot is not None:
            return {"slot": st.lora_slot, "layers": self._adapters.stacked()}
        if st.lora_slots is not None:
            return {"slots": st.lora_slots,
                    "layers": self._adapters.stacked()}
        return None

    def _window_step(self, st: WindowState, t: int, sampled: bool,
                     fused_sample: bool, flags: dict) -> None:
        """One step of a decode window, on tensors only (the scan body of
        the JAX package's ``_build_multistep``): build the step's inputs
        from the carry, forward, sample, freeze stopped rows (they repeat
        their fed token and write no KV), update the stop mask, advance
        the context and the counter, and write the tokens at the counter's
        row. ``t`` is the token bucket and ``flags`` the inputs'
        decode_only / decode_fused / prefill_fused."""
        page = self.cfg.page_size
        live = ~st.stopped
        pos = torch.clamp_min(st.ctx - 1, 0)
        phys = torch.gather(st.page_indices, 1,
                            (pos // page)[:, None].long())[:, 0]
        slots = torch.where((st.ctx > 0) & live, phys * page + pos % page,
                            -1).to(torch.int32)
        inputs = BatchInputs(
            token_ids=_fit(st.feed, t, 0), hidden_states=None,
            positions=_fit(pos, t, 0), kv_lens=st.ctx,
            page_indices=st.page_indices, cu_q_lens=st.cu_q_lens,
            num_seqs=st.num_seqs, slot_mapping=_fit(slots, t, -1),
            logits_indices=st.logits_indices, state_slots=st.state_slots,
            dense_map=st.dense_map, q_lens=st.q_lens,
            reset_state=st.reset_state, lora=self._window_lora(st), **flags,
        )
        logits = window_feature_logits(st, self._forward(inputs))
        if sampled:
            gumbel = gumbel_rows(st.seeds, st.steps0 + st.counter,
                                 self.cfg.seed, logits.shape[-1])
            if fused_sample:
                nxt = fused_sample_topk(logits, gumbel, st.temp, st.top_k)
            else:
                nxt = sample_tokens(logits, st.temp, st.top_k, st.top_p,
                                    st.min_p, gumbel)
        else:
            nxt = greedy_tokens(logits)
        nxt = torch.where(live, nxt, st.feed)
        st.tokens.index_copy_(0, st.counter, nxt[None])
        live_i = live.to(torch.int32)
        window_feature_advance(st, logits, nxt, live)
        st.produced.add_(live_i)
        # The predicate commit_token applies on the host: a stop/EOS token
        # only finishes a row once min_new_tokens is met; the length
        # budget always does.
        hit_stop = (nxt[:, None] == st.stop_tokens).any(dim=1) & (
            st.produced >= st.min_req)
        st.stopped.logical_or_(live & (hit_stop | (st.produced >= st.limit)))
        st.ctx.add_(live_i)
        st.feed.copy_(nxt)
        st.counter.add_(1)

    def _dispatch_multistep(self, plan: BatchPlan,
                            t0: float) -> StepTicket | None:
        """ENQUEUE a chain of k-step decode windows over ``plan`` and
        return its in-flight ticket, or None to use the single-step path.
        Nothing waits for the device here: the window tokens and the final
        produced counts come back in resolve()'s one D2H pass.

        Qualification (``_fused_common_ok``) and scheduler-guaranteed KV
        pages for the whole chain (``plan_decode_window``; page pressure
        falls back to K=1 rather than evict for lookahead). Device-fed
        rows (overlap loop one step ahead) join through the on-device
        last-token gather. Rows may finish mid-window: the stop mask
        freezes them — no KV, context or state advances past a row's stop
        point — and resolve() commits at most each row's produced
        count. Rows with sampling features ride the window with their
        feature state (``_window_feature_flags``); a batch that cannot
        falls back to the host-synchronous sampler. With speculation on,
        the window is the speculative one when its pages at the verify
        width can be reserved and some row got a proposal."""
        k = self._effective_lookahead()
        if k <= 1 or not self._fused_common_ok(plan, allow_features=True):
            return None
        feats = self._window_feature_flags(plan)
        if feats is None:
            return None
        windows = max(1, self.cfg.decode_pipeline)
        m = spec_w = 0
        if self.cfg.speculative_tokens > 0:
            s_bucket = next_bucket(max(len(plan.seqs), 1),
                                   self.spec.seq_buckets)
            spec_w = self._spec_window_width(plan, s_bucket)
        if spec_w > 0:
            # Worst case: every proposal accepted, K * (1 + width) tokens a
            # row a window. A window the planner cannot page at that width
            # retries plain before dropping to K=1.
            m = self.scheduler.plan_decode_window(
                plan, k, max_windows=windows,
                max_model_len=self.cfg.max_model_len, spec=spec_w,
            )
            if m <= 0:
                spec_w = 0
        if m <= 0:
            m = self.scheduler.plan_decode_window(
                plan, k, max_windows=windows,
                max_model_len=self.cfg.max_model_len,
            )
        if m <= 0:
            # Soft fallback to K=1: the normal path probes +1 token itself
            # and owns the kv_oom decision.
            return None
        props = sources = None
        if spec_w > 0:
            # Proposals are staged only now that the pages are reserved:
            # page pressure never burns a draft forward. No proposal hit
            # anywhere: the plain window runs on the reservation held.
            props, sources = self._stage_spec_proposals(plan, k, spec_w)
        if props is None:
            spec_w = 0
        return self._dispatch_window(plan, t0, k, m, feats, spec_w, props,
                                     sources)

    def _dispatch_window(self, plan: BatchPlan, t0: float, k: int, m: int,
                         feats: tuple, spec: int = 0,
                         props: np.ndarray | None = None,
                         sources: list | None = None) -> StepTicket:
        """Enqueue a chain of ``m`` windows of ``k`` steps over ``plan``
        and return its ticket. ``spec > 0`` makes it the speculative
        window (``_spec_window_step``): every step feeds each row ``1 +
        spec`` tokens, its fed token and the next ``spec`` entries of its
        staged proposals ``props``, verified in one multi-token forward
        (the fused prefill path), with the widened batch S x (1 + spec)
        tokens."""
        sampled = any(
            seg.request.sampling_params.temperature > 0.0
            or seg.request.sampling_params.seed is not None
            for seg in plan.seqs
        )
        fused_sample = (sampled and not spec
                        and self._fused_sample_ok(plan))
        # The window's batch has the K=1 decode step's shapes and flags,
        # so its first step is that step, bit for bit. A speculative
        # window widens it (below).
        decode_only = self._use_decode_flag
        self._assign_state_slots(plan)
        inputs = assemble(
            plan, self.spec, self.cfg.page_size, self.device,
            with_dense_map=self._needs_state,
            decode_only=decode_only, decode_fused=self._decode_fused,
            prefill_fused=self._prefill_fused, staging=self._staging,
        )
        if any(seg.device_token for seg in plan.seqs):
            inputs = self._substitute_feed(plan, inputs)
        s = int(inputs.kv_lens.shape[0])
        w = spec + 1
        t = s * w if spec else int(inputs.token_ids.shape[0])
        put = self._staging.put
        stop_tokens, limits, min_req = self._pack_stop_state(plan, s)
        rows = max(1, self.cfg.decode_pipeline) * k
        limit = put("ms_limit", limits)
        cu_q_lens, logits_indices = inputs.cu_q_lens, inputs.logits_indices
        if spec:
            # Every real row owns w contiguous token slots; logits at every
            # fed position.
            n_real = len(plan.seqs)
            cu = np.zeros((s + 1,), np.int32)
            cu[1 : n_real + 1] = (np.arange(n_real, dtype=np.int32) + 1) * w
            cu[n_real + 1 :] = cu[n_real]
            cu_q_lens = put("ms_spec_cu", cu)
            logits_indices = put("ms_spec_li", np.arange(t, dtype=np.int32))
        st = WindowState(
            page_indices=inputs.page_indices, cu_q_lens=cu_q_lens,
            num_seqs=inputs.num_seqs, logits_indices=logits_indices,
            feed=_fit(inputs.token_ids, s, 0).clone(),
            ctx=inputs.kv_lens.clone(),
            stopped=limit <= 0,
            produced=torch.zeros((s,), dtype=torch.int32, device=self.device),
            counter=torch.zeros((1,), dtype=torch.int64, device=self.device),
            tokens=torch.zeros((rows, s) + ((w,) if spec else ()),
                               dtype=torch.int32, device=self.device),
            stop_tokens=put("ms_stop_tokens", stop_tokens), limit=limit,
            min_req=put("ms_min_req", min_req),
            state_slots=inputs.state_slots, dense_map=inputs.dense_map,
            q_lens=inputs.q_lens, reset_state=inputs.reset_state,
        )
        lora = self._lora_field(plan, inputs)
        if lora is not None:
            st.lora_slot, st.lora_slots = lora.get("slot"), lora.get("slots")
        if spec:
            props_pad = np.full((s, props.shape[1]), -1, np.int32)
            props_pad[: props.shape[0]] = props
            st.props = put("ms_props", props_pad)
            st.counts = torch.zeros((rows, s), dtype=torch.int32,
                                    device=self.device)
            if "gram" in feats:
                st.rejs = torch.zeros((rows, s), dtype=torch.int32,
                                      device=self.device)
        step_idx = self._step_count
        if sampled:
            temp, top_k, top_p, min_p, seeds, steps0 = (
                self._pack_base_sampling(plan, s))
            steps0 = np.where(seeds >= 0, steps0,
                              _WINDOW_NOISE_STEPS + (step_idx << 20))
            st.temp, st.top_k = put("ms_temp", temp), put("ms_top_k", top_k)
            st.top_p, st.min_p = put("ms_top_p", top_p), put("ms_min_p",
                                                             min_p)
            st.seeds, st.steps0 = put("ms_seeds", seeds), put("ms_steps0",
                                                             steps0)
        n = m * k
        if feats:
            self._pack_window_features(plan, st, feats)
            n_gram = sum(1 for seg in plan.seqs
                         if seg.request.sampling_params.json_schema)
            self._count_constrained(
                rows=sum(1 for seg in plan.seqs
                         if self._row_has_features(seg.request)),
                mask_steps=n_gram * n * w if "gram" in feats else 0,
            )
        self.window_feature_counts[feats] = (
            self.window_feature_counts.get(feats, 0) + 1)
        if spec:
            # The verify forward is multi-token: the fused prefill path.
            flags = dict(decode_only=False, decode_fused=False,
                         prefill_fused=self._prefill_fused)

            def step(state: WindowState) -> None:
                self._spec_window_step(state, spec, sampled, flags, feats)
        else:
            flags = dict(decode_only=inputs.decode_only,
                         decode_fused=inputs.decode_fused,
                         prefill_fused=inputs.prefill_fused)

            def step(state: WindowState) -> None:
                self._window_step(state, t, sampled, fused_sample, flags)

        if self._graphs is not None:
            # Every shape the step bakes in (batch, pages, stop-set width,
            # chain rows, feature buffers, verify width, the lora form's
            # slot tensors) and every branch it takes, and for an adapter
            # window the stack generation whose tensors its graph reads.
            shapes = tuple((name, tuple(x.shape)) for name, x in st._tensors())
            if lora is not None:
                gen = self._adapters.generation
                if self._graph_lora_gen != gen:
                    # A re-stack freed the tensors older graphs read.
                    self._graphs.drop(lambda key: any(
                        name == "lora_stack" for name, _ in key[5]))
                    self._graph_lora_gen = gen
                shapes += (("lora_stack", gen),)
            key = (t, spec, sampled, fused_sample, feats, shapes)
            st = self._graphs.run(
                key, st, step, n,
                preserve=(self._preserve_state(st.state_slots)
                          if self._needs_state else None))
        else:
            for _ in range(n):
                step(st)
        if spec:
            self._count_kernel_dispatch("spec", self._prefill_impl, n)
        else:
            self._count_kernel_dispatch("multistep", self._attn_impl, n)
        if sampled:
            # A speculative feature window draws at each of its w
            # positions in turn.
            self._count_kernel_dispatch(
                "sample", kernel_select.IMPL_FUSED if fused_sample
                else kernel_select.IMPL_TORCH, n * w if spec and feats else n)
        self._last_fused_steps = n
        # Advance scheduler bookkeeping exactly like a single decode step
        # (+1 computed per row, rows un-ready until their tokens resolve);
        # resolve() adds the remaining commits.
        self.scheduler.on_batch_computed(plan)
        self._step_count += 1
        extra = [x for x in (st.lps, st.rejs) if x is not None]
        host, ready = self._to_host(
            st.tokens, st.counts if spec else st.produced, *extra)
        ticket = StepTicket(
            plan=plan, step_idx=step_idx, t0=t0, ms_windows=host[0],
            ready=ready, dispatch_seq=self._dispatch_seq,
            ms_lp=host[2] if st.lps is not None else None,
            program="spec_window" if spec else "decode_window",
        )
        if spec:
            ticket.ms_counts = host[1]
            ticket.ms_rej = host[-1] if st.rejs is not None else None
            ticket.spec_meta = {
                "width": spec, "sources": sources, "props": props,
                "lengths": (props >= 0).sum(axis=1).tolist(),
            }
        else:
            ticket.ms_state = host[1]
        ticket.host_ms = (time.perf_counter() - t0) * 1000.0
        self._inflight.append(ticket)
        return ticket

    def _resolve_multistep(self, ticket: StepTicket) -> StepOutputs:
        """Complete a window chain: ONE D2H pass for all its tokens, the
        final produced counts and any logprobs (copies started at
        dispatch), then per-token commits, each advancing the row's host
        DFA state. The device's per-row ``produced`` count bounds them —
        tokens past a row's stop point are feed repeats, never committed —
        and ``num_computed_tokens`` only ever advances by the commit count,
        so prefix-cache donation can never expose phantom KV. A row an
        abort raced mid-window commits nothing and its dispatch-time +1
        computed advance is rolled back too."""
        plan = ticket.plan
        t_r0 = time.perf_counter()
        try:
            tb = time.perf_counter()
            self._wait(ticket.ready)
            device_ms = (time.perf_counter() - tb) * 1000.0
            toks = ticket.ms_windows.numpy()
            produced = ticket.ms_state.numpy()
            lp = None if ticket.ms_lp is None else ticket.ms_lp.numpy()
            total = 0
            gp_committed = gp_window = 0
            for i, seg in enumerate(plan.seqs):
                req = seg.request
                want_lp = lp is not None and req.sampling_params.logprobs
                committed = 0
                quota = int(produced[i])
                while committed < quota and not req.status.is_finished:
                    tok = int(toks[committed, i])
                    req.commit_token(
                        tok, float(lp[committed, i]) if want_lp else None)
                    self._advance_grammar(req, tok)
                    committed += 1
                if not req.request_id.startswith("__"):
                    gp_committed += committed
                    gp_window += int(toks.shape[0])
                # Every committed token's predecessor was fed, so computed
                # KV advances by the commit count; dispatch already counted
                # one step (computed == len(all_token_ids) - 1 while
                # generating).
                req.num_computed_tokens += committed - 1
                req.ready_for_step = not req.status.is_finished
                total += committed
            if self._needs_state and self.cache.enable_prefix_cache:
                # Decode snapshots at the window's end. A row that finished
                # mid-window ran surplus recurrence steps (the window's dense
                # view is constant), so only live rows may snapshot.
                live = [seg for seg in plan.seqs
                        if not seg.request.status.is_finished]
                if live:
                    self._maybe_snapshot_state(BatchPlan(live))
        except Exception:
            self._abandon(plan)
            raise
        # Goodput: the window computed toks.shape[0] positions for every
        # row; those past a row's stop point (and a raced row's whole
        # window) were rolled back above: the frozen tail. Internal
        # __draft rows stay out, as in the commit hook.
        self._goodput.count("committed", gp_committed)
        self._goodput.count("frozen_tail", gp_window - gp_committed)
        return self._multistep_outputs(ticket, total, t_r0, device_ms)

    def _multistep_outputs(self, ticket: StepTicket, total: int,
                           t_r0: float, device_ms: float) -> StepOutputs:
        """The shared telemetry tail of the window and verify resolvers:
        latency EWMA over the steps delivered, per-visit / per-token
        timing, serve time, device time, traces, finish collection."""
        now = time.perf_counter()
        host_ms = ticket.host_ms + (now - t_r0) * 1000.0
        overlapped = self._dispatch_seq != ticket.dispatch_seq
        # The EWMA amortizes over the steps delivered (the average
        # committed depth per row), as the JAX engine's does.
        plan = ticket.plan
        steps_done = max(1, -(-total // max(1, len(plan.seqs))))
        self._record_latency(plan, host_ms / steps_done)
        self.step_timing.update(host_ms, device_ms, overlapped,
                                tokens=total)
        self._account_time(ticket, host_ms, device_ms)
        if total:
            self._h_batch_tokens.observe(total)
        if self._traced:
            self._trace_plan(plan, ticket.t0, now)
        return StepOutputs(
            forward=[],
            finished=self._collect_finished(),
            num_tokens=total,
            step_time_ms=(now - ticket.t0) * 1000.0,
            host_ms=host_ms,
            device_ms=device_ms,
            overlapped=overlapped,
        )

    # -- speculative decoding ---------------------------------------------

    # Host-side proposal scan is bounded to this many trailing tokens per
    # sequence, so the per-step cost stays O(batch * window).
    _SPEC_LOOKBACK = 512

    @classmethod
    def _ngram_proposal(cls, tokens: list[int], n: int, k: int) -> list[int]:
        """Propose up to ``k`` continuation tokens (prompt-lookup decoding,
        the JAX engine's rule): find the most recent earlier occurrence of
        the trailing ``n``-gram within the lookback window and copy what
        followed it. A match whose continuation runs to the end of the
        sequence means the stream is periodic with the match distance as
        its period, so the copied span cycles to fill ``k``. Wrong
        proposals only cost acceptance, never correctness."""
        if k <= 0 or len(tokens) <= n:
            return []
        window = tokens[-cls._SPEC_LOOKBACK:]
        tail = window[-n:]
        for start in range(len(window) - n - 1, -1, -1):
            if window[start:start + n] == tail:
                follow = window[start + n : start + n + k]
                if not follow:
                    continue
                if len(follow) < k and start + n + len(follow) == len(window):
                    d = len(window) - n - start
                    follow = [
                        window[start + n + (j % d)] for j in range(k)
                    ]
                return list(follow)[:k]
        return []

    def _propose(self, contexts: list[list[int]], budgets: list[int]
                 ) -> tuple[list[list[int]], str]:
        """Proposals for each context within its budget, and their source:
        the draft engine's (one run for every row) or n-gram lookup. The
        host milliseconds it took feed the propose histogram."""
        t0 = time.perf_counter()
        try:
            return self._propose_rows(contexts, budgets)
        finally:
            self._last_propose_ms = (time.perf_counter() - t0) * 1000.0

    def _propose_rows(self, contexts: list[list[int]], budgets: list[int]
                      ) -> tuple[list[list[int]], str]:
        if self.draft is not None:
            rows = [i for i, b in enumerate(budgets) if b > 0]
            drafted = self.draft.propose_batch(
                [contexts[i] for i in rows], [budgets[i] for i in rows]
            ) if rows else []
            out: list[list[int]] = [[] for _ in budgets]
            for i, prop in zip(rows, drafted):
                out[i] = list(prop)[: budgets[i]]
            return out, "draft"
        return [
            list(self._ngram_proposal(ctx, self.cfg.speculative_ngram,
                                      b))[:b] if b > 0 else []
            for ctx, b in zip(contexts, budgets)
        ], "ngram"

    def _spec_window_width(self, plan: BatchPlan, s_bucket: int) -> int:
        """Verify width of a speculative window over ``plan``, a batch of
        ``s_bucket`` rows (0 = plain window): a single full stage, no
        mixed-adapter batch (its per-token slot vector is one a row), and
        the S x (1 + width) token rows within the batch token budget.
        Cheap: no proposal work happens until the window's pages are
        reserved."""
        p = self.cfg.speculative_tokens
        if (p <= 0 or plan.mixed_lora
                or not (self.model.is_first and self.model.is_last)):
            return 0
        while p > 0 and s_bucket * (1 + p) > \
                self.cfg.max_num_tokens_per_batch:
            p -= 1
        return max(0, p)

    def _stage_spec_proposals(self, plan: BatchPlan, k: int, p: int):
        """Per-row proposal buffers for an already-paged speculative
        window: ``(props i32[rows, L], sources)``, or ``(None, None)`` when
        no row got a proposal. Device-fed rows (their last token is not on
        the host yet) stage an empty buffer and ride the window as plain
        decode. A buffer holds at most what the window can consume, ``k *
        (1 + p) - 1`` tokens, within each row's context and generation
        budget; its length is that cap's power of 2, so staging depth never
        changes the graph key."""
        cap = k * (1 + p) - 1
        budgets: list[int] = []
        for seg in plan.seqs:
            req = seg.request
            sp = req.sampling_params
            if seg.device_token:
                budgets.append(0)
                continue
            budgets.append(max(0, min(
                cap,
                self.cfg.max_model_len - req.total_len - 1,
                sp.max_new_tokens - req.num_generated - 1,
            )))
        proposals, source = self._propose(
            [seg.request.all_token_ids for seg in plan.seqs], budgets)
        if not any(proposals):
            return None, None
        props = np.full((len(plan.seqs), _pow2(cap)), -1, np.int32)
        sources: list[str | None] = []
        for i, prop in enumerate(proposals):
            props[i, : len(prop)] = prop
            sources.append(source if prop else None)
        self._count_spec_proposed(source, sum(map(len, proposals)))
        return props, sources

    def _spec_window_step(self, st: WindowState, spec: int, sampled: bool,
                          flags: dict, feats: tuple) -> None:
        """One step of a speculative window, on tensors only (the scan body
        of the JAX package's ``_build_spec_multistep``). Each row feeds its
        token and the next ``spec`` entries of its proposals (read at its
        produced count; -1 past the buffer), one forward over the widened
        batch gives logits at every fed position, the target at each is
        the argmax or the row's draw (seeded rows keyed by their output
        step, as the K=1 path draws them), and ``speculative_accept``
        commits the agreeing prefix plus the correction token, truncated
        by the stop predicate. Rejected positions' KV lies past the new
        context and is overwritten by the next step (the context pointer
        advances by the commit count only); stopped rows write slot -1
        and repeat their feed. With sampling features (``feats``) the
        positions are walked in order, each one's penalties and grammar
        row advanced through the FED tokens before it, which is exact
        wherever the accept rule can commit; the carried state is then
        recomputed from the committed tokens."""
        page = self.cfg.page_size
        w = spec + 1
        dev = st.feed.device
        s = st.feed.shape[0]
        plen = st.props.shape[1]
        pidx = st.produced[:, None] + torch.arange(
            spec, dtype=torch.int32, device=dev)[None, :]
        props = torch.where(
            pidx < plen,
            torch.gather(st.props, 1, torch.clamp(pidx, 0, plen - 1).long()),
            -1)
        fed = torch.cat([st.feed[:, None], props], dim=1)          # [S, w]
        jw = torch.arange(w, dtype=torch.int32, device=dev)
        pos = torch.clamp_min((st.ctx - 1)[:, None] + jw[None, :], 0)
        pps = st.page_indices.shape[1]
        phys = torch.gather(st.page_indices, 1,
                            torch.clamp(pos // page, max=pps - 1).long())
        live = (st.ctx > 0) & ~st.stopped
        slots = torch.where(live[:, None], phys * page + pos % page, -1)
        # A stopped row attends over at least its w fed positions (its
        # outputs are discarded; it must only stay in bounds).
        kv_lens = torch.where(
            st.stopped, torch.where(st.ctx > 0, torch.clamp_min(st.ctx, w),
                                    st.ctx), st.ctx + spec)
        inputs = BatchInputs(
            token_ids=torch.clamp_min(fed, 0).reshape(-1).to(torch.int32),
            hidden_states=None, positions=pos.reshape(-1).to(torch.int32),
            kv_lens=kv_lens.to(torch.int32), page_indices=st.page_indices,
            cu_q_lens=st.cu_q_lens, num_seqs=st.num_seqs,
            slot_mapping=slots.reshape(-1).to(torch.int32),
            logits_indices=st.logits_indices, lora=self._window_lora(st),
            **flags,
        )
        logits = self._forward(inputs)                              # [S*w, V]
        v = logits.shape[-1]
        jw64 = jw.to(torch.int64)[None, :]

        def noise_steps(j):
            # Seeded rows: their output step; unseeded rows: a step of the
            # window's own range per (counter, position).
            return torch.where(
                st.seeds[:, None] >= 0,
                st.steps0[:, None] + st.produced.to(torch.int64)[:, None] + j,
                st.steps0[:, None] + st.counter * w + j)

        dfa_traj = []
        lp = None
        if not feats:
            if sampled:
                gumbel = gumbel_rows(
                    st.seeds.repeat_interleave(w),
                    noise_steps(jw64).reshape(-1), self.cfg.seed, v)
                g = sample_tokens(
                    logits, st.temp.repeat_interleave(w),
                    st.top_k.repeat_interleave(w),
                    st.top_p.repeat_interleave(w),
                    st.min_p.repeat_interleave(w), gumbel).reshape(s, w)
            else:
                g = greedy_tokens(logits).reshape(s, w)
        else:
            logits3 = logits.reshape(s, w, v)
            counts_j = st.pen_counts
            dfa_j = st.dfa
            g_cols, lp_cols = [], []
            for j in range(w):
                lj = logits3[:, j]
                if counts_j is not None:
                    lj = apply_penalties(lj, counts_j, st.pen_pres,
                                         st.pen_freq, st.pen_rep)
                if st.bias_rows is not None:
                    lj = bias_logits(lj, st.bias_rows, st.bias_vecs)
                if dfa_j is not None:
                    dfa_traj.append(dfa_j)
                    lj = mask_logits_packed(lj, st.g_allowed[dfa_j.long()],
                                            st.g_constrained)
                if sampled:
                    gumbel = gumbel_rows(st.seeds, noise_steps(j)[:, 0],
                                         self.cfg.seed, v)
                    gj = sample_tokens(lj, st.temp, st.top_k, st.top_p,
                                       st.min_p, gumbel)
                else:
                    gj = greedy_tokens(lj)
                g_cols.append(gj)
                if st.lps is not None:
                    lp_cols.append(token_logprobs(lj, gj))
                if j < w - 1:
                    nxt = fed[:, j + 1]
                    valid = nxt >= 0
                    if counts_j is not None:
                        counts_j = counts_j.scatter_add(
                            1, torch.clamp_min(nxt, 0).long()[:, None],
                            valid.to(torch.int32)[:, None])
                    if dfa_j is not None:
                        vg = st.g_trans.shape[1]
                        adv = st.g_trans[dfa_j.long(),
                                         torch.clamp(nxt, 0, vg - 1).long()]
                        adv = torch.where(nxt < vg, adv, st.g_dead)
                        dfa_j = torch.where(st.g_constrained & valid, adv,
                                            dfa_j)
            g = torch.stack(g_cols, dim=1)
            if lp_cols:
                lp = torch.stack(lp_cols, dim=1)
        c, froze = speculative_accept(g, props, st.produced, st.stop_tokens,
                                      st.min_req, st.limit, st.stopped)
        if st.pen_counts is not None:
            for j in range(w):
                st.pen_counts.scatter_add_(
                    1, g[:, j].long()[:, None],
                    (j < c).to(torch.int32)[:, None])
        if st.dfa is not None:
            vg = st.g_trans.shape[1]
            dfa = st.dfa.clone()
            for j in range(w):
                adv = st.g_trans[dfa.long(),
                                 torch.clamp(g[:, j], 0, vg - 1).long()]
                adv = torch.where(g[:, j] < vg, adv, st.g_dead)
                dfa = torch.where((j < c) & st.g_constrained, adv, dfa)
            st.dfa.copy_(dfa)
            # The correction position held a real proposal the grammar
            # mask excluded (the masked target could never match it).
            cm1 = torch.clamp_min(c - 1, 0).long()[:, None]
            if spec > 0:
                prop_at = torch.gather(
                    props, 1, torch.clamp_max(cm1, spec - 1))[:, 0]
            else:
                prop_at = torch.full_like(c, -1)
            g_at = torch.gather(g, 1, cm1)[:, 0]
            dfa_at = torch.gather(torch.stack(dfa_traj, dim=1), 1, cm1)[:, 0]
            rej = (st.g_constrained & (c > 0) & (cm1[:, 0] < spec)
                   & (prop_at >= 0) & (prop_at != g_at)
                   & ~token_in_mask(st.g_allowed[dfa_at.long()], prop_at))
            st.rejs.index_copy_(0, st.counter, rej.to(torch.int32)[None])
        if lp is not None:
            st.lps.index_copy_(0, st.counter, lp[None])
        st.tokens.index_copy_(0, st.counter, g[None])
        st.counts.index_copy_(0, st.counter, c[None])
        st.produced.add_(c)
        st.ctx.add_(c)
        st.stopped.logical_or_(froze)
        last = torch.gather(g, 1, torch.clamp_min(c - 1, 0).long()[:, None])
        st.feed.copy_(torch.where(c > 0, last[:, 0], st.feed))
        st.counter.add_(1)

    def _resolve_spec_multistep(self, ticket: StepTicket) -> StepOutputs:
        """Complete a speculative window chain: ONE D2H pass for every
        step's targets ``[rows, S, 1 + P]`` and commit counts ``[rows,
        S]`` (copies started at dispatch), then per-token commits bounded
        by the device's counts, each advancing the row's host DFA state —
        so the radix tree, the grammar and the counters see exactly the
        accepted stream. A committed token at window output index d was an
        accepted proposal iff it equals the staged entry d the device fed
        there."""
        plan = ticket.plan
        t_r0 = time.perf_counter()
        meta = ticket.spec_meta or {}
        sources = meta.get("sources") or []
        lengths = meta.get("lengths") or []
        props = meta.get("props")
        try:
            tb = time.perf_counter()
            self._wait(ticket.ready)
            device_ms = (time.perf_counter() - tb) * 1000.0
            toks = ticket.ms_windows.numpy()                 # [R, S, w]
            cnts = ticket.ms_counts.numpy()                  # [R, S]
            lp = None if ticket.ms_lp is None else ticket.ms_lp.numpy()
            if ticket.ms_rej is not None:
                rej_total = int(ticket.ms_rej.numpy().sum())
                if rej_total:
                    self._count_constrained(spec_mask_rejections=rej_total)
            w = int(toks.shape[2])
            iters = int(toks.shape[0])
            total = 0
            gp_committed = gp_dev_committed = gp_live_pos = gp_window = 0
            for i, seg in enumerate(plan.seqs):
                req = seg.request
                want_lp = lp is not None and req.sampling_params.logprobs
                committed = dev_committed = fed_props = accepted = 0
                live_iters = 0
                plen = lengths[i] if i < len(lengths) else 0
                for it in range(iters):
                    c = int(cnts[it, i])
                    if c <= 0:
                        # A stopped row stays stopped: the remaining
                        # iterations are its frozen tail.
                        continue
                    live_iters += 1
                    fed_props += min(w - 1, max(0, plen - dev_committed))
                    for j in range(c):
                        d = dev_committed + j
                        if (props is not None and d < plen
                                and int(toks[it, i, j]) == int(props[i, d])):
                            accepted += 1
                    dev_committed += c
                    for j in range(c):
                        if req.status.is_finished:
                            break
                        tok = int(toks[it, i, j])
                        req.commit_token(
                            tok, float(lp[it, i, j]) if want_lp else None)
                        self._advance_grammar(req, tok)
                        committed += 1
                    if req.status.is_finished:
                        break
                internal = req.request_id.startswith("__")
                if not internal:
                    gp_committed += committed
                    gp_dev_committed += dev_committed
                    gp_live_pos += live_iters * w
                    gp_window += iters * w
                src = sources[i] if i < len(sources) else None
                if src is not None and not internal:
                    accepted = min(accepted, fed_props)
                    self._count_spec_result(src, accepted,
                                            fed_props - accepted)
                # Every committed token's predecessor was fed; dispatch
                # counted one step (as in the plain window).
                req.num_computed_tokens += committed - 1
                req.ready_for_step = not req.status.is_finished
                total += committed
        except Exception:
            self._abandon(plan)
            raise
        # Goodput: verified positions the device did not commit were
        # rejected proposals; the stopped iterations and what the device
        # committed past a host-side stop are the frozen tail.
        self._goodput.count("committed", gp_committed)
        self._goodput.count("speculative_rejected",
                            gp_live_pos - gp_dev_committed)
        self._goodput.count("frozen_tail",
                            (gp_window - gp_live_pos)
                            + (gp_dev_committed - gp_committed))
        return self._multistep_outputs(ticket, total, t_r0, device_ms)

    def _verify_targets(self, logits: torch.Tensor, entries: list,
                        step_idx: int) -> torch.Tensor:
        """Target token at every fed position of a host-synchronous verify,
        i32[T]: the argmax when every verified row is greedy, else the
        split sampler at every position with its row's parameters, a
        seeded row's position j keyed by its output step ``origin + j`` (so
        a seeded stream is the same with speculation on or off). ``entries``
        are (request, lo, hi, origin) spans of fed positions; positions
        outside them draw greedily (their targets are not read)."""
        if all(req.sampling_params.temperature <= 0.0
               and req.sampling_params.seed is None
               for req, _lo, _hi, _o in entries):
            return greedy_tokens(logits)
        t, v = logits.shape
        temp = np.zeros((t,), np.float32)
        top_k = np.zeros((t,), np.int32)
        top_p = np.ones((t,), np.float32)
        min_p = np.zeros((t,), np.float32)
        seeds = np.full((t,), -1, np.int64)
        steps = np.full((t,), _VERIFY_NOISE_STEPS + step_idx, np.int64)
        for req, lo, hi, origin in entries:
            (temp[lo:hi], top_k[lo:hi], top_p[lo:hi], min_p[lo:hi], seed,
             _o) = self._row_sampling_fields(req)
            if seed >= 0:
                seeds[lo:hi] = seed
                steps[lo:hi] = origin + np.arange(hi - lo)
        put = self._staging.put
        gumbel = gumbel_rows(put("vf_seeds", seeds), put("vf_steps", steps),
                             self.cfg.seed, v)
        self._count_kernel_dispatch("sample", kernel_select.IMPL_TORCH)
        return sample_tokens(logits, put("vf_temp", temp),
                             put("vf_top_k", top_k), put("vf_top_p", top_p),
                             put("vf_min_p", min_p), gumbel)

    def _dispatch_speculative(self, plan: BatchPlan,
                              t0: float) -> StepTicket | None:
        """The host-synchronous speculative fallback (K = 1, or a window
        the planner could not page): extend each decode row with its
        proposal, enqueue one verify forward over the ragged multi-token
        batch (the fused prefill path) and the targets at every fed
        position, and return a ``sync_only`` ticket;
        ``_resolve_speculative`` applies the accept rule and commits.
        None = use the plain path (feature rows, no proposal, no pages).
        Rejected positions' KV lies past the committed context and is
        overwritten by later steps."""
        k = self.cfg.speculative_tokens
        if k <= 0 or not self._fused_common_ok(plan):
            return None
        spare = self.cfg.max_num_tokens_per_batch - len(plan.seqs)
        budgets = [
            min(k, max(0, spare),
                self.cfg.max_model_len - seg.request.total_len - 1)
            for seg in plan.seqs
        ]
        proposals, source = self._propose(
            [seg.request.all_token_ids for seg in plan.seqs], budgets)
        # The shared token budget, in row order.
        for i, prop in enumerate(proposals):
            proposals[i] = prop[: max(0, spare)]
            spare -= len(proposals[i])
        if not any(proposals):
            return None
        for seg, prop in zip(plan.seqs, proposals):
            if not self.cache.ensure_capacity(
                seg.request, seg.request.total_len + len(prop)
            ):
                return None   # soft fallback; the plain path owns aborts
        self._count_spec_proposed(source, sum(map(len, proposals)))
        spec_plan = BatchPlan([
            ScheduledSeq(
                request=seg.request,
                num_new_tokens=1 + len(prop),
                token_ids=list(seg.token_ids) + prop,
                context_len=seg.context_len + len(prop),
            )
            for seg, prop in zip(plan.seqs, proposals)
        ], lora_id=plan.lora_id, mixed_lora=plan.mixed_lora)
        inputs = assemble(
            spec_plan, self.spec, self.cfg.page_size, self.device,
            gather_all_logits=True, prefill_fused=self._prefill_fused,
            staging=self._staging,
        )
        inputs.lora = self._lora_field(spec_plan, inputs)
        out = self._forward(inputs)
        self._count_kernel_dispatch("spec_verify", self._prefill_impl)
        step_idx = self._step_count
        self._step_count += 1
        entries, row = [], 0
        for seg in spec_plan.seqs:
            origin = self._row_sampling_fields(seg.request)[-1]
            entries.append((seg.request, row, row + seg.num_new_tokens,
                            origin))
            row += seg.num_new_tokens
        targets = self._verify_targets(out, entries, step_idx)
        (host,), ready = self._to_host(targets)
        ticket = StepTicket(
            plan=plan, step_idx=step_idx, t0=t0, inputs=inputs, out=out,
            tokens_host=host, ready=ready, sync_only=True,
            dispatch_seq=self._dispatch_seq,
            spec_verify=(spec_plan, proposals, source),
            program="spec_verify",
        )
        ticket.host_ms = (time.perf_counter() - t0) * 1000.0
        self._inflight.append(ticket)
        return ticket

    def _resolve_speculative(self, ticket: StepTicket) -> StepOutputs:
        """Complete a host-synchronous verify: commit each row's longest
        agreeing prefix plus the correction / bonus token."""
        plan = ticket.plan
        spec_plan, proposals, source = ticket.spec_verify
        t_r0 = time.perf_counter()
        try:
            tb = time.perf_counter()
            self._wait(ticket.ready)
            device_ms = (time.perf_counter() - tb) * 1000.0
            verified = ticket.tokens_host.numpy()
            total = row = 0
            for seg, prop in zip(spec_plan.seqs, proposals):
                req = seg.request
                n_fed = seg.num_new_tokens
                g = verified[row : row + n_fed]
                row += n_fed
                committed = 0
                for j in range(n_fed):
                    if req.status.is_finished:
                        break
                    req.commit_token(int(g[j]))
                    committed += 1
                    # Keep accepting while the next fed token agrees with
                    # what verification produced at this position.
                    if j < len(prop) and prop[j] != int(g[j]):
                        break
                req.num_computed_tokens += committed
                req.ready_for_step = not req.status.is_finished
                total += committed
                if req.request_id.startswith("__"):
                    continue
                self._goodput.count("committed", committed)
                self._goodput.count("speculative_rejected", n_fed - committed)
                if prop:
                    # A committed token was an accepted proposal iff it
                    # equals the proposal at its position.
                    acc = sum(1 for j in range(min(committed, len(prop)))
                              if int(g[j]) == prop[j])
                    self._count_spec_result(source, acc, len(prop) - acc)
        except Exception:
            self._abandon(plan)
            raise
        return self._multistep_outputs(ticket, total, t_r0, device_ms)

    # -- pipeline speculation ---------------------------------------------

    def _extend_plan_pp_spec(self, plan: BatchPlan) -> None:
        """Multi-stage head: extend eligible decode rows with proposals, so
        every stage runs 1 + k tokens for them in one dispatch; the last
        stage verifies (``pp_spec_fed``), the ring returns
        ``spec_accepted`` and ``commit_spec_result`` rewinds the rejects.
        Rows keep their plan slot; only their tokens and context grow.
        Sampled rows are eligible (the last stage verifies them in
        lockstep); rows with sampling features are not."""
        k = self.cfg.speculative_tokens
        spare = self.cfg.max_num_tokens_per_batch - plan.total_new_tokens
        contexts, budgets, rows = [], [], []
        for idx, seg in enumerate(plan.seqs):
            req = seg.request
            if (seg.num_new_tokens != 1
                    or req.status is not RequestStatus.DECODING
                    or getattr(req, "pp_spec_k", 0)
                    or req.replay_ids
                    or self._row_has_features(req)):
                continue
            budget = min(k, max(0, spare),
                         self.cfg.max_model_len - req.total_len - 1)
            if budget <= 0:
                continue
            contexts.append(req.all_token_ids)
            budgets.append(budget)
            rows.append(idx)
        if not rows:
            return
        proposals, _source = self._propose(contexts, budgets)
        for idx, prop in zip(rows, proposals):
            seg = plan.seqs[idx]
            req = seg.request
            prop = prop[: max(0, spare)]
            if not prop or not self.cache.ensure_capacity(
                    req, req.total_len + len(prop)):
                continue
            spare -= len(prop)
            plan.seqs[idx] = ScheduledSeq(
                request=req,
                num_new_tokens=1 + len(prop),
                token_ids=list(seg.token_ids) + list(prop),
                context_len=seg.context_len + len(prop),
            )
            req.pp_spec_k = len(prop)  # type: ignore[attr-defined]

    def commit_spec_result(self, request_id: str,
                           accepted: list[int]) -> None:
        """Head: the ring delivered the verified run of a pipeline
        speculation round. Commits every accepted token and rewinds
        ``num_computed_tokens`` for the rejected suffix (whose KV lies past
        the live context on every stage)."""
        req = self.scheduler.running.get(request_id)
        if req is None:
            return
        k = getattr(req, "pp_spec_k", 0)
        if hasattr(req, "pp_spec_k"):
            del req.pp_spec_k
        if req.status.is_finished:
            return
        # Dispatch advanced computed by the 1 + k fed rows; only those
        # whose fed token matches the committed stream hold valid KV.
        req.num_computed_tokens -= 1 + k
        committed = 0
        for tok in accepted:
            if req.status.is_finished:
                break
            self._commit(req, int(tok))
            committed += 1
        req.num_computed_tokens += committed

    def _enqueue_pp_verify(self, ticket: StepTicket,
                           spec_rows: dict[int, list[int]]) -> None:
        """Last stage, proposal rows present: enqueue the targets at every
        fed position (``_verify_targets``; a row's position j is output
        step ``len(generated) - (len(fed) - 1) + j``, its generated ids
        already holding the fed tokens) and the other rows' ordinary
        samples, with their host copies; the ticket resolves at once."""
        plan, inputs, out = ticket.plan, ticket.inputs, ticket.out
        offs = np.concatenate(
            [[0], np.cumsum([seg.num_new_tokens for seg in plan.seqs])])
        entries = []
        for i, fed in spec_rows.items():
            req = plan.seqs[i].request
            origin = self._row_sampling_fields(req)[-1] - (len(fed) - 1)
            entries.append((req, int(offs[i]), int(offs[i + 1]), origin))
        targets = self._verify_targets(out, entries, ticket.step_idx)
        rest = [i for i in range(len(plan.seqs)) if i not in spec_rows]
        copies = [targets]
        if rest:
            idx = np.zeros((int(inputs.kv_lens.shape[0]),), np.int64)
            idx[: len(rest)] = [offs[i + 1] - 1 for i in rest]
            rest_plan = BatchPlan([plan.seqs[i] for i in rest])
            tokens, lp = self._enqueue_sample(
                rest_plan, inputs, out[self._staging.put("vf_rest", idx)],
                ticket.step_idx)
            copies += [tokens] + ([] if lp is None else [lp])
        host, ticket.ready = self._to_host(*copies)
        ticket.tokens_host = host[0]
        if rest:
            ticket.rest_host = host[1]
            ticket.rest_lp = host[2] if len(host) > 2 else None
        ticket.spec_rows = spec_rows
        ticket.sync_only = True

    def _verify_and_emit(self, plan: BatchPlan, ticket: StepTicket):
        """Last stage: each proposal row's longest agreeing prefix plus the
        correction token goes back to the head in ONE packet
        (``spec_accepted``); the other rows emit their sampled token."""
        spec_rows = ticket.spec_rows
        g_all = ticket.tokens_host.numpy()
        offs = np.concatenate(
            [[0], np.cumsum([seg.num_new_tokens for seg in plan.seqs])])
        forwards = []
        rest_segs = []
        for i, seg in enumerate(plan.seqs):
            if i not in spec_rows:
                rest_segs.append(seg)
                continue
            fed = spec_rows[i]
            req = seg.request
            if hasattr(req, "pp_spec_fed"):
                del req.pp_spec_fed
            g = g_all[offs[i] : offs[i + 1]]
            accepted: list[int] = []
            for j in range(len(fed)):
                accepted.append(int(g[j]))
                if j + 1 < len(fed) and fed[j + 1] != int(g[j]):
                    break
            self.pp_spec_rounds += 1
            self.pp_spec_tokens += len(accepted)
            # Goodput: every fed position was a forward; those whose
            # proposal lost are speculative waste (the accepted run counts
            # as committed at the head's commit).
            self._goodput.count("speculative_rejected",
                                len(fed) - len(accepted))
            forwards.append(IntermediateRequest(
                request_id=req.request_id,
                routing_table=req.routing_table,
                context_len=seg.context_len - len(fed) + len(accepted),
                num_new_tokens=len(accepted),
                spec_accepted=accepted,
                trace=req.traced,
            ))
        if rest_segs:
            forwards.extend(self._emit_tokens(
                BatchPlan(rest_segs), ticket.rest_host.numpy(),
                None if ticket.rest_lp is None else ticket.rest_lp.numpy()))
        return forwards

    # -- internals --------------------------------------------------------

    def _form_plan(self) -> BatchPlan:
        plan = self.scheduler.form_batch()
        if self.model.is_first:
            return plan
        # Non-head stages may only schedule tokens whose activations arrived.
        usable = []
        for s in plan.seqs:
            avail = self._pending_hidden.get(s.request.request_id)
            fed = getattr(s.request, "pp_spec_fed", None)
            if fed is not None and s.num_new_tokens != len(fed):
                # A speculative row is processed whole: verification needs
                # every fed position (the clamp can only be the step's
                # token budget; it waits for the next step).
                continue
            if avail is not None and s.num_new_tokens <= avail.shape[0]:
                s.mirror_last_chunk = bool(
                    getattr(s.request, "last_chunk_flag", True))
                usable.append(s)
        # The batch's adapter group rides on: downstream stages apply the
        # deltas too.
        return BatchPlan(usable, lora_id=plan.lora_id,
                         mixed_lora=plan.mixed_lora)

    def _take_hidden(self, rid: str, n: int) -> torch.Tensor:
        buf = self._pending_hidden[rid]
        take, rest = buf[:n], buf[n:]
        if rest.shape[0]:
            self._pending_hidden[rid] = rest
        else:
            self._pending_hidden.pop(rid)
        return take

    @staticmethod
    def _generated_ids(req: Request) -> list[int]:
        """Tokens this request has generated so far, as visible to THIS
        stage (a mirror accumulates decode-token arrivals)."""
        if getattr(req, "is_mirror", False):
            return getattr(req, "mirror_gen_ids", [])
        return req.full_output_ids

    @classmethod
    def _row_sampling_fields(cls, req: Request):
        """One row's sampler fields, incl. the 31-bit seed mask and the
        output-step origin. Returns (temp, top_k, top_p, min_p,
        seed_or_-1, step_origin)."""
        sp = req.sampling_params
        seed = sp.seed & 0x7FFFFFFF if sp.seed is not None else -1
        return (sp.temperature, sp.top_k, sp.top_p, sp.min_p, seed,
                len(cls._generated_ids(req)))

    def _pack_base_sampling(self, plan: BatchPlan, s: int):
        """Per-row sampling vectors (numpy): (temp, top_k, top_p, min_p,
        seeds, steps); padding rows are greedy. ``steps`` is each row's
        output index of this draw."""
        temp = np.zeros((s,), np.float32)
        top_k = np.zeros((s,), np.int32)
        top_p = np.ones((s,), np.float32)
        min_p = np.zeros((s,), np.float32)
        seeds = np.full((s,), -1, np.int64)
        steps = np.zeros((s,), np.int64)
        for i, seg in enumerate(plan.seqs):
            (temp[i], top_k[i], top_p[i], min_p[i], seeds[i],
             steps[i]) = self._row_sampling_fields(seg.request)
            # A device-fed row's fed token is still uncommitted at
            # dispatch: the host-visible generated count runs one behind
            # the output index this step samples.
            if seg.device_token and seg.request.total_len < seg.context_len:
                steps[i] += 1
        return temp, top_k, top_p, min_p, seeds, steps

    def _needs_token(self, seg) -> bool:
        """Does this segment's sequence produce a sampled token this step?
        A mirror's does when the head's last chunk had arrived when the
        step was planned AND this segment reaches the end of what had
        arrived: a stage of a swarm can receive several chunks before it
        steps (and schedules them in chunks of its own), or the last chunk
        while a step is in flight. (The JAX engine reads the request's flag
        at resolve time alone, and samples mid-prompt in both cases;
        ROADMAP queue 3.)"""
        if getattr(seg.request, "is_mirror", False):
            return seg.mirror_last_chunk and seg.is_last_prefill_chunk
        return seg.is_last_prefill_chunk

    def _emit_tokens(self, plan: BatchPlan, tokens: np.ndarray,
                     logprobs: np.ndarray | None = None):
        forwards = []
        for i, seg in enumerate(plan.seqs):
            if not self._needs_token(seg):
                continue
            req = seg.request
            if req.status.is_finished:
                # Aborted mid-step (e.g. a grammar that failed to set up):
                # a commit would clobber the abort status.
                continue
            token = int(tokens[i])
            lp = (float(logprobs[i])
                  if logprobs is not None and req.sampling_params.logprobs
                  else None)
            if self.model.is_first:
                # Single stage: commit locally, ring closed trivially. The
                # grammar advances by the token that landed in the stream
                # (a teacher-forced replay commits its recorded id).
                self._commit(req, token, lp)
                if req.full_output_ids:
                    self._advance_grammar(req, int(req.full_output_ids[-1]))
            else:
                # A mirror never replays: the sampled token is the
                # committed one.
                self._advance_grammar(req, token)
                forwards.append(IntermediateRequest(
                    request_id=req.request_id,
                    routing_table=req.routing_table,
                    context_len=seg.context_len + 1,
                    num_new_tokens=1,
                    next_token_id=token,
                    token_logprob=lp,
                    trace=req.traced,
                ))
        return forwards

    def _emit_hidden(self, plan: BatchPlan, hidden: torch.Tensor):
        forwards = []
        row = 0
        for seg in plan.seqs:
            n = seg.num_new_tokens
            req = seg.request
            # Pipeline-speculative rows advertise their proposal suffix, so
            # every later stage forwards the whole run and the last stage
            # verifies it: the head's rows carry pp_spec_k, a middle
            # stage's mirrors relay their pp_spec_fed.
            if self.model.is_first:
                spec_len = getattr(req, "pp_spec_k", 0) if n > 1 else 0
            else:
                fed = getattr(req, "pp_spec_fed", None)
                spec_len = n - 1 if fed is not None and n == len(fed) else 0
            # First chunk after a prefix-cache skip: ship the skipped ids so
            # downstream stages align their own match.
            prefix_ids = None
            start = seg.context_len - n
            if self.model.is_first:
                if req.num_cached_tokens and start == req.num_cached_tokens:
                    prefix_ids = req.prompt_ids[: req.num_cached_tokens]
            else:
                mp = getattr(req, "mirror_prefix_ids", None)
                if mp is not None and start == len(mp):
                    prefix_ids = mp
            forwards.append(IntermediateRequest(
                request_id=req.request_id,
                routing_table=req.routing_table,
                context_len=seg.context_len,
                num_new_tokens=n,
                token_ids=list(seg.token_ids),
                hidden_states=hidden[row : row + n],
                sampling_params=req.sampling_params.to_dict(),
                # The plan's own flag, as of dispatch: with a step in
                # flight the request's status may already be the next
                # chunk's (the JAX engine also ORs in ``status is
                # DECODING`` here, which marks a non-last chunk last when
                # the last one was dispatched before it resolved;
                # ROADMAP queue 3).
                is_last_chunk=(
                    self._needs_token(seg)
                    if not self.model.is_first
                    else seg.is_last_prefill_chunk
                ),
                spec_len=spec_len,
                cached_prefix_ids=prefix_ids,
                lora_id=req.lora_id,
                trace=req.traced,
                qos_class=req.qos_class,
            ))
            row += n
        return forwards

    def commit_token(self, request_id: str, token: int,
                     logprob: float | None = None) -> None:
        """Head: the ring delivered a sampled token for ``request_id``."""
        req = self.scheduler.running.get(request_id)
        if req is None or req.status.is_finished:
            return
        self._commit(req, token, logprob)

    def stop_request(self, request_id: str) -> None:
        """Gracefully finish a request early (stop-string match). Unlike
        abort, the generated text stands; the next step collects and
        releases it through the normal finish flow. A row inside a decode
        window already in flight commits none of the window's tokens
        (``_resolve_multistep`` stops at a finished row)."""
        req = self.scheduler.running.get(request_id) or (
            self.scheduler.wait_queue.get(request_id)
        )
        if req is not None and not req.status.is_finished:
            req.set_status(RequestStatus.FINISHED_STOP, "stop")

    def _commit(self, req: Request, token: int,
                logprob: float | None = None) -> None:
        # Goodput: a commit that substitutes a teacher-forced replay id
        # (migration restore) re-delivers a token the client already
        # streamed: device work, not goodput. Internal requests (the
        # draft's __draft rows) stay out of the ledger: the main engine's
        # accept / reject accounting prices them.
        replaying = bool(req.replay_ids)
        req.commit_token(token, logprob)
        if not req.request_id.startswith("__"):
            self._goodput.count("replayed" if replaying else "committed", 1)
        self.scheduler.on_token_committed(req)

    def _collect_finished(self) -> list[Request]:
        finished = self.scheduler.finished_requests()
        for req in finished:
            self.scheduler.release_request(req)
            self._pending_hidden.pop(req.request_id, None)
            self._grammar_states.pop(req.request_id, None)
            self._bias_cache.pop(req.request_id, None)
            self._free_state_slot(req)
            self._free_token_slot(req.request_id)
            req.device_feed_ready = False
            if self.model.is_first or req.request_id in self._traced:
                self._obs_finish(req)
        return finished

    # -- hybrid linear state ----------------------------------------------

    def _free_state_slot(self, req: Request) -> None:
        if self._needs_state and hasattr(req, "state_slot"):
            self._slot_alloc.free(req.state_slot - 1)
            del req.state_slot

    def _on_prefix_slot_free(self, slot: int) -> None:
        """The radix cache evicted (or could not attach) a snapshot slot."""
        self._prefix_slot_alloc.free(slot - self._prefix_slot_base)

    def _copy_state(self, src: int, dst: int) -> None:
        """Copy one slot's conv / recurrent state into another on every
        local linear layer (a snapshot, or a restore on a prefix hit), in
        place (captured window graphs hold the state tensors) and by view,
        so no index crosses to the device."""
        self._note_program("copy_state")
        for cache in self.kv:
            if isinstance(cache, tuple):
                for t in cache:
                    t[dst].copy_(t[src])

    def _assign_state_slots(self, plan: BatchPlan) -> None:
        """Give each new row of a hybrid stage its state slot (slot 0 is
        the null slot) before the step that reads it; a prefix hit first
        restores the tree's snapshot into it (the row's first chunk then
        starts at ``num_cached_tokens``, so its reset flag is 0 and the
        copied state stands)."""
        if not self._needs_state:
            return
        for seg in plan.seqs:
            req = seg.request
            if hasattr(req, "state_slot"):
                continue
            req.state_slot = self._slot_alloc.alloc() + 1
            src = getattr(req, "restore_state_from", None)
            if src is not None:
                self._copy_state(src, req.state_slot)
                del req.restore_state_from

    def _preserve_state(self, state_slots: torch.Tensor):
        """For a window graph's first capture: a function that saves the
        window rows' states and returns one that puts them back, so the
        eager warm-up step (which the first replay runs again) does not
        advance the recurrence twice."""
        def save():
            idx = state_slots.long()
            saved = [(t, t.index_select(0, idx)) for cache in self.kv
                     if isinstance(cache, tuple) for t in cache]

            def restore():
                for t, v in saved:
                    t.index_copy_(0, idx, v)
            return restore
        return save

    def _maybe_snapshot_state(self, plan: BatchPlan) -> None:
        """Copy rows' linear state into snapshot slots at page boundaries,
        right after a forward. Each request keeps up to two pending
        snapshots, each overwriting its own slot, both attached to the
        radix tree on release:
        - "prefill": the deepest boundary inside the prompt, capped at
          ``prompt - 1`` so an exact repeat can still match (the scheduler
          ends the penultimate chunk there);
        - "decode": the deepest boundary of the whole conversation, re-copied
          once per ``linear_decode_snapshot_stride`` pages (0 = none).
        Prefill snapshots steal the least recently used tree snapshot when
        the pool is empty; decode ones never do."""
        page = self.cfg.page_size
        for seg in plan.seqs:
            req = seg.request
            c = req.num_computed_tokens
            if c % page or not hasattr(req, "state_slot"):
                continue
            decoding = (req.status is RequestStatus.DECODING
                        or c > req.num_prompt_tokens)
            kind = "decode" if decoding else "prefill"
            snaps = getattr(req, "state_snapshots", None)
            if snaps is None:
                snaps = req.state_snapshots = {}
            if decoding:
                stride = self.cfg.linear_decode_snapshot_stride
                if not stride:
                    continue
                prev = snaps.get("decode")
                if prev is not None and c - prev[0] < stride * page:
                    continue
            elif c > ((req.num_prompt_tokens - 1) // page) * page:
                continue
            if c <= req.num_cached_tokens or c <= max(
                    (n for n, _ in snaps.values()), default=0):
                continue   # the tree or a snapshot already covers it
            snap = snaps.get(kind)
            if snap is None:
                try:
                    slot = (self._prefix_slot_base
                            + self._prefix_slot_alloc.alloc())
                except OutOfPages:
                    if decoding:
                        continue
                    slot = self.cache.prefix_cache.detach_lru_linear_slot()
                    if slot is None:
                        continue
            else:
                slot = snap[1]
            self._copy_state(req.state_slot, slot)
            snaps[kind] = (c, slot)


def _tensor_leaves(tree):
    """The tensors of a nested dict / list / tuple tree."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
