"""StageEngine: the per-node execution engine around one stage (port of
``parallax_tpu/runtime/engine.py``, its K=1 synchronous configuration).

Continuous batching, paged KV with the radix prefix cache, chunked prefill,
per-step sampling and the pipeline ring protocol (head commits, mirrors on
later stages). ``step()`` is ``resolve(dispatch())`` exactly as the JAX
package's synchronous step; the overlapped loop and the K-step decode window
are not ported yet, so this ``EngineConfig`` defaults to
``decode_lookahead=1`` and ``overlap_steps=False`` and refuses the others.

Construction raises on every configuration the port does not run yet, and
``submit`` raises on every per-request feature it does not run yet — nothing
is silently ignored.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from parallax_tpu_torch.models.base import BatchInputs, StageModel
from parallax_tpu_torch.models.registry import params_to, unported_features
from parallax_tpu_torch.ops import kernel_select
from parallax_tpu_torch.ops.sampling import (
    FUSED_SAMPLE_TOPK_MAX,
    fused_sample_topk,
    greedy_tokens,
    row_gumbel,
    sample_tokens,
)
from parallax_tpu_torch.runtime.batch import BucketSpec, assemble
from parallax_tpu_torch.runtime.cache_manager import make_cache_manager
from parallax_tpu_torch.runtime.request import (
    IntermediateRequest,
    Request,
    RequestStatus,
    SamplingParams,
)
from parallax_tpu_torch.runtime.scheduler import BatchPlan, Scheduler

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class EngineConfig:
    """The JAX package's ``EngineConfig`` field names. Live in this slice:
    page/batch/bucket sizing, the prefix cache, chunked prefill and chunk
    skipping, ``kv_dtype``, ``seed``, ``request_timeout_s`` and the
    ``decode_fused`` / ``prefill_fused`` kernel switches. The fields listed
    in ``_UNPORTED`` must keep their defaults (construction raises
    otherwise); ``linear_*``, ``speculative_ngram``, ``constrained_window``
    and ``slow_request_ms`` only tune features that are refused elsewhere."""

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
    # The JAX default is None (adaptive K = 8); the port runs K = 1 until
    # the K-step window is ported.
    decode_lookahead: int | None = 1
    decode_pipeline: int = 1
    speculative_tokens: int = 0
    speculative_ngram: int = 3
    constrained_window: bool = True
    # The JAX default is True; the port's step is synchronous for now.
    overlap_steps: bool = False
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
    "decode_lookahead": 1,
    "decode_pipeline": 1,
    "overlap_steps": False,
    "speculative_tokens": 0,
    "host_cache_bytes": 0,
    "sp_threshold": None,
    "qos": None,
    "prefill_seq_parallel": False,
    "cache_digests": False,
    "wire_dtype": None,
    "trace_sample_rate": 0.0,
    "lora_max_adapters": 0,
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


@dataclasses.dataclass(eq=False)
class StepTicket:
    """A dispatched step: the plan plus its forward outputs; ``resolve``
    completes it. ``outputs`` is pre-filled for empty plans."""

    plan: BatchPlan
    step_idx: int
    t0: float
    inputs: BatchInputs | None = None
    out: torch.Tensor | None = None
    outputs: StepOutputs | None = None


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "parallax_tpu_torch runs on cuda:0 by default and no CUDA device "
            "is available; pass device=\"cpu\" to run the plain PyTorch path "
            "on the CPU"
        )
    return torch.device("cuda:0")


class StageEngine:
    """Continuous-batching engine for one pipeline stage."""

    def __init__(
        self,
        model: StageModel,
        params: dict,
        config: EngineConfig | None = None,
        device=None,
    ):
        self.cfg = config or EngineConfig()
        for name, want in _UNPORTED.items():
            got = getattr(self.cfg, name)
            if got != want:
                raise NotImplementedError(
                    f"EngineConfig.{name}={got!r}: not ported yet to "
                    f"parallax_tpu_torch (only {want!r})"
                )
        feats = unported_features(model.config)
        if feats:
            raise NotImplementedError(
                f"{', '.join(feats)}: not ported yet to parallax_tpu_torch"
            )
        if self.cfg.kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"kv_dtype {self.cfg.kv_dtype!r}: want one of "
                f"{sorted(_KV_DTYPES)}"
            )
        self.device = torch.device(device) if device is not None else (
            _default_device()
        )
        self.model = model
        self.params = params_to(params, self.device)
        # One paged cache per local layer, updated in place by every step.
        self.kv = model.new_kv_caches(
            self.cfg.num_pages, self.cfg.page_size,
            _KV_DTYPES[self.cfg.kv_dtype], self.device,
        )
        self.cache = make_cache_manager(
            self.cfg.page_size,
            self.cfg.num_pages,
            enable_prefix_cache=self.cfg.enable_prefix_cache,
            max_model_len=self.cfg.max_model_len,
            prefill_chunk_skip=self.cfg.prefill_chunk_skip,
        )
        self.scheduler = Scheduler(
            self.cache,
            max_batch_size=self.cfg.max_batch_size,
            max_num_tokens_per_batch=self.cfg.max_num_tokens_per_batch,
            prefill_chunk_size=self.cfg.prefill_chunk_size,
            request_timeout_s=self.cfg.request_timeout_s,
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
        # The fused prefill kernels are GQA's; MLA families keep their
        # split prefill chain, as in the JAX package.
        is_mla = model.config.is_mla
        if is_mla:
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
        self._kernel_counts: dict[tuple[str, str], int] = {}
        self._step_count = 0
        # Non-head stages: hidden rows waiting per request id (tensors on
        # this engine's device, in the model's dtype).
        self._pending_hidden: dict[str, torch.Tensor] = {}

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
        _refuse_unported(request)
        # Clamp generation to the context budget so oversized max_tokens
        # finish at the length limit instead of dying on KV exhaustion.
        cap = (
            self.cfg.max_model_len - request.num_prompt_tokens
            + request.output_offset
        )
        sp = request.sampling_params
        if sp.max_new_tokens > cap:
            sp.max_new_tokens = cap
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
            )
            req.is_mirror = True  # type: ignore[attr-defined]
            # This stage MUST start computing at exactly this offset: rows
            # before it never arrive.
            req.mirror_head_cached = len(prefix)  # type: ignore[attr-defined]
            if prefix:
                req.mirror_prefix_ids = prefix  # type: ignore[attr-defined]
            self.scheduler.enqueue(req)
        else:
            if getattr(req, "last_chunk_flag", False):
                # The prompt was complete before this packet: these tokens
                # are generated ones.
                req.mirror_gen_ids = (  # type: ignore[attr-defined]
                    getattr(req, "mirror_gen_ids", []) + list(new_tokens)
                )
            req.prompt_ids.extend(new_tokens)
            req.set_status(RequestStatus.PREFILLING, "mirror-chunk")
            req.ready_for_step = True
        req.last_chunk_flag = ireq.is_last_chunk  # type: ignore[attr-defined]
        if ireq.hidden_states is not None:
            h = ireq.hidden_states.to(self.device)
            prev = self._pending_hidden.get(rid)
            self._pending_hidden[rid] = (
                h if prev is None else torch.cat([prev, h], dim=0)
            )

    def release(self, request_id: str, abort: bool = False) -> None:
        """Finish/abort broadcast: free this stage's state for a request.
        On a normal finish the mirror's full pages are donated to this
        stage's prefix cache; on abort they are freed."""
        req = self.scheduler.running.get(request_id) or (
            self.scheduler.wait_queue.get(request_id)
        )
        self._pending_hidden.pop(request_id, None)
        if req is not None:
            if not req.status.is_finished:
                if abort:
                    req.abort("released")
                else:
                    req.set_status(RequestStatus.FINISHED_EOS, "release")
            self.scheduler.release_request(req)

    def has_work(self) -> bool:
        return self.scheduler.num_requests() > 0

    def cache_stats(self) -> dict:
        """Prefix-cache counters: tokens admitted, reused and skipped,
        pages evicted, KV-exhaustion aborts."""
        return dataclasses.asdict(self.cache.stats)

    # -- kernel accounting -------------------------------------------------

    def _count_kernel_dispatch(self, path: str, impl: str) -> None:
        key = (impl, path)
        self._kernel_counts[key] = self._kernel_counts.get(key, 0) + 1

    def kernel_dispatch_summary(self) -> dict:
        """The active impls and per-(impl, path) dispatch counts, so a run
        shows which path served it (``cuda-fused``, ``cuda-split`` or
        ``torch``)."""
        return {
            "impl": self._attn_impl,
            "decode_fused": self._decode_fused,
            "prefill_impl": self._prefill_impl,
            "prefill_fused": self._prefill_fused,
            "dispatch_total": {
                f"{impl}/{path}": n
                for (impl, path), n in sorted(self._kernel_counts.items())
            },
        }

    # -- stepping ---------------------------------------------------------

    def step(self) -> StepOutputs:
        """One fully synchronous engine step (dispatch + resolve)."""
        return self.resolve(self.dispatch())

    @torch.no_grad()
    def dispatch(self) -> StepTicket:
        """Form the plan, assemble device inputs and run the stage forward.
        Bookkeeping advances only after the forward ran."""
        t0 = time.perf_counter()
        plan = self._form_plan()
        if plan.is_empty:
            return StepTicket(
                plan=plan, step_idx=self._step_count, t0=t0,
                outputs=StepOutputs(forward=[],
                                    finished=self._collect_finished()),
            )
        hidden = None
        if not self.model.is_first:
            hidden = torch.cat([
                self._take_hidden(s.request.request_id, s.num_new_tokens)
                for s in plan.seqs
            ], dim=0)
        one_token = all(s.num_new_tokens == 1 for s in plan.seqs)
        decode_only = self._use_decode_flag and one_token
        inputs = assemble(
            plan, self.spec, self.cfg.page_size, self.device,
            hidden_states=hidden, decode_only=decode_only,
            decode_fused=self._decode_fused,
            prefill_fused=self._prefill_fused,
        )
        self._count_kernel_dispatch(
            "decode" if one_token else "prefill",
            self._attn_impl if decode_only else self._prefill_impl,
        )
        out, self.kv = self.model(self.params, self.kv, inputs)
        self.scheduler.on_batch_computed(plan)
        step_idx = self._step_count
        self._step_count += 1
        return StepTicket(plan=plan, step_idx=step_idx, t0=t0,
                          inputs=inputs, out=out)

    @torch.no_grad()
    def resolve(self, ticket: StepTicket) -> StepOutputs:
        """Sample (last stage) or forward hidden states, then collect
        finished requests."""
        if ticket.outputs is not None:
            return ticket.outputs
        plan = ticket.plan
        if not self.model.is_last:
            forwards = self._emit_hidden(plan, ticket.out)
        else:
            tokens = self._sample(ticket.out, ticket.inputs, plan,
                                  ticket.step_idx)
            forwards = self._emit_tokens(plan, tokens)
        return StepOutputs(
            forward=forwards,
            finished=self._collect_finished(),
            num_tokens=plan.total_new_tokens,
            step_time_ms=(time.perf_counter() - ticket.t0) * 1000.0,
        )

    # -- internals --------------------------------------------------------

    def _form_plan(self) -> BatchPlan:
        plan = self.scheduler.form_batch()
        if self.model.is_first:
            return plan
        # Non-head stages may only schedule tokens whose activations arrived.
        usable = []
        for s in plan.seqs:
            avail = self._pending_hidden.get(s.request.request_id)
            if avail is not None and s.num_new_tokens <= avail.shape[0]:
                usable.append(s)
        return BatchPlan(usable)

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
        seeds, steps, any_seed); padding rows are greedy."""
        temp = np.zeros((s,), np.float32)
        top_k = np.zeros((s,), np.int32)
        top_p = np.ones((s,), np.float32)
        min_p = np.zeros((s,), np.float32)
        seeds = np.full((s,), -1, np.int64)
        steps = np.zeros((s,), np.int64)
        for i, seg in enumerate(plan.seqs):
            (temp[i], top_k[i], top_p[i], min_p[i], seeds[i],
             steps[i]) = self._row_sampling_fields(seg.request)
        return temp, top_k, top_p, min_p, seeds, steps, bool((seeds >= 0).any())

    def _sample(self, logits: torch.Tensor, inputs: BatchInputs,
                plan: BatchPlan, step_idx: int) -> np.ndarray:
        s = int(inputs.kv_lens.shape[0])
        temp, top_k, top_p, min_p, seeds, steps, any_seed = (
            self._pack_base_sampling(plan, s)
        )
        if not np.any(temp > 0.0):
            # All-greedy batch (padding rows are greedy): argmax only, no
            # noise.
            return greedy_tokens(logits).cpu().numpy()
        v = logits.shape[-1]
        gumbel = row_gumbel(
            s, v, base_seed=self.cfg.seed, step=step_idx,
            seeds=seeds if any_seed else None, out_steps=steps,
            device=self.device,
        )
        dev = self.device
        temp_t = torch.from_numpy(temp).to(dev)
        top_k_t = torch.from_numpy(top_k).to(dev)
        fused = self._decode_fused and all(
            seg.request.sampling_params.top_p >= 1.0
            and seg.request.sampling_params.min_p <= 0.0
            and seg.request.sampling_params.top_k <= FUSED_SAMPLE_TOPK_MAX
            for seg in plan.seqs
        )
        if fused:
            self._count_kernel_dispatch("sample", kernel_select.IMPL_FUSED)
            tokens = fused_sample_topk(logits, gumbel, temp_t, top_k_t)
        else:
            self._count_kernel_dispatch("sample", kernel_select.IMPL_TORCH)
            tokens = sample_tokens(
                logits, temp_t, top_k_t, torch.from_numpy(top_p).to(dev),
                torch.from_numpy(min_p).to(dev), gumbel,
            )
        return tokens.cpu().numpy()

    def _needs_token(self, seg) -> bool:
        """Does this segment's sequence produce a sampled token this step?"""
        req = seg.request
        if getattr(req, "is_mirror", False):
            return bool(getattr(req, "last_chunk_flag", True))
        return seg.is_last_prefill_chunk

    def _emit_tokens(self, plan: BatchPlan, tokens: np.ndarray):
        forwards = []
        for i, seg in enumerate(plan.seqs):
            if not self._needs_token(seg):
                continue
            req = seg.request
            if req.status.is_finished:
                continue
            token = int(tokens[i])
            if self.model.is_first:
                # Single stage: commit locally, ring closed trivially.
                self._commit(req, token)
            else:
                forwards.append(IntermediateRequest(
                    request_id=req.request_id,
                    routing_table=req.routing_table,
                    context_len=seg.context_len + 1,
                    num_new_tokens=1,
                    next_token_id=token,
                ))
        return forwards

    def _emit_hidden(self, plan: BatchPlan, hidden: torch.Tensor):
        forwards = []
        row = 0
        for seg in plan.seqs:
            n = seg.num_new_tokens
            req = seg.request
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
                is_last_chunk=(
                    self._needs_token(seg)
                    if not self.model.is_first
                    else seg.is_last_prefill_chunk
                    or req.status is RequestStatus.DECODING
                ),
                cached_prefix_ids=prefix_ids,
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

    def _commit(self, req: Request, token: int,
                logprob: float | None = None) -> None:
        req.commit_token(token, logprob)
        self.scheduler.on_token_committed(req)

    def _collect_finished(self) -> list[Request]:
        finished = self.scheduler.finished_requests()
        for req in finished:
            self.scheduler.release_request(req)
            self._pending_hidden.pop(req.request_id, None)
        return finished


def _refuse_unported(request: Request) -> None:
    """``submit`` refuses per-request features the port does not run yet."""
    sp = request.sampling_params
    feats = []
    if sp.presence_penalty or sp.frequency_penalty or sp.repetition_penalty != 1.0:
        feats.append("penalties")
    if sp.logit_bias:
        feats.append("logit_bias")
    if sp.logprobs:
        feats.append("logprobs")
    if sp.json_schema:
        feats.append("json_schema (grammar)")
    if request.lora_id is not None:
        feats.append("LoRA")
    if feats:
        raise NotImplementedError(
            f"request {request.request_id}: {', '.join(feats)} not ported "
            "yet to parallax_tpu_torch"
        )
