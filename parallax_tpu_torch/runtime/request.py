"""Request lifecycle types.

Pipeline protocol (capability parity with reference
``src/parallax/server/request.py:23-55``):

- The *head* node owns the full :class:`Request` state: prompt ids, generated
  ids, sampling params, KV bookkeeping.
- Between stages only an :class:`IntermediateRequest` travels: request id,
  routing table, current position, and either ``hidden_states`` (stage k ->
  k+1) or the freshly sampled ``next_token_id`` (last stage -> head, closing
  the ring).
- Chunked prefill: the head advances ``num_computed_tokens`` chunk by chunk;
  downstream stages see each chunk as an independent ragged segment.

A copy of ``parallax_tpu/runtime/request.py`` with two changes: status
transitions carry their FSM edge name but run no conformance hook, and
``IntermediateRequest.hidden_states`` is a torch tensor (numpy has no
bfloat16, so a bf16 hidden state crosses stages without a cast).
"""

from __future__ import annotations

import dataclasses
import enum
import time

import torch


class RequestStatus(enum.Enum):
    """Lifecycle states (reference: request.py:71-80)."""

    PENDING = "pending"          # waiting for admission (KV not allocated)
    PREFILLING = "prefilling"    # admitted, prompt chunks in flight
    DECODING = "decoding"        # generating, one token per pipeline round
    # Swapped out to the host KV tier under memory pressure (decode OOM);
    # parked in the wait queue, resumes via swap-in when pages free up.
    PREEMPTED = "preempted"
    FINISHED_EOS = "finished_eos"
    FINISHED_LENGTH = "finished_length"
    FINISHED_STOP = "finished_stop"
    FINISHED_ABORT = "finished_abort"

    @property
    def is_finished(self) -> bool:
        return self.value.startswith("finished")


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling configuration (reference sampling_params.py:8-60)."""

    temperature: float = 1.0
    top_k: int = -1
    top_p: float = 1.0
    min_p: float = 0.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    max_new_tokens: int = 128
    min_new_tokens: int = 0
    stop_token_ids: tuple[int, ...] = ()
    stop_strings: tuple[str, ...] = ()
    ignore_eos: bool = False
    seed: int | None = None
    json_schema: str | None = None
    # OpenAI logit_bias: token id -> additive bias (reference REJECTS this
    # field, engine_core_protocol.py:196; we support it natively).
    logit_bias: dict | None = None
    # Return per-token logprobs of the sampled tokens (reference wire
    # fields token_prob/return_probs, forward.proto:39-40).
    logprobs: bool = False

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["stop_token_ids"] = list(self.stop_token_ids)
        d["stop_strings"] = list(self.stop_strings)
        if self.logit_bias:
            # String keys, as OpenAI sends them: a msgpack decoder refuses
            # int map keys (strict_map_key), so the JAX package's frames
            # cannot carry logit_bias between stages (ROADMAP queue 3).
            # from_dict turns them back into ints.
            d["logit_bias"] = {str(k): v for k, v in self.logit_bias.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingParams":
        d = dict(d)
        d["stop_token_ids"] = tuple(d.get("stop_token_ids", ()))
        d["stop_strings"] = tuple(d.get("stop_strings", ()))
        if d.get("logit_bias"):
            # JSON object keys arrive as strings (OpenAI sends them that
            # way too); canonicalize to int -> float.
            d["logit_bias"] = {
                int(k): float(v) for k, v in d["logit_bias"].items()
            }
        return cls(**{k: v for k, v in d.items()
                      if k in {f.name for f in dataclasses.fields(cls)}})


@dataclasses.dataclass
class Request:
    """Full head-node request state."""

    request_id: str
    prompt_ids: list[int]
    sampling_params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # Node path assigned by the global scheduler (list of node ids, in stage
    # order). Empty for single-node serving.
    routing_table: list[str] = dataclasses.field(default_factory=list)
    status: RequestStatus = RequestStatus.PENDING
    output_ids: list[int] = dataclasses.field(default_factory=list)
    # Log-probability of each sampled output token (filled when
    # sampling_params.logprobs is set).
    output_logprobs: list[float] = dataclasses.field(default_factory=list)
    # Prompt tokens whose KV is already computed (prefix-cache hit + finished
    # prefill chunks).
    num_computed_tokens: int = 0
    # Tokens matched in the prefix cache at admission.
    num_cached_tokens: int = 0
    # Pages allocated to this request, in order.
    page_ids: list[int] = dataclasses.field(default_factory=list)
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)
    eos_token_ids: tuple[int, ...] = ()
    # Filled when decoding starts; used by the decode-ready gating.
    ready_for_step: bool = True
    # Overlapped decode: the row's next token was sampled by an in-flight
    # engine step and lives only in the device-resident last-token array —
    # the scheduler may feed it without a host round trip (the step loop
    # keeps one step in flight; see StageEngine.dispatch). Cleared when
    # the row is scheduled device-fed or when the token reaches the host
    # before being fed (sync tail).
    device_feed_ready: bool = False
    abort_reason: str | None = None
    # Per-request LoRA adapter name (reference ``Req.lora_path``,
    # forward.proto). None = base model. The local scheduler groups each
    # dispatched batch by this id; every stage must have the adapter
    # registered (StageEngine.load_adapter).
    lora_id: str | None = None
    # Observability: this request was sampled for lifecycle tracing
    # (obs/trace.py). The flag travels on inter-stage packets so every
    # pipeline stage records spans under the same trace id.
    traced: bool = False
    # Monotonic timestamp of the first committed output token — TTFT for
    # the metrics registry and flight recorder. Set in commit_token (the
    # single choke point every sampling path funnels through).
    first_token_time: float | None = None
    # Live migration (runtime/checkpoint.py): a resumed request folds its
    # previously committed outputs into ``prompt_ids`` (their KV must be
    # recomputed or adopted before decode continues); this counts those
    # folded tokens so generation budgets, penalty windows and the
    # seeded ``fold_in(key(seed), output_step)`` origin keep counting
    # from the ORIGINAL stream position. 0 for every non-migrated
    # request — all accounting then reduces to the pre-migration form.
    output_offset: int = 0
    # Logprobs of the folded prior outputs (resumed requests only).
    prior_output_logprobs: list[float] = dataclasses.field(
        default_factory=list
    )
    # Set while the migration flow is extracting this request from its
    # engine: the local scheduler stops scheduling (and never preempts)
    # a row that is about to be checkpointed away.
    migrating: bool = False
    # Set on a request a prefill-role head restored locally (no decode
    # pool took it): it decodes here, and the handoff tick never flags it
    # again.
    handoff_local: bool = False
    # Multi-tenant QoS (parallax_tpu/qos, docs/qos.md): the request's
    # class tag (interactive / agent / batch), its absolute deadline on
    # THIS process's monotonic clock (None = derive from the class
    # budget at order time; re-anchored from a relative budget on every
    # process hop), and the tenant the per-tenant routing fairness term
    # charges. All None when QoS is off — the scheduler then never
    # reads them.
    qos_class: str | None = None
    deadline: float | None = None
    tenant_id: str | None = None
    # Replay restore (no KV image adopted): the pre-migration outputs a
    # restored request must TEACHER-FORCE back through ordinary decode
    # steps before free-running sampling resumes. Each commit_token pops
    # one entry and commits IT (not the freshly sampled token): decode
    # steps have identical shapes to the original run, so the replayed
    # region's KV is bitwise what the dead pipeline held — re-prefilling
    # those positions instead would recompute them under prefill-chunk
    # shapes, whose float reductions differ enough to flip a near-tied
    # argmax. Replay rows force the host-synchronous sample path (no
    # device feed, no fused windows): the substituted token must be the
    # one fed to the next step.
    replay_ids: list[int] = dataclasses.field(default_factory=list)
    replay_logprobs: list[float] = dataclasses.field(default_factory=list)

    def set_status(self, dst: RequestStatus, edge: str) -> None:
        """The single status-mutation funnel. ``edge`` names the owning
        FSM edge, as in the JAX package, so call sites stay comparable."""
        del edge
        self.status = dst

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_ids)

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_ids)

    @property
    def num_generated(self) -> int:
        """Output tokens in the LOGICAL stream (folded prior outputs of a
        resumed request included) — the count every budget (min/max_new),
        penalty window and seeded-key origin must use."""
        return self.output_offset + len(self.output_ids)

    @property
    def prior_output_ids(self) -> list[int]:
        """The folded prior outputs of a resumed request (tail of the
        prompt); [] for non-migrated requests."""
        if not self.output_offset:
            return []
        return self.prompt_ids[len(self.prompt_ids) - self.output_offset:]

    @property
    def full_output_ids(self) -> list[int]:
        """The complete logical output stream: folded prior outputs plus
        tokens committed since the (last) resume."""
        if not self.output_offset:
            return self.output_ids
        return self.prior_output_ids + self.output_ids

    @property
    def full_output_logprobs(self) -> list[float]:
        if not self.output_offset:
            return self.output_logprobs
        return list(self.prior_output_logprobs) + self.output_logprobs

    @property
    def total_len(self) -> int:
        return self.num_prompt_tokens + self.num_output_tokens

    @property
    def all_token_ids(self) -> list[int]:
        return self.prompt_ids + self.output_ids

    @property
    def is_prefill_done(self) -> bool:
        return self.num_computed_tokens >= self.num_prompt_tokens

    def remaining_prompt_tokens(self) -> int:
        return max(0, self.num_prompt_tokens - self.num_computed_tokens)

    def commit_token(self, token_id: int, logprob: float | None = None) -> None:
        """Record one generated token and update status.

        Reference: ``InitialRequest.commit_new_token`` (request.py:230-249).
        """
        if self.first_token_time is None:
            self.first_token_time = time.monotonic()
        if self.replay_ids:
            # Teacher-forced catch-up of a migrated request: the
            # recorded stream is authoritative (the sampled token SHOULD
            # match on equal-numerics replicas; substitution makes the
            # contract hold even on a near-tied argmax).
            token_id = self.replay_ids.pop(0)
            if self.replay_logprobs:
                logprob = self.replay_logprobs.pop(0)
        self.output_ids.append(token_id)
        if logprob is not None:
            self.output_logprobs.append(logprob)
        sp = self.sampling_params
        if self.num_generated >= sp.min_new_tokens:
            if not sp.ignore_eos and (
                token_id in self.eos_token_ids or token_id in sp.stop_token_ids
            ):
                self.set_status(
                    RequestStatus.FINISHED_STOP
                    if token_id in sp.stop_token_ids
                    else RequestStatus.FINISHED_EOS,
                    "commit",
                )
                return
        if self.num_generated >= sp.max_new_tokens:
            self.set_status(RequestStatus.FINISHED_LENGTH, "commit")
            return
        if self.status is not RequestStatus.PREEMPTED:
            # A preempted request can still receive the commit of a step
            # that was in flight when it was swapped out; the token is
            # recorded but the request stays parked until swap-in.
            self.set_status(RequestStatus.DECODING, "commit")

    def abort(self, reason: str = "") -> None:
        self.set_status(RequestStatus.FINISHED_ABORT, "abort")
        self.abort_reason = reason or None


@dataclasses.dataclass
class IntermediateRequest:
    """The inter-stage wire packet (reference request.py:326-393)."""

    request_id: str
    routing_table: list[str]
    # Total context length after this step's tokens (defines KV positions).
    context_len: int
    # Number of new tokens this step carries for this request.
    num_new_tokens: int
    # Token ids for the first stage (prefill chunk or the single decode
    # token); None past the first stage.
    token_ids: list[int] | None = None
    # Activations entering the next stage: [num_new_tokens, hidden], a
    # torch tensor on the sending stage's device (bf16 stays bf16). None on
    # the hop back to the head.
    hidden_states: torch.Tensor | None = None
    # Sampled token (last stage -> head hop only).
    next_token_id: int | None = None
    # Its logprob when the request asked for logprobs (reference
    # token_prob, forward.proto:39).
    token_logprob: float | None = None
    sampling_params: dict | None = None
    is_last_chunk: bool = True
    abort: bool = False
    # Pipeline speculative decode: on a head->downstream decode packet,
    # the last ``spec_len`` of ``token_ids`` are unverified proposals (the
    # packet carries 1 + spec_len tokens). On the last->head ring hop,
    # ``spec_accepted`` is the greedy-verified token list (the head
    # commits them all and rewinds its computed count for the rejects).
    spec_len: int = 0
    spec_accepted: list[int] | None = None
    # First prefill chunk of a request whose head stage prefix-cache hit
    # skipped tokens: the skipped token ids, so every downstream stage can
    # align its own prefix match to the same absolute positions (the
    # packet's hidden rows start at position len(cached_prefix_ids)).
    cached_prefix_ids: list[int] | None = None
    # Per-request LoRA adapter (reference ``Req.lora_path``,
    # forward.proto:1-57): downstream stages apply their layers' deltas.
    lora_id: str | None = None
    # Trace context (obs/trace.py): the request was sampled for lifecycle
    # tracing — receiving stages record their spans under the request id
    # so multi-stage traces stitch.
    trace: bool = False
    # QoS class tag (docs/qos.md): downstream stages order their mirror
    # work by the same class budgets the head uses. None = untagged
    # (QoS off, or an older peer's frame).
    qos_class: str | None = None

    @property
    def is_prefill(self) -> bool:
        return self.num_new_tokens > 1 or not self.is_last_chunk
