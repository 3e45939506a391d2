"""Local continuous-batching scheduler for one pipeline stage.

A copy of ``parallax_tpu/runtime/scheduler.py``: FCFS admission with radix
prefix matching, prefill-first batch formation under token and batch-size
budgets, chunked prefill, prefix-aware chunk skipping, the overlapped
loop's device-fed decode rows, the K-step window's page planning
(``plan_decode_window``) and preemption to the host tier: a row that
cannot grow its pages swaps the latest-arriving running decode out to host
DRAM (``_ensure_capacity_or_preempt``), the parked request resumes at the
wait queue's front by swap-in, and ``kv_oom`` is the last resort once the
tier is full too (or absent: ``host_cache_bytes=0``). Rows flagged
``migrating`` are neither scheduled, admitted nor preempted. Swap-in,
chunk skip, preemption and ``kv_oom`` each leave a flight-recorder event
and, for a traced request, a span under the stage's label. With a QoS
policy (``qos=``) admission runs earliest-deadline-first with the
starvation guard, the shed gate holds sheddable classes, running
sheddable decodes park to the host tier, and batch formation orders the
running set by deadline slack. Not ported yet: LoRA adapter grouping and
sequence-parallel prefill planning.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

from parallax_tpu_torch.runtime.cache_manager import CacheManager
from parallax_tpu_torch.runtime.request import Request, RequestStatus
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class ScheduledSeq:
    """One ragged segment of the step batch."""

    request: Request
    num_new_tokens: int          # query tokens this step
    token_ids: list[int]         # the new tokens (head node fills these)
    context_len: int             # total KV length after this step
    is_last_prefill_chunk: bool = True
    # A mirror's (a later stage of a pipeline): the head's last chunk had
    # arrived when the step was planned. The engine stamps it at dispatch;
    # the request's own flag may move on before the step resolves.
    mirror_last_chunk: bool = True
    # Overlapped decode: this row's fed token is the one an in-flight
    # step sampled — it lives only in the engine's device-resident
    # last-token array; ``token_ids`` holds a placeholder the engine
    # replaces with an on-device gather (batch.substitute_device_tokens).
    device_token: bool = False


@dataclasses.dataclass
class BatchPlan:
    """Everything the executor needs to build device inputs for one step."""

    seqs: list[ScheduledSeq]

    @property
    def total_new_tokens(self) -> int:
        return sum(s.num_new_tokens for s in self.seqs)

    @property
    def is_empty(self) -> bool:
        return not self.seqs

    @property
    def has_prefill(self) -> bool:
        return any(s.num_new_tokens > 1 or not s.request.is_prefill_done
                   for s in self.seqs)


class Scheduler:
    """Continuous batching over a wait queue and a running set."""

    def __init__(
        self,
        cache_manager: CacheManager,
        max_batch_size: int = 64,
        max_num_tokens_per_batch: int = 2048,
        prefill_chunk_size: int = 1024,
        max_queue_size: int = 1024,
        request_timeout_s: float = 600.0,
        stage_name: str = "stage",
        qos=None,
    ):
        self.cache = cache_manager
        self.stage_name = stage_name
        self.max_batch_size = max_batch_size
        self.max_num_tokens_per_batch = max_num_tokens_per_batch
        self.prefill_chunk_size = prefill_chunk_size
        self.max_queue_size = max_queue_size
        self.request_timeout_s = request_timeout_s
        self.wait_queue: OrderedDict[str, Request] = OrderedDict()
        self.running: OrderedDict[str, Request] = OrderedDict()
        # Requests moved out of the wait queue (admissions, swap-ins and
        # finished-while-queued): the admission watchdog probe's progress.
        self.admitted_total = 0
        # Multi-tenant QoS policy (``qos/admission.QoSPolicy``). None (the
        # default, ``--qos off``) keeps every path below on arrival order:
        # each hook is one attribute check.
        self.qos = qos

    # -- intake -----------------------------------------------------------

    def enqueue(self, request: Request) -> bool:
        if len(self.wait_queue) >= self.max_queue_size:
            return False
        self.wait_queue[request.request_id] = request
        return True

    def num_requests(self) -> int:
        return len(self.wait_queue) + len(self.running)

    # -- admission (phase 1) ---------------------------------------------

    def admit_requests(self) -> None:
        """Move wait-queue requests into the running set with KV allocated:
        FCFS, stopping at the first request that does not fit. With a QoS
        policy the order is earliest-deadline-first and the shed gate can
        hold sheddable classes back; the per-request mechanics
        (``_admit_one``) are shared by both modes."""
        if self.qos is not None:
            self._admit_requests_qos()
            return
        while self.wait_queue and len(self.running) < self.max_batch_size:
            rid, req = next(iter(self.wait_queue.items()))
            if not self._admit_one(rid, req):
                break

    def _admit_one(self, rid: str, req: Request) -> bool:
        """Try to admit one wait-queue request. Returns False when
        admission must STOP (the request blocks: migrating, or capacity ran
        out) — later queue entries must not leapfrog it."""
        if req.migrating:
            # About to be checkpointed away: admitting (or swapping it back
            # in) would race the extraction. The park lands within a step
            # or two; admission resumes then.
            return False
        if req.status.is_finished:
            # Aborted while queued or parked: route it through the running
            # set so the normal finish collection releases its state.
            del self.wait_queue[rid]
            self.admitted_total += 1
            self.running[rid] = req
            return True
        if req.status is RequestStatus.PREEMPTED:
            # Preempted to host: swap the KV image back in instead of
            # allocating a prompt. A resume that does not fit blocks
            # admission like any other head-of-queue request.
            resume = getattr(self.cache, "resume_from_host", None)
            t0 = time.perf_counter()
            if resume is None or not resume(req):
                return False
            del self.wait_queue[rid]
            self.admitted_total += 1
            # A mid-prefill park resumes into PREFILLING at its computed
            # mark (the restored image covers exactly that span).
            req.set_status(
                RequestStatus.DECODING if req.is_prefill_done
                else RequestStatus.PREFILLING,
                "swap-in",
            )
            self.running[rid] = req
            self._obs_event("swap_in", req, dur=time.perf_counter() - t0)
            return True
        if not self.cache.allocate_for_prompt(req):
            return False
        del self.wait_queue[rid]
        self.admitted_total += 1
        head_cached = getattr(req, "mirror_head_cached", None)
        if head_cached is not None:
            # Mirror of a head-side prefix hit: the head only forwards
            # hidden rows from ``head_cached`` on. A shorter local match
            # would need rows that never arrive — abort loudly; a longer
            # one is clamped down (the overlap rows recompute into the
            # shared pages with the same values).
            if req.num_computed_tokens < head_cached:
                logger.warning(
                    "%s: downstream prefix-cache miss (head skipped %d, "
                    "local match %d) — aborting", rid, head_cached,
                    req.num_computed_tokens,
                )
                req.abort("downstream_prefix_cache_miss")
                self.running[rid] = req
                return True
            req.num_computed_tokens = head_cached
        req.set_status(RequestStatus.PREFILLING, "admission")
        self.running[rid] = req
        return True

    def _admit_requests_qos(self) -> None:
        """QoS admission: EDF order with the starvation guard, the shed
        gate holding sheddable classes while the admission controller
        sheds, and park enforcement over the running set."""
        pol = self.qos
        now = time.monotonic()
        pol.maybe_tick(now, self)
        self._qos_enforce(pol)
        if pol.controller.active:
            # Shed-held accounting covers every gated request, not only
            # those the capacity-bounded loop below visits (count_shed is
            # once per request).
            for req in self.wait_queue.values():
                if not req.status.is_finished and pol.blocks_admission(req):
                    pol.count_shed(req)
        for rid, req in pol.admit_order(self.wait_queue, now):
            if len(self.running) >= self.max_batch_size:
                break
            if self.wait_queue.get(rid) is not req:
                continue   # admitted or parked by an earlier iteration
            if not req.status.is_finished and pol.blocks_admission(req):
                # Held, not dropped: it resumes through this gate when the
                # shed lifts.
                continue
            was_finished = req.status.is_finished
            if not self._admit_one(rid, req):
                break
            if (
                not was_finished
                and not req.status.is_finished
                and rid in self.running
            ):
                pol.on_admit(req, now)

    def _qos_enforce(self, pol) -> None:
        """Shed enforcement over the RUNNING set: park sheddable-class
        decodes to the host tier (the PREEMPTED path: they resume with the
        same bits when the shed releases; enforcement never aborts). The
        safety tests are memory-pressure preemption's: only committed or
        device-fed decode rows park (a row whose step or window is in
        flight is neither), never mirrors or migrating requests."""
        if not pol.controller.active:
            return
        preempt = getattr(self.cache, "preempt_to_host", None)
        if preempt is None or getattr(self.cache, "host_tier", None) is None:
            # No tier, or the native manager (no preempt path): shedding
            # can only hold admissions.
            pol.warn_no_tier_once()
            return
        for req in list(self.running.values()):
            if (
                not pol.parkable(req)
                or req.migrating
                or req.status is not RequestStatus.DECODING
                or not (req.ready_for_step or req.device_feed_ready)
                or getattr(req, "is_mirror", False)
            ):
                continue
            if not preempt(req):
                continue   # host tier full: the request keeps running
            self._park(req)
            pol.count_park(req)

    # -- batch formation (phase 2) ---------------------------------------

    def form_batch(self) -> BatchPlan:
        """Prefill-first batch under token and batch-size budgets. A long
        prompt contributes at most ``prefill_chunk_size`` tokens per step
        and keeps its place in the running set between chunks."""
        self.check_timeouts()
        self.admit_requests()
        seqs: list[ScheduledSeq] = []
        token_budget = self.max_num_tokens_per_batch
        running = list(self.running.values())
        if self.qos is not None:
            # Earliest deadline first (guard=False: the starvation guard is
            # a wait-queue notion): under a token-budget squeeze the urgent
            # prompt's chunk ships this step, not the flood's.
            now = time.monotonic()
            running.sort(
                key=lambda r: self.qos.order_key(r, now, guard=False))
        for req in running:
            if len(seqs) >= self.max_batch_size or token_budget <= 0:
                break
            if req.status is not RequestStatus.PREFILLING or req.migrating:
                continue
            # Prefix-aware chunk skipping: before the FIRST chunk ships,
            # re-consult the radix tree — a donor that released after
            # admission may now cover more of the prompt.
            if (req.num_computed_tokens == req.num_cached_tokens
                    and self.cache.extend_prefix_match(req)):
                # parallax_prefill_tokens_skipped_total is collected from
                # CacheStats; only the flight / trace event goes here.
                self._obs_event("chunk_skip", req)
            remaining = req.remaining_prompt_tokens()
            if remaining <= 0:
                continue
            n = min(remaining, self.prefill_chunk_size, token_budget)
            if n < remaining and n < self.cache.page_size:
                break  # not worth a degenerate chunk; wait for budget
            start = req.num_computed_tokens
            # Mirror requests grow their prompt incrementally (chunks arrive
            # over the ring), so page capacity may lag the prompt length.
            if not self._ensure_capacity_or_preempt(req, start + n):
                continue
            seqs.append(
                ScheduledSeq(
                    request=req,
                    num_new_tokens=n,
                    token_ids=req.prompt_ids[start : start + n],
                    context_len=start + n,
                    is_last_prefill_chunk=(start + n >= req.num_prompt_tokens),
                )
            )
            token_budget -= n

        seqs.extend(self._fill_decode(self.max_batch_size - len(seqs),
                                      token_budget))
        return BatchPlan(seqs)

    def _fill_decode(self, max_seqs: int,
                     token_budget: int) -> list[ScheduledSeq]:
        """Ready decode rows: host-fed (``ready_for_step``) or device-fed
        (``device_feed_ready``: the in-flight step sampled the row's next
        token, which lives only on the device). A row preempted by an
        earlier row of the same pass is skipped."""
        seqs: list[ScheduledSeq] = []
        scheduled: set[str] = set()
        candidates = [
            req for req in self.running.values()
            if req.status is RequestStatus.DECODING and not req.migrating
            and (req.ready_for_step or req.device_feed_ready)
        ]
        if self.qos is not None and candidates:
            # EDF decode-batch formation: when the batch or token budget
            # caps the step, the rows with the least slack decode first.
            now = time.monotonic()
            candidates.sort(
                key=lambda r: self.qos.order_key(r, now, guard=False))
        for req in candidates:
            if len(seqs) >= max_seqs or token_budget <= 0:
                break
            if req.status is not RequestStatus.DECODING:
                continue   # preempted by an earlier row of this pass
            # A device-fed row's next token was sampled by the in-flight
            # step: it occupies one more context slot than the
            # host-committed total.
            fed = req.device_feed_ready and not req.ready_for_step
            ctx = req.total_len + 1 if fed else req.total_len
            if not self._ensure_capacity_or_preempt(
                req, ctx, allow_self=True, exclude_scheduled=scheduled,
            ):
                continue
            scheduled.add(req.request_id)
            seqs.append(
                ScheduledSeq(
                    request=req,
                    num_new_tokens=1,
                    token_ids=[0] if fed else [req.all_token_ids[-1]],
                    context_len=ctx,
                    device_token=fed,
                )
            )
            if fed:
                req.device_feed_ready = False
            token_budget -= 1
        return seqs

    # -- multi-step decode planning ---------------------------------------

    def plan_decode_window(
        self, plan: BatchPlan, k: int, max_windows: int, max_model_len: int,
        spec: int = 0,
    ) -> int:
        """K-step window planning: pre-allocate KV pages for a chain of up
        to ``max_windows`` k-token decode windows over ``plan``'s rows,
        all-or-nothing.

        Returns the number of windows (>= 1) whose pages are guaranteed
        now, or 0 when the allocator cannot guarantee even one — the
        caller then falls back to single-step decode, whose normal path
        owns the kv_oom decision. The probe never aborts or preempts, and
        the chain is sized against pages free right now, so a failed probe
        leaves no allocation behind; only the final ``ensure_capacity``
        may evict from the prefix tree, exactly as a single-step +1 probe
        would.

        The chain is clamped to every row's context room below
        ``max_model_len`` and to the largest remaining generation budget
        (windows past every row's ``max_new_tokens`` are pure waste);
        device-fed rows count their pending uncommitted token.

        ``spec > 0`` plans a speculative window: each step feeds ``1 +
        spec`` tokens a row, so the worst case (every proposal accepted)
        commits ``k * (1 + spec)`` tokens a row a window, and the
        reservation and the context room cover that; the budget clamp
        stays the plain window's (a speculative window commits at least
        ``k`` tokens a live row).
        """
        k_eff = k * (1 + max(0, spec))
        m = max(1, max_windows)
        want = 1
        for seg in plan.seqs:
            room = (max_model_len - seg.context_len) // k_eff
            if room < 1:
                return 0
            m = min(m, room)
            pending = int(
                seg.device_token
                and seg.request.total_len < seg.context_len
            )
            want = max(
                want,
                seg.request.sampling_params.max_new_tokens
                - seg.request.num_generated - pending,
            )
        m = min(m, max(1, -(-want // k)))

        def _extra_pages(mm: int) -> int:
            return sum(
                max(0, self.cache.pages_needed(seg.context_len + mm * k_eff)
                    - len(seg.request.page_ids))
                for seg in plan.seqs
            )

        while m > 1 and _extra_pages(m) > self.cache.num_free_pages:
            m -= 1
        if not all(
            self.cache.ensure_capacity(seg.request,
                                       seg.context_len + m * k_eff)
            for seg in plan.seqs
        ):
            return 0
        return m

    # -- step feedback ----------------------------------------------------

    def on_batch_computed(self, plan: BatchPlan) -> None:
        """Advance prefill progress; mark decodes in-flight until the ring
        (or the local resolve) delivers the sampled token."""
        for s in plan.seqs:
            req = s.request
            if req.status is RequestStatus.PREFILLING:
                req.num_computed_tokens += s.num_new_tokens
                if req.is_prefill_done:
                    req.set_status(RequestStatus.DECODING, "prefill-complete")
                    req.ready_for_step = False
            elif req.status is RequestStatus.DECODING:
                # The fed token's KV was written this step; release() relies
                # on the computed count to know which pages hold real KV.
                req.num_computed_tokens += s.num_new_tokens
                req.ready_for_step = False

    def on_token_committed(self, request: Request) -> None:
        """The ring (or the local resolve) delivered a sampled token.

        A token that was already fed from the device-resident array (the
        overlapped step loop ran one dispatch ahead) must NOT re-arm
        ``ready_for_step`` — feeding it again would recompute its
        position and resample its logits, duplicating a token.
        """
        fed_ahead = request.num_computed_tokens >= request.total_len
        request.ready_for_step = not fed_ahead
        if not fed_ahead:
            # The committed token is host-known and unfed: the normal
            # host-fed path takes over (sync tail / overlap off).
            request.device_feed_ready = False

    # -- completion -------------------------------------------------------

    def finished_requests(self) -> list[Request]:
        return [r for r in self.running.values() if r.status.is_finished]

    def release_request(self, request: Request) -> None:
        self.running.pop(request.request_id, None)
        self.wait_queue.pop(request.request_id, None)
        self.cache.release(request)

    def _abort_on_oom(self, req: Request) -> None:
        logger.warning("decode OOM: aborting %s", req.request_id)
        req.abort("kv_oom")
        self.cache.stats.kv_oom_aborts += 1
        self._obs_event("kv_oom", req)

    def _obs_event(self, kind: str, req: Request, dur: float = 0.0) -> None:
        """Flight-recorder event and, for a traced request, a trace span
        for the memory-pressure transitions (swap-in, chunk skip,
        preemption, kv_oom)."""
        from parallax_tpu_torch.obs.flight import get_flight

        get_flight().event(
            kind, request_id=req.request_id, stage=self.stage_name,
            context_tokens=req.total_len,
        )
        if req.traced:
            from parallax_tpu_torch.obs.trace import get_trace_store

            get_trace_store().add(
                req.request_id, self.stage_name, kind,
                t0=time.perf_counter() - dur, dur=dur,
                args={"context_tokens": req.total_len},
            )

    # -- preemption to host -----------------------------------------------

    def _ensure_capacity_or_preempt(
        self,
        req: Request,
        new_total_tokens: int,
        allow_self: bool = False,
        exclude_scheduled: set[str] | None = None,
    ) -> bool:
        """``ensure_capacity`` with preemption-to-host behind it.

        Under memory pressure, swap out the lowest-priority running decode
        (latest arrival first) until ``req`` fits. When nothing is left to
        preempt: park ``req`` itself if eligible (``allow_self``, decode
        path), else abort it — ``kv_oom`` is the last resort once the host
        tier is also exhausted, not the first response to pressure.
        Returns True when ``req`` may be scheduled this step.
        """
        if self.cache.ensure_capacity(req, new_total_tokens):
            return True
        if self.cache.host_tier is not None:
            preempt = self.cache.preempt_to_host
            skip: set[str] = set(exclude_scheduled or ())
            while True:
                victim = self._preemption_victim(req, skip)
                if victim is None:
                    break
                if not preempt(victim):
                    # This victim's image does not fit the host tier; a
                    # smaller (slightly older) victim still might — keep
                    # walking before declaring the tier full.
                    skip.add(victim.request_id)
                    continue
                self._park(victim)
                if self.cache.ensure_capacity(req, new_total_tokens):
                    return True
            if (
                allow_self
                and req.status is RequestStatus.DECODING
                and (req.ready_for_step or req.device_feed_ready)
                and preempt(req)
            ):
                # req is itself the lowest priority: park it rather than
                # abort — its pages unblock older requests at once.
                self._park(req)
                return False
        self._abort_on_oom(req)
        return False

    def _preemption_victim(
        self, exclude: Request, exclude_ids: set[str] | None = None
    ) -> Request | None:
        """Latest-arrival running decode that is safe to swap out.

        Safe: a committed row awaiting scheduling (``ready_for_step``), or
        a row whose next token sits in the device last-token array
        (``device_feed_ready``) — an in-flight step's writes to its pages
        are ordered BEFORE the demotion gather on the device stream, and
        its pending commit lands on the parked request object directly.
        Unsafe: a row awaiting a ring / host token with nothing on the
        device (including every row of an in-flight decode window), rows
        already placed in the plan being formed (their segment would
        reference freed pages), mirrors and migrating rows.
        """
        best: Request | None = None
        for r in self.running.values():
            if (
                r is exclude
                or r.migrating
                or r.status is not RequestStatus.DECODING
                or not (r.ready_for_step or r.device_feed_ready)
                or (exclude_ids and r.request_id in exclude_ids)
                or getattr(r, "is_mirror", False)
            ):
                continue
            if best is None or r.arrival_time > best.arrival_time:
                best = r
        return best

    def _park(self, req: Request) -> None:
        """Move a preempted request to the wait-queue FRONT: preempted
        requests carry the oldest arrivals among waiting work, so FCFS
        resume order falls out of front insertion. ``ready_for_step`` is
        preserved: a parked row with a commit still in flight is re-armed
        by ``on_token_committed`` when it lands."""
        self.running.pop(req.request_id, None)
        req.set_status(RequestStatus.PREEMPTED, "preempt")
        req.device_feed_ready = False
        self.wait_queue[req.request_id] = req
        self.wait_queue.move_to_end(req.request_id, last=False)
        self._obs_event("preempt", req)

    def check_timeouts(self) -> list[Request]:
        """Abort requests exceeding the wall-clock budget."""
        now = time.monotonic()
        timed_out = []
        for req in list(self.running.values()) + list(self.wait_queue.values()):
            if req.status.is_finished:
                continue
            if now - req.arrival_time > self.request_timeout_s:
                req.abort("timeout")
                timed_out.append(req)
        return timed_out
