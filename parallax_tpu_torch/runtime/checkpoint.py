"""Portable request checkpoints: the unit of live migration (port of
``parallax_tpu/runtime/checkpoint.py``).

A :class:`RequestCheckpoint` is everything a *different* head engine
needs to continue a request mid-decode **bit-identically**:

- the token-level state (original prompt, every committed output token,
  their logprobs) — sampling keys derive from ``fold_in(key(seed),
  output_step)`` and greedy is deterministic, so token state alone
  already guarantees an identical continuation via re-prefill of the
  (radix-uncovered suffix of the) history;
- the sampling parameters including the seed, plus the stop/eos sets;
- optionally the committed KV image (the preemption-to-host page image,
  serialized) so a compatible target can swap it in through the existing
  ``resume_from_host`` path instead of recomputing.

The wire form is a msgpack-compatible dict carried by a dedicated
``rpc_checkpoint`` frame (p2p/proto.py), the JAX package's byte for byte:
the image's layers are CPU torch tensors framed by ``proto.tensor_to_wire``
at their native dtype (never the bf16 activation downcast), under the JAX
dtype names, so a port signature equals a JAX one for the same layout and
either package adopts the other's checkpoints. :func:`checkpoint_from_wire`
validates every field — lengths, dtypes, shape/byte agreement — and raises
:class:`CheckpointError` on anything malformed, so a truncated or corrupt
frame is rejected cleanly instead of poisoning the target engine. The
trace-span helpers carry empty lists until the tracing plane is ported
(ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import time

import torch

from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.runtime.request import Request, SamplingParams

CHECKPOINT_VERSION = 1

# Restored prompts fold the committed outputs in, so the hard cap is the
# model context; anything past ~1M tokens is a corrupt frame, not a
# request.
_MAX_TOKENS = 1 << 20


class CheckpointError(ValueError):
    """A checkpoint frame failed validation (truncated, corrupt, or
    from an incompatible build). The frame is rejected; the request
    falls back to the next recovery rung (re-prefill / client resume)."""


@dataclasses.dataclass
class KVImage:
    """The committed KV pages of one request on ONE stage, host-side.

    ``layers[i]`` is ``[n_pages, *page_dims]`` for local attention layer
    ``i`` — exactly what :meth:`HostKVTier.demote` gathers for a
    preempted request. ``prefix_tokens`` KV tokens are NOT in the image:
    they were radix-shared at the source, and the target must cover them
    from its own radix (or the restore falls back to re-prefill).
    ``computed_tokens`` is the total KV coverage including that prefix.
    """

    page_size: int
    start_layer: int
    end_layer: int
    kv_dtype: str
    prefix_tokens: int
    computed_tokens: int
    layers: list[torch.Tensor]

    @property
    def signature(self) -> tuple:
        """Compatibility signature: a target adopts the image only when
        its own :meth:`StageEngine.kv_page_signature` matches."""
        return (
            self.page_size, self.start_layer, self.end_layer,
            self.kv_dtype,
            tuple(
                (tuple(a.shape[1:]), proto.dtype_name(a.dtype))
                for a in self.layers
            ),
        )


@dataclasses.dataclass
class RequestCheckpoint:
    request_id: str
    # The ORIGINAL prompt (a previously-resumed request unfolds its
    # prior outputs back out, so checkpoints never nest).
    prompt_ids: list[int]
    # Every committed output token, in order.
    output_ids: list[int]
    output_logprobs: list[float]
    sampling_params: dict
    eos_token_ids: list[int]
    lora_id: str | None
    # The NEW pipeline path the restored request will run on (filled by
    # the migration flow before shipping).
    routing_table: list[str]
    # Seconds since the request's original arrival, so the target
    # reconstructs ``arrival_time`` on its own monotonic clock and
    # request timeouts keep counting from the true start.
    age_s: float
    # Wall-clock park instant (time.time()): the park->resume migration
    # latency metric on the target. Wall clocks skew across hosts; the
    # histogram is a fleet observability signal, not a correctness one.
    parked_wall: float
    traced: bool = False
    kv: KVImage | None = None
    # Lifecycle-trace spans recorded on the SOURCE head (bounded;
    # ``t0`` rebased to wall-clock seconds — see ``spans_to_wire``), so
    # the target's ``/debug/trace/<rid>`` shows one stitched timeline
    # across heads instead of losing the pre-migration history.
    trace_spans: list | None = None
    # True when this checkpoint is a planned prefill->decode handoff
    # (docs/disaggregation.md) rather than a churn migration: the target
    # accounts it under parallax_kv_handoffs_* instead of the migration
    # families, so churn dashboards stay churn-only.
    handoff: bool = False
    # Resumable partial-prefill progress: prompt tokens whose KV was
    # computed at park time, or 0 when prefill had finished (the decode
    # cases carry no mark — the whole prompt is implied). A target that
    # adopts the KV image resumes the chunked prefill AT this mark
    # instead of recomputing from token zero; without an image the
    # replay path re-prefills from scratch, which is always correct.
    # Cross-checked against ``kv.computed_tokens`` at decode.
    prefill_computed_tokens: int = 0
    # Grammar-DFA progress of a constrained (json_schema) request: the
    # source head's host-mirror state plus a short hash of the schema
    # text it was computed under. The restoring stage trusts the int
    # only when ITS compile of the schema hashes identically (state
    # numbering is a pure function of the schema text); otherwise it
    # recomputes by advancing from state 0 through the recorded stream
    # — always correct, just O(output) table lookups. None/"" for
    # unconstrained requests and pre-dfa_state frames.
    dfa_state: int | None = None
    grammar_hash: str = ""


# Span-shipping bound: a traced request's decode epochs coalesce
# (obs/trace.py), so real traces are tens of spans; anything larger is
# trimmed rather than bloating the checkpoint frame.
_MAX_TRACE_SPANS = 512


def spans_to_wire(spans: list[dict]) -> list[dict]:
    """Wire form of TraceStore spans: ``t0`` (local ``perf_counter``
    seconds) is rebased to wall clock (``t0w``) so the target can map it
    into ITS perf_counter domain. Cross-host wall skew shifts the whole
    source block together — span ordering and durations survive."""
    wall_off = time.time() - time.perf_counter()
    out = []
    for s in spans[:_MAX_TRACE_SPANS]:
        w = {
            "name": s.get("name"),
            "stage": s.get("stage"),
            "t0w": float(s.get("t0") or 0.0) + wall_off,
            "dur": s.get("dur"),
        }
        if isinstance(s.get("args"), dict):
            w["args"] = s["args"]
        out.append(w)
    return out


def spans_from_wire(spans: list) -> list[dict]:
    """Back into this process's ``perf_counter`` domain; malformed
    entries are dropped (``TraceStore.adopt`` re-sanitizes anyway)."""
    wall_off = time.time() - time.perf_counter()
    out = []
    for s in spans[:_MAX_TRACE_SPANS]:
        if not isinstance(s, dict):
            continue
        try:
            t0 = float(s["t0w"]) - wall_off
        except (KeyError, TypeError, ValueError):
            continue
        out.append({**s, "t0": t0})
    return out


def checkpoint_from_request(
    req: Request,
    routing_table: list[str] | None = None,
    kv: KVImage | None = None,
    grammar: tuple[int, str] | None = None,
) -> RequestCheckpoint:
    """Snapshot one head-owned request. The request may itself be a
    resumed one: folded prior outputs (``output_offset > 0``) are peeled
    back out of the prompt, and outputs still awaiting teacher-forced
    replay (``replay_ids``) are appended to the committed stream — so
    checkpoints never nest and never lose recorded tokens."""
    orig_prompt = (
        req.prompt_ids[: len(req.prompt_ids) - req.output_offset]
        if req.output_offset else req.prompt_ids
    )
    # The port records no lifecycle spans until item 9: a traced
    # request ships none.
    trace_spans = None
    return RequestCheckpoint(
        request_id=req.request_id,
        prompt_ids=list(orig_prompt),
        output_ids=list(req.full_output_ids) + list(req.replay_ids),
        output_logprobs=(
            list(req.full_output_logprobs) + list(req.replay_logprobs)
        ),
        sampling_params=req.sampling_params.to_dict(),
        eos_token_ids=list(req.eos_token_ids),
        lora_id=req.lora_id,
        routing_table=list(routing_table or ()),
        age_s=max(0.0, time.monotonic() - req.arrival_time),
        parked_wall=time.time(),
        traced=req.traced,
        kv=kv,
        trace_spans=trace_spans,
        prefill_computed_tokens=(
            0 if req.is_prefill_done else req.num_computed_tokens
        ),
        dfa_state=(int(grammar[0]) if grammar is not None else None),
        grammar_hash=(str(grammar[1]) if grammar is not None else ""),
    )


def build_resumed_request(
    ckpt: RequestCheckpoint, replay: bool = False
) -> Request:
    """The restored head request, in one of two bit-identical forms.

    ``replay=False`` — KV-adoption intent: committed outputs fold into
    the prompt (their KV arrives via the checkpoint's page image, which
    the target swaps in through ``resume_from_host``), and
    ``output_offset`` keeps every output-side accounting site
    (generation budgets, penalty windows, the seeded ``fold_in(key(seed),
    output_step)`` origin) counting from the ORIGINAL stream position.

    ``replay=True`` — no image to adopt: the request restarts from the
    ORIGINAL prompt (prefix-cache hits and prefill chunking match a
    fresh serve exactly) and teacher-forces the recorded outputs through
    ordinary decode steps via ``replay_ids`` before sampling resumes.
    Folding them into the prompt instead would recompute their KV under
    prefill-chunk shapes — float-reduction differences there can flip a
    near-tied argmax, which replay makes impossible by construction."""
    outs = list(ckpt.output_ids)
    lps = list(ckpt.output_logprobs or ())
    req = Request(
        request_id=ckpt.request_id,
        prompt_ids=(
            list(ckpt.prompt_ids) if replay
            else list(ckpt.prompt_ids) + outs
        ),
        sampling_params=SamplingParams.from_dict(ckpt.sampling_params),
        routing_table=list(ckpt.routing_table),
        eos_token_ids=tuple(ckpt.eos_token_ids),
        lora_id=ckpt.lora_id,
    )
    if replay:
        req.replay_ids = outs
        # Positional alignment only holds when every recorded token has
        # a logprob; a ragged record replays tokens alone.
        req.replay_logprobs = lps if len(lps) == len(outs) else []
    else:
        req.output_offset = len(outs)
        req.prior_output_logprobs = lps
    req.arrival_time = time.monotonic() - max(0.0, float(ckpt.age_s))
    req.traced = bool(ckpt.traced)
    if not replay and ckpt.dfa_state is not None and ckpt.grammar_hash:
        # Grammar-DFA restore intent (ADOPT mode only): the adopting
        # engine's _grammar_initial_state validates the hash against
        # its own compile and falls back to stream recompute on
        # mismatch. Replay mode must NOT pre-seed the state: its
        # committed stream restarts empty and the DFA mirror advances
        # through the teacher-forced commits, landing on exactly the
        # checkpointed state when replay drains — seeding it would
        # double-count every replayed token.
        req.grammar_dfa_state = int(ckpt.dfa_state)
        req.grammar_hash = str(ckpt.grammar_hash)
    return req


# -- wire form ---------------------------------------------------------------


def checkpoint_to_wire(ckpt: RequestCheckpoint) -> dict:
    d = {
        "v": CHECKPOINT_VERSION,
        "rid": ckpt.request_id,
        "prompt_ids": list(ckpt.prompt_ids),
        "output_ids": list(ckpt.output_ids),
        "output_logprobs": list(ckpt.output_logprobs),
        "sampling_params": ckpt.sampling_params,
        "eos_token_ids": list(ckpt.eos_token_ids),
        "lora_id": ckpt.lora_id,
        "routing_table": list(ckpt.routing_table),
        "age_s": float(ckpt.age_s),
        "parked_wall": float(ckpt.parked_wall),
        "traced": bool(ckpt.traced),
        "handoff": bool(ckpt.handoff),
        "prefill_computed_tokens": int(ckpt.prefill_computed_tokens),
    }
    if ckpt.trace_spans:
        d["trace_spans"] = list(ckpt.trace_spans[:_MAX_TRACE_SPANS])
    if ckpt.dfa_state is not None and ckpt.grammar_hash:
        d["dfa_state"] = int(ckpt.dfa_state)
        d["grammar_hash"] = str(ckpt.grammar_hash)
    if ckpt.kv is not None:
        d["kv"] = {
            "page_size": ckpt.kv.page_size,
            "start_layer": ckpt.kv.start_layer,
            "end_layer": ckpt.kv.end_layer,
            "kv_dtype": ckpt.kv.kv_dtype,
            "prefix_tokens": ckpt.kv.prefix_tokens,
            "computed_tokens": ckpt.kv.computed_tokens,
            "layers": [proto.tensor_to_wire(a) for a in ckpt.kv.layers],
        }
    return d


def _ids(d: dict, key: str, maximum: int = _MAX_TOKENS) -> list[int]:
    v = d.get(key)
    if not isinstance(v, (list, tuple)):
        raise CheckpointError(f"checkpoint {key} is not a list")
    if len(v) > maximum:
        raise CheckpointError(f"checkpoint {key} oversized ({len(v)})")
    try:
        return [int(x) for x in v]
    except (TypeError, ValueError) as e:
        raise CheckpointError(f"checkpoint {key} holds non-ints: {e}")


def _kv_from_wire(d: dict) -> KVImage:
    try:
        page_size = int(d["page_size"])
        start_layer = int(d["start_layer"])
        end_layer = int(d["end_layer"])
        kv_dtype = str(d["kv_dtype"])
        prefix_tokens = int(d["prefix_tokens"])
        computed_tokens = int(d["computed_tokens"])
        raw_layers = d["layers"]
    except (KeyError, TypeError, ValueError) as e:
        raise CheckpointError(f"kv image header malformed: {e}")
    if page_size <= 0 or not 0 <= start_layer < end_layer:
        raise CheckpointError("kv image header out of range")
    if not 0 <= prefix_tokens <= computed_tokens <= _MAX_TOKENS:
        raise CheckpointError("kv image token counts out of range")
    if prefix_tokens % page_size:
        raise CheckpointError("kv prefix not page-aligned")
    if not isinstance(raw_layers, (list, tuple)) or not raw_layers:
        raise CheckpointError("kv image has no layers")
    layers: list[torch.Tensor] = []
    n_pages = None
    for t in raw_layers:
        if not isinstance(t, dict):
            raise CheckpointError("kv layer frame is not a tensor dict")
        try:
            arr = proto.tensor_from_wire(t)
        except (KeyError, TypeError, ValueError, RuntimeError,
                NotImplementedError) as e:
            # A byte-count/shape disagreement raises in the reshape —
            # exactly the truncated-frame case.
            raise CheckpointError(f"kv layer tensor malformed: {e}")
        if arr is None or arr.dim() < 2:
            raise CheckpointError("kv layer tensor has no page dim")
        data = t.get("data")
        if not isinstance(data, (bytes, bytearray)) or len(data) != (
            arr.numel() * proto.resolve_dtype(t["dtype"]).itemsize
        ):
            # An empty payload frames as an empty tensor of any shape: the
            # byte count is what exposes the truncation.
            raise CheckpointError("kv layer tensor truncated")
        if n_pages is None:
            n_pages = int(arr.shape[0])
        elif int(arr.shape[0]) != n_pages:
            raise CheckpointError("kv layers disagree on page count")
        layers.append(arr)
    # The image must cover its tokens; one page of slack is legal (the
    # source allocates a page for the token the next decode step would
    # have written).
    image_tokens = computed_tokens - prefix_tokens
    want = -(-image_tokens // page_size)
    if image_tokens <= 0 or not want <= n_pages <= want + 1:
        raise CheckpointError(
            f"kv image pages ({n_pages}) do not cover "
            f"{image_tokens} tokens at page_size {page_size}"
        )
    return KVImage(
        page_size=page_size, start_layer=start_layer, end_layer=end_layer,
        kv_dtype=kv_dtype, prefix_tokens=prefix_tokens,
        computed_tokens=computed_tokens, layers=layers,
    )


def checkpoint_from_wire(d: dict) -> RequestCheckpoint:
    """Strictly validated decode; raises :class:`CheckpointError` on any
    malformed field so the restore path can reject the frame cleanly."""
    if not isinstance(d, dict):
        raise CheckpointError("checkpoint frame is not a map")
    if d.get("v") != CHECKPOINT_VERSION:
        raise CheckpointError(f"unsupported checkpoint version {d.get('v')!r}")
    rid = d.get("rid")
    if not isinstance(rid, str) or not rid:
        raise CheckpointError("checkpoint has no request id")
    prompt_ids = _ids(d, "prompt_ids")
    if not prompt_ids:
        raise CheckpointError("checkpoint prompt is empty")
    output_ids = _ids(d, "output_ids")
    lps = d.get("output_logprobs")
    if lps is None:
        lps = []
    if not isinstance(lps, (list, tuple)) or len(lps) > len(output_ids):
        raise CheckpointError("checkpoint logprobs malformed")
    try:
        logprobs = [float(x) for x in lps]
    except (TypeError, ValueError) as e:
        raise CheckpointError(f"checkpoint logprobs non-float: {e}")
    sp = d.get("sampling_params")
    if not isinstance(sp, dict):
        raise CheckpointError("checkpoint sampling_params is not a map")
    try:
        SamplingParams.from_dict(sp)
    except (TypeError, ValueError, AttributeError) as e:
        raise CheckpointError(f"checkpoint sampling_params invalid: {e}")
    lora_id = d.get("lora_id")
    if lora_id is not None and not isinstance(lora_id, str):
        raise CheckpointError("checkpoint lora_id is not a string")
    table = d.get("routing_table") or []
    if not isinstance(table, (list, tuple)) or not all(
        isinstance(x, str) for x in table
    ):
        raise CheckpointError("checkpoint routing_table malformed")
    try:
        age_s = float(d.get("age_s") or 0.0)
        parked_wall = float(d.get("parked_wall") or 0.0)
    except (TypeError, ValueError) as e:
        raise CheckpointError(f"checkpoint timestamps malformed: {e}")
    kv = None
    if d.get("kv") is not None:
        if not isinstance(d["kv"], dict):
            raise CheckpointError("checkpoint kv is not a map")
        kv = _kv_from_wire(d["kv"])
        total = len(prompt_ids) + len(output_ids)
        if kv.computed_tokens > total:
            raise CheckpointError(
                "kv image covers more tokens than the checkpoint holds"
            )
    try:
        prefill_computed = int(d.get("prefill_computed_tokens") or 0)
    except (TypeError, ValueError) as e:
        raise CheckpointError(f"prefill progress malformed: {e}")
    if prefill_computed:
        # Mid-prefill park: the mark must sit strictly inside the
        # restored prompt (folded outputs included) and agree with the
        # KV image when one shipped — a disagreement means a corrupt or
        # mixed-up frame, not a resumable request.
        if not 0 < prefill_computed < len(prompt_ids) + len(output_ids):
            raise CheckpointError("prefill progress out of range")
        if kv is not None and kv.computed_tokens != prefill_computed:
            raise CheckpointError(
                "prefill progress disagrees with the kv image"
            )
    dfa_state = d.get("dfa_state")
    grammar_hash = d.get("grammar_hash") or ""
    if dfa_state is not None:
        try:
            dfa_state = int(dfa_state)
        except (TypeError, ValueError) as e:
            raise CheckpointError(f"checkpoint dfa_state malformed: {e}")
        # -1 is the host-side dead state; huge values are corrupt
        # frames, not automata (state counts are bounded well below the
        # token cap by the device-table budget).
        if not -1 <= dfa_state <= _MAX_TOKENS:
            raise CheckpointError("checkpoint dfa_state out of range")
        if not isinstance(grammar_hash, str) or not (
            0 < len(grammar_hash) <= 64
        ):
            raise CheckpointError("checkpoint grammar_hash malformed")
        if not SamplingParams.from_dict(sp).json_schema:
            raise CheckpointError(
                "checkpoint carries dfa_state without a json_schema"
            )
    # Trace spans are observability freight: bounded and type-checked
    # but never a reason to reject the frame (TraceStore.adopt
    # sanitizes field-by-field on use).
    trace_spans = d.get("trace_spans")
    if not isinstance(trace_spans, (list, tuple)):
        trace_spans = None
    else:
        trace_spans = list(trace_spans[:_MAX_TRACE_SPANS])
    return RequestCheckpoint(
        request_id=rid,
        prompt_ids=prompt_ids,
        output_ids=output_ids,
        output_logprobs=logprobs,
        sampling_params=sp,
        eos_token_ids=_ids(d, "eos_token_ids", maximum=4096),
        lora_id=lora_id,
        routing_table=[str(x) for x in table],
        age_s=age_s,
        parked_wall=parked_wall,
        traced=bool(d.get("traced", False)),
        kv=kv,
        trace_spans=trace_spans,
        handoff=bool(d.get("handoff", False)),
        prefill_computed_tokens=prefill_computed,
        dfa_state=dfa_state,
        grammar_hash=str(grammar_hash) if dfa_state is not None else "",
    )
