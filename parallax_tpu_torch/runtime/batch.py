"""Host-side batch assembly: BatchPlan -> bucketed device inputs (port of
``parallax_tpu/runtime/batch.py``).

Token and sequence counts are padded up to a small lattice of power-of-two
buckets, as in the JAX package, where the lattice bounds recompiles; here it
keys the decode window's CUDA graphs (``runtime/step_graph.py``). Occupancy
within a bucket is dynamic (``num_seqs``).

Host arrays reach the device through :class:`HostStaging`: pinned buffers
and ``non_blocking`` copies, so a dispatch never waits for the step in
flight.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.runtime.scheduler import BatchPlan


class HostStaging:
    """Pinned host buffers for the H2D copies of a dispatch.

    A copy from pageable memory may wait for the stream to drain, which
    would stop the overlapped loop; a pinned source with ``non_blocking``
    does not. At most two tickets exist at once (the one-in-flight loop),
    so two sets of buffers alternate: :meth:`begin` starts a dispatch on
    the set the dispatch before last used, after waiting for that set's
    copies (an event recorded behind them), so the host never writes a
    buffer a pending copy still reads. On a CPU device :meth:`put` is
    ``torch.from_numpy``.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self._pinned = self.device.type == "cuda"
        self._sets: list[dict[str, torch.Tensor]] = [{}, {}]
        self._events: list = [None, None]
        self._cur = 0

    def begin(self) -> None:
        """Start a dispatch's copies on the other buffer set."""
        self._cur ^= 1
        ev = self._events[self._cur]
        if ev is not None:
            ev.synchronize()
            self._events[self._cur] = None

    def put(self, name: str, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device, copied through this set's buffer ``name``."""
        src = torch.from_numpy(np.ascontiguousarray(a))
        if not self._pinned:
            return src
        bufs = self._sets[self._cur]
        buf = bufs.get(name)
        if (buf is None or buf.dtype != src.dtype
                or buf.numel() < src.numel()):
            buf = torch.empty((max(src.numel(), 64),), dtype=src.dtype,
                              pin_memory=True)
            bufs[name] = buf
        view = buf[: src.numel()].view(src.shape)
        view.copy_(src)
        out = view.to(self.device, non_blocking=True)
        if self._events[self._cur] is None:
            self._events[self._cur] = torch.cuda.Event()
        # Re-recorded behind each copy: the set is free once the last
        # copy of its dispatch has run.
        self._events[self._cur].record()
        return out


def next_bucket(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def default_buckets(max_value: int, floor: int = 8) -> list[int]:
    out, b = [], floor
    while b < max_value:
        out.append(b)
        b *= 2
    out.append(max_value)
    return out


@dataclasses.dataclass
class BucketSpec:
    """The shape lattice: (token bucket, seq bucket, fixed pages/seq)."""

    token_buckets: list[int]
    seq_buckets: list[int]
    pages_per_seq: int

    @classmethod
    def build(
        cls, max_num_tokens: int, max_batch_size: int, max_model_len: int,
        page_size: int,
    ) -> "BucketSpec":
        # A non-power-of-two max_batch_size's exact-size tail bucket merges
        # into the next power of two when the padding is small (<= 25%).
        seq = default_buckets(max_batch_size)
        tail = seq[-1]
        if tail & (tail - 1):
            pow2 = 1 << (tail - 1).bit_length()
            if pow2 <= tail + tail // 4:
                seq[-1] = pow2
        return cls(
            token_buckets=default_buckets(max_num_tokens),
            seq_buckets=seq,
            pages_per_seq=(max_model_len + page_size - 1) // page_size,
        )


def assemble(
    plan: BatchPlan,
    spec: BucketSpec,
    page_size: int,
    device,
    hidden_states: torch.Tensor | None = None,
    with_dense_map: bool = False,
    decode_only: bool = False,
    gather_all_logits: bool = False,
    decode_fused: bool = False,
    prefill_fused: bool = False,
    staging: HostStaging | None = None,
) -> BatchInputs:
    """Build fixed-shape tensors on ``device`` from a ragged plan.

    ``hidden_states`` replaces token ids on non-first stages; rows are
    ordered as the plan's segments and padded here to the token bucket.
    ``with_dense_map`` (hybrid models) adds the densified view of the
    ragged rows: ``dense_map [S, maxq]`` (``maxq`` bucketed on ``[1] +
    token_buckets``, so decode batches have 1; ``t`` marks a padding step,
    the out-of-bounds row), each row's state slot, its step count and its
    reset flag (1 on a request's first chunk). ``staging`` (the engine's)
    copies through pinned buffers without blocking; without it the copies
    are plain ``.to(device)``.
    """
    seqs = plan.seqs
    t_real = plan.total_new_tokens
    s_real = len(seqs)
    s = next_bucket(max(s_real, 1), spec.seq_buckets)
    if decode_only:
        # One token per sequence: bucket tokens on the SEQ lattice so t == s
        # (the decode-kernel dispatch contract).
        t = s
    else:
        t = next_bucket(max(t_real, 1), spec.token_buckets)

    token_ids = np.zeros((t,), np.int32)
    positions = np.zeros((t,), np.int32)
    slot_mapping = np.full((t,), -1, np.int32)
    kv_lens = np.zeros((s,), np.int32)
    page_indices = np.zeros((s, spec.pages_per_seq), np.int32)
    cu_q_lens = np.zeros((s + 1,), np.int32)
    logits_indices = np.zeros((s,), np.int32)

    row = 0
    for i, seg in enumerate(seqs):
        n = seg.num_new_tokens
        start_pos = seg.context_len - n
        token_ids[row : row + n] = seg.token_ids
        pos = np.arange(start_pos, seg.context_len)
        positions[row : row + n] = pos
        pages = np.asarray(seg.request.page_ids, np.int32)
        slot_mapping[row : row + n] = (
            pages[pos // page_size] * page_size + pos % page_size
        )
        kv_lens[i] = seg.context_len
        page_indices[i, : len(pages)] = pages
        cu_q_lens[i + 1] = cu_q_lens[i] + n
        logits_indices[i] = row + n - 1
        row += n
    cu_q_lens[s_real + 1 :] = cu_q_lens[s_real]
    if gather_all_logits:
        # Logits at EVERY fed position (the reference check replays a whole
        # stream in one forward); its length is the token bucket.
        logits_indices = np.arange(t, dtype=np.int32)

    def dev(a: np.ndarray, name: str) -> torch.Tensor:
        if staging is not None:
            return staging.put(name, a)
        return torch.from_numpy(a).to(device)

    dense = {}
    if with_dense_map:
        maxq = next_bucket(
            max((seg.num_new_tokens for seg in seqs), default=1),
            [1] + spec.token_buckets)
        dense_map = np.full((s, maxq), t, np.int32)
        q_lens = np.zeros((s,), np.int32)
        slots = np.zeros((s,), np.int32)
        reset = np.zeros((s,), np.int32)
        for i, seg in enumerate(seqs):
            n = seg.num_new_tokens
            dense_map[i, :n] = np.arange(cu_q_lens[i], cu_q_lens[i] + n)
            q_lens[i] = n
            slots[i] = getattr(seg.request, "state_slot", 0)
            # A request's first chunk: its reused slot holds a finished
            # request's state and must be zeroed.
            reset[i] = int(seg.context_len - n == 0)
        dense = dict(state_slots=dev(slots, "state_slots"),
                     dense_map=dev(dense_map, "dense_map"),
                     q_lens=dev(q_lens, "q_lens"),
                     reset_state=dev(reset, "reset_state"))
    hidden = None
    if hidden_states is not None:
        hidden = hidden_states
        if hidden.shape[0] < t:
            pad = hidden.new_zeros((t - hidden.shape[0], hidden.shape[1]))
            hidden = torch.cat([hidden, pad], dim=0)
    return BatchInputs(
        token_ids=dev(token_ids, "token_ids"),
        hidden_states=hidden,
        positions=dev(positions, "positions"),
        kv_lens=dev(kv_lens, "kv_lens"),
        page_indices=dev(page_indices, "page_indices"),
        cu_q_lens=dev(cu_q_lens, "cu_q_lens"),
        num_seqs=dev(np.asarray([s_real], np.int32), "num_seqs"),
        slot_mapping=dev(slot_mapping, "slot_mapping"),
        logits_indices=dev(logits_indices, "logits_indices"),
        **dense,
        decode_only=decode_only,
        decode_fused=decode_fused and decode_only,
        prefill_fused=prefill_fused and not decode_only,
    )


def _gather_feed(token_ids: torch.Tensor, last_tokens: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """Rows with a slot >= 0 take ``last_tokens[slot]``; the rest keep
    ``token_ids`` (a gather on the device)."""
    fed = last_tokens[torch.clamp(slots, 0, last_tokens.shape[0] - 1).long()]
    return torch.where(slots >= 0, fed, token_ids)


def substitute_device_tokens(
    inputs: BatchInputs, last_tokens: torch.Tensor, feed_slots: torch.Tensor
) -> BatchInputs:
    """Overlapped decode's on-device token feedback: replace the
    placeholder token ids of device-fed rows with a gather from the
    engine's device-resident last-token array.

    ``feed_slots`` is i32[T] with the row's token slot at its first token
    position and -1 everywhere else (host rows keep their assembled ids).
    The gather is enqueued between the sampler that produced
    ``last_tokens`` and the forward that consumes the result, so the
    sampled token never round-trips through the host.
    """
    return dataclasses.replace(
        inputs, token_ids=_gather_feed(inputs.token_ids, last_tokens,
                                       feed_slots))
