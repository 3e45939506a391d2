"""Host-side batch assembly: BatchPlan -> bucketed device inputs (port of
``parallax_tpu/runtime/batch.py``).

Token and sequence counts are padded up to a small lattice of power-of-two
buckets, as in the JAX package, where the lattice bounds recompiles; here it
will key CUDA graphs. Occupancy within a bucket is dynamic (``num_seqs``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parallax_tpu_torch.models.base import BatchInputs
from parallax_tpu_torch.runtime.scheduler import BatchPlan


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
    decode_only: bool = False,
    gather_all_logits: bool = False,
    decode_fused: bool = False,
    prefill_fused: bool = False,
) -> BatchInputs:
    """Build fixed-shape tensors on ``device`` from a ragged plan.

    ``hidden_states`` replaces token ids on non-first stages; rows are
    ordered as the plan's segments and padded here to the token bucket.
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

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    hidden = None
    if hidden_states is not None:
        hidden = hidden_states
        if hidden.shape[0] < t:
            pad = hidden.new_zeros((t - hidden.shape[0], hidden.shape[1]))
            hidden = torch.cat([hidden, pad], dim=0)
    return BatchInputs(
        token_ids=dev(token_ids),
        hidden_states=hidden,
        positions=dev(positions),
        kv_lens=dev(kv_lens),
        page_indices=dev(page_indices),
        cu_q_lens=dev(cu_q_lens),
        num_seqs=dev(np.asarray([s_real], np.int32)),
        slot_mapping=dev(slot_mapping),
        logits_indices=dev(logits_indices),
        decode_only=decode_only,
        decode_fused=decode_fused and decode_only,
        prefill_fused=prefill_fused and not decode_only,
    )
