"""KV-page handoff: the disaggregation wire between phase pools (port of
``parallax_tpu/runtime/kv_handoff.py``).

Disaggregated prefill / decode serving (the DistServe / Mooncake pattern)
splits the swarm into phase-specialized replica pools: a prefill head
computes the prompt, then ships the request — its token-level checkpoint
(:class:`RequestCheckpoint`) plus the committed KV pages (the host tier's
pinned image) — to a CacheIndex-scored decode replica, which admits it
exactly like a preempted resume. This module owns the WIRE of that
handoff, the JAX package's frame for frame:

- :func:`image_to_frames` splits one :class:`KVImage` into layer-chunked
  ``KV_TRANSFER`` frames (begin / layers / end) sized to ``chunk_bytes``,
  so the transfer streams over the worker's dedicated ``AsyncSender`` lane
  frame by frame: the prefill engine keeps serving (and the decode head
  starts assembling) while later layers are still in flight, and a
  mid-transfer failure wastes at most the frames already sent, never a
  blocked step thread.
- :class:`HandoffAssembler` reassembles frames on the decode side,
  enforcing per-transfer deadlines (a source that dies mid-transfer is
  swept, its partial state discarded) and validating the completed
  transfer through the STRICT checkpoint decoder
  (:func:`checkpoint_from_wire`), so a truncated or corrupt transfer is
  rejected exactly like a corrupt ``rpc_checkpoint`` frame.
- :class:`HandoffStats`, the worker's counters: transfer bytes and frames
  by direction, transfer seconds, fallbacks by rung and handoffs by
  restore mode, plus one record per handoff a prefill head made. The JAX
  package writes the same counts to its metrics registry, which the port
  does not run yet (ROADMAP queue 1 item 9).

Tensors ship at native precision (bf16 through its 16-bit view, under the
JAX dtype names): handoff streams must stay bit-identical to mixed-mode
serving, so KV never rides the lossy activation wire dtypes. Everything
here handles CPU tensors and host values only; no call touches a device.

The fallback ladder (each rung strictly correct, each cheaper to reach):
prefix-warm target -> checkpoint-only ship (the target re-prefills from
its own radix, usually a page); transfer failed / rejected / timed out ->
checkpoint-only re-ship (re-prefill + teacher-forced replay); no decode
pool -> restore locally (the prefill head decodes it, mixed-mode
behaviour); engine gone -> abort (the only rung that drops the request).
"""

from __future__ import annotations

import time
from collections import OrderedDict

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.p2p import proto
from parallax_tpu_torch.runtime.checkpoint import (
    CheckpointError,
    KVImage,
    RequestCheckpoint,
    checkpoint_from_request,
    checkpoint_from_wire,
)
from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)

# A transfer whose begin frame arrived but whose end frame has not within
# this horizon is presumed orphaned (source death, lane failure): the
# partial state is discarded and the request recovers through the source's
# own result timeout or the client resume ladder.
ASSEMBLY_TIMEOUT_S = 30.0

# Default per-frame payload target for layer chunking. Small enough that a
# frame serializes in well under a heartbeat, large enough that a 7B-class
# stage ships in a handful of frames.
DEFAULT_CHUNK_BYTES = 4 << 20


# -- telemetry ---------------------------------------------------------------


class HandoffStats:
    """One worker's handoff counters (thread-safe: transport threads,
    the ship thread and the step thread all count).

    - ``transfer_bytes`` / ``transfer_frames``: KV_TRANSFER payload by
      direction (``out`` on a prefill head, ``in`` on a decode head).
    - ``transfer_s``: transfer seconds, one entry per completed leg
      (out: first frame enqueued -> the decode head's accept; in: begin
      frame -> image assembled).
    - ``fallbacks``: rungs down the ladder by reason (prefix_warm,
      no_image, layout, transfer_failed, result_timeout,
      transfer_abandoned, no_decode_pool).
    - ``handoffs``: requests restored after a planned handoff, by mode
      (``kv_image``: raw pages adopted; ``reprefill``: checkpoint-only
      restore; ``local``: the prefill head kept it).
    - ``log``: rid -> the figures of one handoff (bounded). Out of a
      prefill head: pages, bytes, frames, the target, flag -> park ms,
      the park's own ms, first frame enqueued -> result and park ->
      result ms, and how it ended. Into a decode head: begin frame ->
      image assembled ms.
    """

    LOG_CAP = 4096

    def __init__(self):
        self._lock = make_lock("runtime.kv_handoff.stats")
        self.transfer_bytes = {"in": 0, "out": 0}
        self.transfer_frames = {"in": 0, "out": 0}
        self.transfer_s: list[float] = []
        self.fallbacks: dict[str, int] = {}
        self.handoffs: dict[str, int] = {}
        self.log: OrderedDict[str, dict] = OrderedDict()

    def record_transfer(self, direction: str, frames: int, nbytes: int,
                        ms: float | None = None) -> None:
        with self._lock:
            self.transfer_bytes[direction] = (
                self.transfer_bytes.get(direction, 0) + int(nbytes))
            self.transfer_frames[direction] = (
                self.transfer_frames.get(direction, 0) + int(frames))
            if ms is not None:
                self.transfer_s.append(ms / 1e3)
                del self.transfer_s[:-self.LOG_CAP]

    def record_fallback(self, reason: str) -> None:
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def record_handoff(self, mode: str) -> None:
        with self._lock:
            self.handoffs[mode] = self.handoffs.get(mode, 0) + 1

    def note(self, rid: str, **fields) -> None:
        """Merge ``fields`` into one handoff's record."""
        with self._lock:
            entry = self.log.setdefault(rid, {})
            entry.update(fields)
            self.log.move_to_end(rid)
            while len(self.log) > self.LOG_CAP:
                self.log.popitem(last=False)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "transfer_bytes": dict(self.transfer_bytes),
                "transfer_frames": dict(self.transfer_frames),
                "transfer_s": list(self.transfer_s),
                "fallbacks": dict(self.fallbacks),
                "handoffs": dict(self.handoffs),
                "log": {rid: dict(e) for rid, e in self.log.items()},
            }


# -- wire framing ------------------------------------------------------------


def image_to_frames(
    rid: str,
    ckpt_wire: dict,
    image: KVImage,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> list[tuple[dict, int]]:
    """Split one transfer into ``KV_TRANSFER`` frame payloads.

    Returns ``[(frame, payload_bytes), ...]``: a begin frame carrying the
    checkpoint (without ``kv`` — that is what the layer frames are for)
    and the image header, one or more layer-chunk frames grouped to at
    most ``chunk_bytes`` of tensor payload each (always at least one layer
    a frame), and an end frame with the expected layer count."""
    ckpt_wire = dict(ckpt_wire)
    ckpt_wire.pop("kv", None)
    frames: list[tuple[dict, int]] = [(
        {
            "rid": rid,
            "kind": "begin",
            "ckpt": ckpt_wire,
            "header": {
                "page_size": image.page_size,
                "start_layer": image.start_layer,
                "end_layer": image.end_layer,
                "kv_dtype": image.kv_dtype,
                "prefix_tokens": image.prefix_tokens,
                "computed_tokens": image.computed_tokens,
                "num_layers": len(image.layers),
            },
        },
        0,
    )]
    batch: list[dict] = []
    batch_bytes = 0
    batch_start = 0
    for i, arr in enumerate(image.layers):
        t = proto.tensor_to_wire(arr)
        nbytes = proto.tensor_nbytes(t)
        if batch and batch_bytes + nbytes > chunk_bytes:
            frames.append((
                {"rid": rid, "kind": "layers", "idx": batch_start,
                 "layers": batch},
                batch_bytes,
            ))
            batch, batch_bytes, batch_start = [], 0, i
        batch.append(t)
        batch_bytes += nbytes
    if batch:
        frames.append((
            {"rid": rid, "kind": "layers", "idx": batch_start,
             "layers": batch},
            batch_bytes,
        ))
    frames.append((
        {"rid": rid, "kind": "end", "num_layers": len(image.layers)},
        0,
    ))
    return frames


# -- decode-side reassembly --------------------------------------------------


class HandoffAssembler:
    """Per-request reassembly of in-flight KV transfers (decode head).

    Frames of one transfer arrive IN ORDER (the source's kv lane is a
    per-peer FIFO), but transfers from different sources interleave
    freely — state is keyed by request id. Thread-safe: transport threads
    feed frames while the heartbeat thread sweeps deadlines. ``stats``
    (the worker's :class:`HandoffStats`) counts completed inbound
    transfers and swept orphans."""

    def __init__(self, timeout_s: float = ASSEMBLY_TIMEOUT_S,
                 stats: HandoffStats | None = None):
        self.timeout_s = timeout_s
        self.stats = stats
        self._partial: dict[str, dict] = {}
        self._lock = make_lock("runtime.kv_handoff")
        # Monotonic frames-fed counter: progress while a large transfer
        # assembles.
        self.frames_total = 0

    def partial_count(self) -> int:
        with self._lock:
            return len(self._partial)

    def feed(self, peer: str, frame: dict) -> tuple[str, object] | None:
        """Consume one ``KV_TRANSFER`` frame.

        Returns None while the transfer is still assembling, ``("done",
        RequestCheckpoint)`` when the end frame completes a valid transfer,
        or ``("error", reason)`` when the transfer is malformed (the caller
        nacks the source, which falls back to a checkpoint-only
        re-ship)."""
        if not isinstance(frame, dict):
            return ("error", "frame is not a map")
        rid = frame.get("rid")
        if not isinstance(rid, str) or not rid:
            return ("error", "frame has no request id")
        kind = frame.get("kind")
        now = time.monotonic()
        with self._lock:
            self.frames_total += 1
            if kind == "begin":
                # A duplicate begin (source retry) restarts the transfer:
                # stale bytes of the first attempt must not leak into the
                # second.
                self._partial[rid] = {
                    "peer": peer,
                    "ckpt": frame.get("ckpt"),
                    "header": frame.get("header") or {},
                    "layers": [],
                    "bytes": 0,
                    "frames": 1,
                    "t0": now,
                    "deadline": now + self.timeout_s,
                }
                return None
            entry = self._partial.get(rid)
            if entry is None:
                # Layer / end frames of a transfer never begun (a swept
                # partial, a restart): reject so the source falls back
                # instead of waiting for a result that cannot come.
                return ("error", f"no transfer in progress for {rid}")
            entry["frames"] += 1
            if kind == "layers":
                layers = frame.get("layers")
                if not isinstance(layers, list):
                    del self._partial[rid]
                    return ("error", "layer frame without tensors")
                if frame.get("idx") != len(entry["layers"]):
                    # The lane is a FIFO, so a gap means frames were
                    # dropped (overflow): the transfer cannot complete.
                    del self._partial[rid]
                    return ("error", "layer frames out of sequence")
                entry["layers"].extend(layers)
                entry["bytes"] += sum(
                    proto.tensor_nbytes(t) for t in layers
                    if isinstance(t, dict)
                )
                return None
            if kind == "end":
                entry = self._partial.pop(rid)
            else:
                del self._partial[rid]
                return ("error", f"unknown frame kind {kind!r}")
        # End frame: validate OUTSIDE the lock (reshaping multi-MB payloads
        # must not serialize other transfers).
        want = frame.get("num_layers")
        if want != len(entry["layers"]):
            return ("error", (
                f"transfer truncated: {len(entry['layers'])} of "
                f"{want} layers"
            ))
        ckpt_wire = entry["ckpt"]
        if not isinstance(ckpt_wire, dict):
            return ("error", "begin frame carried no checkpoint")
        ckpt_wire = dict(ckpt_wire)
        kv_wire = dict(entry["header"], layers=entry["layers"])
        kv_wire.pop("num_layers", None)
        ckpt_wire["kv"] = kv_wire
        try:
            # The strict checkpoint decoder validates everything — header
            # ranges, per-layer shape / byte agreement, page coverage —
            # exactly as for an inline rpc_checkpoint frame.
            ckpt = checkpoint_from_wire(ckpt_wire)
        except CheckpointError as e:
            return ("error", str(e))
        if self.stats is not None:
            ms = (time.monotonic() - entry["t0"]) * 1e3
            self.stats.record_transfer(
                "in", frames=entry["frames"], nbytes=entry["bytes"], ms=ms)
            self.stats.note(ckpt.request_id, assemble_ms=ms)
        return ("done", ckpt)

    def sweep(self) -> list[tuple[str, str]]:
        """Discard transfers whose deadline passed (orphaned by a dead
        source or a failed lane). Returns ``[(rid, peer), ...]`` — the
        request itself recovers through the source's result timeout or
        the client resume ladder."""
        now = time.monotonic()
        out: list[tuple[str, str]] = []
        with self._lock:
            for rid in [
                r for r, e in self._partial.items() if now > e["deadline"]
            ]:
                e = self._partial.pop(rid)
                out.append((rid, e["peer"]))
        for rid, peer in out:
            logger.warning(
                "kv handoff: transfer of %s from %s abandoned mid-flight "
                "(no end frame within %.0fs); partial state discarded",
                rid, peer, self.timeout_s,
            )
            if self.stats is not None:
                self.stats.record_fallback("transfer_abandoned")
        return out


# -- checkpoint helper -------------------------------------------------------


def handoff_checkpoint(
    req, routing_table: list[str], kv: KVImage | None,
    grammar: tuple[int, str] | None = None,
) -> RequestCheckpoint:
    """A :class:`RequestCheckpoint` marked as a planned handoff (the target
    counts it among handoffs, not migrations). ``grammar`` is the
    (dfa_state, grammar_hash) pair the park read before ``extract``; the
    JAX helper takes none, and its decode head recomputes the DFA state
    from the stream."""
    ckpt = checkpoint_from_request(req, routing_table=routing_table, kv=kv,
                                   grammar=grammar)
    ckpt.handoff = True
    return ckpt
