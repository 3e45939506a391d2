"""Per-node serving state and the roofline performance model (port of
``parallax_tpu/scheduling/node.py``).

Capability parity: reference ``src/scheduling/node.py:24-427`` (Node,
NodeHardwareInfo, RooflinePerformanceModel: per-layer latency =
max(compute, IO) with embed/lm_head terms; KV-derived request capacity;
measured-latency override; RTT cache), with the scheduler HA codec of
``CacheIndex`` (``export`` / ``adopt``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

from parallax_tpu_torch.analysis.sanitizer import make_lock
from parallax_tpu_torch.config import ModelConfig
from parallax_tpu_torch.utils.hw import HardwareInfo

# Capacity-model constants: fraction of device memory treated as usable,
# and the slice of that reserved for KV.
HBM_UTILIZATION = 0.92
KV_RESERVE_FRACTION = 0.35


@dataclasses.dataclass
class RooflinePerformanceModel:
    """Estimates per-layer decode latency on a node from peak specs."""

    hardware: HardwareInfo
    model: ModelConfig

    def layer_latency_ms(self, batch_size: int = 1, context_len: int = 1024) -> float:
        flops = self.model.decoder_layer_flops(batch_size, context_len)
        # Decode streams the layer's params + the batch's KV for this layer.
        param_bytes = (
            self.model.decoder_layer_params(0)
            * self.model.param_bytes_per_element
        )
        kv_bytes = (
            self.model.kv_bytes_per_token_per_layer() * context_len * batch_size
        )
        compute_s = flops / (self.hardware.total_tflops * 1e12)
        io_s = (param_bytes + kv_bytes) / (
            self.hardware.hbm_gbps * self.hardware.num_chips * 1e9
        )
        return max(compute_s, io_s) * 1e3

    def lm_head_latency_ms(self, batch_size: int = 1) -> float:
        flops = self.model.lm_head_flops(batch_size)
        bytes_ = (
            self.model.embedding_params() * self.model.param_bytes_per_element
        )
        return max(
            flops / (self.hardware.total_tflops * 1e12),
            bytes_ / (self.hardware.hbm_gbps * self.hardware.num_chips * 1e9),
        ) * 1e3

    def max_layers_in_memory(
        self, kv_fraction: float = KV_RESERVE_FRACTION
    ) -> int:
        """How many decoder layers fit in device memory, reserving a KV
        budget."""
        usable = (
            self.hardware.total_hbm_bytes * HBM_UTILIZATION
            * (1 - kv_fraction)
        )
        per_layer = (
            self.model.decoder_layer_params(0)
            * self.model.param_bytes_per_element
        )
        return max(1, int(usable // per_layer))


class CacheIndex:
    """Scheduler-side mirror of one head node's prefix-cache digests.

    Fed by heartbeat deltas (``RadixPageCache.digest_payload``), bounded
    LRU, staleness-decayed. Digest membership implies the whole prefix
    path exists on the worker (tree nodes always have ancestors), so the
    deepest chain hit IS the predicted cached page count. Rebuilt from a
    full snapshot whenever the delta sequence breaks (node rejoin, engine
    reload, scheduler restart) — the worker is asked for a resync via the
    next heartbeat reply.
    """

    def __init__(self, max_entries: int = 65536, stale_after_s: float = 30.0):
        self.max_entries = max_entries
        self.stale_after_s = stale_after_s
        # Digest set with LRU ordering (values unused). The scheduler's
        # event thread applies deltas while the dispatch thread predicts:
        # every entry access takes the lock.
        self._entries: OrderedDict[int, int] = OrderedDict()
        self._lock = make_lock("scheduling.cache_index")
        self.block = 0           # the worker's page size (digest granularity)
        self.seq = -1            # last applied heartbeat sequence number
        self.updated_at = 0.0    # monotonic time of the last apply

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.block = 0
            self.seq = -1

    def apply(self, payload: dict) -> bool:
        """Merge one heartbeat digest payload. Returns True when the
        payload could not be applied in sequence and the worker must be
        asked for a full snapshot (``digests_resync``)."""
        seq = payload.get("seq")
        block = payload.get("block")
        if not isinstance(seq, int) or not isinstance(block, int) or block <= 0:
            return True
        full = payload.get("full")
        if full is not None:
            with self._lock:
                self._entries = OrderedDict((int(d), 0) for d in full)
                self.block = block
                self.seq = seq
                self.updated_at = time.monotonic()
                self._trim()
            return False
        if seq != self.seq + 1 or block != self.block:
            # Missed a delta (dropped heartbeat, worker restart) or the
            # worker changed page size: drop the mirror and request a
            # snapshot rather than route on fiction.
            self.clear()
            return True
        with self._lock:
            for d in payload.get("removed") or ():
                self._entries.pop(int(d), None)
            for d in payload.get("added") or ():
                self._entries[int(d)] = 0
                self._entries.move_to_end(int(d))
            self.seq = seq
            self.updated_at = time.monotonic()
            self._trim()
        return False

    def _trim(self) -> None:
        # Caller holds the lock.
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def export(self) -> dict:
        """HA snapshot codec (``ha/journal.py``): the digest set in LRU
        order plus the delta cursor, with the staleness clock shipped as
        an AGE (the standby's monotonic clock is not ours)."""
        with self._lock:
            return {
                "entries": list(self._entries),
                "block": self.block,
                "seq": self.seq,
                "age_s": (
                    max(0.0, time.monotonic() - self.updated_at)
                    if self._entries else None
                ),
            }

    def adopt(self, snap: dict) -> None:
        """Restore an :meth:`export` payload, re-anchoring the staleness
        clock on the local monotonic clock. The delta cursor carries
        over so the worker's NEXT in-sequence delta applies cleanly — a
        promotion alone must not force a digest resync."""
        entries = snap.get("entries") or ()
        age = snap.get("age_s")
        with self._lock:
            self._entries = OrderedDict((int(d), 0) for d in entries)
            self.block = int(snap.get("block") or 0)
            self.seq = int(snap.get("seq", -1))
            self.updated_at = (
                time.monotonic() - float(age) if age is not None else 0.0
            )
            self._trim()

    def confidence(self) -> float:
        """1.0 while heartbeats flow (anything fresher than half the
        staleness horizon), then decaying linearly to 0.0 at
        ``stale_after_s``: a worker that stopped publishing must stop
        attracting traffic on the strength of a stale mirror.
        Step-shaped so steady-state predictions are exact."""
        with self._lock:
            if not self._entries:
                return 0.0
        age = time.monotonic() - self.updated_at
        if age <= self.stale_after_s / 2:
            return 1.0
        return max(0.0, 2.0 * (1.0 - age / self.stale_after_s))

    def predict_cached_tokens(self, chain: list[int], block: int,
                              num_prompt_tokens: int) -> int:
        """Predicted prefix-cache hit (tokens) for a prompt whose rolling
        block-hash chain is ``chain`` at granularity ``block``. Walks the
        chain deepest-first; the first digest present in the mirror gives
        the hit depth. Staleness-decayed (see :meth:`confidence`)."""
        if not chain or block != self.block:
            return 0
        # The engine always recomputes >= 1 prompt token, so a full-prompt
        # match is capped one page short (mirrors allocate_for_prompt).
        max_pages = min(len(chain), (num_prompt_tokens - 1) // block)
        hit = 0
        with self._lock:
            for depth in range(max_pages, 0, -1):
                if chain[depth - 1] in self._entries:
                    self._entries.move_to_end(chain[depth - 1])
                    hit = depth * block
                    break
        return round(hit * self.confidence()) if hit else 0


@dataclasses.dataclass
class Node:
    """A swarm member as the global scheduler sees it. The payload fields
    of planes the port does not run yet (step timing, speculation,
    constrained decoding, goodput, device attribution, health) keep their
    JAX names and stay None unless a JAX worker's heartbeat fills them."""

    node_id: str
    hardware: HardwareInfo
    model: ModelConfig
    start_layer: int = -1
    end_layer: int = -1
    # In-flight requests routed through this node.
    load: int = 0
    # Measured per-layer decode latency EWMA from heartbeats (overrides
    # roofline when present; reference node.py:378-387).
    measured_layer_latency_ms: float | None = None
    # Per-request LoRA adapters this node can serve (heartbeat-reported).
    lora_adapters: tuple = ()
    # RTT cache to peers, node_id -> seconds.
    rtt_s: dict[str, float] = dataclasses.field(default_factory=dict)
    last_heartbeat: float = dataclasses.field(default_factory=time.monotonic)
    # Weight-refit version currently loaded.
    refit_version: int = 0
    # True once the node reports its executor is serving.
    is_ready: bool = False
    step_timing: dict | None = None
    # Prefix-cache counters from heartbeats; surfaced in /cluster/status.
    cache_stats: dict | None = None
    # Attention-kernel dispatch summary from heartbeats (active impl +
    # per-path counts); surfaced in /cluster/status so a silent kernel
    # fallback is operator-visible.
    kernel: dict | None = None
    spec: dict | None = None
    constrained: dict | None = None
    # Per-link activation-transport telemetry from heartbeats.
    transport: dict | None = None
    # Wire-format capability list from node_join (dtype names this
    # node's build can decode on activation frames).
    wire_formats: tuple = ()
    # Phase specialization from node_join: "prefill" nodes compute prompts
    # and hand finished requests to the decode pool over the KV-transfer
    # lane; "decode" nodes run the decode phase the prompt phase never
    # interrupts; "mixed" (the default) serves both phases. The allocator
    # keeps pipelines role-homogeneous, and routing restricts the prompt
    # phase to prefill / mixed pools.
    role: str = "mixed"
    # Prefix-digest mirror for cache-aware routing (fed by heartbeat
    # ``cache_digests`` payloads; only head-stage digests matter).
    cache_index: CacheIndex = dataclasses.field(default_factory=CacheIndex)
    # Set when a digest delta arrived out of sequence: the next heartbeat
    # reply asks the worker for a full snapshot.
    digests_need_resync: bool = False
    # Dead peer ids whose in-flight requests this HEAD must give up,
    # pending for the node's next heartbeat reply (``drain``).
    pending_drain: set = dataclasses.field(default_factory=set)
    # Last heartbeat reported an in-progress engine reload: the sweep
    # multiplies this node's grace so a loading worker is never declared
    # dead.
    reported_busy: bool = False
    # A peer's async sender declared this node unreachable: its
    # CacheIndex was cleared and the sweep shortens its grace. Reset by
    # the next heartbeat.
    peer_down_at: float | None = None
    # Past the base heartbeat timeout but inside the busy-probation
    # extended grace (surfaced in /cluster/status).
    suspect: bool = False
    goodput: dict | None = None
    device: dict | None = None
    health: dict | None = None

    def __post_init__(self):
        self.perf = RooflinePerformanceModel(self.hardware, self.model)

    # -- layers -----------------------------------------------------------

    @property
    def has_allocation(self) -> bool:
        return 0 <= self.start_layer < self.end_layer

    @property
    def num_layers(self) -> int:
        return max(0, self.end_layer - self.start_layer)

    @property
    def is_first_stage(self) -> bool:
        return self.start_layer == 0

    @property
    def is_last_stage(self) -> bool:
        return self.end_layer == self.model.num_hidden_layers

    def set_layers(self, start: int, end: int) -> None:
        self.start_layer, self.end_layer = start, end

    def clear_layers(self) -> None:
        self.start_layer = self.end_layer = -1

    # -- capacity ---------------------------------------------------------

    def layer_capacity(self) -> int:
        """Max decoder layers this node can host (memory-bound)."""
        cap = self.perf.max_layers_in_memory()
        return min(cap, self.model.num_hidden_layers)

    def max_concurrent_requests(self, avg_context: int = 2048) -> int:
        """KV-budget-derived admission cap (reference node.py:212-246)."""
        layers = self.num_layers or 1
        kv_budget = (
            self.hardware.total_hbm_bytes * HBM_UTILIZATION
            * KV_RESERVE_FRACTION
        )
        per_req = (
            self.model.kv_bytes_per_token_per_layer() * avg_context * layers
        )
        return max(1, int(kv_budget // per_req))

    # -- latency ----------------------------------------------------------

    def layer_latency_ms(self, batch_size: int = 8) -> float:
        base = (
            self.measured_layer_latency_ms
            if self.measured_layer_latency_ms is not None
            else self.perf.layer_latency_ms(batch_size)
        )
        # Load compensation (reference: +0.05 * load fraction).
        cap = self.max_concurrent_requests()
        return base * (1.0 + 0.05 * min(1.0, self.load / cap))

    def stage_latency_ms(self, batch_size: int = 8) -> float:
        lat = self.num_layers * self.layer_latency_ms(batch_size)
        if self.is_last_stage:
            lat += self.perf.lm_head_latency_ms(batch_size)
        return lat

    def rtt_to(self, other_id: str) -> float:
        return self.rtt_s.get(other_id, 0.03)

    # -- liveness ---------------------------------------------------------

    def touch(self) -> None:
        self.last_heartbeat = time.monotonic()

    def is_stale(self, timeout_s: float) -> bool:
        return time.monotonic() - self.last_heartbeat > timeout_s
