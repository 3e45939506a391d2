"""KV cache orchestration: page ownership, prefix reuse, memory budgeting.

A copy of the Python ``CacheManager`` in ``parallax_tpu/runtime/
cache_manager.py``: radix prefix matching, pinning, eviction under pressure,
prefix-aware chunk skipping and donation on release, the routing digests
(``track_digests`` / ``digest_payload``, the delta log of cache-aware
routing), and the host-DRAM tier (``runtime/host_cache.py``): radix
eviction demotes pages to host memory, a prefix hit on a host-resident node
swaps it back in before admission, a decode short of pages preempts a
request's KV image to host (``preempt_to_host`` / ``resume_from_host``),
and a migrated-in image is adopted as if preempted here
(``adopt_migrated``). Host-tier transfers accrue their host seconds to
the goodput ledger's ``swap`` bucket and the device plane's
``swap_gather`` / ``swap_scatter`` programs, and an admission swap-in
leaves a flight event (and a span for a traced request).
``make_cache_manager`` returns the native C++
manager (``parallax_tpu_torch/native``) by default and this class under the
JAX factory's gates. Hybrid (linear-attention) models prefix-cache through
linear-state snapshots (``linear_state``): a match is cut to the deepest
node carrying a snapshot slot, which the request restores from
(``restore_state_from``), and a released request's snapshots attach to the
tree. A LoRA request's token stream is XOR-salted per adapter
(``ns_tokens``) at every radix lookup and insert, so tenants never share
pages.

Ownership model: every device page has one owner — an in-flight request or
the radix tree. Prefix-cache hits share tree-owned pages read-only, pinned
via lock refs for the request's lifetime.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time

from parallax_tpu_torch.config import ModelConfig
from parallax_tpu_torch.runtime.allocator import OutOfPages, PageAllocator
from parallax_tpu_torch.runtime.radix_cache import RadixPageCache
from parallax_tpu_torch.runtime.request import Request
from parallax_tpu_torch.utils.request_metrics import CacheStats

logger = logging.getLogger(__name__)


def kv_bytes_per_page(
    config: ModelConfig, num_local_layers: int, page_size: int, dtype_bytes: int = 2
) -> int:
    """Device bytes one page occupies across this shard's attention layers.

    Uses the config's per-token accounting, which covers MLA latent+rope
    and the DSA index-key cache.
    """
    per_token = config.kv_bytes_per_token_per_layer() * dtype_bytes // 2
    return per_token * page_size * num_local_layers


def derive_num_pages(
    free_bytes: int,
    config: ModelConfig,
    num_local_layers: int,
    page_size: int,
    utilization: float = 0.9,
    dtype_bytes: int = 2,
) -> int:
    """KV page budget from free device memory."""
    per_page = kv_bytes_per_page(config, num_local_layers, page_size, dtype_bytes)
    return max(8, int(free_bytes * utilization) // per_page)


def make_cache_manager(
    page_size: int,
    num_pages: int,
    enable_prefix_cache: bool = True,
    max_model_len: int = 32768,
    prefill_chunk_skip: bool = True,
    track_digests: bool = False,
    host_tier=None,
    use_native: bool | None = None,
    linear_state: bool = False,
    on_slot_free=None,
):
    """CacheManager factory, with the JAX factory's gates line for line:
    the C++ manager (``native.NativeCacheManager``, one ABI crossing per
    admit / grow / release) by default; the Python manager with a
    ``host_tier`` (tier residency lives on radix nodes and in the
    preemption bookkeeping), with ``track_digests`` (the digest delta log
    lives on the Python radix nodes), with ``prefill_chunk_skip=False``
    (only the Python manager keeps inserting while declining reuse) or with
    ``PARALLAX_TPU_NO_NATIVE`` set. ``use_native=None`` falls back quietly
    (a warning) when the library does not build; an explicit
    ``use_native=True`` raises then."""
    explicit = use_native is True
    if use_native is None:
        use_native = (
            not os.environ.get("PARALLAX_TPU_NO_NATIVE")
            and host_tier is None
            and not track_digests
        )
    if track_digests and use_native:
        logger.info(
            "prefix-digest publishing requested: using the Python cache "
            "manager (the native tree does not expose per-node evictions)"
        )
        use_native = False
    if not prefill_chunk_skip and use_native:
        logger.info(
            "prefill chunk skipping disabled: using the Python cache "
            "manager (radix inserts still populate, admission reuse off)"
        )
        use_native = False
    if host_tier is not None and not os.environ.get("PARALLAX_TPU_NO_NATIVE"):
        logger.info(
            "host KV tier enabled: using the Python cache manager "
            "(the native manager does not model tier residency)"
        )
    if use_native and host_tier is None:
        from parallax_tpu_torch import native

        if native.native_available():
            return native.NativeCacheManager(
                page_size, num_pages,
                enable_prefix_cache=enable_prefix_cache,
                max_model_len=max_model_len,
                linear_state=linear_state,
                on_slot_free=on_slot_free,
            )
        reason = native.build_error or "PARALLAX_TPU_NO_NATIVE is set"
        if explicit:
            raise RuntimeError("use_native=True: the native cache library "
                               f"is unavailable ({reason})")
        logger.warning("native cache unavailable: %s", reason)
    return CacheManager(
        page_size, num_pages, enable_prefix_cache=enable_prefix_cache,
        max_model_len=max_model_len, prefill_chunk_skip=prefill_chunk_skip,
        track_digests=track_digests, host_tier=host_tier,
        linear_state=linear_state, on_slot_free=on_slot_free,
    )


_NS_SECRET_NOTED = False


def derive_ns_salt(lora_id: str) -> int:
    """Deterministic 31-bit prefix-cache namespace salt for one adapter:
    ``blake2s(secret + adapter id)``, never 0 (an all-zero salt would alias
    the base namespace). A copy of the JAX package's: every replica salts
    the same adapter identically, and ``PARALLAX_NS_SECRET`` (the same
    value cluster-wide) makes the namespaces unguessable."""
    import hashlib

    secret = os.environ.get("PARALLAX_NS_SECRET", "")
    global _NS_SECRET_NOTED
    if not _NS_SECRET_NOTED:
        _NS_SECRET_NOTED = True
        if not secret:
            logger.info(
                "adapter prefix-cache namespaces derived without "
                "PARALLAX_NS_SECRET: deterministic and distinct per "
                "adapter, but computable by anyone who knows the adapter id"
            )
    digest = hashlib.blake2s(
        f"{secret}:{lora_id}".encode("utf-8", "surrogatepass")
    ).digest()
    return (int.from_bytes(digest[:4], "little") & 0x7FFFFFFF) or 1


def ns_salt(salts: dict[str, int], lora_id: str | None) -> int | None:
    """Memoized per-adapter namespace salt (see ``derive_ns_salt``): KV
    contents depend on the LoRA adapter, so tenants must never prefix-hit
    each other's pages; XOR-salting the token stream keeps its length."""
    if lora_id is None:
        return None
    salt = salts.get(lora_id)
    if salt is None:
        salt = salts[lora_id] = derive_ns_salt(lora_id)
    return salt


def ns_tokens(salts: dict[str, int], token_ids: list[int],
              lora_id: str | None) -> list[int]:
    """Namespace a token stream per LoRA adapter (see ``ns_salt``)."""
    salt = ns_salt(salts, lora_id)
    if salt is None:
        return token_ids
    return [t ^ salt for t in token_ids]


class CacheManager:
    """Host-side paged-KV bookkeeping for one pipeline stage."""

    def __init__(
        self,
        page_size: int,
        num_pages: int,
        enable_prefix_cache: bool = True,
        max_model_len: int = 32768,
        prefill_chunk_skip: bool = True,
        track_digests: bool = False,
        host_tier=None,
        linear_state: bool = False,
        on_slot_free=None,
    ):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_model_len = max_model_len
        self.enable_prefix_cache = enable_prefix_cache
        # False keeps the radix tree populating on release but admission
        # and mid-prefill planning stop REUSING matches.
        self.prefill_chunk_skip = prefill_chunk_skip
        # Host-DRAM second tier (runtime/host_cache.py): radix eviction
        # demotes pages into it, matches can hit host-resident nodes
        # (swap-in before admission), and decode OOM preempts whole
        # requests into it instead of aborting.
        self.host_tier = host_tier
        # Hybrid models: a prefix hit also needs a linear-state snapshot at
        # the skip boundary; matches truncate to the deepest slot-carrying
        # node and the snapshot's slot is surfaced on the request as
        # ``restore_state_from``. ``on_slot_free`` returns a snapshot slot
        # the tree dropped (or never took) to the engine's pool.
        self.linear_state = linear_state
        self.on_slot_free = on_slot_free
        self.allocator = PageAllocator(num_pages)
        self._track_digests = track_digests and enable_prefix_cache
        self.prefix_cache = self._new_tree()
        self.stats = CacheStats()
        # rid -> (locked node path, number of shared tree-owned pages)
        self._locked: dict[str, tuple] = {}
        # rid -> the retired tree its pages and lock belong to: requests
        # that held pages when a refit invalidated the prefix cache
        # (``invalidate_prefix_cache``). Their KV is the old weights', so
        # they release into nothing.
        self._stale: dict[str, RadixPageCache] = {}
        # Per-adapter prefix-cache namespaces (``ns_tokens``).
        self._ns_salts: dict[str, int] = {}

    def _new_tree(self) -> RadixPageCache:
        tier = self.host_tier
        tree = RadixPageCache(
            self.page_size, on_evict_slot=self.on_slot_free,
            host_free=(lambda h: tier.pool.free(h)) if tier is not None
            else None,
            track_digests=self._track_digests)
        if tier is not None:
            tier.set_evict_cb(tree.drop_host_page)
        return tree

    def _ns_tokens(self, token_ids: list[int], lora_id: str | None):
        return ns_tokens(self._ns_salts, token_ids, lora_id)

    # -- capacity ---------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return self.allocator.num_free

    def pages_needed(self, num_tokens: int) -> int:
        return math.ceil(num_tokens / self.page_size)

    def _reclaim(self, need: int) -> bool:
        """Free pages from the prefix cache until ``need`` are available.

        With a host tier attached, evicted pages demote into it (one
        batched D2H) instead of losing their KV; prefix reuse then extends
        past device capacity. A demotion that fails raises once the
        detached victims' pages are back in the allocator (the radix tree
        has dropped them by then): no transfer fault is hidden."""
        if self.allocator.num_free >= need:
            return True
        deficit = need - self.allocator.num_free
        demoter = None
        failure: list[BaseException] = []
        if self.host_tier is not None:
            def demoter(ids, _tier=self.host_tier):
                # Partial mode: evict() orders victims coldest-first, so
                # the kept suffix is the warmest, ancestor-closed subset.
                try:
                    return _tier.demote(ids, partial=True)
                except BaseException as e:
                    failure.append(e)
                    raise
        freed = self.prefix_cache.evict(deficit, demoter=demoter)
        self.allocator.free(freed)
        self.stats.pages_evicted += len(freed)
        if failure:
            raise failure[0]
        return self.allocator.num_free >= need

    # -- request lifecycle ------------------------------------------------

    def allocate_for_prompt(self, request: Request) -> bool:
        """Admit a request: prefix-match, pin, allocate the rest.

        Sets ``request.page_ids`` / ``num_cached_tokens`` /
        ``num_computed_tokens``. Returns False (no side effects) when memory
        is insufficient even after eviction.
        """
        prompt_len = request.num_prompt_tokens
        shared_pages: list[int] = []
        path: list = []
        if self.linear_state and hasattr(request, "restore_state_from"):
            del request.restore_state_from  # stale from a failed admit
        if (
            self.enable_prefix_cache
            and self.prefill_chunk_skip
            and prompt_len > 1
        ):
            pages, full_path = self.prefix_cache.match_prefix(
                self._ns_tokens(request.prompt_ids, request.lora_id))
            # Always leave >=1 prompt token to recompute so the stage emits a
            # hidden state for sampling.
            usable = min(len(pages), (prompt_len - 1) // self.page_size)
            if self.linear_state:
                # Mirror stages skip exactly what the head skipped, so a
                # longer local match cannot put the recurrence ahead of
                # the rows about to arrive.
                head_cached = getattr(request, "mirror_head_cached", None)
                if head_cached is not None:
                    usable = min(usable, head_cached // self.page_size)
                usable = self.prefix_cache.deepest_linear_slot(
                    full_path, usable)
                if usable:
                    request.restore_state_from = (
                        full_path[usable - 1].linear_slot)
            shared_pages = pages[:usable]
            path = self.prefix_cache.slice_path(full_path, usable)

        fresh_needed = self.pages_needed(prompt_len) - len(shared_pages)
        # Host-resident nodes in the matched path need a device page each
        # (swap-in) on top of the fresh tail.
        host_nodes = [n for n in path if not n.on_device]
        # Pin the matched prefix BEFORE any eviction: reclaiming first could
        # evict the matched nodes and hand their pages back out as this
        # very request's fresh pages. The pin also shields host-resident
        # nodes from the host pool's own watermark eviction meanwhile.
        self.prefix_cache.lock(path)
        if not self._reclaim(fresh_needed + len(host_nodes)):
            self.prefix_cache.unlock(path)
            return False
        try:
            fresh = self.allocator.alloc(fresh_needed + len(host_nodes))
        except OutOfPages:
            self.prefix_cache.unlock(path)
            return False
        if host_nodes:
            # H2D scatter of the host-tier hits; the nodes are then
            # ordinary device-resident tree pages shared with this request.
            t_swap = time.perf_counter()
            swap_pages = fresh[:len(host_nodes)]
            fresh = fresh[len(host_nodes):]
            handles = [
                self.prefix_cache.promote_node(n, p)
                for n, p in zip(host_nodes, swap_pages)
            ]
            self.host_tier.promote(handles, swap_pages)
            shared_pages = [n.page_id for n in path]
            dur = time.perf_counter() - t_swap
            from parallax_tpu_torch.obs.flight import get_flight
            from parallax_tpu_torch.obs.trace import get_trace_store

            self._goodput_swap(dur)
            get_flight().event(
                "swap_in", request_id=request.request_id,
                pages=len(host_nodes), ms=round(dur * 1e3, 3),
            )
            if request.traced:
                get_trace_store().add(
                    request.request_id, "cache", "swap_in",
                    t0=t_swap, dur=dur, args={"pages": len(host_nodes)},
                )
        request.page_ids = shared_pages + fresh
        request.num_cached_tokens = len(shared_pages) * self.page_size
        request.num_computed_tokens = request.num_cached_tokens
        self._locked[request.request_id] = (path, len(shared_pages))
        self.stats.tokens_admitted += prompt_len
        self.stats.tokens_hit_host += len(host_nodes) * self.page_size
        self.stats.tokens_hit_device += (
            request.num_cached_tokens - len(host_nodes) * self.page_size
        )
        return True

    def extend_prefix_match(self, request: Request) -> int:
        """Mid-prefill chunk skipping: re-consult the radix tree before a
        request's FIRST chunk and grow its shared prefix if a donor
        finished (and inserted) after this request was admitted. Callers
        only invoke this while ``num_computed_tokens == num_cached_tokens``.
        Returns the number of newly skipped tokens. Never allocates."""
        if not (self.enable_prefix_cache and self.prefill_chunk_skip):
            return 0
        if self.linear_state or request.request_id in self._stale:
            # A linear-state skip needs the snapshot wired at the skip
            # boundary (restore_state_from), which only the admission match
            # sets up; a request admitted before a refit holds a retired
            # tree's path.
            return 0
        if getattr(request, "mirror_head_cached", None) is not None:
            # Mirror stages may only skip what the head skipped: rows
            # before the head's boundary never arrive.
            return 0
        entry = self._locked.get(request.request_id)
        if entry is None:
            return 0
        old_path, num_shared = entry
        prompt_len = request.num_prompt_tokens
        if prompt_len <= 1:
            return 0
        pages, full_path = self.prefix_cache.match_prefix(
            self._ns_tokens(request.prompt_ids, request.lora_id))
        usable = min(len(pages), (prompt_len - 1) // self.page_size)
        # Host-resident nodes in the extension would need a swap-in
        # allocation; truncate the growth at the first one (the admission
        # path owns swap-in).
        new_path = self.prefix_cache.slice_path(full_path, usable)
        for i, node in enumerate(new_path[num_shared:], start=num_shared):
            if not node.on_device:
                usable = i
                new_path = self.prefix_cache.slice_path(full_path, usable)
                break
        if usable <= num_shared:
            return 0
        new_shared = pages[:usable]
        if new_shared[:num_shared] != request.page_ids[:num_shared]:
            return 0
        # Lock the longer path before unlocking the old one so shared
        # ancestors never drop to zero refs in between.
        self.prefix_cache.lock(new_path)
        self.prefix_cache.unlock(old_path)
        self.allocator.free(request.page_ids[num_shared:usable])
        request.page_ids = new_shared + request.page_ids[usable:]
        request.num_cached_tokens = usable * self.page_size
        request.num_computed_tokens = usable * self.page_size
        self._locked[request.request_id] = (new_path, usable)
        skipped = (usable - num_shared) * self.page_size
        self.stats.tokens_hit_device += skipped
        self.stats.tokens_chunk_skipped += skipped
        return skipped

    def ensure_capacity(self, request: Request, new_total_tokens: int) -> bool:
        """Grow the page list to cover ``new_total_tokens`` (decode append)."""
        need = self.pages_needed(new_total_tokens) - len(request.page_ids)
        if need <= 0:
            return True
        if not self._reclaim(need):
            return False
        try:
            request.page_ids.extend(self.allocator.alloc(need))
        except OutOfPages:
            return False
        return True

    def trim_uncomputed_pages(self, request: Request) -> int:
        """Free a mid-prefill request's owned pages past its computed
        span. ``allocate_for_prompt`` allocates the WHOLE prompt's pages
        upfront, so a request parked mid-prefill owns pages holding no KV
        yet; an image that demoted them would ship garbage and overrun the
        checkpoint's bound (one page of slack past the computed tokens).
        The prefill chunk loop re-grows the list through
        ``ensure_capacity`` after resume. Returns the number of pages
        freed."""
        keep = max(
            self.pages_needed(request.num_computed_tokens),
            self._locked.get(request.request_id, ([], 0))[1],
        )
        tail = request.page_ids[keep:]
        if not tail:
            return 0
        self.allocator.free(tail)
        del request.page_ids[keep:]
        return len(tail)

    # -- preemption (decode OOM -> host tier, not abort) ------------------

    def preempt_to_host(self, request: Request) -> bool:
        """Park a running request's KV in the host tier (pinned — losing
        it would corrupt the resumed stream) and free its device pages.

        The shared prefix stays tree-owned and LOCKED on device (the
        ``_locked`` entry survives preemption), so only the request's own
        pages move. False (no side effects) when the tier is absent or
        cannot hold the image — the caller then falls back to abort.
        """
        if self.host_tier is None:
            return False
        _path, num_shared = self._locked.get(request.request_id, ([], 0))
        owned = request.page_ids[num_shared:]
        if not owned:
            return False   # nothing to reclaim; preemption is pointless
        t_swap = time.perf_counter()
        handles = self.host_tier.demote(owned, pinned=True)
        if handles is None:
            return False
        request.host_page_handles = handles  # type: ignore[attr-defined]
        self.allocator.free(owned)
        del request.page_ids[num_shared:]
        self.stats.preemptions += 1
        self._goodput_swap(time.perf_counter() - t_swap, "swap_gather")
        return True

    def shared_prefix_tokens(self, request_id: str) -> int:
        """Tokens of the request's context covered by LOCKED tree-shared
        pages (the part a preemption image does NOT carry)."""
        _path, num_shared = self._locked.get(request_id, ([], 0))
        return num_shared * self.page_size

    def adopt_migrated(
        self, request: Request, handles: list[int], prefix_tokens: int
    ) -> bool:
        """Register a migrated-in request's host-parked KV image as if THIS
        manager had preempted it: lock a radix path covering exactly
        ``prefix_tokens`` (the image starts right after them) and attach
        the pinned handles; the request then resumes through the ordinary
        ``resume_from_host`` admission. False (no side effects — the caller
        frees the handles and falls back to re-prefill) when the local
        radix does not cover the prefix with device-resident pages."""
        pages_prefix = prefix_tokens // self.page_size
        path: list = []
        shared: list[int] = []
        if pages_prefix:
            if not self.enable_prefix_cache:
                return False
            pages, full_path = self.prefix_cache.match_prefix(
                self._ns_tokens(request.prompt_ids, request.lora_id))
            if len(pages) < pages_prefix:
                return False
            path = self.prefix_cache.slice_path(full_path, pages_prefix)
            if any(not n.on_device for n in path):
                # Host-resident twins would need their own swap-in
                # orchestration; re-prefill is simpler and always right.
                return False
            shared = pages[:pages_prefix]
            self.prefix_cache.lock(path)
        request.page_ids = list(shared)
        request.host_page_handles = list(handles)  # type: ignore[attr-defined]
        self._locked[request.request_id] = (path, len(shared))
        request.num_cached_tokens = prefix_tokens
        self.stats.tokens_hit_device += prefix_tokens
        return True

    def resume_from_host(self, request: Request) -> bool:
        """Swap a preempted request's KV image back into fresh device
        pages. False (request stays parked) when pages are still short."""
        handles = getattr(request, "host_page_handles", None)
        if handles is None:
            return True
        if not self._reclaim(len(handles)):
            return False
        t_swap = time.perf_counter()
        try:
            fresh = self.allocator.alloc(len(handles))
        except OutOfPages:
            return False
        self.host_tier.promote(handles, fresh)
        request.page_ids.extend(fresh)
        del request.host_page_handles
        self.stats.resumes += 1
        self._goodput_swap(time.perf_counter() - t_swap)
        return True

    @staticmethod
    def _goodput_swap(seconds: float, program: str = "swap_scatter") -> None:
        """Accrue a host <-> device KV transfer's host seconds to the
        goodput ledger's ``swap`` bucket and the device plane's program
        split: ``swap_gather`` is device -> host (a preemption park),
        ``swap_scatter`` host -> device (a resume or admission swap-in).
        Never raises."""
        try:
            from parallax_tpu_torch.obs.device import get_device_plane
            from parallax_tpu_torch.obs.goodput import get_goodput

            get_goodput().add_time("swap", seconds)
            get_device_plane().time.add(program, seconds)
        except Exception:  # pragma: no cover - obs only
            pass

    def release(self, request: Request) -> None:
        """Return a finished/aborted request's pages.

        Full pages of the final COMPUTED context are donated to the prefix
        cache; duplicates and the ragged tail are freed. A request released
        while preempted (timeout, abort, a migration park) frees its parked
        host image too.
        """
        handles = getattr(request, "host_page_handles", None)
        if handles is not None:
            self.host_tier.free(handles)
            del request.host_page_handles
        path, num_shared = self._locked.pop(request.request_id, ([], 0))
        stale = self._stale.pop(request.request_id, None)
        (self.prefix_cache if stale is None else stale).unlock(path)
        # Hybrid models: the engine copied the request's linear state into
        # snapshot slots at page boundaries ((length, slot) per kind); each
        # attaches to the radix node at exactly its boundary, so a later
        # prefix hit resumes the recurrence there. An unattachable one (an
        # aborted request, a missing node, a boundary already covered)
        # goes back to the engine's pool.
        snapshots = list(getattr(request, "state_snapshots", {}).values())
        if hasattr(request, "state_snapshots"):
            del request.state_snapshots
        owned = request.page_ids[num_shared:]
        if stale is not None:
            # Admitted before a refit: its KV is the old weights', so
            # nothing is donated, and the retired tree drops whatever no
            # other request still holds.
            self._free_slots(s for _, s in snapshots)
            self.allocator.free(owned)
            self.allocator.free(stale.drop_unlocked())
            request.page_ids = []
            return
        if not owned:
            self._free_slots(s for _, s in snapshots)
            request.page_ids = []
            return
        if self.enable_prefix_cache and request.status.value != "finished_abort":
            # The final sampled token never runs a forward step, so only
            # pages fully covered by computed KV may be donated.
            computed = min(request.num_computed_tokens, len(request.all_token_ids))
            n_full = computed // self.page_size
            tail = owned[max(0, n_full - num_shared):]
            duplicates = self.prefix_cache.insert(
                self._ns_tokens(request.all_token_ids[: n_full * self.page_size],
                                request.lora_id),
                request.page_ids[:n_full],
            )
            self.allocator.free(duplicates + tail)
            self._free_slots(
                slot for length, slot in snapshots
                if not (length <= n_full * self.page_size
                        and self.prefix_cache.attach_linear_slot(
                            self._ns_tokens(request.all_token_ids[:length],
                                            request.lora_id), slot)))
        else:
            self._free_slots(s for _, s in snapshots)
            self.allocator.free(owned)
        request.page_ids = []

    def _free_slots(self, slots) -> None:
        for slot in slots:
            if self.on_slot_free:
                self.on_slot_free(slot)

    def reset_prefix_cache(self) -> None:
        self.allocator.free(self.prefix_cache.reset())

    def invalidate_prefix_cache(self) -> int:
        """The stage's weights were replaced (a refit): no later admission
        may reuse KV computed before. A fresh tree takes the old one's
        place, so no match reaches an old page in any adapter namespace;
        the old tree's unreferenced nodes go now (device pages to the
        allocator, host pages to the tier's pool, snapshot slots to the
        engine), and the paths requests in flight hold go as those
        requests release (``_stale``). Returns the pages (device and host)
        the old tree held, also counted in ``stats.pages_invalidated``."""
        old = self.prefix_cache
        n = old.num_cached_pages + old.num_host_pages
        self.prefix_cache = self._new_tree()
        for rid in self._locked:
            self._stale.setdefault(rid, old)
        self.allocator.free(old.drop_unlocked())
        self.stats.pages_invalidated += n
        return n

    def digest_payload(self, full: bool = False) -> dict | None:
        """Prefix-digest heartbeat payload for cache-aware routing (see
        :meth:`RadixPageCache.digest_payload`); None when tracking is off
        or the prefix cache is disabled."""
        if not self.enable_prefix_cache:
            return None
        return self.prefix_cache.digest_payload(full=full)
