"""KV cache orchestration: page ownership, prefix reuse, memory budgeting.

A copy of the Python ``CacheManager`` in ``parallax_tpu/runtime/
cache_manager.py`` for the port's first slice: radix prefix matching, pinning,
eviction under pressure, prefix-aware chunk skipping and donation on release.
Its routing digests (``track_digests`` / ``digest_payload``, the delta log
of cache-aware routing) are the JAX manager's. The native C++ manager, the
host-DRAM tier (preemption/swap-in), LoRA namespaces and linear-state
snapshots are not ported yet; ``make_cache_manager`` therefore always
returns this class.

Ownership model: every device page has one owner — an in-flight request or
the radix tree. Prefix-cache hits share tree-owned pages read-only, pinned
via lock refs for the request's lifetime.
"""

from __future__ import annotations

import dataclasses
import math

from parallax_tpu_torch.config import ModelConfig
from parallax_tpu_torch.runtime.allocator import OutOfPages, PageAllocator
from parallax_tpu_torch.runtime.radix_cache import RadixPageCache
from parallax_tpu_torch.runtime.request import Request


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


@dataclasses.dataclass
class CacheStats:
    """Prefix-cache counters for one engine stage (the fields of
    ``parallax_tpu/utils/request_metrics.CacheStats`` this slice moves)."""

    tokens_admitted: int = 0       # prompt tokens of admitted requests
    tokens_hit_device: int = 0     # skipped via cached prefixes
    tokens_chunk_skipped: int = 0  # of those, skipped by a mid-prefill
    #                                radix re-consult
    pages_evicted: int = 0         # pages reclaimed from the tree
    kv_oom_aborts: int = 0         # decodes aborted for want of pages


def make_cache_manager(
    page_size: int,
    num_pages: int,
    enable_prefix_cache: bool = True,
    max_model_len: int = 32768,
    prefill_chunk_skip: bool = True,
    track_digests: bool = False,
) -> "CacheManager":
    """CacheManager factory. The JAX package prefers its native C++ manager
    (and falls back to the Python one when ``track_digests`` asks for the
    digest log); the port has only the Python one so far."""
    return CacheManager(
        page_size, num_pages, enable_prefix_cache=enable_prefix_cache,
        max_model_len=max_model_len, prefill_chunk_skip=prefill_chunk_skip,
        track_digests=track_digests,
    )


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
    ):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_model_len = max_model_len
        self.enable_prefix_cache = enable_prefix_cache
        # False keeps the radix tree populating on release but admission
        # and mid-prefill planning stop REUSING matches.
        self.prefill_chunk_skip = prefill_chunk_skip
        self.allocator = PageAllocator(num_pages)
        self.prefix_cache = RadixPageCache(
            page_size, track_digests=track_digests and enable_prefix_cache)
        self.stats = CacheStats()
        # rid -> (locked node path, number of shared tree-owned pages)
        self._locked: dict[str, tuple] = {}

    # -- capacity ---------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return self.allocator.num_free

    def pages_needed(self, num_tokens: int) -> int:
        return math.ceil(num_tokens / self.page_size)

    def _reclaim(self, need: int) -> bool:
        """Free pages from the prefix cache until ``need`` are available."""
        if self.allocator.num_free >= need:
            return True
        freed = self.prefix_cache.evict(need - self.allocator.num_free)
        self.allocator.free(freed)
        self.stats.pages_evicted += len(freed)
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
        if (
            self.enable_prefix_cache
            and self.prefill_chunk_skip
            and prompt_len > 1
        ):
            pages, full_path = self.prefix_cache.match_prefix(request.prompt_ids)
            # Always leave >=1 prompt token to recompute so the stage emits a
            # hidden state for sampling.
            usable = min(len(pages), (prompt_len - 1) // self.page_size)
            shared_pages = pages[:usable]
            path = self.prefix_cache.slice_path(full_path, usable)

        fresh_needed = self.pages_needed(prompt_len) - len(shared_pages)
        # Pin the matched prefix BEFORE any eviction: reclaiming first could
        # evict the matched nodes and hand their pages back out as this
        # very request's fresh pages.
        self.prefix_cache.lock(path)
        if not self._reclaim(fresh_needed):
            self.prefix_cache.unlock(path)
            return False
        try:
            fresh = self.allocator.alloc(fresh_needed)
        except OutOfPages:
            self.prefix_cache.unlock(path)
            return False
        request.page_ids = shared_pages + fresh
        request.num_cached_tokens = len(shared_pages) * self.page_size
        request.num_computed_tokens = request.num_cached_tokens
        self._locked[request.request_id] = (path, len(shared_pages))
        self.stats.tokens_admitted += prompt_len
        self.stats.tokens_hit_device += request.num_cached_tokens
        return True

    def extend_prefix_match(self, request: Request) -> int:
        """Mid-prefill chunk skipping: re-consult the radix tree before a
        request's FIRST chunk and grow its shared prefix if a donor
        finished (and inserted) after this request was admitted. Callers
        only invoke this while ``num_computed_tokens == num_cached_tokens``.
        Returns the number of newly skipped tokens. Never allocates."""
        if not (self.enable_prefix_cache and self.prefill_chunk_skip):
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
        pages, full_path = self.prefix_cache.match_prefix(request.prompt_ids)
        usable = min(len(pages), (prompt_len - 1) // self.page_size)
        if usable <= num_shared:
            return 0
        new_shared = pages[:usable]
        if new_shared[:num_shared] != request.page_ids[:num_shared]:
            return 0
        new_path = self.prefix_cache.slice_path(full_path, usable)
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

    def release(self, request: Request) -> None:
        """Return a finished/aborted request's pages.

        Full pages of the final COMPUTED context are donated to the prefix
        cache; duplicates and the ragged tail are freed.
        """
        path, num_shared = self._locked.pop(request.request_id, ([], 0))
        self.prefix_cache.unlock(path)
        owned = request.page_ids[num_shared:]
        if not owned:
            request.page_ids = []
            return
        if self.enable_prefix_cache and request.status.value != "finished_abort":
            # The final sampled token never runs a forward step, so only
            # pages fully covered by computed KV may be donated.
            computed = min(request.num_computed_tokens, len(request.all_token_ids))
            n_full = computed // self.page_size
            tail = owned[max(0, n_full - num_shared):]
            duplicates = self.prefix_cache.insert(
                request.all_token_ids[: n_full * self.page_size],
                request.page_ids[:n_full],
            )
            self.allocator.free(duplicates + tail)
        else:
            self.allocator.free(owned)
        request.page_ids = []

    def digest_payload(self, full: bool = False) -> dict | None:
        """Prefix-digest heartbeat payload for cache-aware routing (see
        :meth:`RadixPageCache.digest_payload`); None when tracking is off
        or the prefix cache is disabled."""
        if not self.enable_prefix_cache:
            return None
        return self.prefix_cache.digest_payload(full=full)
