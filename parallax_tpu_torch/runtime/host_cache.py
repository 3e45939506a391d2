"""Host-DRAM KV tier: the second level of the memory hierarchy (port of
``parallax_tpu/runtime/host_cache.py``).

Device memory holds the working set (the paged pool and the radix prefix
cache); this module adds a host-side page pool behind it so memory
pressure degrades to latency instead of failures:

- Radix eviction *demotes* cold prefix pages to host DRAM (one batched
  gather and D2H copy) instead of discarding their KV; a later prefix
  match on a host-resident node swaps the page back in (H2D scatter)
  before admission.
- Decode-time OOM *preempts* the latest-arriving running decode to the
  host tier (its whole KV image parks here, pinned) rather than aborting
  it with ``kv_oom``; it resumes via swap-in when pages free up.

The pool is itself LRU with a low watermark: once full it sheds cold
unpinned pages in a batch down to the watermark, so steady-state demotion
never pays a per-page eviction walk. Pinned pages (preempted requests' KV)
are never shed — losing them would silently corrupt the resumed stream —
so the only way out of the pool for those is ``free()`` on resume or
release.

Device transfers are injected (``gather_fn`` / ``scatter_fn``) so the
bookkeeping is testable without a device; :func:`tier_from_paged_kv`
builds them on ``ops/kv_cache_ops.py``'s ``gather_pages`` /
``scatter_pages`` over the engine's live cache tensors. Payloads are CPU
torch tensors (numpy has no bfloat16 without ``ml_dtypes``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch


class HostPagePool:
    """LRU pool of host-resident KV pages under a byte budget.

    Entries are opaque per-page payloads of a fixed size (``page_nbytes``);
    the budget is expressed in bytes and enforced as a page-count capacity.
    Eviction consults ``evict_cb(handle)`` — the owner (radix tree) drops
    its reference and returns True, or refuses (pinned node) and the walk
    skips it.
    """

    def __init__(
        self,
        budget_bytes: int,
        page_nbytes: int,
        low_watermark: float = 0.85,
    ):
        self.page_nbytes = max(1, int(page_nbytes))
        self.capacity = max(0, int(budget_bytes) // self.page_nbytes)
        self.low_target = int(self.capacity * low_watermark)
        # handle -> payload, insertion/access-ordered (oldest first).
        self._pages: "OrderedDict[int, object]" = OrderedDict()
        self._pinned: set[int] = set()
        self._next_handle = 0
        self.evict_cb: Callable[[int], bool] | None = None
        self.evictions = 0

    # -- capacity ---------------------------------------------------------

    @property
    def num_pages(self) -> int:
        return len(self._pages)

    @property
    def num_free(self) -> int:
        return self.capacity - len(self._pages)

    def ensure_room(self, n: int) -> bool:
        """Make room for ``n`` new pages, shedding cold unpinned entries
        down to the low watermark in one batch. False when the budget
        cannot hold them even after eviction (everything pinned, or the
        pool is simply too small)."""
        if n > self.capacity:
            return False
        if self.num_free >= n:
            return True
        target = min(self.low_target, self.capacity - n)
        # Snapshot: evict_cb may reentrantly free() descendants of the
        # handle being dropped (host subtrees), mutating the dict.
        for h in list(self._pages.keys()):
            if len(self._pages) <= target:
                break
            if h in self._pinned or h not in self._pages:
                continue
            if self.evict_cb is None or self.evict_cb(h):
                self._pages.pop(h, None)
                self._pinned.discard(h)
                self.evictions += 1
        return self.num_free >= n

    # -- entries ----------------------------------------------------------

    def store(self, data, pinned: bool = False) -> int | None:
        """Insert one page; None when no room can be made."""
        if not self.ensure_room(1):
            return None
        h = self._next_handle
        self._next_handle += 1
        self._pages[h] = data
        if pinned:
            self._pinned.add(h)
        return h

    def load(self, handle: int):
        """Read a page's payload (touches LRU recency)."""
        data = self._pages[handle]
        self._pages.move_to_end(handle)
        return data

    def free(self, handle: int) -> None:
        self._pages.pop(handle, None)
        self._pinned.discard(handle)

    def unpin(self, handle: int) -> None:
        """Make a pinned page evictable again (pinning itself happens at
        ``store(pinned=True)`` — a page is pinned for its whole parked
        life or not at all)."""
        self._pinned.discard(handle)


class HostKVTier:
    """Device<->host page movement over a :class:`HostPagePool`.

    ``gather_fn(page_ids) -> [per-layer CPU tensor with leading dim n]``
    reads device pages to host; ``scatter_fn(page_ids, layers)`` writes
    host pages back into device pages, ``layers[i]`` being layer ``i``'s
    page payloads as a list (the JAX tier stacks them first; the port's
    scatter stacks them straight into its pinned slab). One handle = one
    page's KV across every local attention layer.
    """

    def __init__(
        self,
        budget_bytes: int,
        page_nbytes: int,
        gather_fn: Callable[[list[int]], list[torch.Tensor]],
        scatter_fn: Callable[[list[int], list[torch.Tensor]], None],
        low_watermark: float = 0.85,
    ):
        self.pool = HostPagePool(budget_bytes, page_nbytes, low_watermark)
        self._gather = gather_fn
        self._scatter = scatter_fn
        self.pages_demoted = 0
        self.pages_swapped_in = 0

    def set_evict_cb(self, cb: Callable[[int], bool] | None) -> None:
        self.pool.evict_cb = cb

    @property
    def num_host_pages(self) -> int:
        return self.pool.num_pages

    @property
    def capacity_pages(self) -> int:
        return self.pool.capacity

    @property
    def host_evictions(self) -> int:
        return self.pool.evictions

    def demote(
        self,
        page_ids: Sequence[int],
        pinned: bool = False,
        partial: bool = False,
    ) -> list[int] | None:
        """Copy device pages to host; returns their handles.

        All-or-nothing by default: None (no side effects beyond pool
        eviction) when the tier cannot hold every page — a preempted
        request's KV image is useless in halves. With ``partial``, as many
        pages as fit are taken from the END of the list (None entries for
        the rest): radix eviction passes victims coldest first, so the
        suffix keeps the warmest pages AND is ancestor-closed (children
        precede parents in the victim order, so a kept child's kept parent
        is never dropped under it)."""
        n = len(page_ids)
        if n == 0:
            return []
        want = min(n, self.pool.capacity) if partial else n
        if not self.pool.ensure_room(want) and not partial:
            return None
        # Non-partial: ensure_room(n) succeeded, so fit == n here.
        fit = min(want, self.pool.num_free)
        if fit <= 0:
            return [None] * n if partial else None
        kept = list(page_ids[n - fit:])
        layers = self._gather(kept)
        handles: list[int | None] = [None] * (n - fit)
        for j in range(fit):
            handles.append(self.pool.store(
                tuple(layer[j] for layer in layers), pinned=pinned
            ))
        self.pages_demoted += fit
        return handles

    def promote(
        self, handles: Sequence[int], device_page_ids: Sequence[int]
    ) -> None:
        """Swap host pages back into freshly allocated device pages and
        release their host copies."""
        if not handles:
            return
        datas = [self.pool.load(h) for h in handles]
        layers = [
            [d[i] for d in datas] for i in range(len(datas[0]))
        ]
        self._scatter(list(device_page_ids), layers)
        for h in handles:
            self.pool.free(h)
        self.pages_swapped_in += len(handles)

    def store_image(
        self, layers: Sequence[torch.Tensor]
    ) -> list[int] | None:
        """Adopt an externally produced page image (live migration): the
        per-layer ``[n_pages, ...]`` tensors a peer's checkpoint carried
        are stored pinned, page by page, with no device gather.
        All-or-nothing; None when the pool cannot hold them."""
        if not layers:
            return []
        n = int(layers[0].shape[0])
        if any(int(a.shape[0]) != n for a in layers):
            return None
        if not self.pool.ensure_room(n):
            return None
        handles: list[int] = []
        for j in range(n):
            h = self.pool.store(tuple(a[j] for a in layers), pinned=True)
            if h is None:  # pragma: no cover - ensure_room guarantees room
                for hh in handles:
                    self.pool.free(hh)
                return None
            handles.append(h)
        return handles

    def free(self, handles: Sequence[int]) -> None:
        for h in handles:
            self.pool.free(h)


class _PinnedSlab:
    """One page-locked host buffer, grown to the next power of two of the
    bytes asked for and reused: ``cudaHostAlloc`` costs milliseconds, so it
    is never called per page or per transfer, and nothing is reserved up
    front for the tier's budget. ``ready`` is the event behind the last
    copy that read or wrote the buffer; a new use waits on it first."""

    def __init__(self):
        self._buf: torch.Tensor | None = None
        self.ready = None

    def take(self, nbytes: int) -> torch.Tensor:
        if self.ready is not None:
            self.ready.synchronize()
            self.ready = None
        if self._buf is None or self._buf.numel() < nbytes:
            size = 1 << max(20, (nbytes - 1).bit_length())
            self._buf = torch.empty((size,), dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf


def _bucket_ids(page_ids: list[int]) -> np.ndarray:
    """Power-of-two id buckets bound the variety of transfer shapes;
    padding repeats the first id — harmless for the gather (extra rows
    sliced off host-side) and for the scatter (the same payload
    rewritten)."""
    b = 1
    while b < len(page_ids):
        b *= 2
    ids = np.full((b,), page_ids[0], np.int32)
    ids[: len(page_ids)] = page_ids
    return ids


def tier_from_paged_kv(
    budget_bytes: int,
    get_kv: Callable[[], list],
    num_pages: int,
    low_watermark: float = 0.85,
) -> HostKVTier | None:
    """Build a tier whose transfers operate on the engine's list of paged
    per-layer cache tensors (leading dim ``num_pages``), re-read through
    ``get_kv`` on every transfer. Returns None when the KV layout is
    unsupported (tuple caches of the DSA / MSA families) or the budget is
    below one page.

    The gather enqueues one ``gather_pages`` per layer on the current
    stream — the one where eager steps and graph replays run — so a
    demotion issued while a step is in flight reads that step's writes to
    the same pages (stream order), then copies the staged pages D2H with
    ``non_blocking=True`` into a pinned slab and waits on an event before
    any handle is handed out. The payloads are pageable copies of the
    slab's rows. The swap-in stacks the payloads into a pinned slab, copies
    them H2D and scatters them in place (``scatter_pages``): the captured
    window graphs hold the cache tensors' pointers. On the CPU the same
    code runs with plain copies.
    """
    from parallax_tpu_torch.ops.kv_cache_ops import (
        gather_pages,
        scatter_pages,
    )

    kv = get_kv()
    if not kv or any(
        not isinstance(a, torch.Tensor) or a.dim() < 2
        or a.shape[0] != num_pages
        for a in kv
    ):
        return None
    page_nbytes = sum(a[0].numel() * a.element_size() for a in kv)
    if budget_bytes < page_nbytes:
        return None
    device = kv[0].device
    on_card = device.type == "cuda"
    d2h, h2d = _PinnedSlab(), _PinnedSlab()

    def carve(slab: torch.Tensor, like: list[torch.Tensor], n: int):
        """Per-layer [n, *page] views over one pinned slab."""
        out, off = [], 0
        for a in like:
            shape = (n, *a.shape[1:])
            nbytes = int(np.prod(shape)) * a.element_size()
            out.append(slab[off:off + nbytes].view(a.dtype).view(shape))
            off += nbytes
        return out

    def gather_fn(page_ids: list[int]) -> list[torch.Tensor]:
        ids = _bucket_ids(page_ids)
        n = len(page_ids)
        kv = get_kv()
        ids_dev = torch.from_numpy(ids).to(device)
        staged = [gather_pages(layer, ids_dev) for layer in kv]
        if not on_card:
            return [s[:n].clone() for s in staged]
        slab = d2h.take(len(ids) * page_nbytes)
        host = carve(slab, kv, len(ids))
        for h, s in zip(host, staged):
            h.copy_(s, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return [h[:n].clone() for h in host]

    def scatter_fn(page_ids: list[int],
                   layers: list[list[torch.Tensor]]) -> None:
        ids = _bucket_ids(page_ids)
        n = len(page_ids)
        kv = get_kv()
        ids_dev = torch.from_numpy(ids).to(device)
        if on_card:
            slab = h2d.take(len(ids) * page_nbytes)
            staged = carve(slab, kv, len(ids))
        else:
            staged = [torch.empty((len(ids), *a.shape[1:]), dtype=a.dtype)
                      for a in kv]
        for st, pages in zip(staged, layers):
            torch.stack(pages, out=st[:n])
            if len(ids) > n:
                st[n:] = st[:1]
        for layer, st in zip(kv, staged):
            scatter_pages(layer, ids_dev, st.to(device, non_blocking=True))
        if on_card:
            h2d.ready = torch.cuda.Event()
            h2d.ready.record()

    return HostKVTier(
        budget_bytes, page_nbytes, gather_fn, scatter_fn, low_watermark
    )
