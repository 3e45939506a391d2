"""Page-granularity radix prefix cache.

Capability parity: reference ``src/parallax/server/block_radix_cache.py:14-333``
(BlockRadixCache). Each tree node holds exactly one *full* KV page's token
ids; matching walks full-page keys, insertion reuses existing device pages,
and eviction walks LRU leaves with a pin refcount protecting in-flight
requests. Device KV never moves: the cache only shares page ids.

Hybrid (linear-attention) models additionally attach a *linear state slot*
to a node: a device snapshot of the conv/recurrent state taken at exactly
that node's token boundary (reference linear-aware BlockRadixCache:
``has_linear_cache`` + per-node ``linear_slot``). A hybrid prefix match is
only usable up to the deepest slot-carrying node — the recurrence cannot
resume from pages alone.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable

from parallax_tpu_torch.utils import get_logger

logger = get_logger(__name__)


# -- block-hash digests (prefix-cache-aware routing) -----------------------
#
# Each full-page prefix of a token stream gets a compact rolling digest:
# ``D_i = blake2b(D_{i-1} || tokens of page i)`` with ``D_0 = 0``. The
# chain is stable across processes, so the scheduler-side head backend can
# hash a prompt ONCE and compare against digests the workers' radix trees
# published through heartbeats — digest membership implies the whole
# prefix path exists on that worker (tree nodes always have ancestors).

# Per-heartbeat delta bound: a delta larger than this collapses into a
# full snapshot (one list instead of two, same cap below).
MAX_DIGEST_DELTA = 4096
# Hard cap on any published digest set. At 8 bytes/digest this bounds the
# heartbeat payload to ~256 KiB worst case; trees are page-budget-bounded
# in practice, so hitting the cap means a huge host tier — the truncated
# tail only costs routing accuracy, never correctness.
MAX_DIGEST_SNAPSHOT = 32768


def hash_block(parent_digest: int, token_ids) -> int:
    """Chained digest of one token block (63-bit int, msgpack-friendly)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_digest.to_bytes(8, "little"))
    h.update(",".join(map(str, token_ids)).encode())
    return int.from_bytes(h.digest(), "little") >> 1


def block_hash_chain(token_ids, block_size: int) -> list[int]:
    """Rolling digests for every full ``block_size`` prefix of the stream
    (index ``i`` covers ``(i + 1) * block_size`` tokens)."""
    out: list[int] = []
    parent = 0
    for start in range(0, len(token_ids) - block_size + 1, block_size):
        parent = hash_block(parent, token_ids[start:start + block_size])
        out.append(parent)
    return out


class _Node:
    __slots__ = ("key", "page_id", "children", "parent", "lock_ref",
                 "last_access", "linear_slot", "host_handle", "digest")

    def __init__(self, key: tuple[int, ...], page_id: int, parent: "_Node | None"):
        self.key = key                      # the page's token ids
        self.page_id = page_id
        self.children: dict[tuple[int, ...], _Node] = {}
        self.parent = parent
        self.lock_ref = 0
        self.last_access = time.monotonic()
        # Rolling block-hash digest of the prefix this node completes
        # (None when digest tracking is off — the default).
        self.digest: int | None = None
        # Linear-state snapshot at this node's token boundary (hybrid
        # models only; None = pages-only node).
        self.linear_slot: int | None = None
        # Host-tier residency: a demoted node keeps its key in the tree
        # but its KV lives in the host pool under this handle
        # (page_id == -1 while set). Invariant: host-resident nodes only
        # ever sit BELOW device-resident ones — eviction demotes the
        # device fringe bottom-up — so a match walk sees device pages,
        # then host pages, never interleaved.
        self.host_handle: int | None = None

    @property
    def on_device(self) -> bool:
        return self.host_handle is None


class RadixPageCache:
    """Prefix cache over full KV pages."""

    def __init__(self, page_size: int, on_evict: Callable[[int], None] | None = None,
                 on_evict_slot: Callable[[int], None] | None = None,
                 host_free: Callable[[int], None] | None = None,
                 track_digests: bool = False):
        self.page_size = page_size
        self.on_evict = on_evict
        self.on_evict_slot = on_evict_slot
        # Called with the host handle when a host-resident node is
        # dropped from the tree (its pool page is no longer reachable).
        self.host_free = host_free
        self._root = _Node((), -1, None)
        self._root.digest = 0
        self._num_pages = 0
        self._num_host_pages = 0
        # handle -> node, for the host pool's eviction callback.
        self._host_nodes: dict[int, _Node] = {}
        # Prefix-digest tracking (cache-aware routing): chronological
        # insert/drop log drained per heartbeat by ``digest_payload``.
        # Off by default — zero per-insert work unless the scheduler's
        # routing strategy asked for digests.
        self.track_digests = track_digests
        self._digest_log: list[tuple[bool, int]] = []   # (added, digest)
        self._digest_cleared = False

    @property
    def num_cached_pages(self) -> int:
        return self._num_pages

    @property
    def num_host_pages(self) -> int:
        return self._num_host_pages

    # -- matching ---------------------------------------------------------

    def match_prefix(self, token_ids: list[int]) -> tuple[list[int], list[_Node]]:
        """Longest full-page prefix match.

        Returns (page_ids, node_path). Only complete pages match; the caller
        recomputes the ragged tail.
        """
        node = self._root
        pages: list[int] = []
        path: list[_Node] = []
        now = time.monotonic()
        for start in range(0, len(token_ids) - self.page_size + 1, self.page_size):
            key = tuple(token_ids[start : start + self.page_size])
            child = node.children.get(key)
            if child is None:
                break
            child.last_access = now
            pages.append(child.page_id)
            path.append(child)
            node = child
        return pages, path

    @staticmethod
    def slice_path(path, n: int):
        """First ``n`` pages of a match path (impl-specific handle)."""
        return path[:n]

    @staticmethod
    def deepest_linear_slot(path: list[_Node], max_pages: int) -> int:
        """Pages usable by a hybrid match: depth of the deepest node within
        ``path[:max_pages]`` carrying a linear-state snapshot (0 = none).
        The recurrence must resume from a snapshot taken at exactly the
        skip boundary, so slotless tail nodes contribute nothing."""
        for i in range(min(len(path), max_pages) - 1, -1, -1):
            if path[i].linear_slot is not None:
                return i + 1
        return 0

    # -- linear-state snapshots -------------------------------------------

    def attach_linear_slot(self, token_ids: list[int], slot: int) -> bool:
        """Attach state snapshot ``slot`` to the node covering exactly
        ``token_ids`` (a whole number of pages). Returns False — caller
        keeps ownership of the slot — when the node does not exist or
        already carries a snapshot."""
        if not token_ids or len(token_ids) % self.page_size:
            return False
        node = self._root
        for start in range(0, len(token_ids), self.page_size):
            node = node.children.get(
                tuple(token_ids[start : start + self.page_size])
            )
            if node is None:
                return False
        if node.linear_slot is not None:
            return False
        node.linear_slot = slot
        return True

    def detach_lru_linear_slot(self) -> int | None:
        """Reclaim the least-recently-used unpinned snapshot slot (the node
        keeps its pages). Returns the freed slot id, or None."""
        best: _Node | None = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.linear_slot is not None and n.lock_ref <= 0:
                if best is None or n.last_access < best.last_access:
                    best = n
        if best is None:
            return None
        slot, best.linear_slot = best.linear_slot, None
        return slot

    def lock(self, path: list[_Node]) -> None:
        """Pin matched nodes so eviction cannot free their pages mid-request."""
        for n in path:
            n.lock_ref += 1

    def unlock(self, path: list[_Node]) -> None:
        for n in path:
            n.lock_ref -= 1

    # -- insertion --------------------------------------------------------

    def insert(self, token_ids: list[int], page_ids: list[int]) -> list[int]:
        """Insert full pages of a finished request's context.

        The tree takes ownership of pages for keys it does not already hold.
        Returns the *duplicate* page ids — pages the caller computed but whose
        key already exists in the tree — which the caller must free (the tree
        keeps its original copy; device KV contents are identical).
        """
        node = self._root
        duplicates: list[int] = []
        now = time.monotonic()
        n_full = len(token_ids) // self.page_size
        for i in range(min(n_full, len(page_ids))):
            key = tuple(token_ids[i * self.page_size : (i + 1) * self.page_size])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page_ids[i], node)
                if self.track_digests:
                    child.digest = hash_block(node.digest or 0, key)
                    self._digest_note(True, child.digest)
                node.children[key] = child
                self._num_pages += 1
            elif not child.on_device:
                # Host-resident twin: adopt the caller's freshly computed
                # device copy (identical KV) and drop the stale host page
                # — promotion by recomputation.
                self._release_host(child)
                child.page_id = page_ids[i]
                self._num_pages += 1
            elif child.page_id != page_ids[i]:
                duplicates.append(page_ids[i])
            child.last_access = now
            node = child
        return duplicates

    # -- eviction ---------------------------------------------------------

    def evict(self, num_pages: int, demoter=None) -> list[int]:
        """Evict up to ``num_pages`` unpinned LRU device-leaf pages.

        Returns freed device page ids (also passed to ``on_evict``).
        With a ``demoter`` — ``demoter(page_ids) -> [handle | None] |
        None`` — victims' KV moves to the host tier in one batched
        gather instead of vanishing: the node stays in the tree tagged
        host-resident and a later ``match_prefix`` can still hit it.
        Victims whose demotion fails (host tier full) are dropped
        outright, together with any host-resident descendants.
        Reference: ``evict_lru_blocks`` (block_radix_cache.py:252-291);
        demotion follows SGLang HiCache's HBM->host hierarchy.
        """
        # Victim selection keeps the reference's iterative LRU-leaf
        # discipline EXACTLY (the native impl is differentially fuzzed
        # against it): pick the LRU unpinned device-leaf, detach it —
        # exposing its parent as the next candidate — and repeat. Only
        # the KV transfer is batched: one demoter call covers the whole
        # victim set (single staging gather + async D2H).
        victims: list[_Node] = []
        while len(victims) < num_pages:
            leaf = self._lru_unpinned_leaf()
            if leaf is None:
                break
            del leaf.parent.children[leaf.key]
            victims.append(leaf)
        if not victims:
            return []
        # Victims run coldest-first with children before parents, so a
        # partial demoter keeping only a suffix (HostKVTier.demote
        # partial mode) never re-attaches a kept child under a dropped
        # parent.
        handles = None
        if demoter is not None:
            try:
                handles = demoter([n.page_id for n in victims])
            except Exception:  # noqa: BLE001 - any transfer failure
                # A failed transfer (e.g. host allocation under the very
                # memory pressure this tier targets) must not leak the
                # already-detached victims' device pages: degrade to
                # plain eviction.
                logger.warning(
                    "host-tier demotion failed; evicting %d pages "
                    "without offload", len(victims), exc_info=True,
                )
        freed: list[int] = []
        for i, leaf in enumerate(victims):
            freed.append(leaf.page_id)
            if self.on_evict:
                self.on_evict(leaf.page_id)
            if leaf.linear_slot is not None and self.on_evict_slot:
                # The device-side state snapshot does not follow the
                # page to host; the slot returns to the engine pool
                # either way.
                self.on_evict_slot(leaf.linear_slot)
                leaf.linear_slot = None
            self._num_pages -= 1
            h = handles[i] if handles else None
            if h is not None:
                # Re-attach tier-tagged: the node's KV now lives in the
                # host pool and future matches can still walk it. The
                # digest survives — host-resident prefixes still serve
                # matches, so the routing index must keep seeing them.
                leaf.parent.children[leaf.key] = leaf
                leaf.page_id = -1
                leaf.host_handle = h
                self._host_nodes[h] = leaf
                self._num_host_pages += 1
            else:
                self._digest_drop(leaf)
                self._drop_host_subtree(leaf)
        return freed

    def _digest_drop(self, node: _Node) -> None:
        """Log a node leaving the tree for the routing-digest delta."""
        if self.track_digests and node.digest is not None:
            self._digest_note(False, node.digest)

    def _digest_note(self, added: bool, digest: int) -> None:
        # Memory guard: if nothing drains the log (heartbeats stopped,
        # scheduler unreachable) it must not grow with tree churn —
        # collapse to "send a snapshot next time" instead.
        if len(self._digest_log) >= 4 * MAX_DIGEST_DELTA:
            self._digest_log.clear()
            self._digest_cleared = True
        if not self._digest_cleared:
            self._digest_log.append((added, digest))

    def _drop_host_subtree(self, node: _Node) -> None:
        """Release the (all host-resident) descendants of a dropped
        device node; their pages return to the pool via ``host_free``."""
        stack = list(node.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._digest_drop(n)
            self._release_host(n)
            if n.linear_slot is not None and self.on_evict_slot:
                self.on_evict_slot(n.linear_slot)

    def _release_host(self, node: _Node) -> None:
        """Drop a node's host residency (freeing the pool page)."""
        if node.host_handle is None:
            return
        self._host_nodes.pop(node.host_handle, None)
        if self.host_free:
            self.host_free(node.host_handle)
        node.host_handle = None
        self._num_host_pages -= 1

    # -- host tier --------------------------------------------------------

    def promote_node(self, node: _Node, page_id: int) -> int:
        """A host-resident node regains a device page (the caller has
        swapped its KV in). Returns the host handle the caller must
        release from the pool."""
        handle = node.host_handle
        self._host_nodes.pop(handle, None)
        node.host_handle = None
        node.page_id = page_id
        self._num_host_pages -= 1
        self._num_pages += 1
        node.last_access = time.monotonic()
        return handle

    def drop_host_page(self, handle: int) -> bool:
        """Host-pool eviction callback: drop the node holding ``handle``
        (and its host-resident subtree — children are unreachable
        without their ancestor's pages). Refuses pinned nodes: a locked
        path is mid-swap-in for an admitting request."""
        node = self._host_nodes.get(handle)
        if node is None:
            return True    # already gone; the pool may reclaim the slot
        stack = [node]
        while stack:
            n = stack.pop()
            if n.lock_ref > 0:
                return False
            stack.extend(n.children.values())
        del node.parent.children[node.key]
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self._digest_drop(n)
            self._release_host(n)
            if n.linear_slot is not None and self.on_evict_slot:
                self.on_evict_slot(n.linear_slot)
        return True

    def _lru_unpinned_leaf(self) -> _Node | None:
        """LRU unpinned device-resident node with no device-resident
        children (host-resident subtrees hang below the device fringe
        and do not shield their ancestors from eviction)."""
        best: _Node | None = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if not n.on_device:
                continue   # host subtrees never contain device pages
            stack.extend(n.children.values())
            if n.lock_ref <= 0 and not any(
                c.on_device for c in n.children.values()
            ):
                if best is None or n.last_access < best.last_access:
                    best = n
        return best

    def drop_unlocked(self) -> list[int]:
        """Drop every node no request holds, returning their device page
        ids (host pages go back through ``host_free``, snapshot slots
        through ``on_evict_slot``). A lock pins a whole path from the root,
        so below an unlocked node nothing is locked: each unlocked child
        of the root or of a locked node goes with its subtree. What stays
        is exactly the locked paths."""
        pages: list[int] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            for key, child in list(node.children.items()):
                if child.lock_ref > 0:
                    stack.append(child)
                    continue
                del node.children[key]
                sub = [child]
                while sub:
                    n = sub.pop()
                    sub.extend(n.children.values())
                    self._digest_drop(n)
                    if n.on_device:
                        pages.append(n.page_id)
                        self._num_pages -= 1
                    else:
                        self._release_host(n)
                    if n.linear_slot is not None and self.on_evict_slot:
                        self.on_evict_slot(n.linear_slot)
                        n.linear_slot = None
        return pages

    def reset(self) -> list[int]:
        """Drop the whole tree, returning every owned device page id
        (host-resident pages are released through ``host_free``)."""
        pages: list[int] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.on_device:
                pages.append(n.page_id)
            else:
                self._release_host(n)
            if n.linear_slot is not None and self.on_evict_slot:
                self.on_evict_slot(n.linear_slot)
            stack.extend(n.children.values())
        self._root = _Node((), -1, None)
        self._root.digest = 0
        self._num_pages = 0
        self._num_host_pages = 0
        self._host_nodes.clear()
        if self.track_digests:
            self._digest_log.clear()
            self._digest_cleared = True
        return pages

    # -- routing digests ---------------------------------------------------

    def prefix_digests(self) -> list[int]:
        """Every cached prefix's rolling digest (device + host tiers),
        capped at ``MAX_DIGEST_SNAPSHOT`` (warmest subtrees first)."""
        from collections import deque

        out: list[int] = []
        queue = deque(sorted(
            self._root.children.values(),
            key=lambda n: n.last_access, reverse=True,
        ))
        while queue and len(out) < MAX_DIGEST_SNAPSHOT:
            n = queue.popleft()
            if n.digest is not None:
                out.append(n.digest)
            queue.extend(n.children.values())
        return out

    def digest_payload(self, full: bool = False) -> dict | None:
        """Heartbeat payload for the scheduler's routing index: either a
        full snapshot (``{"block", "full": [...]}``) or an incremental
        delta (``{"block", "added": [...], "removed": [...]}``). Drains
        the log. None when digest tracking is off. Bounded: deltas larger
        than ``MAX_DIGEST_DELTA`` collapse into a (capped) snapshot."""
        if not self.track_digests:
            return None
        if (
            full or self._digest_cleared
            or len(self._digest_log) > MAX_DIGEST_DELTA
        ):
            # Swap the log out BEFORE walking: tree mutations racing the
            # walk land in the fresh log and ship as the next delta
            # (idempotent against the snapshot). If the walk raises, arm
            # a re-snapshot so the discarded log cannot silently diverge
            # the scheduler mirror.
            self._digest_log = []
            self._digest_cleared = False
            try:
                snapshot = self.prefix_digests()
            except Exception:
                self._digest_cleared = True
                raise
            return {"block": self.page_size, "full": snapshot}
        # Swap atomically instead of iterate-then-clear: an entry the
        # step thread appends mid-iteration must land in the NEXT delta,
        # not vanish (seq would not gap, so the scheduler could never
        # tell the mirror diverged).
        log, self._digest_log = self._digest_log, []
        # Last action per digest wins: an add-then-drop-then-add within
        # one heartbeat must land in exactly one of the two lists.
        final: dict[int, bool] = {}
        for added, digest in log:
            final[digest] = added
        return {
            "block": self.page_size,
            "added": [d for d, a in final.items() if a],
            "removed": [d for d, a in final.items() if not a],
        }
