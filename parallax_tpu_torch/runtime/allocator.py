"""Free-list allocators for KV pages and linear-state slots.

Capability parity: reference ``src/parallax/server/cache/allocator.py``
(BlockAllocator/SlotAllocator). Pages index into the device-side
``kv_pages`` arrays; slots index into linear-attention state arrays.
"""

from __future__ import annotations


class OutOfPages(Exception):
    pass


class PageAllocator:
    """O(1) free-list allocator over ``num_pages`` device pages.

    Page 0 is reserved as the null page: padded page-table entries point at
    it so gathers stay in bounds without branching.

    ``free`` validates its input: a double-free or out-of-range id would
    put one page on the free list twice and hand it to two owners — a
    silent KV corruption — so it raises instead. The whole batch is
    validated before any page is returned (a partial free would leave
    the caller unable to retry).
    """

    def __init__(self, num_pages: int, reserve_null_page: bool = True):
        self.num_pages = num_pages
        start = 1 if reserve_null_page else 0
        self._free = list(range(num_pages - 1, start - 1, -1))
        self.null_page = 0 if reserve_null_page else -1
        self._is_free = [False] * num_pages
        for p in self._free:
            self._is_free[p] = True

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._is_free[p] = False
        return out

    def free(self, pages: list[int]) -> None:
        batch: list[int] = []
        seen: set[int] = set()
        for p in pages:
            if p == self.null_page:
                continue
            if not 0 <= p < self.num_pages:
                raise ValueError(
                    f"free of out-of-range page {p} (num_pages "
                    f"{self.num_pages})"
                )
            if self._is_free[p] or p in seen:
                raise ValueError(f"double free of page {p}")
            seen.add(p)
            batch.append(p)
        for p in batch:
            self._is_free[p] = True
            self._free.append(p)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)


class SlotAllocator:
    """Free-list over fixed-size state slots (linear-attention caches).

    Guarded like :class:`PageAllocator`: a double-freed slot would be
    handed to two requests whose recurrent states would then overwrite
    each other.
    """

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._free = list(range(num_slots - 1, -1, -1))
        self._is_free = [True] * num_slots

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages("no free slots")
        slot = self._free.pop()
        self._is_free[slot] = False
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.num_slots:
            raise ValueError(
                f"free of out-of-range slot {slot} (num_slots "
                f"{self.num_slots})"
            )
        if self._is_free[slot]:
            raise ValueError(f"double free of slot {slot}")
        self._is_free[slot] = True
        self._free.append(slot)
