"""Paged KV-cache bookkeeping for the continuous-batching server.

The dense decode backend allocates ``[max_slots, ..., max_cache_len]``
KV buffers, so cache HBM scales with the CONFIGURED cache length. The
paged backend (cf. "Ragged Paged Attention", PAPERS.md) stores K/V in a
fixed global pool ``[num_pages, page_size, kv_heads, head_dim]`` per
layer and gives each slot an ordered block table of page ids — HBM and
decode bandwidth then scale with ACTUAL tokens, and a pool sized to the
real working set serves slot counts x cache lengths that a dense layout
could not.

This module is the HOST-side allocator: free-list page alloc/release on
slot admit/harvest, per-slot block tables (the device copy is refreshed
only when rows change — no recompiles, the table is a runtime argument
of the decode program), and refcounted page sharing so a cached
prompt prefix is stored ONCE and referenced by every slot that starts
with it. Page 0 is reserved as a null page: unused block-table entries
point at it (gathers through them are length-masked) and inactive slots'
wasted decode writes are redirected to it, so a stale write can never
corrupt a live slot's pages.
"""
import numpy as np

__all__ = ["PagedKVCache", "OutOfPages", "NULL_PAGE"]

NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """The page pool cannot satisfy an allocation. At admission this
    just defers the request (it stays queued until a slot frees pages);
    mid-decode it is surfaced — size ``num_pages`` to the worst-case
    working set (sum over concurrent slots of ceil(len / page_size))."""


class PagedKVCache:
    """Free-list page allocator + per-slot block tables.

    ``block_table`` is the ``[max_slots, pages_per_slot]`` int32 host
    mirror handed to the decode program (rows are page ids in position
    order; unused entries hold ``NULL_PAGE``). ``dirty`` flags that the
    device copy needs a refresh.
    """

    def __init__(self, num_pages, page_size, max_slots, pages_per_slot):
        if page_size < 1 or pages_per_slot < 1:
            raise ValueError("page_size and pages_per_slot must be >= 1")
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is the "
                             "reserved null page)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self.pages_per_slot = int(pages_per_slot)
        self.block_table = np.zeros((max_slots, pages_per_slot), np.int32)
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> low ids
        self._ref = np.zeros((num_pages,), np.int32)
        self._slot_pages = [[] for _ in range(max_slots)]
        self.dirty = True
        # last-resort page source: when the free list runs short,
        # ``alloc`` calls ``reclaimer(shortfall)`` once before giving
        # up — the prefix cache hooks in here to evict LRU cached
        # pages. The callback must release pages (growing the free
        # list) and MUST NOT raise; it returns the count it freed.
        self.reclaimer = None

    # ------------------------------------------------------- allocation
    def _npages(self, n_tokens):
        return -(-int(n_tokens) // self.page_size)

    def free_pages(self):
        return len(self._free)

    def used_pages(self):
        return self.num_pages - 1 - len(self._free)

    def alloc(self, n):
        """Take ``n`` pages off the free list (refcount 1 each). A
        short free list first asks ``reclaimer`` (the prefix cache's
        LRU eviction) to make up the difference."""
        if n > len(self._free) and self.reclaimer is not None:
            self.reclaimer(n - len(self._free))
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages but only {len(self._free)} of "
                f"{self.num_pages - 1} are free — grow num_pages or "
                f"admit fewer concurrent slots")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def release(self, pages):
        """Drop one reference per page; pages reaching zero return to
        the free list (slot teardown, or rolling back an alloc)."""
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    def refcount(self, page):
        """Live references on ``page`` (prefix-cache eviction treats
        anything above the tree's own 1 as in-use)."""
        return int(self._ref[page])

    # ------------------------------------------------------- slot state
    def slot_pages(self, slot):
        return list(self._slot_pages[slot])

    def admit_slot(self, slot, n_tokens, shared_pages=()):
        """Give ``slot`` a block table covering ``n_tokens`` positions —
        the request's FULL extent (prompt + budget), reserved up front
        so decode can never hit an empty pool mid-flight:
        ``shared_pages`` (refcounted, e.g. a cached prefix's full
        pages) cover the head, fresh pages the rest. Returns the fresh
        page ids — the caller copies the slot's own KV rows (positions
        ``len(shared_pages) * page_size`` onward) into them."""
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        need = self._npages(n_tokens)
        need = max(need, len(shared_pages))
        if need > self.pages_per_slot:
            raise ValueError(
                f"{n_tokens} tokens need {need} pages > pages_per_slot "
                f"({self.pages_per_slot})")
        # reference the shared pages BEFORE allocating: alloc may evict
        # via the reclaimer, and a cached page this slot is about to
        # reuse must already read as in-use (refcount > 1) or the sweep
        # could free-and-recycle it mid-admission
        for p in shared_pages:
            self._ref[p] += 1
        try:
            own = self.alloc(need - len(shared_pages))
        except Exception:
            for p in shared_pages:
                self._ref[p] -= 1
            raise
        pages = list(shared_pages) + own
        self._slot_pages[slot] = pages
        row = self.block_table[slot]
        row[:] = NULL_PAGE
        row[:len(pages)] = pages
        self.dirty = True
        return own

    def free_slot(self, slot):
        """Release the slot's pages (shared pages just drop a ref) and
        null its block-table row so stale decode writes are redirected
        to the null page."""
        self.release(self.detach_slot(slot))

    def detach_slot(self, slot):
        """Hand the slot's pages to the caller WITHOUT dropping any
        references — prefix-cache donation takes over their ownership —
        and null the block-table row like ``free_slot``."""
        pages = self._slot_pages[slot]
        self._slot_pages[slot] = []
        self.block_table[slot, :] = NULL_PAGE
        self.dirty = True
        return pages
