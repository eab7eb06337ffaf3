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

from ..reliability.faults import KV_GROW, PAGE_ALLOC

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

    def __init__(self, num_pages, page_size, max_slots, pages_per_slot,
                 fault_injector=None):
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
        self._slot_shared = [0] * max_slots
        self.dirty = True
        # chaos hook (reliability.FaultInjector): alloc() checks the
        # "kv.alloc" point BEFORE touching the free list, so an injected
        # allocation failure can never leak pages
        self._faults = fault_injector
        self.grown_total = 0       # pages appended mid-decode (grow_slot)
        self.alloc_total = 0       # pages taken off the free list
        self.freed_total = 0       # pages returned (refcount hit 0)
        self.shared_ref_total = 0  # extra refs taken on shared pages
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
        if self._faults is not None:
            self._faults.check(PAGE_ALLOC, need=n)
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
        self.alloc_total += n
        return pages

    def release(self, pages):
        """Drop one reference per page; pages reaching zero return to
        the free list (slot teardown, or rolling back an alloc)."""
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                self.freed_total += 1

    def refcount(self, page):
        """Live references on ``page`` (prefix-cache eviction treats
        anything above the tree's own 1 as in-use)."""
        return int(self._ref[page])

    # ------------------------------------------------------- slot state
    def slot_pages(self, slot):
        return list(self._slot_pages[slot])

    def coverage(self, slot):
        """Tokens the slot's current pages can hold."""
        return len(self._slot_pages[slot]) * self.page_size

    def admit_slot(self, slot, n_tokens, shared_pages=()):
        """Give ``slot`` a block table covering ``n_tokens`` positions —
        under reserve admission the request's FULL extent (prompt +
        budget), so decode can never hit an empty pool mid-flight; under
        optimistic admission the prompt plus headroom, grown later by
        ``grow_slot``:
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
        self.shared_ref_total += len(shared_pages)
        try:
            own = self.alloc(need - len(shared_pages))
        except Exception:
            for p in shared_pages:
                self._ref[p] -= 1
            self.shared_ref_total -= len(shared_pages)
            raise
        pages = list(shared_pages) + own
        self._slot_pages[slot] = pages
        self._slot_shared[slot] = len(shared_pages)
        row = self.block_table[slot]
        row[:] = NULL_PAGE
        row[:len(pages)] = pages
        self.dirty = True
        return own

    def grow_slot(self, slot, n):
        """Append ``n`` fresh pages to a live slot's block table:
        optimistic admission grows a slot page by page as decode crosses
        page boundaries instead of reserving its full extent up front.
        The ``kv.grow`` chaos point fires BEFORE the free list is
        touched, so an injected grow failure is a clean transient
        (nothing to roll back). Raises ``OutOfPages`` when the pool
        (plus whatever the reclaimer can evict) cannot supply the pages:
        the server's preemption policy then frees a victim's pages and
        retries. Returns the new page ids."""
        if self._faults is not None:
            self._faults.check(KV_GROW, slot=slot, need=n)
        pages = self._slot_pages[slot]
        if not pages:
            raise RuntimeError(f"slot {slot} holds no pages to grow")
        if len(pages) + n > self.pages_per_slot:
            raise ValueError(
                f"growing slot {slot} by {n} pages exceeds "
                f"pages_per_slot ({self.pages_per_slot})")
        own = self.alloc(n)
        row = self.block_table[slot]
        row[len(pages):len(pages) + n] = own
        pages.extend(own)
        self.dirty = True
        self.grown_total += n
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
        self._slot_shared[slot] = 0
        self.block_table[slot, :] = NULL_PAGE
        self.dirty = True
        return pages

    # ------------------------------------------------------- accounting
    def occupancy(self, num_shards=1, host_tier=None):
        """Per-slot block-table occupancy, plain data — the postmortem
        bundle's "who holds which pages" section: pages held and
        shared-prefix pages per occupied slot, plus the pool totals.
        With ``num_shards > 1`` a ``shards`` view is appended (the
        JAX package's signature: the port's pool is one card's, and the
        kv-head-sharded pool is ROADMAP Queue 1 item 9). ``host_tier`` (a
        ``kv_tier.HostTier`` or its ``stats()`` dict) appends the host
        tier's residency as a ``host_tier`` section — where the evicted
        pages went once spill-to-host is on."""
        occ = {"free_pages": self.free_pages(),
               "used_pages": self.used_pages(),
               "pages_per_slot": self.pages_per_slot,
               "slots": {s: {"pages": len(p),
                             "shared": self._slot_shared[s]}
                         for s, p in enumerate(self._slot_pages) if p}}
        if num_shards > 1:
            occ["shards"] = [{"shard": i,
                              "free_pages": occ["free_pages"],
                              "used_pages": occ["used_pages"]}
                             for i in range(num_shards)]
        if host_tier is not None:
            occ["host_tier"] = dict(host_tier.stats()
                                    if hasattr(host_tier, "stats")
                                    else host_tier)
        return occ

    def telemetry_stats(self):
        """Point-in-time pool state + cumulative churn, plain data —
        the ``/stats`` payload and the page-pool gauges source."""
        return {"num_pages": self.num_pages,
                "page_size": self.page_size,
                "free_pages": self.free_pages(),
                "used_pages": self.used_pages(),
                "alloc_total": self.alloc_total,
                "freed_total": self.freed_total,
                "shared_ref_total": self.shared_ref_total,
                "grown_total": self.grown_total}

    @staticmethod
    def paged_hbm_bytes(num_pages, page_size, layers, kv_heads, head_dim,
                        itemsize=4):
        """K+V pool bytes for a paged cache config."""
        return 2 * layers * num_pages * page_size * kv_heads * head_dim \
            * itemsize

    @staticmethod
    def dense_hbm_bytes(max_slots, max_cache_len, layers, kv_heads,
                        head_dim, itemsize=4):
        """K+V bytes the dense backend allocates for the same serving
        config: the baseline the paged pool is measured against."""
        return 2 * layers * max_slots * max_cache_len * kv_heads \
            * head_dim * itemsize
