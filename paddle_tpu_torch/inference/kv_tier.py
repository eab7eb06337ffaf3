"""Host-RAM KV tier: the spill store under the prefix cache.

Copied from ``paddle_tpu/inference/kv_tier.py`` (framework-free). With
a tier attached, prefix-cache eviction becomes spill-to-host instead of
drop, so a cold prefix (a returning user's conversation history) stays
resident between turns.

Division of labour — the tier is deliberately DUMB:

- ``HostTier`` stores page PAYLOADS: one page's K and V rows as host
  numpy arrays, each page sha256-checksummed, under a ``budget_bytes``
  cap. It owns the byte accounting and the ``tier.spill`` /
  ``tier.restore`` fault points.
- ``PrefixCache`` keeps owning the TREE: which nodes are ``hot`` (pool
  page) vs ``host`` (spilled entry), the cross-tier LRU order (one
  clock for both tiers), spill-on-evict, budget-driven host eviction
  (the bottom of the hierarchy, where pages are finally forgotten), and
  sketch membership — spilled runs KEEP their fingerprints, so a router
  routes a returning session to the replica holding its history in
  EITHER tier.
- The server does the DEVICE work: the page gather at spill (one
  indexed read of the pool and one device-to-host copy), the scatter at
  restore (one in-place indexed write into the pool), and re-entry
  through the normal ``admit_slot``/refcount path, so a restored run is
  bit-exact with a never-evicted one.

Payload layout is the reference's: per page ``[k, v]``, each ``[L, pg,
kvh, hd]`` in the pool's dtype. numpy has no bfloat16, so a bf16 pool's
pages travel as their ``uint16`` bit patterns; the bytes — and so each
page's sha256 — are the ones the reference hashes.

Integrity contract: ``get()`` re-hashes the payload and returns None on
mismatch — a corrupted host buffer is a cache MISS plus a counter
(``kv_host_restore_corrupt_total``), never a serving failure; the caller
drops the unrecoverable node.

A DISABLED tier (``enabled=False``) is treated by the server exactly
like None. The tier itself takes no locks: it is mutated only under the
server lock, like the radix tree above it.
"""
import hashlib

import numpy as np

from ..reliability.faults import TIER_RESTORE, TIER_SPILL

__all__ = ["HostTier", "HostEntry"]


def _sha256(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class HostEntry:
    """One spilled page: ``payload`` is the page's K and V rows as host
    numpy arrays, ``sha256`` the digest verified on every read."""

    __slots__ = ("payload", "nbytes", "sha256")

    def __init__(self, payload, nbytes, sha256):
        self.payload = payload
        self.nbytes = nbytes
        self.sha256 = sha256


class HostTier:
    """Checksummed host-RAM byte store for spilled KV pages.

    >>> tier = HostTier(budget_bytes=64 << 20)
    >>> srv = ContinuousBatchingServer(model, cache_backend="paged",
    ...                                host_tier=tier)

    ``budget_bytes=None`` means unbounded (the prefix cache never asks
    it to shrink). The LRU across both tiers lives in the radix tree's
    node clocks; the tier only answers ``over_budget()``.
    """

    # payloads are plain (pageable) numpy buffers
    memory_kind = "unpinned_host"

    def __init__(self, budget_bytes=None, enabled=True,
                 fault_injector=None):
        self.enabled = bool(enabled)
        self.budget_bytes = None if budget_bytes is None \
            else int(budget_bytes)
        if self.budget_bytes is not None and self.budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0 or None")
        self._faults = fault_injector
        self.bytes_used = 0
        self.entries = 0
        # cumulative churn (the server mirrors these into telemetry)
        self.spilled_pages_total = 0    # put() commits
        self.restored_pages_total = 0   # get() hits handed back
        self.restore_corrupt_total = 0  # checksum mismatches (= misses)
        self.evicted_pages_total = 0    # entries dropped for real

    # ----------------------------------------------------------- store
    def put(self, arrays, **ctx):
        """Adopt one page's payload (a sequence of numpy arrays — K
        rows then V rows). Raises (``tier.spill`` fault) strictly
        BEFORE any state changes: on failure the caller still owns the
        device page and simply drops it. Returns the ``HostEntry``."""
        if self._faults is not None:
            self._faults.check(TIER_SPILL, **ctx)
        payload = tuple(np.ascontiguousarray(a) for a in arrays)
        nbytes = sum(a.nbytes for a in payload)
        entry = HostEntry(payload, nbytes, _sha256(payload))
        self.bytes_used += nbytes
        self.entries += 1
        self.spilled_pages_total += 1
        return entry

    def get(self, entry, **ctx):
        """The entry's payload, checksum-verified — or None when the
        buffer no longer hashes to its digest (the caller treats that
        as a MISS and forgets the node; ``restore_corrupt_total``
        counts it). Raises (``tier.restore`` fault) strictly BEFORE
        the read: an injected restore failure is a transient miss and
        changes no state."""
        if self._faults is not None:
            self._faults.check(TIER_RESTORE, **ctx)
        if _sha256(entry.payload) != entry.sha256:
            self.restore_corrupt_total += 1
            return None
        self.restored_pages_total += 1
        return entry.payload

    def discard(self, entry, evicted=False):
        """Drop an entry's bytes: a restore promoted it back to the
        pool, its node left the tree (corrupt / subtree drop), or —
        ``evicted=True`` — the cross-tier LRU pushed it off the bottom
        of the hierarchy (the one place a page is finally forgotten)."""
        self.bytes_used -= entry.nbytes
        self.entries -= 1
        if evicted:
            self.evicted_pages_total += 1

    def over_budget(self):
        return self.budget_bytes is not None \
            and self.bytes_used > self.budget_bytes

    # ------------------------------------------------------ accounting
    def stats(self):
        """Point-in-time store state + cumulative churn, plain data —
        the ``occupancy()`` / postmortem ``host_tier`` section."""
        return {"entries": self.entries,
                "bytes_used": self.bytes_used,
                "budget_bytes": self.budget_bytes,
                "memory_kind": self.memory_kind,
                "spilled_pages_total": self.spilled_pages_total,
                "restored_pages_total": self.restored_pages_total,
                "restore_corrupt_total": self.restore_corrupt_total,
                "evicted_pages_total": self.evicted_pages_total}
