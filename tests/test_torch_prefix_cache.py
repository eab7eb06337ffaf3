"""The port's page allocator and radix prefix cache against the JAX
package's, driven through one seeded script of admissions, harvests
and evictions on a pool small enough that LRU eviction runs.

Both are host-side integer bookkeeping, so every observable (block
tables, free-list order, refcounts, matches, eviction counts) must be
EQUAL, not close.
"""
import numpy as np
import pytest

from paddle_tpu.inference.kv_cache import OutOfPages as JaxOutOfPages
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxKV
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxPrefix
from paddle_tpu_torch.inference import OutOfPages, PagedKVCache, PrefixCache

PG, SLOTS, PPS = 4, 3, 6


def _pair(num_pages):
    out = []
    for kv_cls, pc_cls in ((JaxKV, JaxPrefix), (PagedKVCache, PrefixCache)):
        kv = kv_cls(num_pages, PG, SLOTS, PPS)
        pc = pc_cls(kv)
        kv.reclaimer = pc.evict
        out.append((kv, pc))
    return out


def _state(kv, pc):
    return (kv.block_table.tolist(), list(kv._free), kv._ref.tolist(),
            pc.cached_pages, pc.evictable_pages())


@pytest.mark.parametrize("num_pages,seed", [(10, 0), (13, 1), (13, 2), (12, 3)])
def test_allocator_and_prefix_cache_match_jax(num_pages, seed):
    """Prompts share a few stems so lookups hit; a pool of 9 or 12
    usable pages against 3 slots of up to 6 pages forces evictions and
    deferred admissions (OutOfPages) along the way."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 50, (12,)).astype(np.int32) for _ in range(3)]
    sides = _pair(num_pages)
    held = [None] * SLOTS                 # (ids, prompt_len) per slot
    evicted = hits = deferred = 0
    for _ in range(300):
        slot = int(rng.integers(0, SLOTS))
        if held[slot] is not None:
            ids, plen = held[slot]
            for kv, pc in sides:
                pc.donate(ids, kv.detach_slot(slot), plen)
            held[slot] = None
        else:
            stem = stems[int(rng.integers(0, len(stems)))]
            tail = rng.integers(0, 50, (int(rng.integers(1, 9)),))
            ids = np.concatenate([stem[:int(rng.integers(0, 13))],
                                  tail]).astype(np.int32)
            extent = len(ids) + int(rng.integers(1, 5))
            outcome = []
            for kv, pc in sides:
                m = pc.lookup(ids, len(ids) - 1)
                pages = [] if m is None else m.pages
                try:
                    own = kv.admit_slot(slot, extent, pages)
                except (OutOfPages, JaxOutOfPages):
                    outcome.append(("deferred", pages))
                    continue
                if m is not None:
                    pc.use(m)
                outcome.append((own, pages))
            assert outcome[0] == outcome[1]
            if outcome[0][0] == "deferred":
                deferred += 1
            else:
                held[slot] = (ids, len(ids))
                hits += bool(outcome[0][1])
        if rng.random() < 0.2:           # an explicit sweep, as a reclaim
            n = int(rng.integers(1, 4))
            freed = [pc.evict(n) for _, pc in sides]
            assert freed[0] == freed[1]
            evicted += freed[0]
        assert _state(*sides[0]) == _state(*sides[1])
    assert hits > 0 and deferred > 0 and evicted > 0


def test_eviction_takes_the_least_recently_used_leaf_like_jax():
    """Two donated prompts, the OLDER one reused since: a one-page sweep
    frees the newer prompt's leaf on both sides (recency beats insertion
    order), then the older prompt's leaf."""
    a = np.arange(8, dtype=np.int32)
    b = np.arange(100, 108, dtype=np.int32)
    freed = []
    for kv, pc in _pair(10):
        for slot, ids in enumerate((a, b)):
            kv.admit_slot(slot, 8)
            pc.donate(ids, kv.detach_slot(slot), 8)
        pc.use(pc.lookup(a, 8))
        order = []
        for _ in range(4):
            before = set(kv._free)
            assert pc.evict(1) == 1
            order += sorted(set(kv._free) - before)
        freed.append(order)
        assert pc.cached_pages == 0 and pc.evictable_pages() == 0
    assert freed[0] == freed[1] == [4, 3, 2, 1]


def _pin_state(kv, pc):
    return _state(kv, pc) + (pc.pinned_pages,)


@pytest.mark.parametrize("adopt", [0, 1, 2])
def test_pinned_nodes_match_jax_and_survive_eviction(adopt):
    """register_prefix's tree work on both sides: ``adopt`` pages of a
    3-page prefix are already cached (donated), ``node_run`` finds them,
    ``protect`` shields them while the rest is allocated under a
    reclaiming pool, ``extend_pinned`` pins the run and the new pages.
    Eviction then never takes a pinned node (nor, through it, its
    ancestors), a donation onto a pinned page drops its duplicate
    reference, and a slot sharing the pinned run reads it by
    reference."""
    rng = np.random.default_rng(adopt)
    prefix = rng.integers(0, 50, (3 * PG,)).astype(np.int32)
    other = rng.integers(50, 99, (3 * PG,)).astype(np.int32)
    seen = []
    for kv, pc in _pair(9):
        # cached state: ``adopt`` pages of the prefix, and another
        # prompt's 3 pages the allocation below must evict
        if adopt:
            kv.admit_slot(0, adopt * PG)
            pc.donate(prefix, kv.detach_slot(0), adopt * PG)
        kv.admit_slot(1, 3 * PG)
        pc.donate(other, kv.detach_slot(1), 3 * PG)
        kv.admit_slot(2, 8)                       # a live slot's pages
        run = pc.node_run(prefix)
        assert len(run) == adopt
        pc.protect(run)
        try:
            own = kv.alloc(3 - len(run))
        finally:
            pc.protect(())
        pages = pc.extend_pinned(prefix, run, own)
        assert pc.pinned_pages == 3
        trace = [_pin_state(kv, pc), pages]
        # nothing pinned is evictable; the sweep frees only the rest
        trace.append(pc.evict(10))
        trace.append(_pin_state(kv, pc))
        # a slot sharing the pinned run, then donating it back
        m = pc.lookup(np.concatenate([prefix, other[:3]]), 3 * PG + 2)
        kv.free_slot(2)
        kv.admit_slot(2, 3 * PG + 5, m.pages)
        pc.use(m)
        trace.append(_pin_state(kv, pc))
        pc.donate(np.concatenate([prefix, other[:3]]), kv.detach_slot(2),
                  3 * PG + 3)
        trace.append(_pin_state(kv, pc))
        trace.append(pc.evict(10))
        trace.append(_pin_state(kv, pc))
        seen.append(trace)
    assert seen[0] == seen[1]
    assert seen[1][-1][-1] == 3            # pinned pages outlive it all


@pytest.mark.parametrize("args", [(17, 8, 2, 2, 16, 4), (8 * 128 + 1, 16, 32,
                                                        32, 128, 2)])
def test_hbm_byte_helpers_match_jax(args):
    """The pool's K+V bytes and the dense backend's for the same slots
    x cache length (here llama_tiny's and Llama-2-7B's bf16 pool)."""
    pages, pg, layers, kvh, hd, item = args
    assert PagedKVCache.paged_hbm_bytes(pages, pg, layers, kvh, hd, item) \
        == JaxKV.paged_hbm_bytes(pages, pg, layers, kvh, hd, item)
    assert PagedKVCache.dense_hbm_bytes(8, 2048, layers, kvh, hd, item) \
        == JaxKV.dense_hbm_bytes(8, 2048, layers, kvh, hd, item)
