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
