"""Automatic prefix caching: a radix tree of KV pages with LRU eviction,
a host-RAM second tier and a routing sketch.

Copied from ``paddle_tpu/inference/prefix_cache.py`` (host-side numpy
bookkeeping, no device code). The paged serving stack keeps a request's
KV state in refcounted pool pages; this module makes reusing them
automatic and bounded.

Structure: a radix/trie index over token IDs at PAGE granularity. Each
node is one pool page; its key is the ``page_size``-token tuple that
page holds, its children are the pages that can follow it. A path from
the root therefore spells a page-aligned token prefix, and the pages
along the path are exactly the KV state of that prefix — matching is a
dict walk, O(matched pages).

Lifecycle:

- ``donate()``: a finished request's FULL prompt pages are adopted into
  the tree instead of being returned to the free list; pages whose node
  already exists are deduplicated (the duplicate is released).
- ``lookup()``: the longest cached page run matching a new prompt. The
  server attaches those pages to the slot by reference (``admit_slot``
  shares them) and prefills only the remainder.
- ``evict()``: whenever the allocator runs short, unpinned cached pages
  are evicted least-recently-used first, LEAF first, refcount-1 only
  (the tree's own hold), ties broken by insertion order so two runs
  evict identically.
- pinning: ``register_prefix`` stores a prefix's full pages in the tree
  as PINNED nodes (``extend_pinned``), adopting nodes the automatic
  cache already holds for those tokens (``node_run``, shielded from the
  allocation's own reclaim by ``protect``). Eviction never takes a
  pinned node, nor an ancestor of one; ``pinned_pages`` and
  ``cached_pages`` partition the tree for ``pool_balance()``.

Chaos hooks (``reliability.FaultInjector``): ``prefix.donate`` faults
abandon the insert before any state changes (the caller frees the
pages: the cache loses an entry, never a page); ``prefix.evict`` faults
abort that reclaim attempt (the allocator then reports OutOfPages and
admission defers to the next tick). A preemption donates its victim's
pages COLD (``donate(cold=True)``): at the LRU's cold end, so the grow
that displaced it reclaims them first.

Tiered residency: with a ``kv_tier.HostTier`` attached, eviction becomes
SPILL-TO-HOST instead of drop. A demoted node stays in the tree — same
key, same fingerprint (so ``sketch()`` keeps advertising the run to the
router) — but its ``page`` becomes None and ``host`` holds the tier
entry with the page's checksummed K/V payload. Demotion goes bottom-up
(a node is demoted only once it has no hot descendant), so every
root-to-leaf path is a HOT prefix followed by a HOST suffix; ``lookup()``
returns the full run and the server restores the host suffix into
freshly allocated pool pages before prefill. Host entries are forgotten
for real only at the bottom of the hierarchy: when the tier's byte
budget overflows, the LRU host LEAF entries leave the tree
(``_host_shrink``). One LRU clock (``last_used``/``seq``) orders both
tiers.

The routing sketch: every node carries a rolling fingerprint of its
path (``prefix_fingerprints`` builds the same chain for a prompt), and
``sketch()`` publishes the set as an immutable snapshot a router reads
without the server lock. Fingerprints hash int tuples, which CPython
does not salt, so they are equal across processes and equal to the JAX
package's for the same tokens: a router can compare the two packages'
replicas by sketch.

Host-side only, mutated exclusively under the server lock.
"""
import numpy as np

from ..reliability.faults import PREFIX_DONATE, PREFIX_EVICT

__all__ = ["PrefixCache", "PrefixMatch", "prefix_fingerprints"]

# root value of the rolling fingerprint chain (sketch()/
# prefix_fingerprints must agree on it for membership tests to work)
_SKETCH_ROOT = 0


def prefix_fingerprints(ids, page_size, max_tokens=None):
    """Rolling fingerprints of the page-aligned prefixes of ``ids``:
    entry ``k`` identifies the first ``(k + 1) * page_size`` tokens.
    Built with the same chain as ``PrefixCache.sketch()``, so
    ``fps[k] in sketch`` answers "does that replica's radix tree hold
    this exact page-aligned prefix?" with no tree (or device) access —
    the router's affinity signal. ``max_tokens`` caps the covered
    prefix (the server matches at most ``T - 1`` tokens so the
    remainder prefill still emits first-token logits). Int-tuple
    hashing is unsalted in CPython, so fingerprints are stable across
    processes with the same token stream."""
    ids = np.asarray(ids).reshape(-1)
    n = len(ids) if max_tokens is None else min(len(ids), int(max_tokens))
    pg = int(page_size)
    out, fp = [], _SKETCH_ROOT
    for i in range(n // pg):
        fp = hash((fp, tuple(int(x) for x in ids[i * pg:(i + 1) * pg])))
        out.append(fp)
    return out


class _Node:
    """One cached page: ``key`` is the page's token tuple, ``page`` its
    pool id. ``last_used``/``seq`` order eviction (LRU, then insertion
    order); ``pinned`` marks register_prefix entries; ``fp`` is the
    node's rolling path fingerprint (see ``sketch()``). A HOST-resident
    node (demoted by eviction) has ``page is None`` and ``host`` set to
    its ``kv_tier.HostEntry``; exactly one of the two is ever set."""

    __slots__ = ("key", "page", "parent", "children", "pinned",
                 "last_used", "seq", "fp", "host")

    def __init__(self, key, page, parent, fp=0):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.pinned = False
        self.last_used = 0
        self.seq = 0
        self.fp = fp
        self.host = None


class PrefixMatch:
    """A ``lookup()`` result: ``tokens`` (= ``len(pages) * page_size``)
    of the prompt are already cached in ``pages`` (position order).
    ``nodes`` is the matched tree path — pass it back to ``use()`` when
    the match is actually taken so LRU sees the reuse."""

    __slots__ = ("tokens", "pages", "nodes", "_page_size")

    def __init__(self, nodes, page_size):
        self.nodes = nodes
        self.pages = [n.page for n in nodes]
        self.tokens = len(nodes) * page_size
        self._page_size = page_size

    def shrink(self):
        """The same match minus its last page (None when empty) — the
        server trims a match whose remainder would overflow the
        prefill-chunk pad bound."""
        if len(self.nodes) <= 1:
            return None
        return PrefixMatch(self.nodes[:-1], self._page_size)

    def hot_len(self):
        """Leading nodes that are device-resident RIGHT NOW — the
        shared run an admission can take without a restore; everything
        after is the host suffix (demotion is bottom-up, so the split
        is always prefix/suffix). ``pages``/``tokens`` are snapshots
        from construction: after restoring/promoting nodes, build a
        fresh ``PrefixMatch`` from the same nodes."""
        for i, n in enumerate(self.nodes):
            if n.page is None:
                return i
        return len(self.nodes)


class PrefixCache:
    """Radix-tree index of cached prefix pages over one ``PagedKVCache``.

    Page ownership: every node holds exactly ONE allocator reference to
    its page. Slots that reuse a cached page take their own reference
    (``admit_slot(shared_pages=...)``), so ``kv.refcount(page) > 1``
    means "in use by a live slot" and blocks eviction. ``pinned_pages``
    / ``cached_pages`` partition the tree for pool accounting
    (``pool_balance()`` / the ``kv_pool_pages`` gauge).
    """

    def __init__(self, kv, fault_injector=None, host_tier=None,
                 spill=None):
        self.kv = kv
        self.page_size = kv.page_size
        # second tier (kv_tier.HostTier): eviction demotes instead of
        # dropping. ``spill(page_id) -> payload arrays`` is the
        # server-bound device gather (per-shard on a mesh); without
        # both, eviction behaves exactly as before.
        self._tier = host_tier \
            if (host_tier is not None and host_tier.enabled
                and spill is not None) else None
        self._spill = spill
        self._root = _Node(None, None, None, fp=_SKETCH_ROOT)
        # fingerprint index maintained INCREMENTALLY alongside the tree
        # (one rolling hash per node) and published as an immutable
        # snapshot, so a router can read sketch() without the server
        # lock — a serve thread holds that lock for whole ticks. The
        # snapshot is republished in BATCHES (flush_sketch, once per
        # server tick / pin / evacuation), not per mutation: a
        # multi-slot harvest pays one O(tree) copy, not one per slot.
        self._sketch = set()
        self._sketch_dirty = False
        self.sketch_snapshot = frozenset()
        self._tick = 0          # logical LRU clock (bumped per touch)
        self._seq = 0           # insertion order, the deterministic tie-break
        self._protected = frozenset()   # node ids shielded from eviction
        self._faults = fault_injector
        self.pinned_pages = 0   # nodes register_prefix pinned (never evicted)
        self.cached_pages = 0   # unpinned nodes (evictable when refcount 1)
        self.host_pages = 0     # host-resident nodes (no device page)
        # cumulative stats (the server mirrors these into telemetry)
        self.donated_pages_total = 0   # new nodes created by donate()
        self.dedup_pages_total = 0     # donated pages already in the tree
        self.evicted_pages_total = 0

    # ---------------------------------------------------------- matching
    def _page_keys(self, ids, npages):
        ids = np.asarray(ids).reshape(-1)
        pg = self.page_size
        return [tuple(int(x) for x in ids[i * pg:(i + 1) * pg])
                for i in range(npages)]

    def _walk(self, ids, npages):
        """Existing tree path for the first ``npages`` pages of ``ids``
        (possibly shorter — the longest run present). Keys are built
        lazily: a miss at page k costs O(k) token tuples, not
        O(npages) — this runs on every admission attempt, misses
        included."""
        ids = np.asarray(ids).reshape(-1)
        pg = self.page_size
        node, run = self._root, []
        for i in range(npages):
            key = tuple(int(x) for x in ids[i * pg:(i + 1) * pg])
            child = node.children.get(key)
            if child is None:
                break
            run.append(child)
            node = child
        return run

    def lookup(self, ids, max_tokens):
        """Longest cached page-aligned prefix of ``ids`` covering at
        most ``max_tokens`` tokens, or None. Pure — no LRU touch —
        so admission-feasibility checks can probe speculatively; call
        ``use()`` on the match when it is actually taken."""
        npages = min(int(max_tokens), len(np.asarray(ids).reshape(-1))) \
            // self.page_size
        if npages <= 0:
            return None
        run = self._walk(ids, npages)
        if not run:
            return None
        return PrefixMatch(run, self.page_size)

    def node_run(self, ids):
        """Existing HOT nodes covering ``ids`` (which must be
        page-aligned) — register_prefix adopts these instead of
        re-allocating. The run stops at the first host-resident node:
        a pinned entry computes (and pins) its own fresh pages from
        there, replacing the spilled payloads (``extend_pinned``)."""
        ids = np.asarray(ids).reshape(-1)
        run = self._walk(ids, len(ids) // self.page_size)
        for i, n in enumerate(run):
            if n.page is None:
                return run[:i]
        return run

    def _touch(self, node):
        self._tick += 1
        node.last_used = self._tick

    def use(self, match):
        """Mark a taken match as just-used (root-to-leaf, so deeper
        pages read as more recent and fall last under LRU)."""
        for node in match.nodes:
            self._touch(node)

    # ---------------------------------------------------------- donation
    def donate(self, ids, pages, prompt_len, cold=False):
        """Adopt a released slot's page list: full prompt pages become
        (or refresh) tree nodes, everything else — the partial prompt
        tail and the decode budget — is released. Takes ownership of
        EVERY reference the caller held on ``pages``: existing nodes
        absorb the duplicate (released), new nodes keep theirs. Returns
        the number of newly cached pages.

        ``cold=True`` is the PREEMPTION donation path: the donated run
        enters at the COLD end of the LRU instead of as most-recent —
        new nodes keep ``last_used=0`` (insertion ``seq`` still breaks
        ties deterministically) and existing nodes keep their real
        recency untouched. A preemption victim was chosen as the least
        valuable work in flight, and the very grow that displaced it is
        about to reclaim pages — cold insertion lets that reclaim take
        the victim's pages FIRST while a genuinely hot shared prefix
        among them (an existing, recently-used node) survives. The
        pages stay lookup-able until evicted, so a quickly re-admitted
        victim still auto-hits its own prompt (prefix-cache-assisted
        recompute).

        Raises (``prefix.donate`` fault) strictly BEFORE any state
        changes — on failure the caller still owns all ``pages`` and
        frees them; the tree and refcounts are untouched."""
        if self._faults is not None:
            self._faults.check(PREFIX_DONATE, pages=len(pages))
        nf = min(int(prompt_len) // self.page_size, len(pages))
        node, new = self._root, 0
        for key, page in zip(self._page_keys(ids, nf), pages[:nf]):
            child = node.children.get(key)
            if child is not None and child.page is None:
                # host-resident: the donated page IS this prefix's KV
                # state, recomputed by the slot that just finished —
                # adopt it (a free promotion) and drop the spilled
                # payload instead of ever reading it back
                self._tier.discard(child.host)
                child.host = None
                child.page = page
                self.host_pages -= 1
                self.cached_pages += 1
            elif child is not None:
                # already cached (maybe the very page this slot shared
                # at admission): drop the slot's duplicate reference
                self.kv.release([page])
                self.dedup_pages_total += 1
            else:
                child = _Node(key, page, node, fp=hash((node.fp, key)))
                self._seq += 1
                child.seq = self._seq
                node.children[key] = child
                self._sketch.add(child.fp)
                self.cached_pages += 1
                new += 1
            if not cold:
                self._touch(child)
            node = child
        self.kv.release(pages[nf:])
        self.donated_pages_total += new
        if new:
            self._sketch_dirty = True
        return new

    # ---------------------------------------------------------- eviction
    def _evictable(self, exclude=()):
        """Nodes safe to remove: unpinned, unprotected, refcount 1 (only
        the tree's own hold), and no blocked descendant — an ancestor of
        a pinned/shared/protected page must survive so the chain below
        it stays reachable."""
        ex = {id(n) for n in exclude} | self._protected
        out = []

        def walk(n):
            ok = True
            for ch in n.children.values():
                ok = walk(ch) and ok
            if n.page is None:
                # host-resident: holds no device page — transparent to
                # the sweep (never a candidate, never a blocker; its
                # hot ancestors demote right over it)
                return ok
            ok = (ok and not n.pinned and id(n) not in ex
                  and self.kv.refcount(n.page) == 1)
            if ok:
                out.append(n)
            return ok

        for ch in self._root.children.values():
            walk(ch)
        return out

    def evictable_pages(self, exclude=()):
        """Pages an eviction sweep could free right now — admission
        counts these as available headroom. ``exclude`` holds the
        nodes a pending match is about to take by reference."""
        return len(self._evictable(exclude))

    def protect(self, nodes):
        """Shield ``nodes`` from eviction across an allocator call that
        may reclaim (register_prefix adopting a cached run must not
        have that run evicted out from under it). Pass ``()`` to
        clear."""
        self._protected = frozenset(id(n) for n in nodes)

    def evict(self, need):
        """Free up to ``need`` device pages, least-recently-used leaf
        first (ties by insertion order — fully deterministic). With a
        host tier attached the victim is DEMOTED — payload spilled to
        the tier, node kept (fingerprint and all) with ``page=None`` —
        and only dropped outright when the spill itself fails
        (injected ``tier.spill`` fault / gather error). Either way the
        victim's device page is freed, so the sweep is leak-free under
        fault storms. Returns the number of device pages freed;
        raising (``prefix.evict`` fault) happens strictly before any
        state changes."""
        if self._faults is not None:
            self._faults.check(PREFIX_EVICT, need=int(need))
        safe = set(self._evictable())
        freed = 0
        while freed < int(need):
            # device-leaves: safe nodes with no HOT child (a demoted
            # child stays in the tree, so "no children" is too strong
            # once the tier is on; a hot child not in ``safe`` already
            # disqualified its ancestors in the walk)
            leaves = [n for n in safe
                      if not any(ch.page is not None
                                 for ch in n.children.values())]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: (n.last_used, n.seq))
            safe.discard(victim)
            if self._demote(victim):
                self.kv.release([victim.page])
                victim.page = None
                self.cached_pages -= 1
                self.host_pages += 1
            else:
                # plain drop — the node leaves the tree, taking its
                # (all-host) subtree with it
                self.drop_subtree(victim)
            freed += 1
        if freed:
            self._sketch_dirty = True
        self._host_shrink()
        return freed

    def _demote(self, victim):
        """Try to spill ``victim``'s page payload to the host tier.
        True on success (caller flips the node to host residency);
        False — no tier, injected spill fault, or gather failure —
        means fall back to dropping, with no tier state changed."""
        if self._tier is None:
            return False
        try:
            payload = self._spill(victim.page)
            victim.host = self._tier.put(payload, page=int(victim.page))
        except Exception:
            victim.host = None
            return False
        return True

    def drop_subtree(self, node):
        """Remove ``node`` and everything below it from the tree: hot
        pages go back to the allocator, host entries leave the tier,
        fingerprints leave the sketch. Used for the spill-fault drop
        path and for forgetting a corrupted host run. Returns device
        pages released."""
        if node.parent is not None \
                and node.parent.children.get(node.key) is node:
            del node.parent.children[node.key]
        released = 0
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            self._sketch.discard(n.fp)
            if n.page is not None:
                self.kv.release([n.page])
                if n.pinned:
                    self.pinned_pages -= 1
                else:
                    self.cached_pages -= 1
                self.evicted_pages_total += 1
                released += 1
            elif n.host is not None:
                self._tier.discard(n.host, evicted=True)
                n.host = None
                self.host_pages -= 1
        self._sketch_dirty = True
        return released

    def _host_shrink(self):
        """The bottom of the hierarchy: while the host tier is over
        its byte budget, its least-recently-used LEAF entries are
        forgotten for real (LRU then insertion order, leaf first —
        the same deterministic order as device eviction)."""
        if self._tier is None or not self._tier.over_budget():
            return
        leaves = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.page is None and not n.children \
                    and id(n) not in self._protected:
                leaves.append(n)
        while self._tier.over_budget() and leaves:
            victim = min(leaves, key=lambda n: (n.last_used, n.seq))
            leaves.remove(victim)
            del victim.parent.children[victim.key]
            self._sketch.discard(victim.fp)
            self._tier.discard(victim.host, evicted=True)
            victim.host = None
            self.host_pages -= 1
            self._sketch_dirty = True
            p = victim.parent
            if p is not self._root and p.page is None \
                    and not p.children and id(p) not in self._protected:
                leaves.append(p)

    def promote(self, node, page):
        """A restore landed: ``node``'s payload is back in pool page
        ``page`` (the caller transfers its one allocator reference to
        the node — the normal donate ownership contract) and the host
        entry's bytes return to the tier."""
        self._tier.discard(node.host)
        node.host = None
        node.page = page
        self.host_pages -= 1
        self.cached_pages += 1
        self._touch(node)

    # ----------------------------------------------------------- pinning
    def extend_pinned(self, ids, run, own_pages):
        """Commit a ``register_prefix`` entry: pin the existing ``run``
        (adopted donated pages stop being evictable) and append
        ``own_pages`` as fresh pinned nodes for the remaining keys of
        page-aligned ``ids``. Returns the entry's full page list."""
        for nd in run:
            self._touch(nd)
            if not nd.pinned:
                nd.pinned = True
                self.cached_pages -= 1
                self.pinned_pages += 1
        node = run[-1] if run else self._root
        ids = np.asarray(ids).reshape(-1)
        keys = self._page_keys(ids, len(ids) // self.page_size)
        added = False
        for key, page in zip(keys[len(run):], own_pages):
            child = node.children.get(key)
            if child is not None:
                # a host-resident node on this path (node_run stopped
                # above it): the entry's freshly-computed page replaces
                # the spilled payload — promote-by-pin, no restore read
                self._tier.discard(child.host)
                child.host = None
                child.page = page
                self.host_pages -= 1
            else:
                child = _Node(key, page, node, fp=hash((node.fp, key)))
                self._seq += 1
                child.seq = self._seq
                node.children[key] = child
                self._sketch.add(child.fp)
                added = True
            child.pinned = True
            self._touch(child)
            node = child
            self.pinned_pages += 1
        if added:
            self._sketch_dirty = True
        return [n.page for n in run] + list(own_pages)

    # ---------------------------------------------------------- sketching
    def flush_sketch(self):
        """Republish the lock-free snapshot if the tree changed since
        the last flush. The server calls this once per tick (plus at
        register_prefix and evacuation boundaries) — off-tick
        mutations (e.g. a client-thread cancel's donation) surface at
        the next tick, which only staleness-bounds a routing HINT."""
        if self._sketch_dirty:
            self._sketch_dirty = False
            self.sketch_snapshot = frozenset(self._sketch)

    def sketch(self):
        """Host-side fingerprint set of every page-aligned prefix the
        tree currently caches (pinned and unpinned alike) — one rolling
        hash per node, O(nodes) ints, zero device reads. A router keeps
        one sketch per replica and routes a prompt to the replica whose
        sketch covers its longest ``prefix_fingerprints`` run.

        Returns the maintained IMMUTABLE snapshot, so it is safe to
        call WITHOUT the server lock (a serve thread holds that lock
        for whole decode ticks — the router must not queue behind it
        just to pick a destination). A sketch is a ROUTING HINT, not a
        contract: pages may be evicted right after it is read, which
        costs the chosen replica a cache miss, never correctness."""
        return self.sketch_snapshot

    # -------------------------------------------------------- accounting
    def stats(self):
        """Point-in-time tree state + cumulative churn, plain data
        (``/stats`` and postmortem bundles). ``sketch_size`` is the
        live fingerprint count — the size of the affinity signal the
        router reads, which a postmortem wants next to the page
        counts (a dead replica with a big sketch is lost locality the
        fleet will re-prefill)."""
        return {"cached_pages": self.cached_pages,
                "pinned_pages": self.pinned_pages,
                "host_pages": self.host_pages,
                "sketch_size": len(self._sketch),
                "donated_pages_total": self.donated_pages_total,
                "dedup_pages_total": self.dedup_pages_total,
                "evicted_pages_total": self.evicted_pages_total}
