"""Automatic prefix caching: a radix tree of KV pages with LRU eviction.

Copied from ``paddle_tpu/inference/prefix_cache.py`` (host-side numpy
bookkeeping, no device code), cut to what the port's server reaches:
lookup, donation, LRU eviction and the pinned nodes of registered
prefixes. The paged serving stack keeps a
request's KV state in refcounted pool pages; this module makes reusing
them automatic and bounded.

Structure: a radix/trie index over token IDs at PAGE granularity. Each
node is one pool page; its key is the ``page_size``-token tuple that
page holds, its children are the pages that can follow it. A path from
the root therefore spells a page-aligned token prefix, and the pages
along the path are exactly the KV state of that prefix — matching is a
dict walk, O(matched pages).

Lifecycle:

- ``donate()``: a finished request's FULL prompt pages (every token in
  the page is a prompt token — partial tail pages and decode-budget
  pages are just freed) are adopted into the tree instead of being
  returned to the free list. Pages whose node already exists are
  deduplicated (the duplicate is released); the rest transfer their
  refcount to the tree. Identical prompts therefore cost one page set
  no matter how often they are served.
- ``lookup()``: the longest cached page run matching a new prompt. The
  server attaches those pages to the slot by reference (``admit_slot``
  shares them) and prefills only the remainder.
- ``evict()``: whenever the allocator runs short, cached pages are
  evicted least-recently-used first, LEAF first (a parent page is
  meaningless without the chain below it gone — and a child
  unreachable without its parent), refcount-1 only (the tree's own
  hold; a page a live slot shares is untouchable), ties broken by
  insertion order so two runs evict identically. The cache soaks up
  idle pool capacity and shrinks to nothing under load, with zero
  correctness impact — eviction only ever forgets REUSABLE state.

- pinning: ``register_prefix`` stores a prefix's full pages in the tree
  as PINNED nodes (``extend_pinned``), adopting nodes the automatic
  cache already holds for those tokens (``node_run``, shielded from the
  allocation's own reclaim by ``protect``). Eviction never takes a
  pinned node, nor an ancestor of one; ``pinned_pages`` and
  ``cached_pages`` partition the tree for ``pool_balance()``.

Chaos hooks (reliability.FaultInjector): ``prefix.donate`` faults
abandon the insert before any state changes (the caller frees the
pages: the cache loses an entry, never a page); ``prefix.evict`` faults
abort that reclaim attempt (the allocator then reports OutOfPages and
admission defers to the next tick). A preemption donates its victim's
pages COLD (``donate(cold=True)``): at the LRU's cold end, so the grow
that displaced it reclaims them first.

The host KV tier and the routing sketch (and ``flush_sketch``) of the
JAX module come back with the ROADMAP item that first needs them
(Queue 1 item 9).

Host-side only, mutated exclusively under the server lock.
"""
import numpy as np

from ..reliability.faults import PREFIX_DONATE, PREFIX_EVICT

__all__ = ["PrefixCache", "PrefixMatch"]


class _Node:
    """One cached page: ``key`` is the page's token tuple, ``page`` its
    pool id. ``last_used``/``seq`` order eviction (LRU, then insertion
    order); ``pinned`` marks register_prefix entries."""

    __slots__ = ("key", "page", "parent", "children", "pinned",
                 "last_used", "seq")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.pinned = False
        self.last_used = 0
        self.seq = 0


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
        """The same match minus its last page (None when that leaves it
        empty): the server trims a match whose remainder would overflow
        the prefill-chunk pad bound."""
        if len(self.nodes) <= 1:
            return None
        return PrefixMatch(self.nodes[:-1], self._page_size)


class PrefixCache:
    """Radix-tree index of cached prefix pages over one ``PagedKVCache``.

    Page ownership: every node holds exactly ONE allocator reference to
    its page. Slots that reuse a cached page take their own reference
    (``admit_slot(shared_pages=...)``), so ``kv.refcount(page) > 1``
    means "in use by a live slot" and blocks eviction. ``pinned_pages``
    / ``cached_pages`` partition the tree for pool accounting
    (``pool_balance()``).
    """

    def __init__(self, kv, fault_injector=None):
        self.kv = kv
        self._faults = fault_injector
        self.page_size = kv.page_size
        self._root = _Node(None, None, None)
        self._tick = 0          # logical LRU clock (bumped per touch)
        self._seq = 0           # insertion order, the deterministic tie-break
        self._protected = frozenset()   # node ids shielded from eviction
        self.pinned_pages = 0   # nodes register_prefix pinned (never evicted)
        self.cached_pages = 0   # unpinned nodes (evictable when refcount 1)
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
        """Existing nodes covering ``ids`` (page-aligned): register_prefix
        adopts these instead of allocating again."""
        ids = np.asarray(ids).reshape(-1)
        return self._walk(ids, len(ids) // self.page_size)

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
        enters at the COLD end of the LRU instead of as most recent —
        new nodes keep ``last_used=0`` (insertion ``seq`` still breaks
        ties deterministically) and existing nodes keep their real
        recency. The grow that displaced the victim is about to reclaim
        pages, and takes the victim's first; the pages stay lookup-able
        until evicted, so a quickly re-admitted victim still hits its
        own prompt.

        Raises (``prefix.donate`` fault) strictly BEFORE any state
        changes: on failure the caller still owns all ``pages`` and
        frees them; the tree and refcounts are untouched."""
        if self._faults is not None:
            self._faults.check(PREFIX_DONATE, pages=len(pages))
        nf = min(int(prompt_len) // self.page_size, len(pages))
        node, new = self._root, 0
        for key, page in zip(self._page_keys(ids, nf), pages[:nf]):
            child = node.children.get(key)
            if child is not None:
                # already cached (maybe the very page this slot shared
                # at admission): drop the slot's duplicate reference
                self.kv.release([page])
                self.dedup_pages_total += 1
            else:
                child = _Node(key, page, node)
                self._seq += 1
                child.seq = self._seq
                node.children[key] = child
                self.cached_pages += 1
                new += 1
            if not cold:
                self._touch(child)
            node = child
        self.kv.release(pages[nf:])
        self.donated_pages_total += new
        return new

    # ---------------------------------------------------------- eviction
    def _evictable(self, exclude=()):
        """Nodes safe to remove: unpinned, unprotected, not excluded,
        refcount 1 (only the tree's own hold), and no blocked descendant
        — an ancestor of a pinned, shared, protected or excluded page
        must survive so the chain below it stays reachable."""
        ex = {id(n) for n in exclude} | self._protected
        out = []

        def walk(n):
            ok = True
            for ch in n.children.values():
                ok = walk(ch) and ok
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
        may reclaim (register_prefix adopting a cached run must not have
        that run evicted under it). Pass ``()`` to clear."""
        self._protected = frozenset(id(n) for n in nodes)

    def evict(self, need):
        """Free up to ``need`` pool pages, least-recently-used leaf
        first (ties by insertion order — fully deterministic). Returns
        the number of pages freed; raising (``prefix.evict`` fault)
        happens strictly before any state changes."""
        if self._faults is not None:
            self._faults.check(PREFIX_EVICT, need=int(need))
        safe = set(self._evictable())
        freed = 0
        while freed < int(need):
            leaves = [n for n in safe if not n.children]
            if not leaves:
                break
            victim = min(leaves, key=lambda n: (n.last_used, n.seq))
            safe.discard(victim)
            del victim.parent.children[victim.key]
            self.kv.release([victim.page])
            self.cached_pages -= 1
            self.evicted_pages_total += 1
            freed += 1
        return freed

    def stats(self):
        """Point-in-time tree state + cumulative churn, plain data
        (``/stats`` and postmortem bundles), under the JAX package's
        keys. ``host_pages`` and ``sketch_size`` stay 0: the host tier
        and the routing sketch come with the fleet (ROADMAP Queue 1
        item 9)."""
        return {"cached_pages": self.cached_pages,
                "pinned_pages": self.pinned_pages,
                "host_pages": 0,
                "sketch_size": 0,
                "donated_pages_total": self.donated_pages_total,
                "dedup_pages_total": self.dedup_pages_total,
                "evicted_pages_total": self.evicted_pages_total}

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
        for key, page in zip(keys[len(run):], own_pages):
            child = _Node(key, page, node)
            self._seq += 1
            child.seq = self._seq
            node.children[key] = child
            child.pinned = True
            self._touch(child)
            node = child
            self.pinned_pages += 1
        return [n.page for n in run] + list(own_pages)
