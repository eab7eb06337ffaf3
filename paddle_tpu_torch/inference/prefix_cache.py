"""Automatic prefix caching: a radix tree of KV pages with LRU eviction.

Copied from ``paddle_tpu/inference/prefix_cache.py`` (host-side numpy
bookkeeping, no device code), cut to what the port's server reaches:
lookup, donation and LRU eviction. The paged serving stack keeps a
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

Pinned prefixes (``register_prefix``), the host KV tier, the routing
sketch and the chaos hooks of the JAX module come back with the ROADMAP
items that first need them.

Host-side only, mutated exclusively under the server lock.
"""
import numpy as np

__all__ = ["PrefixCache", "PrefixMatch"]


class _Node:
    """One cached page: ``key`` is the page's token tuple, ``page`` its
    pool id. ``last_used``/``seq`` order eviction (LRU, then insertion
    order)."""

    __slots__ = ("key", "page", "parent", "children", "last_used", "seq")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = {}
        self.last_used = 0
        self.seq = 0


class PrefixMatch:
    """A ``lookup()`` result: ``tokens`` (= ``len(pages) * page_size``)
    of the prompt are already cached in ``pages`` (position order).
    ``nodes`` is the matched tree path — pass it back to ``use()`` when
    the match is actually taken so LRU sees the reuse."""

    __slots__ = ("tokens", "pages", "nodes")

    def __init__(self, nodes, page_size):
        self.nodes = nodes
        self.pages = [n.page for n in nodes]
        self.tokens = len(nodes) * page_size


class PrefixCache:
    """Radix-tree index of cached prefix pages over one ``PagedKVCache``.

    Page ownership: every node holds exactly ONE allocator reference to
    its page. Slots that reuse a cached page take their own reference
    (``admit_slot(shared_pages=...)``), so ``kv.refcount(page) > 1``
    means "in use by a live slot" and blocks eviction.
    ``cached_pages`` counts the tree for pool accounting
    (``pool_balance()``).
    """

    def __init__(self, kv):
        self.kv = kv
        self.page_size = kv.page_size
        self._root = _Node(None, None, None)
        self._tick = 0          # logical LRU clock (bumped per touch)
        self._seq = 0           # insertion order, the deterministic tie-break
        self.cached_pages = 0

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

    def _touch(self, node):
        self._tick += 1
        node.last_used = self._tick

    def use(self, match):
        """Mark a taken match as just-used (root-to-leaf, so deeper
        pages read as more recent and fall last under LRU)."""
        for node in match.nodes:
            self._touch(node)

    # ---------------------------------------------------------- donation
    def donate(self, ids, pages, prompt_len):
        """Adopt a released slot's page list: full prompt pages become
        (or refresh) tree nodes, everything else — the partial prompt
        tail and the decode budget — is released. Takes ownership of
        EVERY reference the caller held on ``pages``: existing nodes
        absorb the duplicate (released), new nodes keep theirs. Returns
        the number of newly cached pages."""
        nf = min(int(prompt_len) // self.page_size, len(pages))
        node, new = self._root, 0
        for key, page in zip(self._page_keys(ids, nf), pages[:nf]):
            child = node.children.get(key)
            if child is not None:
                # already cached (maybe the very page this slot shared
                # at admission): drop the slot's duplicate reference
                self.kv.release([page])
            else:
                child = _Node(key, page, node)
                self._seq += 1
                child.seq = self._seq
                node.children[key] = child
                self.cached_pages += 1
                new += 1
            self._touch(child)
            node = child
        self.kv.release(pages[nf:])
        return new

    # ---------------------------------------------------------- eviction
    def _evictable(self, exclude=()):
        """Nodes safe to remove: not excluded, refcount 1 (only the
        tree's own hold), and no blocked descendant — an ancestor of a
        shared or excluded page must survive so the chain below it stays
        reachable."""
        ex = {id(n) for n in exclude}
        out = []

        def walk(n):
            ok = True
            for ch in n.children.values():
                ok = walk(ch) and ok
            ok = ok and id(n) not in ex and self.kv.refcount(n.page) == 1
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

    def evict(self, need):
        """Free up to ``need`` pool pages, least-recently-used leaf
        first (ties by insertion order — fully deterministic). Returns
        the number of pages freed."""
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
            freed += 1
        return freed
