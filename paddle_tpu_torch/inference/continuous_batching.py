"""Continuous-batching decode server over the paged KV pool.

Port of ``paddle_tpu/inference/continuous_batching.py`` cut down to its
paged path: ``cache_backend="paged"``, ragged prefill, split or fused
ticks, ``admission="reserve"``, automatic prefix caching, and greedy or
seeded sampled decoding. A fixed pool of decode slots steps as one
batched decode step every tick; finished slots are refilled from the
queue without stopping the others. Admissions only reserve pages: every
tick runs the next prompt chunk of ALL mid-prefill slots straight into
pool pages, under a per-tick token budget (``prefill_tokens_per_tick``),
so long prompts stream in across ticks while live slots keep decoding.

``serving_mode="split"`` (the default) runs a tick as one ragged-prefill
launch for the admission wave, then the s=1 decode step for live slots,
with the slot-state pushes between them. ``serving_mode="fused"`` runs
the whole tick as one pass over the layers: prefill chunks and decode
rows packed into one fused-tick launch per layer whose page schedule
covers only live pages, the tick's small host arrays riding in with one
host-to-device copy — the tick's dispatch profile is ``{"fused": 1}``.

Sampling (``do_sample=True``) follows the reference's chains exactly:
a request's key is ``PRNGKey(seed)`` (``seed`` defaults to the server's
seed plus the request id), each token splits the slot's key and draws
``categorical`` from the other half over ``process_logits``' filtered
row, and a slot that does not emit keeps its key. The draw is one
launch a tick on the card (R1, ``ops.kernels.sample_rows``); on fused
ticks the keys ride the launch on the card and come back with the
tokens. Tokens equal the JAX server's for the same seeds.

Host/device split: the device runs the steps (``models.generation``; the
paged-attention, ragged-prefill and fused-tick kernels on a CUDA model);
the host assigns slots, owns the page allocator and the radix prefix
cache (``kv_cache``, ``prefix_cache``), harvests finished rows and swaps
new prompts in.

The JAX server's other modes are not ported yet. Asking for one raises
``NotImplementedError`` naming its ROADMAP item (Queue 1): the dense
backend and dense prefill (item 5), ``tick_block > 1`` (item 6),
optimistic admission and preemption (item 7), telemetry, flight
recorder, goodput ledger, cost catalog, journeys, fault injection and
the supervised serve loop (item 8), the mesh and the host KV tier (item
9), int8 weights and caches (item 10).
"""
import threading
import time as _time_mod

import numpy as np
import torch

from ..core import prng
from ..ops.kernels.fused_tick import build_schedule
from ..ops.kernels.sample_rows import sample_rows
from ..reliability.errors import (CallbackError, DeadlineExceeded,
                                  QueueFullError, ReliabilityError,
                                  RequestCancelled, ServerClosed)
from ..telemetry.clock import MonotonicClock
from .decode_loop import process_logits
from .kv_cache import OutOfPages, PagedKVCache
from .prefix_cache import PrefixCache

__all__ = ["ContinuousBatchingServer"]


def _not_ported(what, item, name):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP, Queue 1 "
        f"item {item}: {name})")


class _Pending:
    """A queued request awaiting a slot."""

    __slots__ = ("rid", "ids", "budget", "on_token", "deadline", "seed")

    def __init__(self, rid, ids, budget, on_token, deadline, seed):
        self.rid = rid
        self.ids = ids
        self.budget = budget
        self.on_token = on_token
        self.deadline = deadline      # absolute clock time, or None
        self.seed = seed              # resolved sampling seed (a Python int)


class _Slot:
    __slots__ = ("rid", "ids", "prompt_len", "budget", "emitted",
                 "on_token", "streamed", "deadline", "fill_pos", "filled",
                 "seed")

    def __init__(self, rid, ids, prompt_len, budget, on_token=None,
                 deadline=None, seed=0):
        self.rid = rid
        self.ids = ids                # prompt tokens (donated at release)
        self.prompt_len = prompt_len
        self.budget = budget          # max_new_tokens
        self.emitted = []
        self.on_token = on_token
        self.streamed = 0             # tokens already sent to on_token
        self.deadline = deadline      # absolute clock time, or None
        self.fill_pos = 0             # next prompt position to prefill
        self.filled = 0               # prompt rows actually written
        self.seed = seed              # the request's sampling seed

    def stream(self, sink):
        """Queue this slot's unstreamed chunk on ``sink``; the server
        fires callbacks AFTER releasing its lock."""
        if self.on_token is None:
            return
        upto = min(len(self.emitted), self.budget)
        if upto > self.streamed:
            sink.append((self.on_token, self.rid,
                         np.asarray(self.emitted[self.streamed:upto],
                                    np.int32)))
            self.streamed = upto


class ContinuousBatchingServer:
    """Serve greedy or seeded sampled requests through a fixed slot pool
    over a paged KV pool, on the model's device.

    >>> srv = ContinuousBatchingServer(model, max_slots=4,
    ...                                max_cache_len=256,
    ...                                cache_backend="paged")
    >>> rid = srv.submit(prompt_ids, max_new_tokens=32)
    >>> outs = srv.run()            # {rid: np.ndarray of new tokens}

    The constructor keeps the JAX server's argument names and defaults;
    ``cache_backend="paged"`` must be given (the dense default is not
    ported). ``serving_mode="fused"`` runs each tick as one fused-tick
    pass (prefill chunks and decode rows in one kernel launch per
    layer) in place of the split prefill launch and decode step; the
    tokens are the same. ``do_sample=True`` draws each token from
    ``process_logits(logits, temperature, top_k, top_p)`` on the
    request's threefry chain, bit for bit the JAX server's. With
    ``auto_prefix_cache=True`` every finished request donates its full
    prompt pages into a radix tree, every admission reuses the longest
    cached page-aligned prefix and prefills only the remainder, and
    unpinned cached pages are evicted LRU when the
    allocator runs short. ``submit(deadline_s=...)`` bounds a request's
    time, ``max_queue`` + ``shed_policy`` bound the queue, and
    ``start()``/``wait()``/``stop()`` serve from a background thread.
    """

    def __init__(self, model, max_slots=4, max_cache_len=256,
                 do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                 eos_token_id=None, seed=0, weight_dtype=None,
                 prefill_chunk=None, mesh=None, tick_block=1,
                 cache_dtype=None, cache_backend="dense", page_size=16,
                 num_pages=None, auto_prefix_cache=True,
                 admission="reserve", headroom_pages=1,
                 preemption_policy=None,
                 prefill_mode=None, prefill_tokens_per_tick=None,
                 max_admissions_per_tick=None, serving_mode=None,
                 telemetry=None,
                 recorder=None, ledger=None, journeys=None, costs=None,
                 host_tier=None, host_tier_bytes=None,
                 max_queue=None, shed_policy="reject",
                 retry_policy=None, breaker=None, fault_injector=None,
                 clock=None, role="hybrid"):
        if role not in ("prefill", "decode", "hybrid"):
            raise ValueError(
                "role must be 'prefill', 'decode' or 'hybrid', got "
                f"{role!r}")
        if cache_backend not in ("dense", "paged"):
            raise ValueError(f"cache_backend must be 'dense' or 'paged', "
                             f"got {cache_backend!r}")
        if prefill_mode not in (None, "dense", "ragged"):
            raise ValueError(f"prefill_mode must be 'dense' or 'ragged',"
                             f" got {prefill_mode!r}")
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or "
                             f"'optimistic', got {admission!r}")
        if serving_mode is None:
            serving_mode = "split"
        if serving_mode not in ("split", "fused"):
            raise ValueError(f"serving_mode must be 'split' or "
                             f"'fused', got {serving_mode!r}")
        if shed_policy not in ("reject", "evict_oldest"):
            raise ValueError(f"shed_policy must be 'reject' or "
                             f"'evict_oldest', got {shed_policy!r}")
        if serving_mode == "fused":
            if cache_backend != "paged":
                raise ValueError(
                    "serving_mode='fused' needs cache_backend='paged' "
                    "(the fused tick writes straight into pool pages "
                    "through a live-page schedule)")
            if prefill_mode == "dense":
                raise ValueError(
                    "serving_mode='fused' needs prefill_mode='ragged' "
                    "(the fused launch packs the ragged scheduler's "
                    "prompt chunks)")
            if mesh is not None:
                raise _not_ported("serving_mode='fused' with mesh=", 9,
                                  "the fleet")
            if int(tick_block) != 1:
                raise NotImplementedError(
                    "serving_mode='fused' runs ONE decode row per slot "
                    "per launch; tick_block > 1 needs multi-token rows "
                    "per slot, the verify shape of speculative decoding "
                    "(ROADMAP, Queue 1 item 12: remaining inference "
                    "modules); use tick_block=1 or serving_mode='split'")
        if cache_backend == "dense" or prefill_mode == "dense":
            raise _not_ported("the dense cache backend and dense prefill",
                              5, "the dense backend")
        if int(tick_block) != 1:
            raise _not_ported("tick_block > 1", 6,
                              "block decode on the split tick")
        if admission == "optimistic":
            raise _not_ported("admission='optimistic'", 7,
                              "optimistic admission and preemption")
        for name, value in (("telemetry", telemetry),
                            ("recorder", recorder), ("ledger", ledger),
                            ("journeys", journeys), ("costs", costs),
                            ("fault_injector", fault_injector),
                            ("retry_policy", retry_policy),
                            ("breaker", breaker)):
            if value is not None:
                raise _not_ported(f"{name}=", 8,
                                  "telemetry and reliability")
        if mesh is not None:
            raise _not_ported("mesh=", 9, "the fleet")
        if host_tier is not None or host_tier_bytes is not None:
            raise _not_ported("host_tier=", 9, "the fleet")
        # ``prefill_chunk`` sizes the dense prefill only (ragged
        # admission chunks by the per-tick token budget) and ``role`` is
        # a placement hint for the fleet router: both are accepted and
        # unused, as in the JAX server's ragged mode. Greedy decoding
        # reads no seed and no sampling parameter.
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.max_cache_len = int(max_cache_len)
        self.eos_token_id = eos_token_id
        self.do_sample = bool(do_sample)
        self._temperature = float(temperature)
        self._top_k = int(top_k)
        self._top_p = float(top_p)
        self._seed = int(seed)

        page_size = int(page_size)
        if self.max_cache_len % page_size:
            raise ValueError(
                f"page_size ({page_size}) must divide max_cache_len "
                f"({self.max_cache_len})")
        pages_per_slot = self.max_cache_len // page_size
        if num_pages is None:     # worst case: every slot maxed out
            num_pages = self.max_slots * pages_per_slot + 1
        self.page_size = page_size
        self.serving_mode = serving_mode
        self._fused = serving_mode == "fused"
        (self._init_caches, self._embed_fn, self._step_fn, self._head_fn,
         _, self._ragged_fn, self._fused_fn) = model._decode_bundle(
            self.max_cache_len, weight_dtype, mesh, cache_dtype,
            cache_backend="paged", page_size=page_size,
            num_pages=int(num_pages))
        self._kv = PagedKVCache(int(num_pages), page_size, self.max_slots,
                                pages_per_slot)
        self._caches = self._init_caches(self.max_slots)
        self._prefix = PrefixCache(self._kv)
        self._kv.reclaimer = self._reclaim_pages
        self._auto_prefix = bool(auto_prefix_cache)

        if prefill_tokens_per_tick is None:
            prefill_tokens_per_tick = self.max_cache_len
        self._prefill_budget = int(prefill_tokens_per_tick)
        if self._prefill_budget < 1:
            raise ValueError("prefill_tokens_per_tick must be >= 1")
        self._admit_cap = None if max_admissions_per_tick is None \
            else int(max_admissions_per_tick)
        if self._admit_cap is not None and self._admit_cap < 1:
            raise ValueError("max_admissions_per_tick must be >= 1 "
                             "(0 would admit nothing, forever)")
        self._prefill_fifo = []   # slot ids mid-prefill, admission order
        self._prefill_used = 0    # tokens prefilled this tick
        # slot-state updates batched into one device write per array
        # per tick
        self._pending_tok = {}
        self._pending_t = {}
        self._tok = torch.zeros((self.max_slots,), dtype=torch.int32,
                                device=self.device)
        self._t = torch.zeros((self.max_slots,), dtype=torch.int32,
                              device=self.device)
        # sampling: each slot's threefry key on the device, the keys of
        # this tick's activations (pushed with the slot state), and the
        # split decode draw's constant flags (no fresh key, every row
        # splits, as the reference's vmap over slots)
        self._keys = torch.zeros((self.max_slots, 2), dtype=torch.int32,
                                 device=self.device).view(torch.uint32)
        self._pending_key = {}
        if self.do_sample and not self._fused:
            self._no_fresh = torch.zeros((self.max_slots,),
                                         dtype=torch.int32,
                                         device=self.device)
            self._all_emit = torch.ones((self.max_slots,),
                                        dtype=torch.int32,
                                        device=self.device)
        self._active = np.zeros((self.max_slots,), bool)   # host-side
        self._slots = [None] * self.max_slots
        self._queue = []
        self._results = {}
        self._next_rid = 0
        self.stats = {"prefill_tokens": 0, "prefix_hit_tokens": 0,
                      "prefix_auto_hits": 0, "prefix_auto_hit_tokens": 0,
                      "admissions": 0, "prefill_dispatches": 0,
                      "tick_dispatches": 0,
                      # launches of the device programs (split ticks:
                      # ragged prefill and decode; fused ticks: the
                      # fused tick), and rows of emitting slots whose
                      # logits (when sampling, filtered ones) held a NaN
                      # or an Inf
                      "prefill_launches": 0, "decode_ticks": 0,
                      "fused_launches": 0, "nonfinite_logit_rows": 0,
                      # seeded draws (one R1 launch on the card each)
                      "sample_launches": 0}
        self._clock = clock if clock is not None else MonotonicClock()
        self._tick_disp = {}      # this tick's {op: dispatches}
        self._failures = {}       # rid -> exception, for wait()
        self._run_failures = {}   # last run()'s drained failures
        self._lock = threading.RLock()
        self._done_cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._thread = None
        self._thread_error = None
        self._deferred_cbs = []   # (cb, rid, tokens) fired OUTSIDE the lock
        self._max_queue = None if max_queue is None else int(max_queue)
        self._shed_policy = shed_policy
        self._accepting = True    # False while draining / after stop
        self._draining = False

    def register_prefix(self, prefix_ids):
        raise _not_ported("register_prefix (it prefills through the dense "
                          "bundle)", 5, "the dense backend")

    # ------------------------------------------------------------ queue
    def submit(self, input_ids, max_new_tokens=32, seed=None,
               on_token=None, deadline_s=None, priority=0,
               journey=None):
        """Queue a prompt; returns a request id. The FIRST generated
        token comes from the prompt's last prefill chunk.
        ``on_token(rid, tokens)`` streams each harvested chunk.
        ``seed`` only matters to sampling: the request's chain starts at
        ``PRNGKey(seed)``, and ``None`` resolves to the server's seed
        plus the request id, as the JAX server does. ``deadline_s``
        bounds the request's total time from submit: a request still
        queued when it expires fails with ``DeadlineExceeded``; one
        expiring in flight is cancelled and its partial tokens become
        the result. With ``max_queue`` set, a
        full queue sheds per ``shed_policy``. ``priority`` only matters
        under optimistic admission and is ignored here, as in the JAX
        server's reserve mode."""
        if journey is not None:
            raise _not_ported("submit(journey=)", 8,
                              "telemetry and reliability")
        if torch.is_tensor(input_ids):
            input_ids = input_ids.detach().cpu().numpy()
        ids = np.asarray(input_ids).astype(np.int32)
        if ids.ndim == 2:
            if ids.shape[0] != 1:
                raise ValueError("submit() takes one request; batch by "
                                 "calling submit() per row")
            ids = ids[0]
        T = ids.shape[0]
        if T < 1:
            raise ValueError("submit() needs a prompt of at least one "
                             "token")
        with self._lock:
            if not self._accepting:
                raise ServerClosed("server is stopped; not accepting new "
                                   "requests")
            if deadline_s is not None and deadline_s <= 0:
                raise DeadlineExceeded(
                    f"deadline_s={deadline_s} is already expired")
            if T + max_new_tokens > self.max_cache_len:
                raise ValueError(
                    f"prompt ({T}) + max_new_tokens ({max_new_tokens}) "
                    f"exceeds max_cache_len ({self.max_cache_len})")
            # full-extent reservation (prompt + budget): a request that
            # can never fit must fail HERE, not stall the FIFO forever
            need = self._npages_for(T + int(max_new_tokens))
            usable = self._kv.num_pages - 1
            if need > usable:
                raise ValueError(
                    f"prompt ({T}) + max_new_tokens ({max_new_tokens}) "
                    f"needs {need} pages but only {usable} are usable — "
                    f"grow num_pages")
            if (self._max_queue is not None
                    and len(self._queue) >= self._max_queue):
                if self._shed_policy == "reject" or not self._queue:
                    raise QueueFullError(
                        f"queue holds {len(self._queue)} requests "
                        f"(max_queue={self._max_queue}); shed_policy="
                        f"'reject' — resubmit with backoff")
                old = self._queue.pop(0)
                self._failures[old.rid] = QueueFullError(
                    f"request {old.rid} evicted by a newer submit "
                    f"(queue full at max_queue={self._max_queue}, "
                    f"shed_policy='evict_oldest')")
                self._done_cv.notify_all()
            rid = self._next_rid
            self._next_rid += 1
            if seed is None:
                seed = self._seed + rid     # the reference's default rule
            deadline = None if deadline_s is None \
                else self._clock.now() + float(deadline_s)
            self._queue.append(_Pending(rid, ids, int(max_new_tokens),
                                        on_token, deadline, int(seed)))
        return rid

    def cancel(self, rid):
        """Drop a request: un-queue it, or free its slot mid-flight (the
        partial result is recorded under the rid). Returns True if the
        request was found live."""
        with self._lock:
            for i, item in enumerate(self._queue):
                if item.rid == rid:
                    del self._queue[i]
                    self._failures[rid] = RequestCancelled(
                        f"request {rid} cancelled while queued")
                    self._done_cv.notify_all()
                    return True
            for slot in range(self.max_slots):
                st = self._slots[slot]
                if st is not None and st.rid == rid:
                    self._finish_partial_locked(slot)
                    self._done_cv.notify_all()
                    return True
            return False

    def _release_slot(self, slot):
        """Tear down a slot's host and page state. With auto prefix
        caching the request's written full prompt pages are DONATED into
        the radix tree; everything else returns to the free list."""
        st = self._slots[slot]
        self._active[slot] = False
        self._slots[slot] = None
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)
        pages = self._kv.detach_slot(slot)
        if not pages:
            return
        if self._auto_prefix and st is not None:
            self._prefix.donate(st.ids, pages, min(st.prompt_len, st.filled))
        else:
            self._kv.release(pages)

    def _finish_partial_locked(self, slot):
        """Record the slot's partial tokens as its rid's result and tear
        the slot down (cancel, deadline expiry, hard stop)."""
        st = self._slots[slot]
        self._results[st.rid] = np.asarray(st.emitted[:st.budget], np.int32)
        self._release_slot(slot)
        return st

    # ---------------------------------------------------- paged backend
    def _sync_block_table(self):
        """Copy the host block-table mirror into the device table the
        kernels read, when a row changed."""
        if self._kv.dirty:
            self._caches["bt"].copy_(
                torch.from_numpy(self._kv.block_table))
            self._kv.dirty = False
            self._tick_dispatch("block_table")

    def pool_balance(self):
        """``(free, live, pinned, cached)`` page counts summing to the
        usable pool (``num_pages - 1``; page 0 is the null page).
        ``live`` pages belong to slots, ``cached`` to the automatic
        prefix cache; ``pinned`` (registered prefixes) stays 0 until
        ``register_prefix`` is ported. ``live == 0`` once drained means
        no page leaked."""
        with self._lock:
            free = self._kv.free_pages()
            pinned = 0
            cached = self._prefix.cached_pages
            live = self._kv.used_pages() - pinned - cached
            return free, live, pinned, cached

    def _reclaim_pages(self, shortfall):
        """``PagedKVCache.alloc``'s reclaimer: evict LRU cached prefix
        pages when the free list runs short."""
        return self._prefix.evict(shortfall)

    def _best_hit(self, ids):
        """The longest cached page-aligned prefix of ``ids``, capped one
        token short of the prompt (the remainder prefill must emit the
        first-token logits), or None."""
        return self._prefix.lookup(ids, int(ids.shape[0]) - 1)

    def _head_fits_pool(self, head, best):
        """Can the pool take ``head``'s full extent now? Evictable
        cached pages count as headroom, minus the nodes the head's own
        hit is about to share."""
        shared, nodes = (0, ()) if best is None \
            else (len(best.nodes), best.nodes)
        need = self._npages_for(head.ids.shape[0] + head.budget) - shared
        avail = self._kv.free_pages() \
            + self._prefix.evictable_pages(exclude=nodes)
        return avail >= need

    def _npages_for(self, n_tokens):
        return -(-int(n_tokens) // self._kv.page_size)

    # ------------------------------------------------------- scheduling
    def _admit(self, run_prefill=True):
        """Pop queued requests into free slots (reservation only: the
        full prompt + budget extent, cache-hit pages shared by
        reference), then run one batched ragged prefill launch over
        every slot with prompt rows still to write. OutOfPages DEFERS
        the head request (FIFO kept); any other admission error fails
        that request alone."""
        admitted = 0
        for slot in range(self.max_slots):
            if self._admit_cap is not None and admitted >= self._admit_cap:
                break
            if self._slots[slot] is not None:
                continue
            if not self._queue:
                break
            item = self._queue[0]
            best = self._best_hit(item.ids)
            if not self._head_fits_pool(item, best):
                break
            req = self._queue.pop(0)
            try:
                self._reserve_one(slot, req, best)
            except OutOfPages:
                self._queue.insert(0, req)
                break
            except Exception as e:
                if self._kv.slot_pages(slot):
                    self._kv.free_slot(slot)     # roll back a part-admit
                self._active[slot] = False
                self._slots[slot] = None
                if slot in self._prefill_fifo:
                    self._prefill_fifo.remove(slot)
                self._failures[req.rid] = e
                self._done_cv.notify_all()
            else:
                admitted += 1
        if run_prefill:
            self._prefill_tick()

    def _reserve_one(self, slot, req, best):
        """Reserve ``slot`` for ``req``: full-extent pages (cache-hit
        pages joined by reference) and a prefill-phase slot record. The
        prompt's chunks run in ``_prefill_tick`` launches."""
        ids = req.ids
        T = ids.shape[0]
        n_pre, pre_pages = (0, []) if best is None \
            else (best.tokens, best.pages)
        self._kv.admit_slot(slot, T + req.budget, pre_pages)
        self.stats["prefix_hit_tokens"] += n_pre
        if best is not None:
            # no prefix is ever pinned here (register_prefix is not
            # ported), so every hit is an automatic one
            self._prefix.use(best)            # LRU: reuse is recency
            self.stats["prefix_auto_hits"] += 1
            self.stats["prefix_auto_hit_tokens"] += n_pre
        st = _Slot(req.rid, ids, T, req.budget, req.on_token,
                   req.deadline, req.seed)
        st.fill_pos = st.filled = n_pre
        self._slots[slot] = st
        self._prefill_fifo.append(slot)
        if not self._fused:
            # park the slot's decode write position past the block
            # table: until activation, its wasted decode-step writes
            # null-redirect (zeroed) instead of landing in the pages
            # being prefilled. (Fused ticks keep no device-resident slot
            # state: mid-prefill slots ride the launch as real prefill
            # rows, idle ones are skipped by the kernel.)
            self._pending_t[slot] = self.max_cache_len

    def _chunk_plan(self):
        """The next prompt chunk of every mid-prefill slot, oldest
        admission first, under what is left of the tick's token budget:
        ``[(slot, start, take)]``, with the budget charged, and the chunk
        width C — the longest take padded up a power-of-two ladder, at
        least 2 (a 1-row chunk would take the decode path of a split
        layer)."""
        budget = self._prefill_budget - self._prefill_used
        plan = []
        used = 0
        for slot in self._prefill_fifo:
            if used >= budget:
                break
            st = self._slots[slot]
            take = min(st.prompt_len - st.fill_pos, budget - used)
            plan.append((slot, st.fill_pos, take))
            used += take
        self._prefill_used += used
        C = max(2, 1 << (max(t for _, _, t in plan) - 1).bit_length()) \
            if plan else 0
        return plan, C

    def _advance(self, plan):
        """The planned chunks are written: move each slot's fill
        position."""
        for slot, start, take in plan:
            st = self._slots[slot]
            st.fill_pos = st.filled = start + take
            self.stats["prefill_tokens"] += take

    def _prefill_tick(self):
        """Run one batched ragged prefill launch: the next chunk of
        every mid-prefill slot (``_chunk_plan``)."""
        plan, C = self._chunk_plan()
        if not plan:
            return
        S = self.max_slots
        toks = np.zeros((S, C), np.int32)
        t0 = np.full((S,), self.max_cache_len, np.int32)  # idle sentinel
        out_idx = np.zeros((S,), np.int32)
        done = []
        for slot, start, take in plan:
            st = self._slots[slot]
            toks[slot, :take] = st.ids[start:start + take]
            t0[slot] = start
            if start + take == st.prompt_len:
                out_idx[slot] = take - 1
                done.append(slot)
        self._sync_block_table()
        dev = self.device
        logits, self._caches = self._ragged_fn(
            torch.from_numpy(toks).to(dev), torch.from_numpy(t0).to(dev),
            self._caches, torch.from_numpy(out_idx).to(dev))
        self._count_dispatches(1, op="prefill")
        self.stats["prefill_launches"] += 1
        self._advance(plan)
        if done:
            firsts = self._pick(logits[torch.tensor(done, device=dev)],
                                done)
            for slot, first in zip(done, firsts):
                self._activate(slot, first)

    def _pick(self, logits, slots):
        """First tokens of ``logits`` rows [n, V] of ``slots`` as a host
        list (one device-to-host copy); rows holding a NaN or an Inf are
        counted in ``stats["nonfinite_logit_rows"]``. Greedy: the argmax.
        Sampling: each slot's chain starts at ``PRNGKey(seed)``, is split
        once and draws from the filtered row (the reference's eager
        ``_activate``: a true division by the temperature); the kept
        halves wait in ``_pending_key`` for the tick's state push."""
        if not self.do_sample:
            nxt = torch.argmax(logits, -1).to(torch.int32)
            bad = (~torch.isfinite(logits).all(-1)).to(torch.int32)
        else:
            n = len(slots)
            seeds = torch.from_numpy(self._wrap_seeds(
                [self._slots[s].seed for s in slots])).to(self.device)
            ones = torch.ones((n,), dtype=torch.int32, device=self.device)
            nxt, keys, bad = self._draw(logits, self._keys[:n], seeds,
                                        ones, ones, reciprocal=False)
            for i, slot in enumerate(slots):
                self._pending_key[slot] = keys[i]
        host = torch.stack([nxt, bad]).cpu().numpy()
        self.stats["nonfinite_logit_rows"] += int(host[1].sum())
        return [int(x) for x in host[0]]

    @staticmethod
    def _wrap_seeds(seeds):
        """Seeds as int32 by two's-complement wrap (``PRNGKey`` of the
        wrapped value is ``PRNGKey`` of the seed: both take its low 32
        bits), as the reference packs them for its fused tick."""
        return np.asarray([s & prng.MASK for s in seeds],
                          np.uint32).view(np.int32)

    def _draw(self, logits, keys, seeds, fresh, emit, reciprocal):
        """One seeded draw a row (R1 on the card) over
        ``process_logits``' filtered rows: (tokens, keys out, non-finite
        row flags), all on the device. The flags read the raw rows, as
        greedy's do: the filters fill a row holding a NaN or an Inf with
        ``-1e30``."""
        rows = process_logits(logits, self._temperature, self._top_k,
                              self._top_p, reciprocal=reciprocal)
        self.stats["sample_launches"] += 1
        return sample_rows(rows, keys, seeds, fresh, emit, raw=logits)

    def _activate(self, slot, first):
        """A slot's prompt is fully written and ``first`` is its first
        token: flip it into the decode phase."""
        st = self._slots[slot]
        self._pending_tok[slot] = first
        self._pending_t[slot] = st.prompt_len
        self._active[slot] = True
        self._prefill_fifo.remove(slot)
        st.emitted.append(first)
        st.stream(self._deferred_cbs)
        self.stats["admissions"] += 1

    def _flush_slot_state(self):
        """Write pending per-slot decode state (first token, write
        position and, when sampling, the key) into the device arrays the
        decode step reads — one batched write per array per tick."""
        for pending, arr in ((self._pending_tok, self._tok),
                             (self._pending_t, self._t)):
            if pending:
                idx = torch.tensor(list(pending), dtype=torch.long,
                                   device=self.device)
                arr[idx] = torch.tensor(list(pending.values()),
                                        dtype=torch.int32,
                                        device=self.device)
                pending.clear()
                self._count_dispatches(1, op="state_push")
        if self._pending_key:
            idx = torch.tensor(list(self._pending_key), dtype=torch.long,
                               device=self.device)
            # uint32 has no index_put or stack: write through int32 views
            self._keys.view(torch.int32)[idx] = torch.stack(
                [k.view(torch.int32) for k in self._pending_key.values()])
            self._pending_key.clear()
            self._count_dispatches(1, op="state_push")

    def _count_dispatches(self, n=1, op="prefill"):
        """Account ``n`` device dispatches of the admission/prefill path
        (prefill launches, slot-state writes) in the tick's profile."""
        self.stats["prefill_dispatches"] += n
        self._tick_dispatch(op, n)

    def _tick_dispatch(self, op, n=1):
        self._tick_disp[op] = self._tick_disp.get(op, 0) + n

    @torch.no_grad()
    def _decode(self):
        """One batched decode step over every slot; returns the new
        tokens [slots, 1] on the host. Rows of slots with no live decode
        work (empty, finished or mid-prefill) ride along: their writes
        null-redirect and their tokens are discarded. Sampling splits
        every slot's key, as the reference's vmap over slots does (the
        idle slots' keys are replaced when they activate), and scales by
        the temperature's reciprocal, as its jitted step does."""
        x = self._embed_fn(self._tok, self._t)
        out, self._caches = self._step_fn(x, self._caches, self._t)
        logits = self._head_fn(out)[:, -1]
        live = torch.from_numpy(self._active).to(self.device)
        if self.do_sample:
            self._tok, self._keys, bad = self._draw(
                logits, self._keys, self._no_fresh, self._no_fresh,
                self._all_emit, reciprocal=True)
            bad = (bad.bool() & live).to(torch.int32)
        else:
            self._tok = torch.argmax(logits, -1).to(torch.int32)
            bad = (~torch.isfinite(logits).all(-1) & live).to(torch.int32)
        self._t = self._t + 1
        host = torch.stack([self._tok, bad]).cpu().numpy()
        self.stats["nonfinite_logit_rows"] += int(host[1].sum())
        self.stats["decode_ticks"] += 1
        self._tick_dispatch("decode")
        return host[0][:, None]

    def step(self):
        """One server tick: admit waiting requests and run their prefill
        chunks, run one batched decode step, harvest finished rows.
        Returns the number of active slots after the tick."""
        with self._lock:
            n = self._step_locked()
        self._fire_callbacks()
        return n

    def _fire_callbacks(self):
        """Run the streamed-token callbacks collected under the lock;
        every one fires even when another raises, then the failures are
        raised together as a ``CallbackError``."""
        cbs, self._deferred_cbs = self._deferred_cbs, []
        errors = []
        for cb, rid, toks in cbs:
            try:
                cb(rid, toks)
            except Exception as e:
                errors.append((rid, e))
        if errors:
            raise CallbackError(errors, what="on_token callback")

    def _step_locked(self):
        self._tick_disp = {}
        try:
            return self._step_inner()
        finally:
            self.stats["tick_dispatches"] += sum(self._tick_disp.values())

    def _activate_fused(self, slot, first):
        """A slot's prompt completed inside the fused launch, which also
        gave its first token: flip it into the decode phase. No device
        state to push: the next tick's launch carries the token."""
        st = self._slots[slot]
        self._active[slot] = True
        self._prefill_fifo.remove(slot)
        st.emitted.append(first)
        st.stream(self._deferred_cbs)
        self.stats["admissions"] += 1

    def _fused_inputs(self, *parts):
        """The tick's small int32 host arrays packed into one buffer and
        moved to the device in ONE copy; returns device views of it in
        argument order."""
        buf = torch.from_numpy(np.concatenate(
            [a.reshape(-1) for a in parts])).to(self.device)
        views, at = [], 0
        for a in parts:
            views.append(buf[at:at + a.size].view(a.shape))
            at += a.size
        return views

    def _step_fused(self):
        """One fused serving tick (``serving_mode="fused"``): admit
        (reservations only), pack every slot's work — the next prompt
        chunk of each mid-prefill slot under the per-tick token budget,
        the single decode row of each live slot — and run it as one
        fused-tick entry call over a page schedule covering only live
        pages. The tick's dispatch profile is ``{"fused": 1}``."""
        self._prefill_used = 0
        self._expire_locked()
        self._admit(run_prefill=False)     # reserve; chunks ride the launch
        # harvest BEFORE packing: a slot whose budget is spent (or that
        # emitted eos at activation) must not decode further
        self._harvest()
        S = self.max_slots
        pg = self.page_size
        plan, C = self._chunk_plan()
        dec_slots = [s for s in range(S) if self._active[s]]
        if not plan and not dec_slots:
            return 0
        C = max(C, 1)          # a decode-only tick packs one row per slot
        tokens = np.zeros((S, C), np.int32)
        t0 = np.full((S,), self.max_cache_len, np.int32)   # idle sentinel
        last = np.full((S,), -1, np.int32)
        dec = np.zeros((S,), np.int32)
        emit = np.zeros((S,), np.int32)
        fresh = np.zeros((S,), np.int32)
        seeds = np.zeros((S,), np.int32)
        out_idx = np.zeros((S,), np.int32)
        done = []
        for slot, start, take in plan:
            st = self._slots[slot]
            tokens[slot, :take] = st.ids[start:start + take]
            t0[slot] = start
            last[slot] = start + take - 1
            if start + take == st.prompt_len:
                out_idx[slot] = take - 1
                emit[slot] = fresh[slot] = 1
                seeds[slot] = self._wrap_seeds([st.seed])[0]
                done.append(slot)
        for slot in dec_slots:
            st = self._slots[slot]
            t = st.prompt_len + len(st.emitted) - 1
            tokens[slot, 0] = st.emitted[-1]
            t0[slot] = last[slot] = t
            dec[slot] = emit[slot] = 1
        # the live block-table slice (a power-of-two width capped at the
        # table) and the schedule of live pages: the launch reads pages
        # up to the live frontier only, whatever the configured width
        live_pages = max(int(x) // pg + 1 for x in last if x >= 0)
        W = min(self._kv.pages_per_slot,
                max(1, 1 << (live_pages - 1).bit_length()))
        bt_live = np.ascontiguousarray(self._kv.block_table[:, :W])
        ss, sp, _ = build_schedule(last, pg, n_slots=S)
        self._kv.dirty = False     # the slice is the device's view
        draw = (emit, fresh, seeds) if self.do_sample else ()
        args = self._fused_inputs(tokens, t0, last, dec, out_idx, bt_live,
                                  ss, sp, *draw)
        logits, self._caches = self._fused_fn(*args[:4], self._caches,
                                              *args[4:8])
        if self.do_sample:
            # the reference's fused program: fresh slots start their
            # chain from their seed inside it, non-emitting slots keep
            # their key; jitted, so the temperature is a reciprocal
            emit_d, fresh_d, seeds_d = args[8:]
            nxt, self._keys, bad = self._draw(logits, self._keys, seeds_d,
                                              fresh_d, emit_d,
                                              reciprocal=True)
        else:
            nxt = torch.argmax(logits, -1).to(torch.int32)
            bad = (~torch.isfinite(logits).all(-1)).to(torch.int32)
        host = torch.stack([nxt, bad]).cpu().numpy()   # syncs the tick
        emitting = done + dec_slots
        self.stats["nonfinite_logit_rows"] += int(host[1][emitting].sum())
        self.stats["fused_launches"] += 1
        if plan:
            # the launch carries this tick's admission-path prefill work:
            # it IS the admission dispatch
            self._count_dispatches(1, op="fused")
        else:
            self._tick_dispatch("fused")
        self._advance(plan)
        for slot in done:
            self._activate_fused(slot, int(host[0][slot]))
        for slot in dec_slots:
            st = self._slots[slot]
            st.emitted.append(int(host[0][slot]))
            st.stream(self._deferred_cbs)
        self._harvest()
        # end-of-tick admissions reserve only: their chunks ride the
        # NEXT tick's launch (the token budget is per tick)
        self._admit(run_prefill=False)
        return int(self._active.sum())

    def _step_inner(self):
        if self._fused:
            return self._step_fused()
        self._prefill_used = 0       # per-tick prefill token budget
        self._expire_locked()
        self._admit()
        if not self._active.any():
            return 0
        # harvest BEFORE stepping: a slot whose budget is spent (or that
        # emitted eos as its first token) must not decode further
        self._harvest()
        if not self._active.any():
            return 0
        self._sync_block_table()
        # activations batched their tok/t updates, and slots still
        # prefilling carry parked write positions: push both first
        self._flush_slot_state()
        toks = self._decode()
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            st = self._slots[slot]
            st.emitted.append(int(toks[slot, 0]))
            st.stream(self._deferred_cbs)
        self._harvest()
        # end-of-tick admissions reserve only: their prefill chunks run
        # in the NEXT tick's launch (the token budget is per tick)
        self._admit(run_prefill=False)
        return int(self._active.sum())

    def _busy_locked(self):
        return bool(self._queue or self._active.any()
                    or self._prefill_fifo)

    def queue_depth(self):
        """Requests waiting for a slot (a lock-free point-in-time read)."""
        return len(self._queue)

    def in_flight(self):
        """Slots holding a live request, decoding or mid-prefill (a
        lock-free point-in-time read)."""
        return sum(1 for st in self._slots if st is not None)

    def _finished(self, st):
        if len(st.emitted) >= st.budget:
            return True
        return (self.eos_token_id is not None
                and st.emitted[-1] == self.eos_token_id)

    def _harvest(self):
        finished = False
        for slot in range(self.max_slots):
            st = self._slots[slot]
            if self._active[slot] and self._finished(st):
                self._results[st.rid] = np.asarray(st.emitted[:st.budget],
                                                   np.int32)
                self._release_slot(slot)   # donates prompt pages
                finished = True
        if finished:
            self._done_cv.notify_all()

    def _expire_locked(self):
        """Fail queued requests whose deadline passed (before a prefill
        is spent on them) and cancel expired in-flight slots (their
        partial tokens become the result). Reads the clock only when a
        live request carries a deadline."""
        now = None
        notify = False
        if any(item.deadline is not None for item in self._queue):
            now = self._clock.now()
            keep = []
            for item in self._queue:
                if item.deadline is not None and now >= item.deadline:
                    self._failures[item.rid] = DeadlineExceeded(
                        f"request {item.rid} expired in queue "
                        f"(deadline passed before admission)")
                    notify = True
                else:
                    keep.append(item)
            self._queue[:] = keep
        for slot in range(self.max_slots):
            st = self._slots[slot]
            if st is None or st.deadline is None:
                continue
            if now is None:
                now = self._clock.now()
            if now >= st.deadline:
                self._finish_partial_locked(slot)
                notify = True
        if notify:
            self._done_cv.notify_all()

    def _fail_request_locked(self, rid, err):
        """Fail ONE live request (queued or in flight) with ``err``; a
        rid already settled is left alone."""
        for i, item in enumerate(self._queue):
            if item.rid == rid:
                del self._queue[i]
                break
        else:
            for slot in range(self.max_slots):
                st = self._slots[slot]
                if st is not None and st.rid == rid:
                    self._release_slot(slot)
                    break
            else:
                return
        self._deferred_cbs = [c for c in self._deferred_cbs
                              if c[1] != rid]
        self._failures[rid] = err
        self._done_cv.notify_all()

    def run(self, max_ticks=100000):
        """Drive until queue and slots drain; returns {rid: new_tokens}.
        Requests that failed are left out — their exceptions are drained
        into ``failures``."""
        ticks = 0
        while ticks < max_ticks:
            with self._lock:
                if not self._busy_locked():
                    break
                self._step_locked()
            self._fire_callbacks()
            ticks += 1
        with self._lock:
            out, self._results = self._results, {}
            self._run_failures, self._failures = self._failures, {}
        return out

    # ------------------------------------------------------ serve thread
    def start(self, idle_sleep=0.005):
        """Run the tick loop on a background thread: ``submit()`` from
        any thread, collect results with ``wait(rid)``. A failing
        ``on_token`` callback fails its own request only; any other
        tick error ends the thread and is raised to every waiter (the
        JAX server's retrying supervisor and circuit breaker are not
        ported yet)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread_error = None
        with self._lock:
            self._accepting = True
            self._draining = False

        def loop():
            try:
                while True:
                    with self._lock:
                        busy = self._busy_locked()
                    if self._stop.is_set() and not (self._draining
                                                    and busy):
                        break
                    if not busy:
                        _time_mod.sleep(idle_sleep)
                        continue
                    try:
                        with self._lock:
                            if self._busy_locked():
                                self._step_locked()
                        self._fire_callbacks()
                    except CallbackError as ce:
                        with self._lock:
                            for rid, err in ce.errors:
                                self._fail_request_locked(
                                    rid, CallbackError(
                                        [(rid, err)],
                                        what="on_token callback"))
            except BaseException as e:   # surface to waiters, don't wedge
                with self._lock:
                    self._thread_error = e
                    self._done_cv.notify_all()
                raise

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=60.0, drain=False):
        """Stop the serve thread. ``drain=True`` closes admission and
        keeps ticking until every queued and in-flight request has
        finished; ``drain=False`` stops after the current tick, records
        in-flight partials and fails still-queued requests with
        ``ServerClosed``."""
        with self._lock:
            self._accepting = False
            if drain and self._thread is not None:
                self._draining = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"serve thread did not stop within {timeout}s; call "
                    f"stop() again to re-join")
            self._thread = None
        with self._lock:
            self._draining = False
            if not drain:
                for slot in range(self.max_slots):
                    if self._slots[slot] is not None:
                        self._finish_partial_locked(slot)
                for item in self._queue:
                    self._failures[item.rid] = ServerClosed(
                        f"request {item.rid} was still queued when the "
                        f"server stopped")
                self._queue.clear()
                self._deferred_cbs.clear()
            self._done_cv.notify_all()

    def wait(self, rid, timeout=120.0):
        """Block until ``rid`` finishes (requires start()); returns its
        new tokens. Typed reliability failures are raised directly,
        other per-request errors wrapped in a ``RuntimeError``; a dead
        serve thread raises for every waiter."""
        deadline = _time_mod.monotonic() + timeout
        with self._done_cv:
            while True:
                if rid in self._results:
                    return self._results.pop(rid)
                if rid in self._failures:
                    e = self._failures.pop(rid)
                    if isinstance(e, ReliabilityError):
                        raise e
                    raise RuntimeError(
                        f"request {rid} failed at admission: {e}") from e
                if self._thread_error is not None:
                    raise RuntimeError(
                        "serve thread died") from self._thread_error
                remaining = deadline - _time_mod.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"request {rid} not finished in {timeout}s")
                self._done_cv.wait(timeout=min(remaining, 1.0))

    @property
    def failures(self):
        """{rid: exception} for failed requests: pending ones plus those
        drained by the last ``run()``."""
        with self._lock:
            return {**self._run_failures, **self._failures}
