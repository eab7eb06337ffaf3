"""Continuous-batching decode server over a dense KV cache or a paged
KV pool.

Port of ``paddle_tpu/inference/continuous_batching.py`` cut down to
``admission="reserve"`` on one card: the dense and paged cache backends,
dense or ragged prefill, split or fused ticks, ``tick_block`` decode
steps a split tick, registered and automatic prefix caching, and greedy
or seeded sampled decoding. A fixed pool of decode slots steps as one
batched decode step every tick; finished slots are refilled from the
queue without stopping the others.

``cache_backend="dense"`` (the default) gives every slot its own
``[max_cache_len]`` K/V rows a layer; each admission prefills its prompt
at batch 1 (``prefill_mode="dense"``, optionally in ``prefill_chunk``
chunks) and copies the rows into its slot. ``cache_backend="paged"``
keeps K/V in a global page pool addressed through per-slot block
tables. There, admissions only reserve pages under ragged prefill (its
default): every tick runs the next prompt chunk of ALL mid-prefill slots
straight into pool pages, under a per-tick token budget
(``prefill_tokens_per_tick``), so long prompts stream in across ticks
while live slots keep decoding; ``prefill_mode="dense"`` prefills each
admission at batch 1 as on the dense backend and scatters its rows into
its pages. ``register_prefix`` prefills a shared prefix once: dense
prefill seeds later admissions from its stored rows, ragged prefill
shares its pinned pages through the radix tree.

``serving_mode="split"`` (the default) runs a tick as one ragged-prefill
launch for the admission wave, then the s=1 decode step for live slots,
with the slot-state pushes between them. ``serving_mode="fused"`` runs
the whole tick as one fused-tick entry call: prefill chunks and decode
rows through one fused-tick launch per layer whose page schedule covers
only live pages, the tick's small host arrays riding in with one
host-to-device copy — the tick's dispatch profile is ``{"fused": 1}``.
A tick that carries both runs its decode rows as a pass of their own at
a decode-only tick's shapes, so a decode row's bits do not depend on
what else its tick packs (a replay after a preemption redraws its
parked tokens on the card too).

Sampling (``do_sample=True``) follows the reference's chains exactly:
a request's key is ``PRNGKey(seed)`` (``seed`` defaults to the server's
seed plus the request id), each token splits the slot's key and draws
``categorical`` from the other half over ``process_logits``' filtered
row, and a slot that does not emit keeps its key. The draw is one
launch a decode step on the card (R1, ``ops.kernels.sample_rows``), and
one for the first tokens a prefill gives; on fused ticks the keys ride
the launch on the card and come back with the tokens. Tokens equal the
JAX server's for the same seeds.

``tick_block=n`` runs n decode steps a split tick with one host read of
the ``[slots, n]`` token block; a slot that finishes mid-block wastes
the block's later rows (``stats["block_waste_tokens"]``), whose writes
past ``max_cache_len`` the caches drop. The fused tick refuses it, as
the reference does.

``admission="optimistic"`` (paged) admits a request with its prompt
pages plus ``headroom_pages`` only; decode grows each slot a page at a
time (before a split tick's dispatch, after a fused tick's harvest and
before its packing), and when the pool runs dry the
``preemption_policy`` parks a victim: its written prompt pages are
donated cold into the prefix cache, the rest freed, and a record
carrying its resolved seed, absolute deadline, stream offset and
partial tokens waits on the preempted queue. Re-admission replays it
from the prompt (hitting whatever of its donated pages survived): the
same chain from ``PRNGKey(seed)``, the stream resumed at its old offset.
``submit(priority=...)`` sets the preemption class and makes admission
priority-aware.

Reliability: ``fault_injector`` arms the chaos points of the JAX server
(``server.prefill``, ``server.decode_tick``, ``server.preempt``,
``server.on_token``; ``kv.alloc`` and ``kv.grow`` in the page pool,
``prefix.donate`` and ``prefix.evict`` in the prefix cache), each where
the reference has it: no device write of a failed tick happens before
its point, so a retried tick draws the same keys. ``start()`` runs a
supervised loop (``retry_policy`` and ``breaker``: a failing tick is
retried with backoff; after ``breaker.failure_threshold`` failures in a
row every waiter is failed with ``CircuitOpenError`` and ``health``
goes ``degraded`` until a probe tick passes).

Telemetry (``paddle_tpu_torch.telemetry``), each option off by default
(``None``: every hook site costs one ``is None`` check, no lock and no
clock read; a disabled object is treated as ``None``; ``True`` builds a
default one): ``telemetry`` (``ServerTelemetry``: TTFT, TPOT, queue
wait, tick and dispatch histograms, pool gauges, request spans),
``recorder`` (``FlightRecorder``: an event ring and postmortem bundles,
one on every request failure and breaker open), ``ledger``
(``GoodputLedger``: each tick's device tokens by kind), ``costs``
(``CostCatalog``: each launch priced by ``models.costs``' analytic
model, the compile watch over static tick shapes, the tick's wall by
phase, MFU) and ``journeys`` (``JourneyRecorder``: per-request
timelines, ``journey(rid)``), as the JAX server wires them.
``inference.serving.serve_metrics(srv)`` serves them over HTTP.

The fleet surface (paged): ``host_tier`` spills evicted prefix pages
to a checksummed host-RAM tier (``kv_tier.HostTier``) and an admission
that hits a spilled run restores it into fresh pool pages, bit for bit;
``prefix_sketch()`` is the router's affinity signal; ``migrate_out`` /
``migrate_in`` (and the staged ``migrate_in_begin`` /
``migrate_in_pages`` / ``migrate_in_commit``) move a live request's
written pages, resolved seed and emitted tokens to a sibling, which
continues it without re-prefilling; ``evacuate``, ``abandon`` and
``kill`` are the router's failover hooks (``inference.router``). The
state dict and the page payloads are the JAX server's, key for key and
byte for byte (a bf16 pool's pages as their ``uint16`` bit patterns),
so a request moves between the two packages' servers too. A decode
row's bits depend on the slot count (the decode step's GEMM shapes and
the split decode kernel's plan), so a migrated request continues
bit-exactly on a target built like its source.

Host/device split: the device runs the steps (``models.generation``; the
paged-attention, ragged-prefill and fused-tick kernels on a CUDA model,
dense attention in plain torch);
the host assigns slots, owns the page allocator and the radix prefix
cache (``kv_cache``, ``prefix_cache``), harvests finished rows and swaps
new prompts in.

The server reads no model config: any family the decode bundles serve
(Llama, Mixtral, GPT) runs on every mode, the pool's geometry coming
from the bundle's ``init_caches``. ``weight_dtype="int8"`` (both
backends) and ``cache_dtype="int8"`` (dense) pass through to the
bundles; a paged int8 cache is refused, as in the reference. The mesh
(the kv-head-sharded pool, ROADMAP Queue 1 item 9) is not ported yet and
raises ``NotImplementedError`` naming its item.
"""
import threading
import time as _time_mod

import numpy as np
import torch

from ..core import prng
from ..ops.kernels.fused_tick import build_schedule
from ..ops.kernels.sample_rows import sample_rows
from ..reliability import faults
from ..reliability.errors import (CallbackError, CircuitOpenError,
                                  DeadlineExceeded, MigrationError,
                                  PreemptedError, QueueFullError,
                                  ReliabilityError, RequestCancelled,
                                  ServerClosed)
from ..reliability.health import (DEAD, DEGRADED, DRAINING, HEALTHY,
                                  HealthMonitor)
from ..reliability.supervisor import ServeSupervisor
from ..telemetry.clock import MonotonicClock
from .decode_loop import process_logits
from .kv_cache import OutOfPages, PagedKVCache
from .kv_tier import HostTier, _sha256
from .prefix_cache import PrefixCache, PrefixMatch

__all__ = ["ContinuousBatchingServer", "PreemptionPolicy", "PoolBalance"]


def _not_ported(what, item, name):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP, Queue 1 "
        f"item {item}: {name})")


class _Pending:
    """A queued request awaiting a slot."""

    __slots__ = ("rid", "ids", "budget", "on_token", "deadline", "seed",
                 "priority", "journey")

    def __init__(self, rid, ids, budget, on_token, deadline, seed,
                 priority=0, journey=None):
        self.rid = rid
        self.ids = ids
        self.budget = budget
        self.on_token = on_token
        self.deadline = deadline      # absolute clock time, or None
        self.seed = seed              # resolved sampling seed (a Python int)
        self.priority = priority      # higher = preempted later
        self.journey = journey        # telemetry.Journey handle, or None


class _Slot:
    __slots__ = ("rid", "ids", "prompt_len", "budget", "emitted",
                 "on_token", "streamed", "deadline", "fill_pos", "filled",
                 "seed", "priority", "preempts", "replayed", "journey",
                 "n_pre", "phase", "reprefill_upto", "sent_pages")

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
        self.priority = 0             # preemption class (higher = safer)
        self.preempts = 0             # times this request was preempted
        # the partial recorded BEFORE a preemption: a resumed slot
        # replays the same chain, so the longer of (replayed, emitted)
        # is the request's partial; a deadline, cancel or hard stop
        # mid-replay must not hand the waiter fewer tokens than its
        # on_token stream already delivered
        self.replayed = ()
        self.journey = None           # telemetry.Journey handle, or None
        self.n_pre = 0                # prompt tokens a prefix hit covered
        self.phase = "decode"         # "prefill" while chunks remain
        # the goodput ledger's registered-prefix tail: prompt rows below
        # this that a ragged prefill launches re-prefill registered state
        self.reprefill_upto = 0
        # pages already shipped by a pipelined prefill handoff
        # (``migrate_out(partial=True)``); reset by ``migrate_abort``
        self.sent_pages = 0

    def partial(self):
        """The request's current partial output: the tokens replayed
        from before a preemption or the live emitted list, whichever is
        longer (they agree on the common prefix where the replay is
        bit-exact)."""
        return self.emitted if len(self.emitted) >= len(self.replayed) \
            else list(self.replayed)

    def stream(self, sink):
        """Queue this slot's unstreamed chunk on ``sink``; the server
        fires callbacks AFTER releasing its lock. A RESUMED slot starts
        with ``streamed`` at its pre-preemption offset, so the replayed
        tokens below it are never sent again."""
        if self.on_token is None:
            return
        upto = min(len(self.emitted), self.budget)
        if upto > self.streamed:
            sink.append((self.on_token, self.rid,
                         np.asarray(self.emitted[self.streamed:upto],
                                    np.int32)))
            self.streamed = upto


class _Preempted:
    """A request parked off its slot under pool pressure, awaiting
    re-admission (``admission="optimistic"``). Carries what a bit-exact
    replay needs: the RESOLVED sampling seed (the replayed chain draws
    the same tokens), the ABSOLUTE deadline (time spent parked keeps
    counting), ``streamed`` (on_token never re-sends delivered chunks)
    and ``emitted``, the longest partial so far, flushed as the result
    if the request must leave early (deadline, cancel, hard stop) before
    decode resumes."""

    __slots__ = ("rid", "ids", "budget", "seed", "on_token", "deadline",
                 "priority", "emitted", "streamed", "preempts", "journey")

    def __init__(self, st):
        self.rid = st.rid
        self.ids = st.ids
        self.budget = st.budget
        self.seed = st.seed
        self.on_token = st.on_token
        self.deadline = st.deadline
        self.priority = st.priority
        self.emitted = list(st.partial())
        self.streamed = st.streamed
        self.preempts = st.preempts + 1
        self.journey = st.journey


class PreemptionPolicy:
    """Victim selection for ``admission="optimistic"``: when a decode
    page grow finds the pool exhausted, ``pick`` names the slot whose
    pages are freed. The default order sacrifices the LEAST valuable
    work first: the lowest ``priority`` class, then the fewest tokens
    generated (the least recompute thrown away), then the youngest
    request (highest rid), so ties are deterministic and two runs with
    the same seeds preempt the same slots.

    The growing slot is itself a candidate: when it ranks last it parks
    ITSELF instead of evicting more valuable work. The ranking is then a
    strict total order over live slots, so the top request is never
    preempted, only gains tokens, and finishes: global progress follows
    by induction however hard the pool thrashes."""

    def key(self, slot, st):
        """Sort key over live slots; the MINIMUM is preempted first.
        Work is the request's TRUE partial (``st.partial()``, the longer
        of the pre-preemption tokens and the live replay): a resumed
        victim early in its replay keeps the seniority of the work it
        already did once, or every squeeze would pick the same
        just-resumed request again."""
        return (st.priority, len(st.partial()), -st.rid)

    def pick(self, grower, candidates):
        """``candidates`` is ``[(slot, _Slot)]`` for every live slot, the
        grower included. Returns the victim slot id (possibly
        ``grower`` itself), or None when there is nothing to free."""
        if not candidates:
            return None
        return min(candidates, key=lambda c: self.key(*c))[0]


class PoolBalance(tuple):
    """``pool_balance()``'s result: a plain ``(free, live, pinned,
    cached)`` 4-tuple (4-way unpacks keep working), with the optimistic
    admission state as ATTRIBUTES: ``preempted``, the requests parked
    on the preempted queue now (their pages are donated or freed, so
    they add nothing to ``live``), and ``preemptions``, the victims
    preempted so far.

    The host tier rides as attributes too: ``host``, the host-resident
    radix-tree nodes (spilled pages hold NO device page, so they stay
    outside the 4-tuple, which keeps summing to the usable pool), and
    ``host_bytes``, the tier's buffer bytes. ``num_shards``,
    ``per_shard`` and ``shard_page_bytes`` keep the JAX server's mesh
    view: the port's pool is one card's, one shard (the sharded pool is
    ROADMAP Queue 1 item 9)."""

    def __new__(cls, free, live, pinned, cached, preempted=0,
                preemptions=0, num_shards=1, per_shard=(),
                shard_page_bytes=None, host=0, host_bytes=0):
        self = super().__new__(cls, (free, live, pinned, cached))
        self.preempted = preempted
        self.preemptions = preemptions
        self.num_shards = num_shards
        self.per_shard = tuple(per_shard)
        self.shard_page_bytes = shard_page_bytes
        self.host = host
        self.host_bytes = host_bytes
        return self


class ContinuousBatchingServer:
    """Serve greedy or seeded sampled requests through a fixed slot pool
    over a dense KV cache or a paged KV pool, on the model's device.

    >>> srv = ContinuousBatchingServer(model, max_slots=4,
    ...                                max_cache_len=256)
    >>> rid = srv.submit(prompt_ids, max_new_tokens=32)
    >>> outs = srv.run()            # {rid: np.ndarray of new tokens}

    The constructor keeps the JAX server's argument names and defaults.
    ``cache_backend="dense"`` (the default) prefills each admission at
    batch 1 and gives each slot its own cache rows;
    ``cache_backend="paged"`` serves from a page pool, with ragged
    prefill (the default) or ``prefill_mode="dense"``.
    ``serving_mode="fused"`` (paged, ragged) runs each tick as one
    fused-tick pass (prefill chunks and decode rows in one kernel launch
    per layer) in place of the split prefill launch and decode step; the
    tokens are the same. ``tick_block=n`` runs n decode steps a split
    tick. ``do_sample=True`` draws each token from
    ``process_logits(logits, temperature, top_k, top_p)`` on the
    request's threefry chain, bit for bit the JAX server's.
    ``register_prefix`` prefills a shared prefix once for every later
    request that starts with it. With ``auto_prefix_cache=True`` (paged)
    every finished request donates its full prompt pages into a radix
    tree, every admission reuses the longest cached page-aligned prefix
    and prefills only the remainder, and unpinned cached pages are
    evicted LRU when the allocator runs short.
    ``admission="optimistic"`` (paged) reserves only the prompt plus
    ``headroom_pages`` at admission, grows slots on demand and preempts
    (and later replays, bit for bit) the ``preemption_policy``'s victims
    when the pool runs dry. ``submit(deadline_s=...)`` bounds a
    request's time, ``max_queue`` + ``shed_policy`` bound the queue,
    ``fault_injector`` arms the chaos points, and
    ``start()``/``wait()``/``stop()`` serve from a supervised background
    thread (``retry_policy``, ``breaker``; ``health``). ``telemetry``,
    ``recorder``, ``ledger``, ``costs`` and ``journeys`` wire the
    telemetry objects of ``paddle_tpu_torch.telemetry`` in (module
    docstring); ``goodput()``, ``device_costs()``, ``utilization()``,
    ``postmortems()`` and ``journey(rid)`` read them.
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
        paged = cache_backend == "paged"
        if prefill_mode is None:
            prefill_mode = "ragged" if paged else "dense"
        if prefill_mode not in ("dense", "ragged"):
            raise ValueError(f"prefill_mode must be 'dense' or 'ragged',"
                             f" got {prefill_mode!r}")
        if prefill_mode == "ragged" and not paged:
            raise ValueError("prefill_mode='ragged' needs "
                             "cache_backend='paged' (prefill writes "
                             "straight into pool pages)")
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or "
                             f"'optimistic', got {admission!r}")
        if admission == "optimistic" and not paged:
            raise NotImplementedError(
                "admission='optimistic' needs cache_backend='paged', as "
                "in the reference: the dense backend allocates every "
                "slot's full [max_cache_len] KV rows up front, so there "
                "is no pool to admit optimistically against; use "
                "cache_backend='paged'")
        if int(headroom_pages) < 0:
            raise ValueError("headroom_pages must be >= 0")
        if serving_mode is None:
            serving_mode = "split"
        if serving_mode not in ("split", "fused"):
            raise ValueError(f"serving_mode must be 'split' or "
                             f"'fused', got {serving_mode!r}")
        if shed_policy not in ("reject", "evict_oldest"):
            raise ValueError(f"shed_policy must be 'reject' or "
                             f"'evict_oldest', got {shed_policy!r}")
        self.tick_block = max(1, int(tick_block))
        if serving_mode == "fused":
            if not paged:
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
                                  "the fleet's kv-head-sharded pool")
            if self.tick_block != 1:
                raise NotImplementedError(
                    "serving_mode='fused' runs ONE decode row per slot "
                    "per launch; tick_block > 1 needs multi-token rows "
                    "per slot, the verify shape of speculative decoding, "
                    "which the reference's fused tick refuses too, naming "
                    "its own ROADMAP item 6 (its continuous_batching.py:"
                    "644-651); use tick_block=1 or serving_mode='split'")
        if mesh is not None:
            raise _not_ported("mesh=", 9, "the fleet's kv-head-sharded "
                              "pool")
        # disaggregated serving: the role is a PLACEMENT hint the router
        # reads — a "prefill" specialist runs ragged prefill and hands
        # finished prompt pages to decode replicas; its one hard rule is
        # refusing decode-phase migrate_in (it still decodes locally when
        # the fleet degrades to hybrid routing). "decode" is advisory.
        # Greedy decoding reads no seed and no sampling parameter.
        self.role = role
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
        # the dense bundle always exists: dense prefill and
        # register_prefix run on dense batch-1 caches whatever the
        # decode backend is
        self._bundle = model._decode_bundle(self.max_cache_len,
                                            weight_dtype, mesh, cache_dtype)
        (self._init_caches, self._embed_fn, self._step_fn, self._head_fn,
         _) = self._bundle
        self._prefill_chunk = prefill_chunk
        self.cache_backend = cache_backend
        self.serving_mode = serving_mode
        self._fused = serving_mode == "fused"
        self.prefill_mode = prefill_mode
        self._ragged = prefill_mode == "ragged"
        if paged:
            page_size = int(page_size)
            if self.max_cache_len % page_size:
                raise ValueError(
                    f"page_size ({page_size}) must divide max_cache_len "
                    f"({self.max_cache_len})")
            pages_per_slot = self.max_cache_len // page_size
            if num_pages is None:     # worst case: every slot maxed out
                num_pages = self.max_slots * pages_per_slot + 1
            self.page_size = page_size
            paged_bundle = model._decode_bundle(
                self.max_cache_len, weight_dtype, mesh, cache_dtype,
                cache_backend="paged", page_size=page_size,
                num_pages=int(num_pages))
            self._step_fn = paged_bundle[2]
            self._ragged_fn, self._fused_fn = paged_bundle[5:7]
            self._kv = PagedKVCache(int(num_pages), page_size,
                                    self.max_slots, pages_per_slot,
                                    fault_injector=fault_injector)
            self._caches = paged_bundle[0](self.max_slots)
            # host KV tier (``kv_tier.HostTier``): eviction SPILLS cold
            # prefix pages to checksummed host buffers instead of
            # dropping them, and admissions hitting a spilled run restore
            # it into fresh pool pages. True builds a default tier
            # (``host_tier_bytes`` bounds it; None = unbounded); None or
            # a disabled tier keeps eviction exactly as before
            if host_tier is None and host_tier_bytes is not None:
                host_tier = True
            if host_tier is True:
                host_tier = HostTier(budget_bytes=host_tier_bytes,
                                     fault_injector=fault_injector)
            self.host_tier = host_tier
            self._host = host_tier if (host_tier is not None
                                       and host_tier.enabled) else None
            if self._host is not None and self._host._faults is None:
                # a bare tier adopts the server's injector, so
                # tier.spill / tier.restore storms need no extra wiring
                self._host._faults = fault_injector
            self._prefix = PrefixCache(self._kv,
                                       fault_injector=fault_injector,
                                       host_tier=self._host,
                                       spill=self._spill_payload)
            self._kv.reclaimer = self._reclaim_pages
            self._auto_prefix = bool(auto_prefix_cache)
        else:
            if host_tier is True or (host_tier is not None
                                     and host_tier.enabled):
                raise ValueError("host_tier= needs cache_backend="
                                 "'paged' (the tier spills pool pages)")
            self.host_tier = None
            self._host = None
            self.page_size = None
            self._kv = None
            self._caches = self._init_caches(self.max_slots)
            self._prefix = None
            self._auto_prefix = False
            self._ragged_fn = self._fused_fn = None

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
        # "reserve" takes a request's full extent (prompt + budget) at
        # admission; "optimistic" the prompt plus headroom_pages, and
        # decode grows the slot on demand, preempting the policy's
        # victims when the pool runs dry
        self.admission = admission
        self._optimistic = admission == "optimistic"
        self._headroom_pages = int(headroom_pages)
        self._preempt_policy = preemption_policy \
            if preemption_policy is not None else PreemptionPolicy()
        self._preempted = []      # _Preempted records awaiting re-admission
        # rid -> (slot, telemetry t0, prior phase): paused slots whose
        # gathered pages are in flight to a sibling (migrate_out), settled
        # by migrate_finish (pages released / donated here) or
        # migrate_abort (resume decoding, or prefilling, here)
        self._migrating = {}
        # handle -> pipelined-restore slot (migrate_in_begin): pages
        # scatter in batches while the source still prefills; settled by
        # migrate_in_commit / migrate_in_abort
        self._staging = {}
        self._next_xfer = 1       # staged-restore handle mint
        self._priority_seen = False   # sticky: any submit(priority != 0)
        self._prefill_fifo = []   # slot ids mid-prefill, admission order
        self._prefill_used = 0    # tokens prefilled this tick
        # registered prefixes, longest first: (ids, dense rows, last
        # logits, pool pages); ragged prefill keeps no rows or logits
        self._prefixes = []
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
                      # launches of the device programs (ragged prefill
                      # launches or dense prefill calls; split decode
                      # ticks and the decode steps they run; fused
                      # ticks and their passes over the layers, one a
                      # fused-tick launch a layer), and rows of emitting
                      # slots whose logits
                      # (when sampling, filtered ones) held a NaN or an
                      # Inf
                      "prefill_launches": 0, "decode_ticks": 0,
                      "decode_steps": 0, "fused_launches": 0,
                      "fused_passes": 0,
                      "nonfinite_logit_rows": 0,
                      # decode-block rows after a slot finished mid-block
                      "block_waste_tokens": 0,
                      # seeded draws (one R1 launch on the card each)
                      "sample_launches": 0,
                      # rows the launches ran, from the host arrays they
                      # were packed from: a prefill launch's rows (C a
                      # participating slot; a dense segment's chunks), a
                      # decode step's slots, a fused pass's live rows.
                      # The goodput ledger's tokens less its masked page
                      # reads
                      "device_rows": 0,
                      # admission="optimistic" accounting
                      "preemptions": 0, "preempt_resumed": 0,
                      "grow_pages": 0, "headroom_pages": 0,
                      # live KV-page migration: handoffs committed as the
                      # SOURCE / degraded to evacuate+replay / restored as
                      # the TARGET
                      "migrations": 0, "migration_fallbacks": 0,
                      "migrated_in": 0,
                      # pipelined prefill handoff: partial page batches
                      # shipped as the source / staged batches landed as
                      # the target
                      "handoff_pages_out": 0, "handoff_pages_in": 0}
        # telemetry (``telemetry.ServerTelemetry``): True builds a
        # default-enabled one; None (default) or a disabled one keeps
        # every hook site at a single attribute check — no locks, no
        # clock reads
        if telemetry is True:
            from ..telemetry import ServerTelemetry
            telemetry = ServerTelemetry()
        self.telemetry = telemetry
        self._tele = telemetry if (telemetry is not None
                                   and telemetry.enabled) else None
        # one time base for everything (events must correlate with
        # spans and deadlines in a postmortem, and FakeClock tests need
        # determinism): explicit clock > telemetry's > monotonic
        self._clock = clock if clock is not None else (
            telemetry.clock if self._tele is not None else MonotonicClock())
        # flight recorder: structured event ring + postmortem bundles
        if recorder is True:
            from ..telemetry import FlightRecorder
            recorder = FlightRecorder(clock=self._clock)
        self.recorder = recorder
        self._rec = recorder if (recorder is not None
                                 and recorder.enabled) else None
        # goodput ledger: each tick's device tokens by kind (it never
        # reads a clock)
        if ledger is True:
            from ..telemetry import GoodputLedger
            ledger = GoodputLedger(
                registry=self._tele.registry
                if self._tele is not None else None)
        self.ledger = ledger
        self._led = ledger if (ledger is not None
                               and ledger.enabled) else None
        # device-cost catalog + compile watch: each launch priced by the
        # model's analytic cost model (``models.costs``), the tick's
        # wall split into phases
        if costs is True:
            from ..telemetry import CostCatalog
            costs = CostCatalog(
                registry=self._tele.registry
                if self._tele is not None else None, clock=self._clock)
        self.costs = costs
        self._costs = costs if (costs is not None
                                and costs.enabled) else None
        self._phase_timer = None    # per-tick, set by _step_locked
        self._decode_prog = None    # priced decode program (static shapes)
        self._price = None          # the launches' price model, or None
        self._t_host = None         # host mirror of the decode positions
        if self._costs is not None and self._kv is not None:
            from ..models.costs import serving_costs
            self._price = serving_costs(
                model, self._caches["pool"]["k"].element_size(),
                self.page_size, self._kv.pages_per_slot, self.max_slots,
                weight_dtype=weight_dtype)
            # the decode step's keys are t + 1 a slot, idle slots too
            # (their positions keep stepping); prices read this mirror
            self._t_host = np.zeros((self.max_slots,), np.int64)
        # journeys for a STANDALONE server: submit() mints "s<rid>"
        # journeys when no handle arrives through submit(journey=)
        if journeys is True:
            from ..telemetry import JourneyRecorder
            journeys = JourneyRecorder(clock=self._clock)
        self.journeys = journeys
        self._jrec = journeys if (journeys is not None
                                  and journeys.enabled) else None
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
        self._faults = fault_injector
        if fault_injector is not None:
            # chaos storms become VISIBLE: fires publish to this
            # server's registry and land in its flight recorder (an
            # injector shared across servers keeps the first recorder
            # it was given)
            if self._tele is not None:
                fault_injector.publish_to(self._tele.registry)
            if self._rec is not None \
                    and getattr(fault_injector, "recorder", None) is None:
                fault_injector.recorder = self._rec
        self._sup = ServeSupervisor(retry=retry_policy, breaker=breaker)
        self._health = HealthMonitor(on_change=self._publish_health)
        self._accepting = True    # False while draining / after stop
        self._draining = False
        if self._tele is not None:
            self._tele.set_health(HEALTHY)

    # ------------------------------------------------------ prefix cache
    def register_prefix(self, prefix_ids):
        """Prefill a shared prompt prefix (e.g. a system prompt) ONCE and
        reuse its KV state for every later request that starts with it:
        admission then prefills only the remainder. The longest
        registered match wins. Returns the prefix length. Registering
        the same ids again is a no-op. The entry is permanent: on the
        paged backend its full pages are stored once in the pool as
        PINNED radix-tree nodes (adopting pages the automatic cache
        already holds for these tokens), never evicted. Dense prefill
        seeds admissions from the prefix's stored rows and last logits;
        ragged prefill shares its pinned pages through the tree and
        keeps no rows. Raises ValueError, registering nothing, when the
        prefix would pad a queued request's remainder prefill past
        ``max_cache_len`` or pin pages a queued request needs."""
        if torch.is_tensor(prefix_ids):
            prefix_ids = prefix_ids.detach().cpu().numpy()
        ids = np.asarray(prefix_ids).astype(np.int32).reshape(-1)
        T = ids.shape[0]
        if T + 1 > self.max_cache_len:
            raise ValueError(f"prefix ({T}) leaves no room in "
                             f"max_cache_len ({self.max_cache_len})")
        with self._lock:
            for pre_ids, _, _, _ in self._prefixes:
                # idempotent: re-registering (a client retry) must not
                # prefill again or pin a second, unreachable page set
                if (pre_ids.shape[0] == T
                        and np.array_equal(pre_ids, ids)):
                    return T
            if self._prefill_chunk and not self._ragged:
                # a queued request was bound-checked at submit against
                # the prefixes registered THEN; refuse a prefix whose
                # remainder-chunk pad would overflow its rows
                for item in self._queue:
                    q_ids = item.ids
                    Tq = q_ids.shape[0]
                    if Tq <= T or not np.array_equal(q_ids[:T], ids):
                        continue
                    cur = self._match_prefix(q_ids)
                    if cur is not None and cur[0].shape[0] >= T:
                        continue    # a longer match still wins
                    rpad = self._chunk_pad(Tq - T)
                    if Tq + rpad > self.max_cache_len:
                        raise ValueError(
                            f"registering this {T}-token prefix "
                            f"would pad the queued {Tq}-token "
                            f"request's remainder prefill {rpad} "
                            f"rows past max_cache_len "
                            f"({self.max_cache_len}) — register "
                            f"prefixes before submitting")
            logits, caches1 = self.model._run_prefill(
                self._bundle, ids[None], chunk=self._prefill_chunk)
            self.stats["prefill_tokens"] += T
            if self._tele is not None:
                self._tele.add_prefill_tokens(T)
            # ragged admission matches through the pinned pages alone:
            # a dense copy of the prefix's rows would only hold memory
            rows = None if self._ragged else {
                k: c[:, :, :T].clone() for k, c in caches1.items()}
            if self._ragged:
                logits = None
            pages, run, own, pin_delta = [], [], [], 0
            if self._kv is not None:
                # the prefix's FULL pages go into the pool once; nodes
                # the automatic cache already holds for these tokens are
                # adopted (pinned below), the rest allocated and filled
                nfull = T // self._kv.page_size
                if nfull:
                    aligned = ids[:nfull * self._kv.page_size]
                    run = self._prefix.node_run(aligned)
                    pin_delta = nfull - sum(1 for nd in run if nd.pinned)
                    if nfull > len(run):
                        # the adopted run must survive the allocation's
                        # own reclaim sweep
                        self._prefix.protect(run)
                        try:
                            own = self._kv.alloc(nfull - len(run))
                        finally:
                            self._prefix.protect(())
                    pages = [nd.page for nd in run] + own
            entry = (ids, rows, logits, pages)
            self._prefixes.append(entry)
            self._prefixes.sort(key=lambda e: -e[0].shape[0])
            if self._kv is not None and pages:
                # pinning shrinks the pool for everyone else: a queued
                # request that could never fit again would starve the
                # FIFO, so the registration is refused instead
                usable = self._kv.num_pages - 1 \
                    - (self._prefix.pinned_pages + pin_delta)
                # parked preempted requests must stay re-admittable too:
                # their FULL extent is the binding bound
                for item in self._queue + self._preempted:
                    q_need = self._request_pages(
                        item.ids, item.budget, self._match_prefix(item.ids))
                    if q_need > usable:
                        self._prefixes = [e for e in self._prefixes
                                          if e is not entry]
                        if own:
                            self._kv.release(own)
                        raise ValueError(
                            f"registering this {T}-token prefix pins "
                            f"{len(pages)} pages and would strand an "
                            f"already-queued request needing {q_need} "
                            f"of {usable} usable pages — grow num_pages "
                            f"or register prefixes before submitting")
                if own:
                    self._fill_pages(caches1, own,
                                     len(run) * self._kv.page_size)
                self._prefix.extend_pinned(
                    ids[:len(pages) * self._kv.page_size], run, own)
                self._prefix.flush_sketch()
        return T

    def _chunk_pad(self, seg_len):
        """Rows the chunked prefill pads past ``seg_len``: zero when the
        segment runs unchunked (``seg_len <= chunk``: ``_run_prefill``
        then writes exactly ``seg_len`` rows)."""
        c = self._prefill_chunk
        if not c or seg_len <= c:
            return 0
        return (-seg_len) % c

    def _match_prefix(self, ids):
        """The longest registered prefix ``ids`` starts with, as its
        entry ``(ids, rows, logits, pages)``, or None."""
        for pre_ids, rows, logits, pages in self._prefixes:
            n = pre_ids.shape[0]
            if ids.shape[0] >= n and np.array_equal(ids[:n], pre_ids):
                return pre_ids, rows, logits, pages
        return None

    # ------------------------------------------------------------ queue
    def submit(self, input_ids, max_new_tokens=32, seed=None,
               on_token=None, deadline_s=None, priority=0,
               journey=None):
        """Queue a prompt; returns a request id. The FIRST generated
        token comes from the prompt's prefill (its last chunk).
        ``on_token(rid, tokens)`` streams each harvested chunk.
        ``seed`` only matters to sampling: the request's chain starts at
        ``PRNGKey(seed)``, and ``None`` resolves to the server's seed
        plus the request id, as the JAX server does. ``deadline_s``
        bounds the request's total time from submit: a request still
        queued when it expires fails with ``DeadlineExceeded``; one
        expiring in flight is cancelled and its partial tokens become
        the result. With ``max_queue`` set, a
        full queue sheds per ``shed_policy``. ``priority``
        (``admission="optimistic"`` only; ignored under ``"reserve"``)
        is the request's preemption class: victims are taken from the
        LOWEST class first, and admission prefers higher classes
        (same class: submit order). Whatever the pressure, a request's
        full extent must fit the pool on its own (checked here), so the
        top-ranked request can always run to completion. ``journey`` (a
        ``telemetry.Journey`` handle, normally minted by a router) traces
        the request's phases; a server built with ``journeys=`` mints its
        own when none is given."""
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
                raise ServerClosed(
                    f"server is {self._health.state}; not accepting "
                    f"new requests")
            if deadline_s is not None and deadline_s <= 0:
                raise DeadlineExceeded(
                    f"deadline_s={deadline_s} is already expired")
            hit = None if self._ragged else self._match_prefix(ids)
            pad = 0
            if self._prefill_chunk and not self._ragged:
                # a registered-prefix hit prefills only the REMAINDER at
                # t0 = n, whose own chunk pad can exceed the full
                # prompt's. The longest match wins at admission,
                # prefixes are never removed, and register_prefix
                # refuses one that would strand a queued request, so
                # the CURRENT longest match decides the bound. Ragged
                # prefill never pads.
                pad = self._chunk_pad(T - hit[0].shape[0]) \
                    if hit is not None else self._chunk_pad(T)
            if max(T + max_new_tokens, T + pad) > self.max_cache_len:
                seg = "prefix-remainder" \
                    if hit is not None and self._prefill_chunk else "prompt"
                raise ValueError(
                    f"prompt ({T}) + max({max_new_tokens} new tokens, "
                    f"{pad} prefill-chunk pad rows on the {seg}) "
                    f"exceeds max_cache_len ({self.max_cache_len})")
            if self._kv is not None:
                # full-extent reservation (prompt + budget): a request
                # that can never fit must fail HERE, not stall the FIFO
                # forever: the pool minus the pinned pages, minus the
                # pinned pages this request would share itself (ragged
                # prefill counts only the pinned tree run: donated pages
                # can be evicted before admission)
                if self._ragged:
                    need = self._npages_for(T + int(max_new_tokens)) \
                        - self._pinned_run_pages(ids)
                else:
                    need = self._request_pages(ids, int(max_new_tokens),
                                               hit)
                usable = self._kv.num_pages - 1 \
                    - self._prefix.pinned_pages
                if need > usable:
                    raise ValueError(
                        f"prompt ({T}) + max_new_tokens "
                        f"({max_new_tokens}) needs {need} pages beyond "
                        f"its prefix hit but only {usable} are not "
                        f"pinned by prefixes — grow num_pages")
            if (self._max_queue is not None
                    and len(self._queue) >= self._max_queue):
                if self._shed_policy == "reject" or not self._queue:
                    if self._tele is not None:
                        self._tele.on_shed("reject")
                    raise QueueFullError(
                        f"queue holds {len(self._queue)} requests "
                        f"(max_queue={self._max_queue}); shed_policy="
                        f"'reject' — resubmit with backoff")
                old = self._queue.pop(0)
                err = QueueFullError(
                    f"request {old.rid} evicted by a newer submit "
                    f"(queue full at max_queue={self._max_queue}, "
                    f"shed_policy='evict_oldest')")
                self._failures[old.rid] = err
                if self._tele is not None:
                    self._tele.on_shed("evict_oldest")
                    self._tele.on_admission_failure(old.rid, err)
                self._note_request_failure_locked(old.rid, err,
                                                  old.journey,
                                                  bundle=False)
                self._done_cv.notify_all()
            rid = self._next_rid
            self._next_rid += 1
            if journey is None and self._jrec is not None:
                # standalone server: mint this request's own journey
                # ("s<rid>", location "server"); a handle passed in
                # always wins
                journey = self._jrec.begin(f"s{rid}", where="server")
                journey.event("submitted", rid=rid,
                              prompt_tokens=int(T))
            if seed is None:
                seed = self._seed + rid     # the reference's default rule
            deadline = None if deadline_s is None \
                else self._clock.now() + float(deadline_s)
            if priority:
                self._priority_seen = True
            self._queue.append(_Pending(rid, ids, int(max_new_tokens),
                                        on_token, deadline, int(seed),
                                        int(priority), journey))
            if self._tele is not None:
                self._tele.on_submit(rid, T, len(self._queue))
            if journey is not None:
                journey.event("queued", rid=rid, prompt_tokens=int(T))
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
                    if self._tele is not None:
                        self._tele.on_cancel(rid)
                        self._tele.set_queue_depth(len(self._queue))
                    if self._rec is not None:
                        self._rec.record("cancel", rid=rid, where="queued")
                    if item.journey is not None:
                        item.journey.event("cancelled")
                    self._done_cv.notify_all()
                    return True
            for slot in range(self.max_slots):
                st = self._slots[slot]
                if st is not None and st.rid == rid:
                    if self._rec is not None:
                        self._rec.record("cancel", rid=rid,
                                         where="in_flight")
                    if st.journey is not None:
                        st.journey.event("cancelled")
                    self._finish_partial_locked(slot)
                    if self._tele is not None:
                        self._tele.on_cancel(rid)
                        self._pool_gauges()
                    self._done_cv.notify_all()
                    return True
            for i, rec in enumerate(self._preempted):
                if rec.rid == rid:
                    # parked under pool pressure: the pre-preemption
                    # partial is the result (its pages were donated or
                    # freed at preemption)
                    del self._preempted[i]
                    if self._rec is not None:
                        self._rec.record("cancel", rid=rid,
                                         where="preempted")
                    self._flush_parked_locked(rec)
                    if self._tele is not None:
                        self._tele.on_cancel(rid)
                        self._preempt_gauge()
                    if rec.journey is not None:
                        rec.journey.event("cancelled")
                    self._done_cv.notify_all()
                    return True
            return False

    def _release_slot(self, slot, cold=False):
        """Tear down a slot's host and page state. With auto prefix
        caching the request's written full prompt pages are DONATED into
        the radix tree; everything else returns to the free list. An
        injected ``prefix.donate`` fault abandons the insert and the
        pages are simply freed. ``cold=True`` (preemption teardown)
        donates at the cold end of the LRU, so the grow that displaced
        this slot reclaims its pages first."""
        st = self._slots[slot]
        self._active[slot] = False
        self._slots[slot] = None
        if slot in self._prefill_fifo:
            self._prefill_fifo.remove(slot)
        if self._kv is None:
            return
        pages = self._kv.detach_slot(slot)
        if not pages:
            return
        if self._auto_prefix and st is not None:
            try:
                # only prompt rows actually written are donated: a slot
                # torn down mid-prefill caches its filled prefix only
                new = self._prefix.donate(st.ids, pages,
                                          min(st.prompt_len, st.filled),
                                          cold=cold)
            except Exception:
                self._kv.release(pages)
            else:
                if new and self._tele is not None:
                    self._tele.on_prefix_donate(new)
                if new and self._rec is not None:
                    self._rec.record("donate", rid=st.rid, pages=new,
                                     cold=cold)
        else:
            self._kv.release(pages)

    def _finish_partial_locked(self, slot):
        """Record the slot's partial tokens as its rid's result and tear
        the slot down (cancel, deadline expiry, hard stop). A resumed
        slot's partial is the LONGER of its pre-preemption tokens and the
        replay so far (never fewer tokens than already streamed)."""
        st = self._slots[slot]
        self._results[st.rid] = np.asarray(st.partial()[:st.budget],
                                           np.int32)
        if self._rec is not None:
            self._rec.record("flush", rid=st.rid,
                             tokens=len(self._results[st.rid]))
        if st.journey is not None:
            st.journey.event("flushed",
                             tokens=len(self._results[st.rid]))
        self._release_slot(slot)
        return st

    # ---------------------------------------------------- paged backend
    def _fill_pages(self, caches1, pages, start):
        """Copy dense batch-1 cache rows [start, start + len(pages) *
        page_size) into the pool at ``pages`` (position order)."""
        if not pages:
            return
        pg = self._kv.page_size
        n = len(pages) * pg
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for name in ("k", "v"):
            pool, c = self._caches["pool"][name], caches1[name]
            seg = c[:, 0, start:start + n]
            pool[:, idx] = seg.reshape(seg.shape[0], len(pages), pg,
                                       *seg.shape[2:]).to(pool.dtype)

    def _seed_from_pages(self, pages):
        """The inverse of ``_fill_pages``: cached pool pages gathered into
        fresh dense batch-1 caches covering [0, len(pages) * page_size),
        the rows a tree hit's remainder prefill attends to (dense prefill
        only: ragged prefill attends through the block table)."""
        pg = self._kv.page_size
        n = len(pages) * pg
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        base = self._init_caches(1)
        for name in ("k", "v"):
            s = self._caches["pool"][name][:, idx]
            base[name][:, 0, :n] = s.reshape(s.shape[0], n, *s.shape[3:])
        if self._costs is not None:
            # a read and a write of n rows of K and V, every layer
            self._charge_transfer("page_gather", 2 * n * self._row_nbytes())
        return base

    def _sync_block_table(self):
        """Copy the host block-table mirror into the device table the
        kernels read, when a row changed."""
        if self._kv is not None and self._kv.dirty:
            self._caches["bt"].copy_(
                torch.from_numpy(self._kv.block_table))
            self._kv.dirty = False
            self._tick_dispatch("block_table")
            self._charge_transfer("block_table",
                                  2 * self._kv.block_table.nbytes)

    def _pool_gauges(self):
        """Refresh the page-pool occupancy gauges (paged backend). The
        port's pool is one card's: one shard."""
        if self._tele is not None and self._kv is not None:
            used = self._kv.used_pages()
            pinned = self._prefix.pinned_pages
            cached = self._prefix.cached_pages
            self._tele.set_pool(self._kv.free_pages(),
                                used - pinned - cached, pinned, cached,
                                self._prefix.host_pages)
            self._tele.set_pool_shards(1, self._shard_pool_bytes())

    def _shard_pool_bytes(self):
        """K+V pool bytes resident on the card (one shard)."""
        if self._kv is None:
            return None
        pool = self._caches["pool"]
        return int(pool["k"].nbytes + pool["v"].nbytes)

    def pool_balance(self):
        """``PoolBalance``: ``(free, live, pinned, cached)`` page counts
        summing to the usable pool (``num_pages - 1``; page 0 is the null
        page). ``live`` pages belong to slots, ``pinned`` to registered
        prefixes (never evicted), ``cached`` to the automatic prefix
        cache. ``live == 0`` once drained means no page leaked.
        ``.preempted`` (parked requests), ``.preemptions`` (victims so
        far), ``.host`` (spilled pages) and ``.host_bytes`` ride as
        attributes. The dense backend has no pool: None."""
        if self._kv is None:
            return None
        with self._lock:
            free = self._kv.free_pages()
            pinned = self._prefix.pinned_pages
            cached = self._prefix.cached_pages
            live = self._kv.used_pages() - pinned - cached
            return PoolBalance(free, live, pinned, cached,
                               preempted=len(self._preempted),
                               preemptions=self.stats["preemptions"],
                               shard_page_bytes=self._shard_pool_bytes(),
                               host=self._prefix.host_pages,
                               host_bytes=self._host.bytes_used
                               if self._host is not None else 0)

    def _reclaim_pages(self, shortfall):
        """``PagedKVCache.alloc``'s reclaimer: evict LRU cached prefix
        pages when the free list runs short. An injected
        ``prefix.evict`` fault aborts THIS sweep: alloc then raises
        OutOfPages (admission defers, a grow fails its tick); no page
        leaks and no request fails. With a host tier the sweep DEMOTES
        instead of dropping: spills are counted (and priced as
        ``page_spill`` bytes, never a tick dispatch) by diffing the
        tier's totals across the sweep, so the eviction metrics split
        into spilled and dropped."""
        tier = self._host
        s0 = tier.spilled_pages_total if tier is not None else 0
        try:
            freed = self._prefix.evict(shortfall)
        except Exception:
            return 0
        spilled = tier.spilled_pages_total - s0 if tier is not None else 0
        if spilled:
            if self._tele is not None:
                self._tele.on_host_spill(spilled)
            if self._rec is not None:
                self._rec.record("spill", pages=spilled)
            self._charge_transfer(
                "page_spill",
                2 * spilled * self._kv.page_size * self._row_nbytes())
        dropped = freed - spilled
        if dropped and self._tele is not None:
            self._tele.on_prefix_evict(dropped)
        if freed and self._rec is not None:
            self._rec.record("evict", pages=freed)
        return freed

    def _spill_payload(self, page):
        """One pool page's K and V rows as host numpy arrays, each
        ``[L, pg, kvh, hd]`` — the demotion gather
        ``PrefixCache.evict`` routes through the host tier (one indexed
        read a leaf and one device-to-host copy). Runs inside an
        allocator reclaim under the server lock, off the tick path."""
        return self._gather_pages([int(page)])[0]

    def _gather_pages(self, pages):
        """``[k, v]`` host payloads of pool ``pages`` (position order):
        ONE indexed read of each pool leaf into a page-major ``[n, L,
        pg, kvh, hd]`` tensor and ONE device-to-host copy of it, so each
        page's payload is a contiguous view. A bf16 pool's pages come
        back as their ``uint16`` bit patterns (numpy has no bfloat16):
        the bytes the reference hashes."""
        if not pages:
            return []
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        leaves = []
        for name in ("k", "v"):
            t = self._caches["pool"][name].transpose(0, 1)[idx]
            if t.dtype == torch.bfloat16:
                t = t.view(torch.uint16)
            leaves.append(t.cpu().numpy())
        k, v = leaves
        return [[k[j], v[j]] for j in range(len(pages))]

    def _scatter_pages(self, pages, payloads):
        """Write host page ``payloads`` (``[k, v]`` each, the layout
        ``_gather_pages`` returns, or the JAX server's) into pool
        ``pages`` IN PLACE: one host stack, one host-to-device copy and
        one ``index_copy_`` a leaf — the pool tensors are never
        rebound. ``uint16`` payloads of a bf16 pool are bit patterns."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for j, name in enumerate(("k", "v")):
            leaf = self._caches["pool"][name]
            val = np.stack([np.asarray(p[j]) for p in payloads])
            if leaf.dtype == torch.bfloat16:
                val = torch.from_numpy(val.view(np.uint16)).view(
                    torch.bfloat16)
            else:
                val = torch.from_numpy(val).to(leaf.dtype)
            leaf.index_copy_(1, idx, val.to(self.device).transpose(0, 1))

    def _restore_match(self, m):
        """Restore a tree match's host-resident suffix into freshly
        allocated pool pages so admission takes the WHOLE run by
        reference through the normal ``admit_slot``/refcount path — a
        restored run is bit-exact with a never-evicted one. Returns a
        fresh all-hot ``PrefixMatch`` over the same nodes (possibly
        trimmed to the hot prefix), or None when nothing survives. Any
        failure is a MISS for the affected pages, never a request
        failure: an injected ``tier.restore`` fault leaves the run
        spilled for a later attempt, a checksum mismatch forgets the
        corrupt node (and its all-host subtree) for good, and an
        OutOfPages trims to the hot prefix."""
        nodes = m.nodes
        hot = m.hot_len()
        if hot == len(nodes):
            return m
        tele = self._tele
        t0 = tele.restore_started() if tele is not None else None
        payloads, restoring, n_restored = [], [], 0
        for nd in nodes[hot:]:
            try:
                payload = self._host.get(nd.host, fp=nd.fp)
            except Exception:
                break          # transient (injected) miss: the run stays
            #                    spilled, nodes intact for a retry
            if payload is None:
                # checksum mismatch: drop the node and everything under
                # it so the corrupt entry can never be matched again
                if tele is not None:
                    tele.on_host_restore_corrupt()
                if self._rec is not None:
                    self._rec.record("restore_corrupt", fp=nd.fp)
                self._prefix.drop_subtree(nd)
                break
            payloads.append(payload)
            restoring.append(nd)
        if restoring:
            # fresh pages for the suffix: protect the whole run across
            # the alloc — its reclaim sweep must not demote the hot
            # prefix (not yet referenced by a slot) or shrink away the
            # very entries being restored
            self._prefix.protect(nodes[:hot] + restoring)
            try:
                fresh = self._kv.alloc(len(restoring))
            except Exception:
                fresh = None   # pool exhausted even after reclaim:
            finally:           # serve the hot prefix only
                self._prefix.protect(())
            if fresh is not None:
                self._scatter_pages(fresh, payloads)
                for nd, page in zip(restoring, fresh):
                    self._prefix.promote(nd, page)
                # bytes moved both ways, zero FLOPs, and NOT a tick
                # dispatch
                self._charge_transfer(
                    "page_restore",
                    2 * len(fresh) * self._kv.page_size * self._row_nbytes())
                if self._rec is not None:
                    self._rec.record("restore", pages=len(fresh))
                n_restored = len(fresh)
                hot += n_restored
        if tele is not None:
            tele.on_host_restore(n_restored, t0)
        if hot == 0:
            return None
        return PrefixMatch(nodes[:hot], self._kv.page_size)

    def _best_hit(self, ids):
        """The longest reusable prefix state for ``ids``: ``("reg",
        entry)`` (a registered prefix: dense rows and last logits,
        token-exact length), ``("tree", PrefixMatch)`` (the radix tree's
        page-aligned run), whichever covers more tokens, or None. A tree
        match is capped one token short of the prompt (the remainder
        prefill must emit the first-token logits) and trimmed page by
        page until the remainder's prefill-chunk pad fits
        ``max_cache_len`` (the tree moves under queued requests).

        Ragged prefill matches through the tree alone: registered
        prefixes live there as pinned nodes, so a registered hit reuses
        its page-aligned run and the sub-page tail prefills again with
        the remainder (the same tokens); ragged remainders never pad."""
        T = int(ids.shape[0])
        if self._ragged:
            tree = self._prefix.lookup(ids, T - 1)
            return None if tree is None else ("tree", tree)
        reg = self._match_prefix(ids)
        best = None if reg is None else ("reg", reg)
        if self._auto_prefix:
            tree = self._prefix.lookup(ids, T - 1)
            while tree is not None and \
                    T + self._chunk_pad(T - tree.tokens) \
                    > self.max_cache_len:
                tree = tree.shrink()
            reg_n = reg[0].shape[0] if reg is not None else 0
            if tree is not None and tree.tokens > reg_n:
                best = ("tree", tree)
        return best

    def _pinned_run_pages(self, ids):
        """Pages of the PINNED (registered) tree run this prompt would
        share: the floor on page reuse a ragged-prefill submit may count
        (capped at T - 1 like ``_best_hit``'s lookup)."""
        T = int(ids.shape[0])
        aligned = (T - 1) // self._kv.page_size * self._kv.page_size
        n = 0
        for nd in self._prefix.node_run(ids[:aligned]):
            if not nd.pinned:
                break
            n += 1
        return n

    def _request_pages(self, ids, budget, hit):
        """Fresh pages a request needs for its full extent (prompt +
        budget), net of the shared pages of ``hit`` (a
        ``_match_prefix`` entry)."""
        shared = len(hit[3]) if hit is not None else 0
        return self._npages_for(ids.shape[0] + budget) - shared

    def _extent_tokens(self, T, budget):
        """Tokens' worth of pages admission reserves for a request.
        ``admission="reserve"``: the FULL extent (prompt + budget), so
        decode can never hit an empty pool mid-flight.
        ``"optimistic"``: the prompt plus ``headroom_pages`` worth;
        decode grows page by page on demand (``_grow_locked``) and the
        preemption policy settles the bill when the gamble loses."""
        if self._optimistic:
            return min(T + self._headroom_pages * self.page_size,
                       T + budget)
        return T + budget

    def _head_fits_pool(self, head, best):
        """Can the pool take ``head`` (the chosen admission candidate)
        now? Evictable cached pages count as headroom, minus the nodes
        the head's own tree hit is about to share. Optimistic admission
        asks only for the prompt + headroom reservation."""
        if best is None:
            shared, nodes = 0, ()
        elif best[0] == "reg":
            shared, nodes = len(best[1][3]), ()
        else:
            # only the HOT prefix is shared by reference; a host-resident
            # suffix needs fresh pool pages (the restore allocates them
            # before admit_slot), so it counts toward need exactly like
            # prefilling those tokens would
            hot = best[1].hot_len()
            shared, nodes = hot, best[1].nodes[:hot]
        need = self._npages_for(
            self._extent_tokens(head.ids.shape[0], head.budget)) - shared
        avail = self._kv.free_pages() \
            + self._prefix.evictable_pages(exclude=nodes)
        return avail >= need

    def _npages_for(self, n_tokens):
        return -(-int(n_tokens) // self._kv.page_size)

    # -------------------------------------------- admission scheduling
    def _next_admission_locked(self):
        """``(item, source)`` of the next admission candidate, or
        ``(None, None)``. Reserve mode: strict FIFO, the queue head.
        Optimistic mode: PRIORITY-AWARE FIFO — highest priority class
        first, then submit order (rid), in one order across the
        preempted queue and the main queue; a preempted request keeps
        its rid, so at equal priority it re-enters ahead of later
        arrivals. ``source`` is the pop/defer handle."""
        if not self._optimistic \
                or (not self._priority_seen and not self._preempted):
            # reserve mode, or optimistic with every priority at the
            # default and nothing parked: the order IS rid order, the
            # queue head
            if not self._queue:
                return None, None
            return self._queue[0], ("queue", 0)
        best, src = None, None
        for where, items in (("queue", self._queue),
                             ("preempted", self._preempted)):
            for i, item in enumerate(items):
                if best is None or (-item.priority, item.rid) \
                        < (-best.priority, best.rid):
                    best, src = item, (where, i)
        return best, src

    def _pop_admission_locked(self, src):
        where, i = src
        item = (self._queue if where == "queue"
                else self._preempted).pop(i)
        if where == "preempted":
            self._preempt_gauge()
        return item

    def _defer_admission_locked(self, src, item):
        """Put a popped candidate back where it came from (an admission
        attempt rolled back: OutOfPages defers)."""
        where, i = src
        (self._queue if where == "queue"
         else self._preempted).insert(i, item)
        if where == "preempted":
            self._preempt_gauge()

    def _preempt_gauge(self):
        if self._tele is not None:
            self._tele.set_preempted_depth(len(self._preempted))

    def _flush_parked_locked(self, rec):
        """Record a parked record's pre-preemption partial as its rid's
        RESULT: the one way a preempted request leaves the parked queue
        without decode resuming (cancel, deadline expiry, hard stop).
        The caller removes the record from ``_preempted`` and
        notifies."""
        self._results[rec.rid] = np.asarray(rec.emitted[:rec.budget],
                                            np.int32)
        if self._rec is not None:
            self._rec.record("flush", rid=rec.rid,
                             tokens=len(self._results[rec.rid]),
                             parked=True)
        if rec.journey is not None:
            rec.journey.event("flushed",
                              tokens=len(self._results[rec.rid]),
                              parked=True)

    # ------------------------------------------------------- scheduling
    def _admit(self, run_prefill=True):
        """Fill free slots from the queue and the preempted queue
        (``_next_admission_locked``'s order). Dense prefill: one batch-1
        prefill per admission (``_admit_one``). Ragged prefill:
        admissions only reserve their slot and pages here; the prompt
        chunks run batched in ``_prefill_tick``. OutOfPages DEFERS the
        candidate (order kept); any other admission error fails that
        request alone."""
        admitted = 0
        for slot in range(self.max_slots):
            if self._admit_cap is not None and admitted >= self._admit_cap:
                break
            if self._slots[slot] is not None:
                continue
            item, src = self._next_admission_locked()
            if item is None:
                break
            # one _best_hit an attempt feeds the fits check and the
            # admission: same lock, the tree cannot move in between
            best = self._best_hit(item.ids)
            if self._kv is not None \
                    and not self._head_fits_pool(item, best):
                break
            req = self._pop_admission_locked(src)
            if self._tele is not None:
                self._tele.on_admit(req.rid, len(self._queue))
            try:
                if self._ragged:
                    self._reserve_one(slot, req, best)
                else:
                    self._admit_one(slot, req, best)
            except OutOfPages:
                if self._kv.slot_pages(slot):
                    self._kv.free_slot(slot)
                self._active[slot] = False
                self._slots[slot] = None
                self._defer_admission_locked(src, req)
                if self._tele is not None:
                    self._tele.on_admission_deferred(req.rid,
                                                     len(self._queue))
                if self._rec is not None:
                    self._rec.record("defer", rid=req.rid)
                if req.journey is not None:
                    req.journey.event("deferred")
                break
            except Exception as e:
                if self._kv is not None and self._kv.slot_pages(slot):
                    self._kv.free_slot(slot)     # roll back a part-admit
                self._active[slot] = False
                self._slots[slot] = None
                if slot in self._prefill_fifo:
                    self._prefill_fifo.remove(slot)
                self._failures[req.rid] = e
                if self._tele is not None:
                    self._tele.on_admission_failure(req.rid, e)
                self._note_request_failure_locked(req.rid, e, req.journey)
                self._done_cv.notify_all()
            else:
                admitted += 1
        if run_prefill and self._ragged:
            self._prefill_tick()
        if self._tele is not None:
            self._pool_gauges()

    def _reserve_one(self, slot, req, best):
        """Reserve ``slot`` for ``req`` (ragged prefill): its pages
        (``_extent_tokens``; tree-hit pages joined by reference) and a
        prefill-phase slot record. The prompt's chunks run in
        ``_prefill_tick`` launches."""
        if self._faults is not None:
            # chaos point: an admission that dies is a PER-REQUEST
            # failure (_admit records it), and it fires BEFORE the
            # reservation, so no pages need rolling back
            self._faults.check(faults.PREFILL, rid=req.rid)
        ids = req.ids
        T = ids.shape[0]
        if best is not None and self._host is not None:
            # the match may carry a host-resident suffix: restore it into
            # fresh pool pages FIRST so admit_slot below shares the whole
            # run by reference like any hot hit (a failed restore just
            # trims the match; prefill covers the rest)
            m = self._restore_match(best[1])
            best = None if m is None else ("tree", m)
        m = None if best is None else best[1]
        n_pre, pre_pages = (0, []) if m is None else (m.tokens, m.pages)
        self._kv.admit_slot(slot, self._extent_tokens(T, req.budget),
                            pre_pages)
        self._count_headroom(slot, T)
        n_auto = 0
        if m is not None:
            self._prefix.use(m)               # LRU: reuse is recency
            # pinned nodes are registered state (the run's head:
            # extend_pinned pins whole root paths), the rest the
            # automatic cache's
            n_auto = n_pre - sum(1 for nd in m.nodes if nd.pinned) \
                * self._kv.page_size
        self.stats["prefix_hit_tokens"] += n_pre
        if n_auto:
            self.stats["prefix_auto_hits"] += 1
            self.stats["prefix_auto_hit_tokens"] += n_auto
        if self._tele is not None and self._auto_prefix:
            self._tele.on_prefix_auto(n_auto > 0, n_auto)
        st = _Slot(req.rid, ids, T, req.budget, req.on_token,
                   req.deadline, req.seed)
        st.phase = "prefill"
        st.fill_pos = st.filled = st.n_pre = n_pre
        if self._led is not None:
            # ragged matching is page-granular, so a registered
            # prefix's sub-page tail re-prefills with the remainder:
            # the ledger's tail_reprefill kind
            reg = self._match_prefix(ids)
            if reg is not None and reg[0].shape[0] > n_pre:
                st.reprefill_upto = int(reg[0].shape[0])
        self._bind_request(st, req, slot)
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

    def _bind_request(self, st, req, slot):
        """Carry the request's scheduling state onto its slot. A RESUMED
        (previously preempted) request keeps its stream offset (on_token
        never re-sends delivered chunks), its pre-preemption partial
        (flushed if it must leave early again) and its preemption
        count. Also the observability funnel for admissions: one
        recorder event and one journey phase a (re)admission,
        ``replay`` for a request off the preempted queue."""
        st.priority = req.priority
        st.journey = req.journey
        resumed = isinstance(req, _Preempted)
        if resumed:
            st.streamed = req.streamed
            st.replayed = tuple(req.emitted)
            st.preempts = req.preempts
            self.stats["preempt_resumed"] += 1
            if self._tele is not None:
                self._tele.on_preempt_resumed()
        if self._rec is not None:
            self._rec.record("replay" if resumed else "admit",
                             rid=st.rid, slot=slot,
                             prompt=st.prompt_len, prefix_hit=st.n_pre)
        if st.journey is not None:
            st.journey.event("replay" if resumed else "admitted",
                             slot=slot, prefix_hit=st.n_pre)

    def _count_headroom(self, slot, T):
        """Account the pages an optimistic admission reserved BEYOND the
        prompt (its pre-paid growth headroom)."""
        if not self._optimistic:
            return
        hr = len(self._kv.slot_pages(slot)) - self._npages_for(T)
        if hr > 0:
            self.stats["headroom_pages"] += hr
            if self._tele is not None:
                self._tele.add_headroom_pages(hr)

    def _n_prefill_calls(self, seg_len):
        """Prefill step calls ``_run_prefill`` makes for a
        ``seg_len``-token segment (1 unchunked, else one a chunk)."""
        if seg_len <= 0:
            return 0
        c = self._prefill_chunk
        if not c or seg_len <= c:
            return 1
        return (seg_len + self._chunk_pad(seg_len)) // c

    def _prefill_rest(self, rest, caches1, t0, replay=False):
        """Dense prefill of the prompt segment ``rest`` at ``t0`` (fresh
        batch-1 caches when ``caches1`` is None), accounted; returns its
        last logits [1, V] and the caches. The ledger takes its rows
        (``replay`` when a preempted request re-prefills) and the
        chunked prefill's remainder pad; the dense program runs on dense
        batch-1 caches, with no page reads to model."""
        logits, caches1 = self.model._run_prefill(
            self._bundle, rest[None], chunk=self._prefill_chunk,
            caches=caches1, t0=t0)
        n = rest.shape[0]
        calls = self._n_prefill_calls(n)
        self._count_dispatches(calls)
        self.stats["prefill_launches"] += calls
        self.stats["prefill_tokens"] += n
        self.stats["device_rows"] += n if calls <= 1 \
            else calls * self._prefill_chunk
        if self._led is not None and n:
            self._led.add("replay" if replay else "goodput", n)
            self._led.add("chunk_pad", self._chunk_pad(n))
        return logits, caches1

    def _admit_one(self, slot, req, best):
        """Dense-prefill admission: reserve the slot (its full page
        extent on the paged pool), prefill the prompt at batch 1 (a tree
        hit gathers its cached pages into the dense caches first, a
        registered hit seeds them from the stored rows; either way only
        the remainder is prefilled), draw the first token, and copy the
        rows into the slot's dense cache row or its own pages."""
        if self._faults is not None:
            # chaos point: an admission prefill that dies is a
            # PER-REQUEST failure (_admit records it)
            self._faults.check(faults.PREFILL, rid=req.rid)
        ids, T = req.ids, req.ids.shape[0]
        if best is not None and best[0] == "tree" \
                and self._host is not None:
            # restore any host-resident suffix before the pages are
            # shared and gathered below
            m = self._restore_match(best[1])
            best = None if m is None else ("tree", m)
        if best is not None and best[0] == "tree":
            n_pre, pre_pages = best[1].tokens, best[1].pages
        elif best is not None:
            n_pre, pre_pages = best[1][0].shape[0], best[1][3]
        else:
            n_pre, pre_pages = 0, []
        own = []
        if self._kv is not None:
            # the full extent is reserved before any prefill work or
            # stats: an OutOfPages here defers the request with nothing
            # counted. Shared pages are referenced before the alloc, so
            # its reclaim sweep cannot evict them.
            own = self._kv.admit_slot(
                slot, self._extent_tokens(T, req.budget), pre_pages)
            self._count_headroom(slot, T)
        tele = self._tele
        t_started = tele.prefill_started() if tele is not None else None
        if self._phase_timer is not None:
            self._phase_timer.mark("admission")
        replay = isinstance(req, _Preempted)
        if best is not None and best[0] == "tree":
            m = best[1]
            self._prefix.use(m)               # LRU: reuse is recency
            caches1 = self._seed_from_pages(m.pages)
            self._count_dispatches(1, op="page_gather")
            self.stats["prefix_hit_tokens"] += n_pre
            self.stats["prefix_auto_hits"] += 1
            self.stats["prefix_auto_hit_tokens"] += n_pre
            # the remainder is never empty (the lookup's T - 1 cap)
            logits, caches1 = self._prefill_rest(ids[n_pre:], caches1,
                                                 n_pre, replay)
            if tele is not None:
                tele.on_prefix_auto(True, n_pre)
        elif best is not None:
            rows, pre_logits = best[1][1], best[1][2]
            caches1 = self._init_caches(1)
            for name in caches1:       # k, v; int8: ks, vs too
                caches1[name][:, :, :n_pre] = rows[name]
            self._count_dispatches(1, op="page_scatter")  # the row seed
            if self._costs is not None:
                self._charge_transfer(
                    "page_scatter",
                    2 * sum(r.nbytes for r in rows.values()))
            self.stats["prefix_hit_tokens"] += n_pre
            if T > n_pre:
                logits, caches1 = self._prefill_rest(ids[n_pre:], caches1,
                                                     n_pre, replay)
            else:
                logits = pre_logits
            if tele is not None and self._auto_prefix:
                tele.on_prefix_auto(False, 0)
        else:
            logits, caches1 = self._prefill_rest(ids, None, 0, replay)
            if tele is not None and self._auto_prefix:
                tele.on_prefix_auto(False, 0)
        # _pick's host read waits for the prefill: prefill_launch
        firsts, keys = self._pick(logits, [req.seed])
        first = firsts[0]
        if keys is not None:
            self._keys.view(torch.int32)[slot] = keys[0].view(torch.int32)
        if self._kv is not None:
            # only the prompt's own rows are copied: the shared prefix
            # pages ahead of them are filled already
            pg = self._kv.page_size
            n_prompt = -(-T // pg) - len(pre_pages)
            if own[:n_prompt]:
                self._count_dispatches(1, op="page_scatter")
                if self._costs is not None:
                    self._charge_transfer(
                        "page_scatter",
                        2 * len(own[:n_prompt]) * pg * self._row_nbytes())
            self._fill_pages(caches1, own[:n_prompt], len(pre_pages) * pg)
        else:
            for name in caches1:
                self._caches[name][:, slot] = caches1[name][:, 0]
            self._count_dispatches(1, op="page_scatter")  # the row copy
            if self._costs is not None:
                self._charge_transfer(
                    "page_scatter",
                    2 * sum(c.nbytes for c in caches1.values()))
        self._tok[slot] = first
        self._t[slot] = T
        if self._t_host is not None:
            self._t_host[slot] = T
        self._count_dispatches(3, op="state_push")    # tok, t, key
        if self._costs is not None:
            # three transfers, charged as three: the cost ledger's
            # dispatch count reconciles 1:1 with the tick profile
            for arr in (self._tok, self._t, self._keys):
                self._charge_transfer("state_push", 2 * arr.nbytes)
        self._active[slot] = True
        st = _Slot(req.rid, ids, T, req.budget, req.on_token,
                   req.deadline, req.seed)
        st.filled = st.fill_pos = T
        st.n_pre = n_pre
        self._bind_request(st, req, slot)
        st.emitted.append(first)
        if st.journey is not None:
            st.journey.event("first_token")
        st.stream(self._deferred_cbs)
        self._slots[slot] = st
        self.stats["admissions"] += 1
        if self._phase_timer is not None:
            self._phase_timer.mark("prefill_launch")
        if tele is not None:
            tele.on_prefill_batch(t_started, T - n_pre)
            tele.on_first_token(req.rid, T - n_pre, n_pre)

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
        tele = self._tele
        t_started = tele.prefill_started() if tele is not None else None
        if self._phase_timer is not None:
            self._phase_timer.mark("admission")
        dev = self.device
        args = (torch.from_numpy(toks).to(dev), torch.from_numpy(t0).to(dev),
                self._caches, torch.from_numpy(out_idx).to(dev))
        prefill_fn = self._ragged_fn
        if self._costs is not None:
            # one catalog entry per chunk width on the pow2 ladder: a
            # width first seen after warm-up is a recompile. Each
            # participating slot runs its C rows (its last is t0 + C - 1)
            price = None if self._price is None else \
                self._price.prefill(
                    [(int(t0[s]), C if int(t0[s]) < self.max_cache_len
                      else 0) for s in range(S)], C)
            prefill_fn = self._cost_program("prefill", self._ragged_fn,
                                            args, price)
        logits, self._caches = prefill_fn(*args)
        self._count_dispatches(1, op="prefill")
        self.stats["prefill_launches"] += 1
        # C rows for each slot whose offset lies in the table
        self.stats["device_rows"] += C * int(
            (t0 < self.max_cache_len).sum())
        led = self._led
        for slot, start, take in plan:
            st = self._slots[slot]
            if led is not None:
                # the launch runs C rows for each participating slot
                # (idle slots are skipped): ``take`` real rows and the
                # ladder's pad
                if st.preempts:
                    # a resumed request's prompt re-prefill is pure
                    # preemption recompute
                    led.add("replay", take)
                else:
                    tail = max(0, min(start + take,
                                      st.reprefill_upto) - start)
                    led.add("tail_reprefill", tail)
                    led.add("goodput", take - tail)
                led.add("chunk_pad", C - take)
                led.add("skipped_page_dma",
                        self._skipped_dma(start + take))
            if st.journey is not None:
                st.journey.event("prefill_chunk", start=start, take=take)
        self._advance(plan)
        if done:
            # _pick's host read waits for the launch: prefill_launch
            firsts, keys = self._pick(
                logits[torch.tensor(done, device=dev)],
                [self._slots[s].seed for s in done])
            for i, slot in enumerate(done):
                if keys is not None:
                    self._pending_key[slot] = keys[i]
                self._activate(slot, firsts[i])
        if self._phase_timer is not None:
            self._phase_timer.mark("prefill_launch")
        if tele is not None:
            tele.on_prefill_batch(t_started, sum(t for _, _, t in plan))

    def _pick(self, logits, seeds):
        """First tokens of the prefill ``logits`` rows [n, V] of requests
        with sampling ``seeds``, as a host list (one device-to-host
        copy), and when sampling their chains' kept keys on the device
        [n, 2] (else None); rows holding a NaN or an Inf are counted in
        ``stats["nonfinite_logit_rows"]``. Greedy: the argmax. Sampling:
        each chain starts at ``PRNGKey(seed)``, is split once and draws
        from the filtered row (the reference's eager first draw: a true
        division by the temperature)."""
        keys = None
        if not self.do_sample:
            nxt = torch.argmax(logits, -1).to(torch.int32)
            bad = (~torch.isfinite(logits).all(-1)).to(torch.int32)
        else:
            n = len(seeds)
            seeds = torch.from_numpy(self._wrap_seeds(seeds)).to(
                self.device)
            ones = torch.ones((n,), dtype=torch.int32, device=self.device)
            nxt, keys, bad = self._draw(logits, self._keys[:n], seeds,
                                        ones, ones, reciprocal=False)
        host = torch.stack([nxt, bad]).cpu().numpy()
        self.stats["nonfinite_logit_rows"] += int(host[1].sum())
        return [int(x) for x in host[0]], keys

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
        st.phase = "decode"
        self._active[slot] = True
        self._prefill_fifo.remove(slot)
        st.emitted.append(first)
        if st.journey is not None:
            st.journey.event("first_token")
        st.stream(self._deferred_cbs)
        self.stats["admissions"] += 1
        if self._tele is not None:
            self._tele.on_first_token(st.rid, st.prompt_len - st.n_pre,
                                      st.n_pre)

    def _flush_slot_state(self):
        """Write pending per-slot decode state (first token, write
        position and, when sampling, the key) into the device arrays the
        decode step reads — one batched write per array per tick."""
        if self._t_host is not None:
            for slot, t in self._pending_t.items():
                self._t_host[slot] = t
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
                self._charge_transfer("state_push", 2 * arr.nbytes)
        if self._pending_key:
            idx = torch.tensor(list(self._pending_key), dtype=torch.long,
                               device=self.device)
            # uint32 has no index_put or stack: write through int32 views
            self._keys.view(torch.int32)[idx] = torch.stack(
                [k.view(torch.int32) for k in self._pending_key.values()])
            self._pending_key.clear()
            self._count_dispatches(1, op="state_push")
            self._charge_transfer("state_push", 2 * self._keys.nbytes)

    def _count_dispatches(self, n=1, op="prefill"):
        """Account ``n`` device dispatches of the admission/prefill path
        (prefill launches, slot-state writes) in the tick's profile."""
        self.stats["prefill_dispatches"] += n
        self._tick_dispatch(op, n)
        if self._tele is not None:
            self._tele.add_prefill_dispatches(n)

    def _tick_dispatch(self, op, n=1):
        self._tick_disp[op] = self._tick_disp.get(op, 0) + n

    def _cost_program(self, op, fn, args, price=None):
        """The cost catalog's priced callable for ``fn`` at ``args``'
        shape signature, charging ``price`` (``models.costs``; None: a
        model the port cannot price). The compile-watch funnel lives
        here: the first call of a new signature (which may build
        kernels) lands a ``compile`` recorder event, and one after the
        op warmed is a RECOMPILE, stamped as a ``compile_stall`` journey
        phase on every request parked behind the stalled tick. Caller
        guarantees ``self._costs is not None``."""
        prog = self._costs.program(op, fn, args, price)
        if not getattr(prog, "compiled_now", False):
            return prog

        def first_call(*a):
            out = prog(*a)
            if self._rec is not None:
                self._rec.record("compile", op=op,
                                 recompile=prog.recompile,
                                 seconds=prog.compile_s)
            if prog.recompile:
                stalled = [item.journey for item in self._queue]
                stalled += [rec.journey for rec in self._preempted]
                stalled += [st.journey for st in self._slots
                            if st is not None]
                for journey in stalled:
                    if journey is not None:
                        journey.event("compile_stall", op=op)
            return out
        first_call.prog = prog
        return first_call

    def _charge_transfer(self, op, nbytes):
        """Price a host<->device data movement that is not a program
        (slot-state push, page gather/scatter, block-table sync): bytes
        moved — read + write of the touched buffers — zero FLOPs. No-op
        without an enabled cost catalog."""
        if self._costs is not None:
            self._costs.charge_bytes(op, int(nbytes))

    def _row_nbytes(self):
        """Bytes one token's K and V rows take across every layer of the
        page pool: the unit of the page gather and scatter charges."""
        pool = self._caches["pool"]
        pg = self._kv.page_size
        return sum(leaf.nbytes // (leaf.shape[1] * pg)
                   for leaf in (pool["k"], pool["v"]))

    def _skipped_dma(self, live_tokens):
        """The goodput ledger's masked page reads of one live slot in
        one launch: on the card none (every route reads no column at or
        past the frontier); on the CPU the plain versions gather the
        block table's whole width, so the pages wholly beyond the slot's
        live length are read and masked —
        ``(table_width - ceil(live / pg)) * pg`` token-equivalents, the
        reference's model."""
        if self.device.type == "cuda":
            return 0
        live = -(-int(live_tokens) // self.page_size)
        return max(0, self._kv.pages_per_slot - live) * self.page_size

    # ------------------------------------- optimistic growth / preemption
    def _grow_locked(self):
        """Optimistic admission's growth pass: every active slot whose
        next ``tick_block`` decode writes would cross its block-table
        coverage gets pages appended on demand
        (``PagedKVCache.grow_slot``); when the pool cannot supply them
        the preemption policy frees victims (``_grow_one_locked``). Runs
        under the server lock BEFORE the device work that writes those
        rows, so the launch always sees tables covering every row it
        genuinely needs; rows past a request's total extent
        null-redirect, as reserve mode's wasted block steps do."""
        n = self.tick_block
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue              # empty, mid-prefill, or just parked
            st = self._slots[slot]
            # the next tick writes rows [t, t + n), t = prompt_len +
            # emitted - 1; rows at or past prompt + budget are never
            # read back (harvest stops the slot first)
            needed = min(st.prompt_len + len(st.emitted) - 1 + n,
                         st.prompt_len + st.budget)
            try:
                self._grow_one_locked(slot, st, needed)
            except PreemptedError:
                # the grower itself ranked last and was parked: typed,
                # internal, and caught HERE, so it never reaches a waiter
                continue

    def _grow_one_locked(self, slot, st, needed_tokens):
        """Grow one slot to cover ``needed_tokens``, preempting victims
        if the pool is genuinely exhausted. Each iteration succeeds,
        raises (a transient tick failure, retried by the supervisor with
        all state consistent) or removes one live slot from the
        candidates, so it terminates; when the grower itself is the
        least valuable live work it parks itself (``PreemptedError``,
        caught by ``_grow_locked``) rather than evict anyone ranked
        above it."""
        kv = self._kv
        need = self._npages_for(needed_tokens) - len(kv.slot_pages(slot))
        if need <= 0:
            return
        while True:
            try:
                kv.grow_slot(slot, need)
            except OutOfPages:
                if kv.free_pages() \
                        + self._prefix.evictable_pages() >= need:
                    # pages exist but this reclaim sweep died (an
                    # injected ``prefix.evict`` fault): a TRANSIENT tick
                    # failure the supervisor retries; preempting here
                    # would burn a victim for pages already reclaimable
                    raise
                cands = [(s, self._slots[s])
                         for s in range(self.max_slots)
                         if self._slots[s] is not None]
                victim = self._preempt_policy.pick(slot, cands)
                if victim is None:
                    raise      # no live work to free: genuine exhaustion
                if self._faults is not None:
                    # chaos point: an aborted victim teardown leaves the
                    # victim decoding and fails the TICK (supervised
                    # retry); victims already parked this sweep stay
                    # parked, and nothing leaks either way
                    self._faults.check(faults.SERVER_PREEMPT,
                                       slot=victim, grower=slot,
                                       rid=self._slots[victim].rid)
                if victim == slot:
                    self._preempt_slot_locked(slot)
                    raise PreemptedError(
                        f"request {st.rid} parked by its own page "
                        f"growth (least valuable live work)")
                self._preempt_slot_locked(victim)
            else:
                self.stats["grow_pages"] += need
                if self._tele is not None:
                    self._tele.add_grow_pages(need)
                if self._rec is not None:
                    self._rec.record("grow", rid=st.rid, slot=slot,
                                     pages=need)
                if st.journey is not None:
                    st.journey.event("grow", pages=need)
                return

    def _preempt_slot_locked(self, slot):
        """Tear a victim down, resumable: park its replay record
        (resolved seed, absolute deadline, stream offset, the partial so
        far) on the preempted queue, donate its written
        prompt pages into the radix tree COLD (the grow that triggered
        this reclaims them first; a quick re-admission still hits what
        survives) and free the rest. The waiter keeps blocking:
        re-admission replays the same token chain, greedy trivially,
        sampled because the chain restarts from the same seed."""
        st = self._slots[slot]
        rec = _Preempted(st)
        if self._rec is not None:
            self._rec.record("preempt", rid=st.rid, slot=slot,
                             tokens=len(rec.emitted),
                             preempts=rec.preempts)
        if st.journey is not None:
            st.journey.event("preempted", slot=slot,
                             tokens=len(rec.emitted))
        self._release_slot(slot, cold=True)
        self._preempted.append(rec)
        self.stats["preemptions"] += 1
        if self._tele is not None:
            self._tele.on_preempt(st.rid, len(self._preempted))
            self._pool_gauges()

    @torch.no_grad()
    def _decode(self):
        """``tick_block`` batched decode steps over every slot; returns
        the tokens [slots, n] and their rows' non-finite flags [slots, n]
        on the host (one device-to-host copy). Rows of slots with no live
        decode work (empty or mid-prefill) ride along: their writes
        null-redirect (paged) or land in their own rows or past the
        cache (dense), and their tokens are discarded. Sampling splits
        every slot's key every step, as the reference's vmap over slots
        does (the idle slots' keys are replaced when they activate),
        and scales by the temperature's reciprocal, as its jitted step
        does: one R1 launch a step."""
        step = self._decode_steps
        if self._costs is not None:
            price = None if self._price is None \
                else self._price.decode(self._t_host, self.tick_block)
            if self._decode_prog is None:
                # one catalog entry, priced once per tick below: the
                # decode step's shapes are static, so the tick path does
                # not hash the caches' shapes again
                step = self._cost_program(
                    "decode", self._decode_steps,
                    (self._tok, self._caches, self._t, self._keys), price)
                self._decode_prog = getattr(step, "prog", step)
            else:
                step = self._decode_prog
                if price is not None:
                    step.at(price)
        toks, bads = step()
        if self._t_host is not None:
            self._t_host += self.tick_block
        # the host read waits for every step: decode_launch
        host = torch.stack([torch.stack(toks, 1),
                            torch.stack(bads, 1)]).cpu().numpy()
        self.stats["decode_ticks"] += 1
        self.stats["decode_steps"] += self.tick_block
        self._tick_dispatch("decode")
        return host[0], host[1]

    def _decode_steps(self, *_):
        """Launch ``tick_block`` decode steps; returns the device token
        and non-finite flag rows, one a step."""
        toks, bads = [], []
        for _ in range(self.tick_block):
            x = self._embed_fn(self._tok, self._t)
            out, self._caches = self._step_fn(x, self._caches, self._t)
            self.stats["device_rows"] += x.shape[0]
            logits = self._head_fn(out)[:, -1]
            if self.do_sample:
                self._tok, self._keys, bad = self._draw(
                    logits, self._keys, self._no_fresh, self._no_fresh,
                    self._all_emit, reciprocal=True)
            else:
                self._tok = torch.argmax(logits, -1).to(torch.int32)
                bad = (~torch.isfinite(logits).all(-1)).to(torch.int32)
            self._t = self._t + 1
            toks.append(self._tok)
            bads.append(bad)
        return toks, bads

    def step(self):
        """One server tick: admit waiting requests and run their prefill
        chunks, run one batched decode step, harvest finished rows.
        Returns the number of active slots after the tick."""
        with self._lock:
            n = self._step_locked()
            if self._prefix is not None:
                self._prefix.flush_sketch()   # one publish a tick
        self._fire_callbacks()
        return n

    def _fire_callbacks(self):
        """Run the streamed-token callbacks collected under the lock;
        every one fires even when another raises, then the failures are
        raised together as a ``CallbackError``."""
        cbs, self._deferred_cbs = self._deferred_cbs, []
        ct = self._costs
        t_cb = ct.clock.now() if (ct is not None and cbs) else None
        errors = []
        for cb, rid, toks in cbs:
            try:
                if self._faults is not None:
                    self._faults.check(faults.ON_TOKEN, rid=rid)
                cb(rid, toks)
            except Exception as e:
                errors.append((rid, e))
        if t_cb is not None:
            # fires OUTSIDE the lock after the tick flushed, so this
            # phase folds into the NEXT tick's breakdown (a one-tick
            # skew, documented in telemetry.costs)
            ct.add_phase("token_callbacks", ct.clock.now() - t_cb)
        if errors:
            raise CallbackError(errors, what="on_token callback")

    def _step_locked(self):
        """One tick under the lock. Publishes the tick's dispatch
        profile, ledger and costs however the tick exits (normal, an
        early return, or a raising fault: a partial profile is what a
        postmortem wants)."""
        self._tick_disp = {}
        ct = self._costs
        if ct is not None:
            self._phase_timer = ct.phase_timer()
        try:
            return self._step_inner()
        finally:
            if self._phase_timer is not None:
                # trailing work since the last mark (the token-emit
                # loop, the end-of-tick harvest and admissions, or an
                # early return's remainder) is bookkeeping
                self._phase_timer.close("bookkeeping")
            prof = self._tick_disp
            total = sum(prof.values())
            self.stats["tick_dispatches"] += total
            if prof:
                if self._tele is not None:
                    self._tele.on_tick_dispatches(prof)
                if self._rec is not None:
                    extra = {}
                    if ct is not None:
                        extra["phases"] = ct.pending_phases()
                    self._rec.record("tick", dispatches=dict(prof),
                                     total=total,
                                     active=int(self._active.sum()),
                                     **extra)
            if self._led is not None:
                # the conservation boundary: whatever this tick
                # attributed (even a partial, faulted tick) is folded
                # and published now
                self._led.flush_tick()
            if ct is not None:
                ct.flush_tick()
                self._phase_timer = None

    def _activate_fused(self, slot, first):
        """A slot's prompt completed inside the fused launch, which also
        gave its first token: flip it into the decode phase. No device
        state to push: the next tick's launch carries the token."""
        st = self._slots[slot]
        st.phase = "decode"
        self._active[slot] = True
        self._prefill_fifo.remove(slot)
        st.emitted.append(first)
        if st.journey is not None:
            st.journey.event("first_token")
        st.stream(self._deferred_cbs)
        self.stats["admissions"] += 1
        if self._tele is not None:
            self._tele.on_first_token(st.rid, st.prompt_len - st.n_pre,
                                      st.n_pre)

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
        if self._phase_timer is not None:
            self._phase_timer.mark("admission")
        # harvest BEFORE packing: a slot whose budget is spent (or that
        # emitted eos at activation) must not decode further
        self._harvest()
        if self._optimistic and self._active.any():
            # grow every decode slot about to cross its coverage NOW:
            # the launch must never write a needed row through a missing
            # page (rows past the extent null-redirect as on split
            # ticks); a slot parked here neither packs nor emits, so its
            # key is not drawn
            self._grow_locked()
        S = self.max_slots
        pg = self.page_size
        plan, C = self._chunk_plan()
        dec_slots = [s for s in range(S) if self._active[s]]
        if not plan and not dec_slots:
            if self._tele is not None:
                self._tele.set_active_slots(0)
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
        # the whole block table and the schedule of live pages: the
        # launch reads pages up to the live frontier only. The table
        # goes at its full width, not sliced to the frontier: the bf16
        # decode body splits a row's keys by the table's width, and a
        # decode row must compute the same bits whatever the other
        # slots' frontiers are (a replay redraws its parked tokens)
        bt_live = self._kv.block_table
        ss, sp, _ = build_schedule(last, pg, n_slots=S)
        self._kv.dirty = False     # the slice is the device's view
        if self._faults is not None:
            # chaos point: a dying fused tick is a SERVER-level transient
            # the supervisor retries; nothing of this tick has reached
            # the device yet (pages, keys), and slot bookkeeping happens
            # after the launch
            self._faults.check(faults.DECODE_TICK)
        tele = self._tele
        n_active = len(dec_slots)
        t_tick = tele.tick_started() if tele is not None else None
        t_pre = tele.prefill_started() if (tele is not None and plan) \
            else None
        draw = (emit, fresh, seeds) if self.do_sample else ()
        args = self._fused_inputs(tokens, t0, last, dec, out_idx, bt_live,
                                  ss, sp, *draw)
        # a tick with prefill chunks and decode rows runs them as two
        # passes over the layers (``models.generation``): the decode
        # rows at C = 1, the chunks at C
        mixed = bool(plan and dec_slots)
        fused_fn = self._fused_fn
        if self._costs is not None:
            call = (*args[:4], self._caches, *args[4:8], bool(dec_slots))
            price = None
            if self._price is not None:
                rows = {s: (int(t0[s]), take, 0) for s, _, take in plan}
                rows.update({s: (int(t0[s]), 1, 1) for s in dec_slots})
                if mixed:
                    passes = [([rows[s] if dec[s] else (0, 0, 0)
                                for s in range(S)], 1),
                              ([(0, 0, 0) if dec[s] else
                                rows.get(s, (0, 0, 0))
                                for s in range(S)], C)]
                else:
                    passes = [([rows.get(s, (0, 0, 0)) for s in range(S)],
                               C)]
                price = self._price.fused(passes)
            fused_fn = self._cost_program("fused", self._fused_fn, call,
                                          price)
        logits, self._caches = fused_fn(
            *args[:4], self._caches, *args[4:8], bool(dec_slots))
        self.stats["fused_passes"] += 1 + mixed
        # C rows a live slot; a mixed tick's decode pass one a decode slot
        live = int((last >= 0).sum())
        self.stats["device_rows"] += len(dec_slots) + (live - len(
            dec_slots)) * C if mixed else live * C
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
        # the host read waits for the whole tick: fused_launch
        host = torch.stack([nxt, bad]).cpu().numpy()
        emitting = done + dec_slots
        self.stats["nonfinite_logit_rows"] += int(host[1][emitting].sum())
        self.stats["fused_launches"] += 1
        if plan:
            # the launch carries this tick's admission-path prefill work:
            # it IS the admission dispatch
            self._count_dispatches(1, op="fused")
        else:
            self._tick_dispatch("fused")
        if self._phase_timer is not None:
            self._phase_timer.mark("fused_launch")
        led = self._led
        for slot, start, take in plan:
            st = self._slots[slot]
            if led is not None:
                if st.preempts:
                    led.add("replay", take)
                else:
                    tail = max(0, min(start + take,
                                      st.reprefill_upto) - start)
                    led.add("tail_reprefill", tail)
                    led.add("goodput", take - tail)
                led.add("chunk_pad", C - take)
                led.add("skipped_page_dma", self._skipped_dma(start + take))
            if st.journey is not None:
                st.journey.event("prefill_chunk", start=start, take=take)
        self._advance(plan)
        for slot in done:
            self._activate_fused(slot, int(host[0][slot]))
        for slot in dec_slots:
            st = self._slots[slot]
            st.emitted.append(int(host[0][slot]))
            if led is not None:
                # one device row a decode slot: a mixed tick runs the
                # decode rows in a pass of their own at [S, 1], with no
                # C - 1 pad. A resumed slot's rows below its
                # pre-preemption offset re-generate tokens the waiter
                # already has
                led.add("replay"
                        if len(st.emitted) <= len(st.replayed)
                        else "goodput", 1)
                led.add("skipped_page_dma",
                        self._skipped_dma(st.prompt_len + len(st.emitted)
                                          - 1))
            st.stream(self._deferred_cbs)
        if tele is not None:
            tele.on_tick(t_tick, n_active, len(dec_slots))
            if t_pre is not None:
                # the launch wall covers decode rows too: fused prefill
                # seconds are launch seconds
                tele.on_prefill_batch(t_pre, sum(t for _, _, t in plan))
        self._harvest()
        # end-of-tick admissions reserve only: their chunks ride the
        # NEXT tick's launch (the token budget is per tick)
        self._admit(run_prefill=False)
        n = int(self._active.sum())
        if tele is not None:
            tele.set_active_slots(n)
        return n

    def _step_inner(self):
        if self._fused:
            return self._step_fused()
        self._prefill_used = 0       # per-tick prefill token budget
        self._expire_locked()
        self._admit()
        if self._phase_timer is not None:
            # scheduling work minus the prefill launches (those mark
            # themselves out as "prefill_launch")
            self._phase_timer.mark("admission")
        if not self._active.any():
            if self._tele is not None:
                self._tele.set_active_slots(0)
            return 0
        # harvest BEFORE stepping: a slot whose budget is spent (or that
        # emitted eos as its first token) must not decode further
        self._harvest()
        if self._phase_timer is not None:
            self._phase_timer.mark("bookkeeping")
        if not self._active.any():
            if self._tele is not None:
                self._tele.set_active_slots(0)
            return 0
        if self._optimistic:
            # grow every slot about to cross its coverage NOW, preempting
            # victims if the pool is dry: the dispatch below must never
            # write a needed row through a missing page
            self._grow_locked()
            if not self._active.any():
                # growth parked every decoding slot: nothing to dispatch
                # this tick (re-admission restarts them next tick)
                if self._tele is not None:
                    self._tele.set_active_slots(0)
                return 0
        self._sync_block_table()
        # activations batched their tok/t updates, and slots still
        # prefilling carry parked write positions: push both first
        self._flush_slot_state()
        if self._faults is not None:
            # chaos point: a dying decode tick is a SERVER-level
            # transient the supervisor retries; nothing was dispatched
            # yet, so no key has been split
            self._faults.check(faults.DECODE_TICK)
        tele = self._tele
        n_active = int(self._active.sum())
        t_tick = tele.tick_started() if tele is not None else None
        toks, bad = self._decode()
        if self._phase_timer is not None:
            # the grow, state pushes and block-table sync, the launches
            # and the host read that waits for them
            self._phase_timer.mark("decode_launch")
        n = toks.shape[1]
        decoded = wasted = 0
        led = self._led
        if led is not None:
            # rows of slots holding no live decode work still ride the
            # step: empty slots and mid-prefill slots (parked past the
            # table so their writes null-redirect; the dense backend
            # drops them past the cache: the same waste class)
            led.add("null_redirect", (self.max_slots - n_active) * n)
        for slot in range(self.max_slots):
            if not self._active[slot]:
                continue
            st = self._slots[slot]
            if led is not None and self._kv is not None:
                led.add("skipped_page_dma", self._skipped_dma(
                    st.prompt_len + len(st.emitted)))
            for j in range(n):
                st.emitted.append(int(toks[slot, j]))
                self.stats["nonfinite_logit_rows"] += int(bad[slot, j])
                if led is not None:
                    # a resumed slot's rows below its pre-preemption
                    # offset re-generate tokens the waiter already has
                    led.add("replay"
                            if len(st.emitted) <= len(st.replayed)
                            else "goodput", 1)
                if self._finished(st):
                    # the block's later rows are waste
                    self.stats["block_waste_tokens"] += n - (j + 1)
                    wasted += n - (j + 1)
                    if led is not None:
                        led.add("block_waste", n - (j + 1))
                    break
            decoded += min(j + 1, n)
            st.stream(self._deferred_cbs)
        if tele is not None:
            # the host read in _decode synced the steps, so the tick
            # time covers the host's launches and the device's work
            tele.on_tick(t_tick, n_active, decoded)
            if wasted:
                tele.add_wasted_block_tokens(wasted)
            if self._kv is not None:
                # inactive rows still step; their writes go through an
                # all-null block-table row to the null page
                tele.add_null_writes((self.max_slots - n_active) * n)
        self._harvest()
        # end-of-tick admissions: ragged ones reserve only, their
        # prefill chunks run in the NEXT tick's launch (the token budget
        # is per tick); dense ones prefill here
        self._admit(run_prefill=False)
        n = int(self._active.sum())
        if tele is not None:
            tele.set_active_slots(n)
        return n

    def _busy_locked(self):
        """Work pending: queued requests, decoding slots, slots still
        mid-prefill, or preempted requests parked for re-admission
        (``stop(drain=True)`` keeps ticking until they finish too)."""
        return bool(self._queue or self._active.any()
                    or self._prefill_fifo or self._preempted)

    def queue_depth(self):
        """Requests waiting for a slot (a lock-free point-in-time read)."""
        return len(self._queue)

    def in_flight(self):
        """Slots holding a live request, decoding or mid-prefill (a
        lock-free point-in-time read)."""
        return sum(1 for st in self._slots if st is not None)

    def preempt_pressure(self):
        """Requests parked on the preempted queue: displaced in-flight
        work this server must replay before it makes progress on new
        traffic. Always 0 under ``admission="reserve"``. A lock-free
        point-in-time read."""
        return len(self._preempted)

    def abandon(self, rid, err):
        """Record a typed failure for ``rid`` on behalf of a caller that
        HOLDS the request outside this server (the router: a foreign rid
        harvested off this replica's queue that no route ever claimed) —
        its waiter's ``wait(rid)`` raises ``err`` promptly instead of
        running out its timeout. No-op (returns False) when the rid
        already settled here."""
        with self._lock:
            if rid in self._results or rid in self._failures:
                return False
            self._failures[rid] = err
            self._done_cv.notify_all()
        return True

    def prefix_sketch(self):
        """Fingerprint set of this replica's radix-tree contents
        (``PrefixCache.sketch()``) — the router's prefix-affinity
        signal. Host-side only, no device reads, and LOCK-FREE: the
        cache publishes an immutable snapshot once a tick. Empty for
        the dense backend."""
        prefix = self._prefix
        return frozenset() if prefix is None else prefix.sketch()

    def evacuate(self, flush_partials=False):
        """Harvest every QUEUED request off this replica and hand it to
        the caller (a router requeues them on sibling replicas). The
        harvested entries carry everything a resubmit needs — prompt,
        budget, the resolved sampling seed (a sibling draws the identical
        chain), callback and the ABSOLUTE deadline. Nothing is recorded
        in ``failures`` for harvested rids: the caller owns them now.

        ``flush_partials=True`` (a DEAD replica being evacuated) also
        flushes every in-flight slot's partial tokens to its waiter, as
        ``stop(drain=False)`` does, and the parked preempted requests'
        partials: mid-decode work is not replayable elsewhere without
        double-streaming. With the default False (a DRAINING replica)
        in-flight slots keep decoding to completion."""
        with self._lock:
            harvested = list(self._queue)
            self._queue.clear()
            if self._rec is not None:
                self._rec.record("evacuate", harvested=len(harvested),
                                 flush_partials=bool(flush_partials))
            if self._tele is not None:
                # the harvested rids leave THIS replica for good: close
                # their lifecycle spans here
                for item in harvested:
                    self._tele.on_cancel(item.rid)
            if flush_partials:
                for slot in range(self.max_slots):
                    if self._slots[slot] is not None:
                        st = self._finish_partial_locked(slot)
                        if self._tele is not None:
                            self._tele.on_cancel(st.rid)
                for rec in self._preempted:
                    self._flush_parked_locked(rec)
                    if self._tele is not None:
                        self._tele.on_cancel(rec.rid)
                self._preempted.clear()
                self._preempt_gauge()
                # nobody fires chunks on a dead replica, and every live
                # rid was just flushed
                self._deferred_cbs.clear()
                if self._tele is not None:
                    self._tele.set_active_slots(0)
            if self._prefix is not None:
                self._prefix.flush_sketch()   # flushed slots donated
            if self._tele is not None:
                self._tele.set_queue_depth(0)
                self._pool_gauges()
            self._done_cv.notify_all()
        return harvested

    # ------------------------------------------- live KV-page migration
    def _chain_key(self, seed, n):
        """A sampled slot's key after ``n`` emitted tokens:
        ``PRNGKey(seed)`` split ``n`` times, keeping the first half each
        time (the draw's chain), on the device."""
        key = prng.PRNGKey(seed)
        for _ in range(n):
            key = prng.split(key)[0]
        return key.to(self.device)

    def migrate_out(self, rid, partial=False, from_page=0):
        """Gather a live request's FULL resumable state so a sibling
        continues it without re-prefilling: the written pool pages (one
        gather, ``_gather_pages``), the resolved sampling seed, the
        emitted-token log and the stream offset. Returns ``(state,
        payloads)`` — ``state`` is a JSON-able dict whose ``sha256``
        list lets the target verify every page END TO END, ``payloads``
        one ``[k, v]`` host-array pair a page. Both are the JAX
        server's, key for key and byte for byte (a bf16 pool adds
        ``"page_dtype": "bfloat16"``: its pages are ``uint16`` bit
        patterns).

        A mid-DECODE slot ships ``phase="decode"``; a slot still
        mid-PREFILL ships ``phase="prefill"`` and ``filled`` (rows
        written) — a prefill handoff: the target scatters the finished
        prompt pages, prefills only the rest and samples the first token
        from the resolved seed.

        ``partial=True`` is the non-pausing PIPELINED half: ship the
        complete, not-yet-shipped prompt pages of a mid-prefill slot as
        one batch and keep prefilling (``_migrate_partial_locked``).
        ``from_page`` skips pages the target already holds.

        The full path PAUSES the slot: stepping (decode) or chunking
        (prefill) stops and its pages stay held until the caller settles
        with ``migrate_finish`` (the target committed: release here,
        donating the prompt prefix as usual) or ``migrate_abort``
        (resume here bit-exactly). Raises ``MigrationError`` when the
        request is not migratable (unknown rid, dense backend, already
        in flight); an injected ``migrate.gather`` fault fires BEFORE
        the pause, so a faulted attempt leaves the slot untouched."""
        with self._lock:
            if self._kv is None:
                raise MigrationError(
                    "cache_backend='dense' has no page pool to migrate "
                    f"(request {rid})")
            slot = next((s for s in range(self.max_slots)
                         if self._slots[s] is not None
                         and self._slots[s].rid == rid), None)
            if slot is None:
                raise MigrationError(
                    f"request {rid} holds no slot here (queued, parked, "
                    f"finished, or foreign rids are not migratable — "
                    f"evacuate/replay covers them)")
            st = self._slots[slot]
            if st.phase not in ("decode", "prefill"):
                raise MigrationError(
                    f"request {rid} is mid-{st.phase} — only decoding "
                    f"or prefilling slots migrate")
            if st.phase == "decode" and not st.emitted:
                raise MigrationError(
                    f"request {rid} has no resumable decode state yet")
            if rid in self._migrating:
                raise MigrationError(
                    f"request {rid} already has a migration in flight")
            if partial:
                # non-pausing: no gather fault either (a pump polls
                # this many times a handoff)
                return self._migrate_partial_locked(slot, st)
            if self._faults is not None:
                self._faults.check(faults.MIGRATE_GATHER, rid=rid)
            t0 = self._tele.migration_started() \
                if self._tele is not None else None
            if st.phase == "decode":
                # the LAST emitted token is the decode step's pending
                # input — sampled but not yet written, so the target
                # rewrites nothing and re-prefills nothing
                written = st.prompt_len + len(st.emitted) - 1
            else:
                # prefill handoff: everything below ``filled`` is final;
                # the target resumes chunking at fill_pos
                written = st.filled
            npages = self._npages_for(written)
            base = max(0, min(int(from_page), npages))
            pages = self._kv.slot_pages(slot)[base:npages]
            payloads = self._gather_pages(pages)
            self._charge_transfer(
                "page_migrate",
                2 * len(payloads) * self._kv.page_size * self._row_nbytes())
            remaining = None if st.deadline is None else \
                max(0.0, st.deadline - self._clock.now())
            state = {
                "rid": rid,
                "ids": [int(t) for t in st.ids],
                "prompt_len": int(st.prompt_len),
                "budget": int(st.budget),
                "seed": int(st.seed),
                "emitted": [int(t) for t in st.emitted],
                "replayed": [int(t) for t in st.replayed],
                "streamed": int(st.streamed),
                "preempts": int(st.preempts),
                "priority": int(st.priority),
                "n_pre": int(st.n_pre),
                "deadline_s": remaining,
                "page_size": int(self._kv.page_size),
                "written": int(written),
                "phase": st.phase,
                "fill_pos": int(st.fill_pos),
                "filled": int(st.filled),
                "base": int(base),
                "sha256": [_sha256(p) for p in payloads],
            }
            if self._caches["pool"]["k"].dtype == torch.bfloat16:
                state["page_dtype"] = "bfloat16"
            # pause: the decode tick skips inactive rows, the ragged
            # planner skips slots off the fifo, and (split ticks) the
            # write cursor parks past the table; resume pushes tok, t and
            # key again (or re-queues the fifo for a prefill slot), so
            # nothing the device writes while paused is ever read
            prior = st.phase
            self._active[slot] = False
            st.phase = "migrating"
            if prior == "prefill" and slot in self._prefill_fifo:
                self._prefill_fifo.remove(slot)
            if not self._fused:
                self._pending_t[slot] = self.max_cache_len
            self._migrating[rid] = (slot, t0, prior)
            if self._rec is not None:
                self._rec.record("migrate_out", rid=rid,
                                 pages=npages - base, phase=prior,
                                 tokens=len(st.emitted))
            if st.journey is not None:
                if prior == "prefill":
                    st.journey.event("handoff", at="source",
                                     pages=npages - base,
                                     filled=int(st.filled))
                else:
                    st.journey.event("migrating", at="source",
                                     pages=npages,
                                     tokens=len(st.emitted))
            return state, payloads

    def _migrate_partial_locked(self, slot, st):
        """One NON-pausing batch of a mid-prefill slot's complete,
        not-yet-shipped pages (``migrate_out(partial=True)``). The
        fragment's ``base``/``fill_pos``/``phase`` tell the handoff pump
        where the stream stands; the slot keeps prefilling throughout,
        so a dead pump costs nothing here."""
        frag = {"rid": int(st.rid), "partial": True,
                "phase": st.phase,
                "page_size": int(self._kv.page_size),
                "prompt_len": int(st.prompt_len),
                "fill_pos": int(st.fill_pos),
                "filled": int(st.filled),
                "base": int(st.sent_pages),
                "sha256": []}
        if st.phase != "prefill":
            # past activation: the full migrate_out ships the balance
            return frag, []
        whole = st.filled // self._kv.page_size
        base = st.sent_pages
        if whole <= base:
            return frag, []
        payloads = self._gather_pages(self._kv.slot_pages(slot)[base:whole])
        self._charge_transfer(
            "page_migrate",
            2 * len(payloads) * self._kv.page_size * self._row_nbytes())
        st.sent_pages = whole
        self.stats["handoff_pages_out"] += len(payloads)
        frag["sha256"] = [_sha256(p) for p in payloads]
        if self._rec is not None:
            self._rec.record("handoff_partial", rid=st.rid, base=base,
                             pages=len(payloads))
        if st.journey is not None:
            st.journey.event("handoff", at="source", base=base,
                             pages=len(payloads))
        return frag, payloads

    def migrate_finish(self, rid):
        """Commit a migration: the target restored ``rid`` (and owns its
        waiter now), so release the paused slot's pages here through the
        normal teardown — the written prompt prefix is DONATED to the
        prefix cache like a finished request's. Counts
        ``server_migrations_total{result="ok"}``. Nothing lands in
        results or failures: the caller owns the request now."""
        with self._lock:
            ent = self._migrating.pop(rid, None)
            if ent is None:
                raise MigrationError(
                    f"request {rid} has no migration in flight")
            slot, t0 = ent[0], ent[1]
            st = self._slots[slot]
            if st is not None and st.rid == rid:
                if st.journey is not None:
                    st.journey.event("migrating", at="source",
                                     handoff=True)
                self._release_slot(slot)
            if self._rec is not None:
                self._rec.record("migrate_done", rid=rid)
            self.stats["migrations"] += 1
            if self._tele is not None:
                self._tele.on_migration("ok", t0)
                self._tele.on_cancel(rid)   # the lifecycle closes HERE
                self._pool_gauges()
            self._done_cv.notify_all()

    def migrate_abort(self, rid):
        """Abort a migration and RESUME the paused slot bit-exactly. A
        mid-decode pause pushes the pending token, the write position
        and (sampling, split ticks) the key again — ``PRNGKey(seed)``
        advanced one split an emitted token, the chain the device
        carried; a fused tick keeps a paused slot's key. A mid-PREFILL
        pause re-queues the slot on the ragged fifo (the shipped-page
        cursor resets, so a later handoff ships everything again).
        Counts ``{result="fallback"}`` and freezes a postmortem. Returns
        False when nothing was in flight for ``rid``."""
        with self._lock:
            ent = self._migrating.pop(rid, None)
            if ent is None:
                return False
            slot, t0, prior = ent
            st = self._slots[slot]
            if st is None or st.rid != rid:
                return False   # torn down behind the pause (hard stop)
            st.sent_pages = 0
            if prior == "prefill":
                st.phase = "prefill"
                if slot not in self._prefill_fifo:
                    self._prefill_fifo.append(slot)
                if not self._fused:
                    self._pending_t[slot] = self.max_cache_len
            else:
                st.phase = "decode"
                if not self._fused:
                    if self.do_sample:
                        self._pending_key[slot] = self._chain_key(
                            st.seed, len(st.emitted))
                    self._pending_tok[slot] = int(st.emitted[-1])
                    self._pending_t[slot] = \
                        st.prompt_len + len(st.emitted) - 1
                self._active[slot] = True
            self.stats["migration_fallbacks"] += 1
            if self._rec is not None:
                self._rec.record("migrate_fallback", rid=rid)
                self._postmortem_locked("migration_fallback")
            if st.journey is not None:
                st.journey.event("migrating", at="source", fallback=True)
            if self._tele is not None:
                self._tele.on_migration("fallback", t0)
            return True

    def _check_restore_state(self, state):
        """Shared ``migrate_in`` / ``migrate_in_commit`` validation: the
        page-size and role gates and the phase's written rows. Returns
        ``(phase, emitted, prompt_len, budget, written)``; every refusal
        is a typed ``MigrationError`` raised BEFORE any allocation."""
        if int(state.get("page_size", self.page_size)) != self.page_size:
            raise MigrationError(
                f"page-size mismatch: source pages are "
                f"{state.get('page_size')} tokens, this pool's are "
                f"{self.page_size} — migration ships pages whole")
        emitted = [int(t) for t in state.get("emitted") or ()]
        prompt_len = int(state["prompt_len"])
        budget = int(state["budget"])
        phase = str(state.get("phase") or "decode")
        if phase == "decode":
            if self.role == "prefill":
                raise MigrationError(
                    "replica role 'prefill' refuses decode-phase "
                    "admissions — hand mid-decode state to a decode "
                    "or hybrid replica")
            if not emitted or len(emitted) >= budget:
                raise MigrationError(
                    "only mid-decode state restores (source sends "
                    "nothing for queued/finished requests)")
            written = prompt_len + len(emitted) - 1
        elif phase == "prefill":
            if emitted:
                raise MigrationError(
                    "a prefill-phase handoff cannot carry emitted "
                    "tokens (activation would have flipped the slot "
                    "to decode)")
            written = int(state.get("filled") or 0)
            if not 0 <= written <= prompt_len:
                raise MigrationError(
                    f"filled={written} rows outside the prompt "
                    f"({prompt_len} tokens)")
        else:
            raise MigrationError(
                f"phase {phase!r} state does not restore (sources "
                f"send decoding or prefilling slots only)")
        return phase, emitted, prompt_len, budget, written

    def _verify_pages(self, payloads, digests, base=None, what="staged"):
        """Every page's end-to-end sha256 against the source's digest (a
        typed ``MigrationError`` on the first mismatch, worded as the
        JAX server words it: ``migrated page i/n`` for a one-shot
        restore, ``{what} page base + i`` for a staged batch)."""
        for i, want in enumerate(digests or ()):
            if _sha256(payloads[i]) != want:
                where = f"migrated page {i}/{len(payloads)}" \
                    if base is None else f"{what} page {base + i}"
                raise MigrationError(
                    f"{where} failed its end-to-end sha256 check")

    def _scatter_pages_locked(self, own, base, payloads):
        """Scatter received page payloads into this pool's pages
        ``own[base : base + len(payloads)]`` in place
        (``_scatter_pages``) and price the bytes as ``page_migrate``
        (never a prefill dispatch). Caller holds the lock and handles
        rollback."""
        self._scatter_pages(own[base:base + len(payloads)], payloads)
        self._charge_transfer(
            "page_migrate",
            2 * len(payloads) * self.page_size * self._row_nbytes())

    def _restore_slot_locked(self, slot, state, phase, emitted,
                             prompt_len, budget, written, on_token,
                             journey):
        """Build and prime the restored ``_Slot`` (the shared tail of
        ``migrate_in`` and ``migrate_in_commit``): a decode-phase
        restore resumes the chain exactly where the source paused it; a
        prefill-phase restore re-queues the ragged fifo at ``fill_pos``
        so the planner finishes the prompt and activation fires HERE.
        Returns the request's NEW rid."""
        rid = self._next_rid
        self._next_rid += 1
        dl = state.get("deadline_s")
        st = _Slot(rid, np.asarray(state["ids"], np.int32), prompt_len,
                   budget, on_token,
                   None if dl is None else self._clock.now() + float(dl),
                   int(state["seed"]))
        st.emitted = list(emitted)
        st.streamed = int(state.get("streamed", 0))
        st.replayed = tuple(int(t) for t in state.get("replayed", ()))
        st.preempts = int(state.get("preempts", 0))
        st.priority = int(state.get("priority", 0))
        st.n_pre = int(state.get("n_pre", 0))
        st.journey = journey
        self._slots[slot] = st
        if phase == "prefill":
            # the remaining prompt rows prefill here; the ragged planner
            # picks the slot up next tick and the activation draws the
            # first token from PRNGKey(seed), the identical chain
            st.phase = "prefill"
            st.fill_pos = st.filled = written
            self._prefill_fifo.append(slot)
            if not self._fused:
                self._pending_t[slot] = self.max_cache_len
        else:
            # prime the decode chain where the source paused it: pending
            # input = the last emitted token, write position = the first
            # unwritten row, key = seed advanced one split an emitted
            # token (greedy never reads it). The whole prompt is written,
            # so the finished request donates its prompt pages here
            st.fill_pos = st.filled = prompt_len
            if self.do_sample:
                key = self._chain_key(st.seed, len(emitted))
                if self._fused:
                    self._keys.view(torch.int32)[slot] = \
                        key.view(torch.int32)
                else:
                    self._pending_key[slot] = key
            if not self._fused:
                self._pending_tok[slot] = int(emitted[-1])
                self._pending_t[slot] = written
            self._active[slot] = True
        self.stats["migrated_in"] += 1
        if journey is not None:
            if phase == "prefill":
                journey.event("handoff", at="target", slot=slot,
                              filled=written)
            else:
                journey.event("migrating", at="target", slot=slot,
                              tokens=len(emitted))
        if self._tele is not None:
            self._pool_gauges()
        self._done_cv.notify_all()
        return rid

    def _free_slot_index(self, what):
        slot = next((s for s in range(self.max_slots)
                     if self._slots[s] is None), None)
        if slot is None:
            raise OutOfPages(f"no free slot for {what} "
                             f"(all {self.max_slots} busy)")
        return slot

    def _check_accepting(self):
        if self._kv is None:
            raise MigrationError(
                "cache_backend='dense' has no page pool to restore "
                "migrated pages into")
        if not self._accepting:
            raise MigrationError(
                "replica is draining/stopped — not accepting migrated "
                "requests")

    def migrate_in(self, state, payloads, on_token=None, journey=None):
        """Restore a migrated request into THIS replica and resume it
        mid-chain: fresh pool pages through the normal ``admit_slot``
        path, one in-place scatter of the received payloads, and the
        slot primed as the activation would have left it at this point
        of the chain — the token stream continues bit-exactly, greedy
        or seeded sampled, with ZERO re-prefill of the shipped rows (the
        scatter is priced as ``page_migrate`` bytes, never counted as a
        prefill). Prefill-phase state resumes CHUNKING at ``fill_pos``.
        Returns the request's NEW rid.

        Every refusal is typed and leak-free: an injected
        ``migrate.restore`` fault, a page failing its end-to-end sha256
        check, a geometry or role mismatch, or a pipelined-stream state
        (``base`` > 0 restores through the staged calls) raises
        ``MigrationError`` BEFORE any allocation; ``OutOfPages`` (no free
        slot, pool exhausted) propagates from the admit; a scatter
        failure rolls the fresh pages back."""
        with self._lock:
            self._check_accepting()
            if self._faults is not None:
                self._faults.check(faults.MIGRATE_RESTORE,
                                   rid=state.get("rid"))
            if int(state.get("base") or 0):
                raise MigrationError(
                    "state carries a page base — a pipelined partial "
                    "stream restores through migrate_in_begin/"
                    "migrate_in_pages/migrate_in_commit, not a one-shot "
                    "migrate_in")
            phase, emitted, prompt_len, budget, written = \
                self._check_restore_state(state)
            if len(payloads) != self._npages_for(written):
                raise MigrationError(
                    f"page-count mismatch: {len(payloads)} payloads for "
                    f"{written} written rows "
                    f"(expected {self._npages_for(written)})")
            self._verify_pages(payloads, state.get("sha256"))
            slot = self._free_slot_index("a migrated request")
            # a prefill restore sizes its extent off the FULL prompt, a
            # decode restore off the written rows; both grow as usual
            # under optimistic admission
            extent = self._extent_tokens(
                prompt_len if phase == "prefill" else written,
                budget - len(emitted))
            own = self._kv.admit_slot(slot, max(written, extent))
            if payloads:
                try:
                    self._scatter_pages_locked(own, 0, payloads)
                except Exception:
                    self._kv.free_slot(slot)
                    raise
            rid = self._restore_slot_locked(
                slot, state, phase, emitted, prompt_len, budget, written,
                on_token, journey)
            if self._rec is not None:
                self._rec.record("migrate_in", rid=rid,
                                 pages=len(payloads), phase=phase,
                                 tokens=len(emitted))
            return rid

    # --------------------- pipelined (staged) prefill-handoff restore
    def migrate_in_begin(self, state):
        """Open a PIPELINED restore (disaggregated prefill handoff):
        allocate the slot and its full page extent NOW so page batches
        scatter as the source's chunks complete (``migrate_in_pages``)
        and the first decode tick launches the moment the commit lands
        (``migrate_in_commit``). ``state`` needs ``ids`` /
        ``prompt_len`` / ``budget`` / ``page_size`` / ``seed``; the
        commit's full state re-verifies everything. Returns an opaque
        transfer handle; ``migrate_in_abort`` releases every page if the
        handoff dies mid-stream. The placeholder slot counts toward
        ``in_flight`` but never ticks: not active, not on the prefill
        fifo, no deadline until the commit."""
        with self._lock:
            self._check_accepting()
            if self._faults is not None:
                self._faults.check(faults.MIGRATE_RESTORE,
                                   rid=state.get("rid"))
            if int(state.get("page_size", self.page_size)) \
                    != self.page_size:
                raise MigrationError(
                    f"page-size mismatch: source pages are "
                    f"{state.get('page_size')} tokens, this pool's are "
                    f"{self.page_size} — migration ships pages whole")
            if self.role == "prefill" and \
                    str(state.get("phase") or "decode") == "decode":
                raise MigrationError(
                    "replica role 'prefill' refuses decode-phase "
                    "admissions — hand mid-decode state to a decode "
                    "or hybrid replica")
            prompt_len = int(state["prompt_len"])
            budget = int(state["budget"])
            slot = self._free_slot_index("a staged restore")
            own = self._kv.admit_slot(
                slot, self._extent_tokens(prompt_len, budget))
            rid = self._next_rid
            self._next_rid += 1
            st = _Slot(rid, np.asarray(state["ids"], np.int32),
                       prompt_len, budget, seed=int(state.get("seed", 0)))
            st.phase = "staging"
            self._slots[slot] = st
            if not self._fused:
                self._pending_t[slot] = self.max_cache_len
            handle = self._next_xfer
            self._next_xfer += 1
            self._staging[handle] = {"slot": slot, "own": list(own),
                                     "rid": rid, "got": set()}
            if self._rec is not None:
                self._rec.record("handoff_begin", rid=rid, slot=slot,
                                 pages=len(own))
            if self._tele is not None:
                self._pool_gauges()
            return handle

    def migrate_in_pages(self, handle, base, payloads, sha256=None):
        """Scatter one pipelined page batch at page index ``base`` of the
        staged restore ``handle`` — the target half of
        ``migrate_out(partial=True)``. Batches may arrive in any order;
        the commit verifies full coverage. Raises ``MigrationError``
        (unknown handle, sha256 failure, pages outside the staged
        extent) with the staging KEPT: the caller decides between a
        retry and ``migrate_in_abort``."""
        with self._lock:
            ent = self._staging.get(handle)
            if ent is None:
                raise MigrationError(
                    f"no staged restore open for handle {handle!r}")
            base = int(base)
            self._verify_pages(payloads, sha256, base, what="staged")
            own = ent["own"]
            if base < 0 or base + len(payloads) > len(own):
                raise MigrationError(
                    f"staged pages [{base}, {base + len(payloads)}) "
                    f"fall outside the slot's {len(own)}-page extent")
            if payloads:
                self._scatter_pages_locked(own, base, payloads)
                ent["got"].update(range(base, base + len(payloads)))
                self.stats["handoff_pages_in"] += len(payloads)
            if self._rec is not None:
                self._rec.record("handoff_pages", rid=ent["rid"],
                                 base=base, pages=len(payloads))
            return len(payloads)

    def migrate_in_commit(self, handle, state, payloads=(), on_token=None,
                          journey=None):
        """Close a pipelined restore: scatter the closing batch (the
        ``migrate_out(..., from_page=...)`` balance, page base in
        ``state["base"]``), verify every page of the written extent
        arrived, and flip the placeholder into a live slot as
        ``migrate_in`` would. Returns the request's NEW rid. Any refusal
        (coverage gap, sha256, role or geometry mismatch, ids drifting
        from the ``migrate_in_begin`` state) raises typed with the
        staging kept, so the caller can still ``migrate_in_abort``."""
        with self._lock:
            ent = self._staging.get(handle)
            if ent is None:
                raise MigrationError(
                    f"no staged restore open for handle {handle!r}")
            phase, emitted, prompt_len, budget, written = \
                self._check_restore_state(state)
            slot, own = ent["slot"], ent["own"]
            ph = self._slots[slot]
            if ph is None or ph.rid != ent["rid"]:
                raise MigrationError(
                    "staged slot was torn down behind the transfer "
                    "(hard stop) — nothing to commit")
            if prompt_len != ph.prompt_len or budget != ph.budget \
                    or not np.array_equal(
                        np.asarray(state["ids"], np.int32), ph.ids):
                raise MigrationError(
                    "commit state does not match the migrate_in_begin "
                    "request (ids/prompt_len/budget drift)")
            need = self._npages_for(written)
            base = int(state.get("base") or 0)
            if need > len(own):
                raise MigrationError(
                    f"{need} written pages exceed the staged "
                    f"{len(own)}-page extent")
            if base + len(payloads) != need:
                raise MigrationError(
                    f"closing batch [{base}, {base + len(payloads)}) "
                    f"does not reach the written extent ({need} pages)")
            missing = sorted(set(range(base)) - ent["got"])
            if missing:
                raise MigrationError(
                    f"staged restore incomplete: pages {missing} never "
                    f"arrived before the commit")
            self._verify_pages(payloads, state.get("sha256"), base,
                               what="closing")
            if payloads:
                self._scatter_pages_locked(own, base, list(payloads))
            # flip the placeholder into the live slot: _restore_slot
            # mints the rid the waiter sees
            self._slots[slot] = None
            self._staging.pop(handle)
            rid = self._restore_slot_locked(
                slot, state, phase, emitted, prompt_len, budget, written,
                on_token, journey)
            if self._rec is not None:
                self._rec.record("handoff_commit", rid=rid, pages=need,
                                 phase=phase)
            return rid

    def migrate_in_abort(self, handle):
        """Tear down a staged restore that will never commit: release
        every staged page straight back to the allocator (no donation:
        the rows may be half-written) and drop the placeholder. Returns
        False when nothing was staged for ``handle``."""
        with self._lock:
            ent = self._staging.pop(handle, None)
            if ent is None:
                return False
            slot = ent["slot"]
            st = self._slots[slot]
            if st is not None and st.rid == ent["rid"]:
                self._slots[slot] = None
                self._active[slot] = False
                pages = self._kv.detach_slot(slot)
                if pages:
                    self._kv.release(pages)
            if self._rec is not None:
                self._rec.record("handoff_abort", rid=ent["rid"])
            if self._tele is not None:
                self._pool_gauges()
            return True

    def kill(self, timeout=60.0):
        """Simulate a replica crash (failover drills): stop the serve
        thread NOW — joined, so no launch is in flight — and mark the
        server ``dead``, but unlike ``stop()`` leave the queue and the
        in-flight slots exactly as they are: no failures recorded, no
        partials flushed. That is the state a router finds after a real
        crash and harvests with ``evacuate(flush_partials=True)``.
        ``start()`` restarts as usual."""
        with self._lock:
            self._accepting = False
            self._draining = False
            if self._rec is not None:
                self._rec.record("killed")
                self._postmortem_locked("killed")
            self._health.to(DEAD)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"serve thread did not stop within {timeout}s (a "
                    f"tick may still be running); call kill() again to "
                    f"re-join")
            self._thread = None
        with self._lock:
            self._done_cv.notify_all()

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
                out = np.asarray(st.emitted[:st.budget], np.int32)
                self._results[st.rid] = out
                self._release_slot(slot)   # donates prompt pages
                if self._tele is not None:
                    self._tele.on_finish(st.rid, len(out))
                if self._rec is not None:
                    self._rec.record("finish", rid=st.rid,
                                     tokens=len(out))
                if st.journey is not None:
                    st.journey.event("finished", tokens=len(out))
                finished = True
        if finished:
            if self._tele is not None:
                self._pool_gauges()
            self._done_cv.notify_all()

    def _expire_locked(self):
        """Fail queued requests whose deadline passed (before a prefill
        is spent on them), cancel expired in-flight slots and flush
        expired parked requests (their partial tokens become the
        result). Reads the clock only when a live request carries a
        deadline."""
        now = None
        notify = False
        if any(item.deadline is not None for item in self._queue):
            now = self._clock.now()
            keep = []
            for item in self._queue:
                if item.deadline is not None and now >= item.deadline:
                    err = DeadlineExceeded(
                        f"request {item.rid} expired in queue "
                        f"(deadline passed before admission)")
                    self._failures[item.rid] = err
                    notify = True
                    if self._tele is not None:
                        self._tele.on_deadline_expired("queued")
                        self._tele.on_admission_failure(item.rid, err)
                    if self._rec is not None:
                        self._rec.record("deadline", rid=item.rid,
                                         where="queued")
                    if item.journey is not None:
                        # "where" is a Journey reserved key (the hop
                        # label): the expiry location is "at"
                        item.journey.event("expired", at="queued")
                else:
                    keep.append(item)
            if len(keep) != len(self._queue):
                self._queue[:] = keep
                if self._tele is not None:
                    self._tele.set_queue_depth(len(self._queue))
        for slot in range(self.max_slots):
            st = self._slots[slot]
            if st is None or st.deadline is None:
                continue
            if st.phase == "migrating":
                # its pages are in flight to a sibling: expiring the slot
                # here would tear down state migrate_finish /
                # migrate_abort still owns. The pause spans ONE attempt;
                # the deadline bites again the moment the slot resumes
                # (or on the target)
                continue
            if now is None:
                now = self._clock.now()
            if now >= st.deadline:
                if self._rec is not None:
                    self._rec.record("deadline", rid=st.rid,
                                     where="decoding")
                if st.journey is not None:
                    st.journey.event("expired", at="decoding")
                self._finish_partial_locked(slot)
                notify = True
                if self._tele is not None:
                    self._tele.on_deadline_expired("decoding")
                    self._tele.on_cancel(st.rid)
                    self._pool_gauges()
        if self._preempted:
            keep_p = []
            for rec in self._preempted:
                if rec.deadline is not None:
                    if now is None:
                        now = self._clock.now()
                    if now >= rec.deadline:
                        if self._rec is not None:
                            self._rec.record("deadline", rid=rec.rid,
                                             where="preempted")
                        if rec.journey is not None:
                            rec.journey.event("expired", at="preempted")
                        # the deadline holds ACROSS preemption (time
                        # parked counts): the pre-preemption partial is
                        # the result and no decode resumes
                        self._flush_parked_locked(rec)
                        notify = True
                        if self._tele is not None:
                            self._tele.on_deadline_expired("preempted")
                            self._tele.on_cancel(rec.rid)
                        continue
                keep_p.append(rec)
            if len(keep_p) != len(self._preempted):
                self._preempted[:] = keep_p
                self._preempt_gauge()
        if notify:
            self._done_cv.notify_all()

    def _fail_request_locked(self, rid, err):
        """Fail ONE live request (queued, in flight or parked) with
        ``err``; a rid already settled is left alone."""
        found, journey = False, None
        for i, item in enumerate(self._queue):
            if item.rid == rid:
                del self._queue[i]
                found, journey = True, item.journey
                break
        if not found:
            for slot in range(self.max_slots):
                st = self._slots[slot]
                if st is not None and st.rid == rid:
                    self._release_slot(slot)
                    if self._tele is not None:
                        self._pool_gauges()
                    found, journey = True, st.journey
                    break
        if not found:
            for i, rec in enumerate(self._preempted):
                if rec.rid == rid:
                    del self._preempted[i]
                    self._preempt_gauge()
                    found, journey = True, rec.journey
                    break
        if not found:
            return
        self._deferred_cbs = [c for c in self._deferred_cbs
                              if c[1] != rid]
        self._failures[rid] = err
        if self._tele is not None:
            self._tele.on_admission_failure(rid, err)
        self._note_request_failure_locked(rid, err, journey)
        self._done_cv.notify_all()

    def _note_request_failure_locked(self, rid, err, journey=None,
                                     bundle=True):
        """Observability funnel for one request FAILING (as opposed to
        finishing with a partial): journey phase, recorder event, and a
        postmortem bundle — the moment an operator wants the last N
        events and the pool state frozen. ``bundle=False`` skips the
        capture for EXPECTED sheds (evict_oldest runs on every
        overloaded submit). The caller owns the failure bookkeeping."""
        if journey is not None:
            journey.event("failed", error=type(err).__name__)
        if self._rec is not None:
            self._rec.record("fail", rid=rid, error=type(err).__name__)
            if bundle:
                self._postmortem_locked("request_failed", rid=rid,
                                        error=repr(err))

    def _postmortem_locked(self, reason, **extra):
        """Capture a postmortem bundle into the flight recorder: recent
        events plus the serving state an incident review needs — pool
        balance, block-table occupancy, radix-tree stats, the parked
        queue, live slots, queue depth, health, stats, the migration
        state, and the ledger's and the catalog's snapshots. Called
        under the server lock; returns the bundle (or None without a
        recorder)."""
        if self._rec is None:
            return None
        sections = {
            "health": self._health.state,
            "stats": dict(self.stats),
            "queue": [item.rid for item in self._queue],
            "slots": [{"slot": s, "rid": st.rid, "phase": st.phase,
                       "emitted": len(st.emitted),
                       "priority": st.priority}
                      for s, st in enumerate(self._slots)
                      if st is not None],
            "parked": [{"rid": rec.rid, "priority": rec.priority,
                        "preempts": rec.preempts,
                        "emitted": len(rec.emitted)}
                       for rec in self._preempted],
            # the in-flight pauses an incident interrupted plus the
            # cumulative outcome split: "did this replica hand its work
            # off or flush it?"
            "migration": {
                "in_flight": sorted(self._migrating),
                "staging": sorted(self._staging),
                "migrations": self.stats["migrations"],
                "fallbacks": self.stats["migration_fallbacks"],
                "migrated_in": self.stats["migrated_in"],
                "handoff_pages_out": self.stats["handoff_pages_out"],
                "handoff_pages_in": self.stats["handoff_pages_in"]},
        }
        if self._kv is not None:
            # pool_balance() is the ONE definition of the balance (a
            # re-entrant lock: safe here)
            bal = self.pool_balance()
            sections["pool_balance"] = {
                "free": bal[0], "live": bal[1], "pinned": bal[2],
                "cached": bal[3], "preempted": bal.preempted,
                "preemptions": bal.preemptions,
                "num_shards": bal.num_shards,
                "per_shard": list(bal.per_shard),
                "shard_page_bytes": bal.shard_page_bytes,
                "host": bal.host, "host_bytes": bal.host_bytes}
            sections["block_table"] = self._kv.occupancy(
                host_tier=self._host)
            sections["prefix_cache"] = self._prefix.stats()
        if self._led is not None:
            sections["goodput"] = self._led.snapshot()
        if self._costs is not None:
            sections["costs"] = self._costs.snapshot()
        sections.update(extra)
        return self._rec.postmortem(reason, **sections)

    def postmortems(self):
        """Captured postmortem bundles, oldest first (empty without a
        recorder) — served over ``/debug/postmortem`` by
        ``serving.serve_metrics``."""
        return [] if self._rec is None else self._rec.postmortems()

    def journey(self, rid):
        """Timeline of a SELF-MINTED journey (a server built with
        ``journeys=``): the request's phase events in arrival order, or
        None without a journey recorder, for an unknown rid, or for a
        journey minted elsewhere. Served over ``/debug/journey/<rid>``
        by ``serving.serve_metrics``."""
        if self._jrec is None:
            return None
        return self._jrec.journey(f"s{int(rid)}")

    def goodput(self):
        """The goodput ledger's cumulative snapshot (``{"tokens": {kind:
        n}, "goodput_ratio": ...}``), or None without an enabled ledger
        — also ``/stats["goodput"]`` and the ``goodput`` postmortem
        section."""
        return None if self._led is None else self._led.snapshot()

    def device_costs(self):
        """The cost catalog's cumulative snapshot (per-op FLOPs and
        bytes, compile counts, warm-up and recompile state,
        MFU/roofline, the last tick's phase split), or None without an
        enabled catalog — also ``/stats["costs"]`` and the ``costs``
        postmortem section."""
        return None if self._costs is None else self._costs.snapshot()

    def utilization(self):
        """Utilization digest for routing-side views: the goodput ratio
        (ledger) and MFU (cost catalog), whichever is wired."""
        util = {}
        if self._led is not None:
            util["goodput_ratio"] = self._led.goodput_ratio()
        if self._costs is not None:
            util["mfu"] = self._costs.mfu()
        return util

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
                if self._prefix is not None:
                    self._prefix.flush_sketch()
            self._fire_callbacks()
            ticks += 1
        with self._lock:
            out, self._results = self._results, {}
            self._run_failures, self._failures = self._failures, {}
        return out

    def _fail_all_locked(self, cause):
        """Breaker-open path: fail EVERY queued, parked and in-flight
        request with a ``CircuitOpenError`` so no waiter wedges on a
        server that cannot tick now."""
        thresh = self._sup.breaker.failure_threshold
        for group in (self._queue, self._preempted,
                      [st for st in self._slots if st is not None]):
            for item in group:
                if item.journey is not None:
                    item.journey.event("failed", error="CircuitOpenError")
        rids = [item.rid for item in self._queue]
        self._queue.clear()
        rids += [rec.rid for rec in self._preempted]
        self._preempted.clear()
        self._preempt_gauge()
        for slot in range(self.max_slots):
            if self._slots[slot] is not None:
                rids.append(self._slots[slot].rid)
                self._release_slot(slot)
        # chunks queued by the failed tick belong to rids that now have
        # no result: firing them after recovery would stream tokens for
        # requests whose wait() already raised
        self._deferred_cbs.clear()
        for rid in rids:
            err = CircuitOpenError(
                f"request {rid} aborted: circuit breaker opened after "
                f"{thresh} consecutive tick failures")
            err.__cause__ = cause
            self._failures[rid] = err
            if self._tele is not None:
                self._tele.on_admission_failure(rid, err)
        if self._tele is not None:
            self._tele.set_queue_depth(0)
            self._tele.set_active_slots(0)
            self._pool_gauges()
        self._done_cv.notify_all()

    @property
    def health(self):
        """Current health state: ``healthy`` / ``degraded`` /
        ``draining`` / ``dead`` (``reliability.health``). A lock-free
        read of a plain string: it answers while a tick holds the serve
        lock."""
        return self._health.state

    def _publish_health(self, state, code):
        if self._tele is not None:
            self._tele.set_health(state)
        if self._rec is not None:
            self._rec.record("health", state=state)

    # ------------------------------------------------------ serve thread
    def start(self, idle_sleep=0.005):
        """Run the tick loop on a SUPERVISED background thread:
        ``submit()`` and ``cancel()`` from any thread, collect results
        with ``wait(rid)``.

        Supervision (``reliability.ServeSupervisor``): a failing tick is
        retried with exponential backoff (``retry_policy``); a failing
        REQUEST (a poisoned on_token callback, an injected per-request
        fault) is failed alone through the per-rid failures channel
        while every other slot keeps decoding; after
        ``breaker.failure_threshold`` consecutive tick failures the
        circuit breaker opens: every waiter is unblocked with
        ``CircuitOpenError``, health goes ``degraded``, and after the
        cooldown a half-open probe tick restores ``healthy``. Deadlines
        still expire during the cooldown, and an idle degraded server
        recovers once the cooldown ends. The thread survives everything
        short of interpreter shutdown."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread_error = None
        with self._lock:
            self._accepting = True
            self._draining = False
            if self._health.state != HEALTHY:
                self._health.reset()   # explicit restart after stop()

        def loop():
            sup = self._sup
            try:
                while True:
                    with self._lock:
                        busy = self._busy_locked()
                    if self._stop.is_set() and not (self._draining
                                                    and busy):
                        break
                    if not busy:
                        if (sup.breaker.state != sup.breaker.CLOSED
                                and sup.allow()):
                            # cooldown elapsed with nothing failing: close
                            # the breaker so an IDLE server does not stay
                            # degraded
                            sup.success()
                            self._recover_health()
                        _time_mod.sleep(idle_sleep)
                        continue
                    if not sup.allow():          # breaker cooldown
                        with self._lock:
                            # deadlines keep their promise while the
                            # breaker gates ticks
                            self._expire_locked()
                        _time_mod.sleep(idle_sleep)
                        continue
                    try:
                        with self._lock:
                            if self._busy_locked():
                                self._step_locked()
                            if self._prefix is not None:
                                self._prefix.flush_sketch()
                        self._fire_callbacks()
                    except CallbackError as ce:
                        # the engine is fine: fail exactly the requests
                        # whose streams are poisoned
                        with self._lock:
                            for rid, err in ce.errors:
                                self._fail_request_locked(
                                    rid, CallbackError(
                                        [(rid, err)],
                                        what="on_token callback"))
                        sup.success()
                        self._recover_health()
                    except Exception as e:
                        self._on_tick_failure(e)
                    else:
                        sup.success()
                        self._recover_health()
            except BaseException as e:   # surface to waiters, don't wedge
                with self._lock:
                    self._thread_error = e
                    self._health.to(DEAD)
                    self._done_cv.notify_all()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def _on_tick_failure(self, e):
        """Supervised-tick failure path, called WITHOUT the lock (the
        retry backoff sleeps here)."""
        if self._tele is not None:
            self._tele.on_tick_retry()
        if self._rec is not None:
            self._rec.record("tick_retry", error=type(e).__name__)
        if self._sup.failure(e) == "open":
            with self._lock:
                self._health.to(DEGRADED)
                if self._rec is not None:
                    self._rec.record("breaker", state="open",
                                     error=type(e).__name__)
                    # capture BEFORE the teardown: the bundle freezes
                    # the parked queue, pool balance and slots as they
                    # were when the retries ran out
                    self._postmortem_locked("breaker_open",
                                            error=repr(e))
                self._fail_all_locked(e)
            if self._tele is not None:
                self._tele.on_breaker_open()

    def _recover_health(self):
        with self._lock:
            if self._health.state == DEGRADED:
                self._health.to(HEALTHY)

    def stop(self, timeout=60.0, drain=False):
        """Stop the serve thread. ``drain=True`` closes admission (health
        ``draining``) and keeps ticking until every queued, parked and
        in-flight request has finished; ``drain=False`` stops after the
        current tick, records in-flight and parked partials and fails
        still-queued requests with ``ServerClosed``. Either way the
        server ends ``dead`` until ``start()`` is called again."""
        with self._lock:
            self._accepting = False
            if drain and self._thread is not None:
                self._draining = True
                self._health.to(DRAINING)
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
                for rec in self._preempted:
                    self._flush_parked_locked(rec)
                self._preempted.clear()
                self._preempt_gauge()
                for item in self._queue:
                    self._failures[item.rid] = ServerClosed(
                        f"request {item.rid} was still queued when the "
                        f"server stopped")
                self._queue.clear()
                self._deferred_cbs.clear()
            self._health.to(DEAD)
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
