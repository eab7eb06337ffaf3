"""Serving SLO instrumentation for the continuous-batching server.

Copied from ``paddle_tpu/telemetry/serving.py`` (framework-free). The
port's server feeds ``ServerTelemetry`` (its host-tier and migration
signals included); the port's ``ReplicaRouter`` feeds
``RouterTelemetry``.

One ``ServerTelemetry`` object owns every signal an SLO-aware scheduler
(or an operator's dashboard) needs from ``ContinuousBatchingServer``:

Request lifecycle (spans ``request.queued`` -> ``request.prefill``
-> ``request.decode`` per rid, plus histograms):
- ``serving_queue_wait_seconds``  submit -> admission pop
- ``serving_ttft_seconds``        submit -> first token available
                                  (admission prefill emits it)
- ``serving_tpot_seconds``        (finish - first token) / (tokens - 1)
- ``serving_e2e_seconds``         submit -> finish
- ``serving_requests_total{state=submitted|finished|canceled|failed}``

Per-tick engine signals:
- ``serving_tick_seconds``        one batched decode dispatch (host
                                  wall, includes device sync)
- ``serving_tick_occupancy``      active slots entering the tick
- ``serving_active_slots`` / ``serving_queue_depth`` gauges
- ``serving_prefill_seconds``     one prefill batch (a ragged packed
                                  launch, or one dense admission)
- ``server_prefill_dispatches_total``  host dispatches on the
  admission/prefill path — the ragged prefill path's counter-asserted
  win is this dropping per admission vs the dense baseline
- ``serving_tick_dispatches``     host->device dispatches per server
  tick (histogram) — the fused-tick baseline
- ``server_dispatches_total{op}`` the same dispatches by op: decode /
  prefill / state_push / block_table / page_gather / page_scatter

Cache signals:
- ``serving_tokens_total{kind=prefill|prefix_hit|decode}``
- ``serving_prefix_cache_total{result=hit|miss|auto_hit|auto_miss}``
  (``hit``/``miss`` count registered-prefix outcomes at admission;
  ``auto_hit``/``auto_miss`` count the AUTOMATIC radix-tree lookups —
  auto_hit when the tree supplied pages beyond any registered match)
- ``kv_pool_pages{state=free|live|pinned|cached}`` (paged backend;
  ``cached`` = evictable auto-prefix-cache pages)
- ``kv_prefix_cached_pages`` gauge / ``kv_prefix_hit_tokens`` gauge
  (tokens covered by the most recent auto hit)
- ``kv_prefix_donated_pages_total`` / ``kv_prefix_evicted_pages_total``
- ``kv_null_redirected_writes_total``  inactive-slot rows stepped per
  tick — their all-null block tables redirect every write to the null
  page. Rows a finished slot wastes INSIDE a block are counted under
  ``serving_wasted_block_tokens_total`` instead (they land past the
  frontier in the slot's own pages, null-redirected only when they
  cross the reserved-extent page boundary).

Reliability signals (``reliability`` wiring):
- ``server_shed_total{policy=reject|evict_oldest}``  admission control
- ``server_deadline_expired_total{where=queued|decoding}``
- ``server_tick_retries_total``   supervised serve-loop retries
- ``server_breaker_open_total``   circuit-breaker opens
- ``server_health``               0 healthy / 1 degraded / 2 draining /
                                  3 dead (also served on ``/healthz``)

Every method no-ops when the registry is disabled (no locks, no clock
reads). All calls happen under the server's own lock, so per-request
state needs no extra synchronization. Host-side only — never call any
of this from jit-traced code.
"""
from .clock import MonotonicClock
from .metrics import DEFAULT_BUCKETS, MetricRegistry
from .tracing import Tracer

__all__ = ["ServerTelemetry", "RouterTelemetry", "TPOT_BUCKETS",
           "TICK_BUCKETS", "OCCUPANCY_BUCKETS"]

# per-token / per-tick scales are finer than request-level latencies
TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0)
TICK_BUCKETS = TPOT_BUCKETS
OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class _ReqState:
    __slots__ = ("t_submit", "t_admit", "t_first", "queued_span",
                 "prefill_span", "decode_span", "preempted")

    def __init__(self, t_submit, queued_span):
        self.t_submit = t_submit
        self.t_admit = None
        self.t_first = None
        self.queued_span = queued_span
        self.prefill_span = None
        self.decode_span = None
        # parked under pool pressure: the next wait span is
        # ``request.parked`` and the next admission's prefill span is
        # ``request.replay`` — preemption is VISIBLE in the
        # per-request span timeline, not disguised as a re-queue
        self.preempted = False


class ServerTelemetry:
    """Bundle of registry + tracer + clock wired for one server.

    >>> tele = ServerTelemetry()
    >>> srv = ContinuousBatchingServer(model, ..., telemetry=tele)
    >>> print(tele.registry.render())          # Prometheus text
    >>> tele.tracer.export_chrome_trace(path)  # request spans

    Tests inject ``clock=FakeClock()`` and advance it between scripted
    server calls for exact histogram assertions.
    """

    def __init__(self, registry=None, tracer=None, clock=None):
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None \
            else MetricRegistry()
        self.tracer = tracer if tracer is not None \
            else Tracer(clock=self.clock, enabled=self.registry.enabled)
        self.enabled = self.registry.enabled
        self._req = {}
        r = self.registry
        req = r.counter("serving_requests_total",
                        "Requests by lifecycle outcome",
                        labelnames=("state",))
        self._c_submitted = req.labels(state="submitted")
        self._c_finished = req.labels(state="finished")
        self._c_canceled = req.labels(state="canceled")
        self._c_failed = req.labels(state="failed")
        self._g_queue = r.gauge("serving_queue_depth",
                                "Requests waiting for a slot")
        self._g_active = r.gauge("serving_active_slots",
                                 "Slots decoding after the last tick")
        self._h_wait = r.histogram("serving_queue_wait_seconds",
                                   "submit() to admission pop",
                                   buckets=DEFAULT_BUCKETS)
        self._h_ttft = r.histogram("serving_ttft_seconds",
                                   "submit() to first generated token",
                                   buckets=DEFAULT_BUCKETS)
        self._h_tpot = r.histogram("serving_tpot_seconds",
                                   "Mean per-token decode latency at "
                                   "finish", buckets=TPOT_BUCKETS)
        self._h_e2e = r.histogram("serving_e2e_seconds",
                                  "submit() to finish",
                                  buckets=DEFAULT_BUCKETS)
        self._h_tick = r.histogram("serving_tick_seconds",
                                   "One batched decode dispatch",
                                   buckets=TICK_BUCKETS)
        self._h_occ = r.histogram("serving_tick_occupancy",
                                  "Active slots entering a tick",
                                  buckets=OCCUPANCY_BUCKETS)
        tok = r.counter("serving_tokens_total", "Token work by kind",
                        labelnames=("kind",))
        self._c_tok_prefill = tok.labels(kind="prefill")
        self._c_tok_prefix = tok.labels(kind="prefix_hit")
        self._c_tok_decode = tok.labels(kind="decode")
        pfx = r.counter("serving_prefix_cache_total",
                        "Admissions by prefix-cache outcome",
                        labelnames=("result",))
        self._c_pfx_hit = pfx.labels(result="hit")
        self._c_pfx_miss = pfx.labels(result="miss")
        self._c_pfx_auto_hit = pfx.labels(result="auto_hit")
        self._c_pfx_auto_miss = pfx.labels(result="auto_miss")
        pool = r.gauge("kv_pool_pages", "Paged KV pool occupancy",
                       labelnames=("state",))
        self._g_pool_free = pool.labels(state="free")
        self._g_pool_live = pool.labels(state="live")
        self._g_pool_pinned = pool.labels(state="pinned")
        self._g_pool_cached = pool.labels(state="cached")
        self._g_pool_host = pool.labels(state="host")
        self._g_pool_shards = r.gauge(
            "kv_pool_shards",
            "Ways the paged KV pool is sharded over the mesh mp axis "
            "(1 when unsharded or replicated)")
        self._g_pool_shard_bytes = r.gauge(
            "kv_pool_shard_page_bytes",
            "Per-device bytes held by one shard of the paged K/V pool")
        self._g_pfx_cached = r.gauge(
            "kv_prefix_cached_pages",
            "Evictable pages held by the automatic prefix cache")
        self._g_pfx_hit_tokens = r.gauge(
            "kv_prefix_hit_tokens",
            "Tokens covered by the most recent automatic prefix hit")
        self._c_pfx_donated = r.counter(
            "kv_prefix_donated_pages_total",
            "Prompt pages donated into the prefix cache at harvest")
        self._c_pfx_evicted = r.counter(
            "kv_prefix_evicted_pages_total",
            "Cached prefix pages reclaimed by LRU eviction")
        # tiered KV: the host tier under the prefix cache
        self._c_host_spilled = r.counter(
            "kv_host_spilled_pages_total",
            "Prefix pages demoted to the host KV tier at eviction")
        self._c_host_restored = r.counter(
            "kv_host_restored_pages_total",
            "Host-tier pages promoted back into pool pages at "
            "admission")
        self._c_host_corrupt = r.counter(
            "kv_host_restore_corrupt_total",
            "Host-tier restores dropped on checksum mismatch (served "
            "as a cache miss, never a request failure)")
        self._h_restore = r.histogram(
            "serving_restore_seconds",
            "One admission's host-tier restore: checksummed payload "
            "reads plus the batched pool scatter",
            buckets=TICK_BUCKETS)
        # live KV-page migration: this replica as the SOURCE
        mig = r.counter(
            "server_migrations_total",
            "Live KV-page migrations attempted with this replica as "
            "the source, by outcome: ok = pages handed off and the "
            "slot released; fallback = degraded to evacuate+replay "
            "(checksum mismatch, frame loss, target refusal, dead "
            "wire)",
            labelnames=("result",))
        self._c_mig_ok = mig.labels(result="ok")
        self._c_mig_fallback = mig.labels(result="fallback")
        self._h_migration = r.histogram(
            "serving_migration_seconds",
            "One live migration at the source: pause + per-shard page "
            "gathers + wire transfer, until the slot is released (ok) "
            "or resumed (fallback)",
            buckets=TICK_BUCKETS)
        self._c_null_writes = r.counter(
            "kv_null_redirected_writes_total",
            "Inactive-slot decode writes redirected to the null page "
            "(mid-block waste of live slots is wasted_block_tokens)")
        self._c_wasted_block = r.counter(
            "serving_wasted_block_tokens_total",
            "Block-decode steps run past a slot's finish (tick_block "
            "amortization cost)")
        # admission/prefill dispatch accounting: the ragged prefill
        # path's counter-asserted win is this DROPPING per admission
        # (one batched launch per tick vs per-request prefill programs
        # + the auto-hit page-gather/scatter detour + 3 slot-state
        # pushes each)
        self._c_prefill_disp = r.counter(
            "server_prefill_dispatches_total",
            "Host->device dispatches on the admission/prefill path "
            "(prefill program launches, page gathers/scatters, "
            "slot-state pushes)")
        self._h_prefill = r.histogram(
            "serving_prefill_seconds",
            "One prefill batch: a ragged packed launch, or one "
            "admission's dense prefill", buckets=TICK_BUCKETS)
        # dispatches-per-decode-tick: THE success metric for the fused
        # decode megakernel — today a tick costs one
        # decode program plus state pushes / block-table syncs /
        # prefill launches; the megakernel's win is this histogram's
        # mass moving toward 1. The per-op counter names where the
        # remaining dispatches go.
        self._h_tick_disp = r.histogram(
            "serving_tick_dispatches",
            "Host->device dispatches per server tick (the fused-tick "
            "baseline)",
            buckets=(1, 2, 3, 5, 8, 13, 21, 34, 55))
        self._c_disp = r.counter(
            "server_dispatches_total",
            "Host->device dispatches on the serving hot path, by op "
            "(decode / prefill / state_push / block_table / "
            "page_gather / page_scatter)", labelnames=("op",))
        self._disp_children = {}
        # reliability signals (reliability): admission
        # control, supervised-loop retries, breaker, health
        shed = r.counter("server_shed_total",
                         "Requests shed by admission control",
                         labelnames=("policy",))
        self._c_shed_reject = shed.labels(policy="reject")
        self._c_shed_evict = shed.labels(policy="evict_oldest")
        exp = r.counter("server_deadline_expired_total",
                        "Requests that outran their deadline",
                        labelnames=("where",))
        self._c_exp = {"queued": exp.labels(where="queued"),
                       "decoding": exp.labels(where="decoding"),
                       "preempted": exp.labels(where="preempted")}
        # admission="optimistic" signals: how often the gamble loses
        # (preemptions), what growth-on-demand actually allocated, the
        # headroom admissions pre-paid, and the parked-replay backlog
        self._c_preempt = r.counter(
            "server_preemptions_total",
            "Slots preempted under KV-pool pressure (victim parked for "
            "bit-exact re-admission)")
        self._c_preempt_resumed = r.counter(
            "server_preempt_resumed_total",
            "Preempted requests re-admitted (replay started)")
        self._c_grow_pages = r.counter(
            "kv_grow_pages_total",
            "Pages grown on demand mid-decode (optimistic admission)")
        self._c_headroom = r.counter(
            "server_headroom_pages_total",
            "Pages reserved beyond the prompt at optimistic admission "
            "(pre-paid growth headroom)")
        self._g_preempted = r.gauge(
            "server_preempted_queue_depth",
            "Preempted requests parked awaiting re-admission")
        self._c_tick_retries = r.counter(
            "server_tick_retries_total",
            "Supervised serve-loop tick failures retried")
        self._c_breaker_open = r.counter(
            "server_breaker_open_total",
            "Circuit-breaker opens (waiters failed, health degraded)")
        self._g_health = r.gauge(
            "server_health",
            "Health state code: 0 healthy / 1 degraded / 2 draining / "
            "3 dead (alert on >= 2)")

    # -------------------------------------------------------- lifecycle
    def on_submit(self, rid, prompt_tokens, queue_depth):
        if not self.enabled:
            return
        t = self.clock.now()
        self._c_submitted.inc()
        self._g_queue.set(queue_depth)
        self._req[rid] = _ReqState(
            t, self.tracer.begin_span("request.queued", rid=rid,
                                      prompt_tokens=prompt_tokens))

    def on_admit(self, rid, queue_depth):
        """Request popped from the queue; admission prefill starts
        (its span is closed by on_first_token)."""
        if not self.enabled:
            return
        st = self._req.get(rid)
        if st is None:
            return
        # the queue-wait histogram is observed by on_first_token, not
        # here: this attempt may still be DEFERRED back to the queue,
        # and a request must contribute exactly one (full) sample
        st.t_admit = self.clock.now()
        self._g_queue.set(queue_depth)
        if st.queued_span is not None:   # None after a deferred admit
            st.queued_span.end()
            st.queued_span = None
        # a resumed (previously preempted) request's admission is a
        # REPLAY, not a first prefill — name the span so the parked ->
        # replay detour reads directly off the timeline
        st.prefill_span = self.tracer.begin_span(
            "request.replay" if st.preempted else "request.prefill",
            rid=rid)

    def on_admission_deferred(self, rid, queue_depth):
        """Admission rolled back (the pool could not be made to fit —
        e.g. an aborted eviction sweep) and the request returned to the
        queue head; it will be admitted again later."""
        if not self.enabled:
            return
        st = self._req.get(rid)
        self._g_queue.set(queue_depth)
        if st is None:
            return
        if st.prefill_span is not None:
            st.prefill_span.end(deferred=True)
            st.prefill_span = None
        if st.queued_span is None:
            st.queued_span = self.tracer.begin_span(
                "request.parked" if st.preempted else "request.queued",
                rid=rid, requeued=True)

    def on_first_token(self, rid, prefill_tokens, prefix_hit_tokens):
        """Admission prefill produced the request's first token. A
        PREEMPTED request re-emits its first token at re-admission:
        the waiter saw it long ago, so TTFT/queue-wait observe only the
        ORIGINAL emission (``t_first`` stays put for TPOT); the token
        counters still count the replay's real prefill work."""
        if not self.enabled:
            return
        st = self._req.get(rid)
        if st is None:
            return
        t = self.clock.now()
        if st.t_first is None:
            if st.t_admit is not None:
                # the wait that ended at the SUCCESSFUL admission
                # (deferred attempts updated t_admit and observed
                # nothing)
                self._h_wait.observe(st.t_admit - st.t_submit)
            self._h_ttft.observe(t - st.t_submit)
            st.t_first = t
        st.preempted = False     # the replay caught up; spans normalize
        if st.prefill_span is not None:
            st.prefill_span.end(prefill_tokens=prefill_tokens,
                                prefix_hit_tokens=prefix_hit_tokens)
            st.prefill_span = None
        if prefill_tokens:
            self._c_tok_prefill.inc(prefill_tokens)
        if prefix_hit_tokens:
            self._c_pfx_hit.inc()
            self._c_tok_prefix.inc(prefix_hit_tokens)
        else:
            self._c_pfx_miss.inc()
        st.decode_span = self.tracer.begin_span("request.decode", rid=rid)

    def on_finish(self, rid, n_tokens):
        if not self.enabled:
            return
        st = self._req.pop(rid, None)
        if st is None:
            return
        t = self.clock.now()
        self._c_finished.inc()
        self._h_e2e.observe(t - st.t_submit)
        if st.t_first is not None and n_tokens > 1:
            self._h_tpot.observe((t - st.t_first) / (n_tokens - 1))
        if st.decode_span is not None:
            st.decode_span.end(tokens=n_tokens)

    def on_cancel(self, rid):
        if not self.enabled:
            return
        st = self._req.pop(rid, None)
        if st is None:
            return
        self._c_canceled.inc()
        for span in (st.queued_span, st.prefill_span,
                         st.decode_span):
            if span is not None:
                span.end(canceled=True)

    def on_admission_failure(self, rid, exc):
        if not self.enabled:
            return
        st = self._req.pop(rid, None)
        self._c_failed.inc()
        if st is not None:
            for span in (st.queued_span, st.prefill_span,
                         st.decode_span):
                if span is not None:
                    span.end(error=type(exc).__name__)
        self.tracer.instant("request.failed", rid=rid,
                            error=type(exc).__name__)

    # ------------------------------------------------------ engine ticks
    def tick_started(self):
        """Timestamp handle for on_tick (one clock read)."""
        if not self.enabled:
            return None
        return self.clock.now()

    def on_tick(self, t_started, active_slots, decode_tokens):
        if not self.enabled:
            return
        self._h_tick.observe(self.clock.now() - t_started)
        self._h_occ.observe(active_slots)
        self._g_active.set(active_slots)
        if decode_tokens:
            self._c_tok_decode.inc(decode_tokens)

    def set_queue_depth(self, n):
        if self.enabled:
            self._g_queue.set(n)

    def set_active_slots(self, n):
        if self.enabled:
            self._g_active.set(n)

    # ------------------------------------------------------- cache state
    def set_pool(self, free, live, pinned, cached=0, host=0):
        if not self.enabled:
            return
        self._g_pool_free.set(free)
        self._g_pool_live.set(live)
        self._g_pool_pinned.set(pinned)
        self._g_pool_cached.set(cached)
        self._g_pfx_cached.set(cached)
        self._g_pool_host.set(host)

    def set_pool_shards(self, num_shards, shard_bytes):
        """Per-shard pool placement: how many ways the K/V pool is
        sharded and the measured bytes one device holds for it."""
        if not self.enabled:
            return
        self._g_pool_shards.set(num_shards)
        if shard_bytes is not None:
            self._g_pool_shard_bytes.set(shard_bytes)

    def on_prefix_auto(self, hit, tokens):
        """One automatic (radix-tree) prefix lookup at admission:
        ``hit`` when the tree supplied pages beyond any registered
        match, covering ``tokens`` prompt tokens."""
        if not self.enabled:
            return
        if hit:
            self._c_pfx_auto_hit.inc()
            self._g_pfx_hit_tokens.set(tokens)
        else:
            self._c_pfx_auto_miss.inc()

    def on_prefix_donate(self, pages):
        if self.enabled and pages:
            self._c_pfx_donated.inc(pages)

    def on_prefix_evict(self, pages):
        if self.enabled and pages:
            self._c_pfx_evicted.inc(pages)

    def on_host_spill(self, pages):
        """``pages`` prefix pages demoted to the host tier by one
        eviction sweep (the tier kept them; ``on_prefix_evict`` counts
        only pages dropped for real)."""
        if self.enabled and pages:
            self._c_host_spilled.inc(pages)

    def restore_started(self):
        """Clock read for ``on_host_restore``'s latency observation —
        only called when a restore actually happens (host suffix hit),
        so the no-tier hot path stays clock-free."""
        return self.clock.now() if self.enabled else None

    def on_host_restore(self, pages, started=None):
        """``pages`` host-tier pages promoted back into pool pages by
        one admission's restore (latency observed from ``started`` =
        ``restore_started()``)."""
        if not self.enabled:
            return
        if pages:
            self._c_host_restored.inc(pages)
        if started is not None:
            self._h_restore.observe(self.clock.now() - started)

    def on_host_restore_corrupt(self):
        """A host-tier payload failed its sha256 check at restore —
        served as a cache miss."""
        if self.enabled:
            self._c_host_corrupt.inc()

    def migration_started(self):
        """Clock read for ``on_migration``'s latency observation —
        only called when a migration actually starts, so the no-
        migration hot path stays clock-free."""
        return self.clock.now() if self.enabled else None

    def on_migration(self, result, started=None):
        """One live KV-page migration settled at the source:
        ``result`` is ``"ok"`` (handoff committed, slot released) or
        ``"fallback"`` (degraded to evacuate+replay); latency observed
        from ``started`` = ``migration_started()``."""
        if not self.enabled:
            return
        (self._c_mig_ok if result == "ok"
         else self._c_mig_fallback).inc()
        if started is not None:
            self._h_migration.observe(self.clock.now() - started)

    def add_null_writes(self, n):
        if self.enabled and n:
            self._c_null_writes.inc(n)

    def add_wasted_block_tokens(self, n):
        if self.enabled and n:
            self._c_wasted_block.inc(n)

    def add_prefill_tokens(self, n):
        """Out-of-band prefill work (register_prefix)."""
        if self.enabled and n:
            self._c_tok_prefill.inc(n)

    def add_prefill_dispatches(self, n):
        """``n`` host->device dispatches on the admission/prefill path."""
        if self.enabled and n:
            self._c_prefill_disp.inc(n)

    def on_tick_dispatches(self, profile):
        """Publish one tick's host->device dispatch profile:
        ``profile`` maps op name -> dispatch count for the tick that
        just ran (the server accumulates it; empty ticks publish
        nothing). Observes the per-tick total and feeds the per-op
        counter."""
        if not self.enabled or not profile:
            return
        self._h_tick_disp.observe(sum(profile.values()))
        for op, n in profile.items():
            child = self._disp_children.get(op)
            if child is None:
                child = self._disp_children[op] = \
                    self._c_disp.labels(op=op)
            child.inc(n)

    def prefill_started(self):
        """Timestamp handle for on_prefill_batch (one clock read)."""
        if not self.enabled:
            return None
        return self.clock.now()

    def on_prefill_batch(self, t_started, tokens):
        """One prefill batch finished: a ragged packed launch covering
        ``tokens`` prompt rows across its slots, or one admission's
        dense prefill. (Token counters are driven by on_first_token;
        this only times the batch.)"""
        if not self.enabled:
            return
        self._h_prefill.observe(self.clock.now() - t_started)

    # ------------------------------------------------------- reliability
    def on_shed(self, policy):
        if not self.enabled:
            return
        (self._c_shed_reject if policy == "reject"
         else self._c_shed_evict).inc()

    def on_deadline_expired(self, where):
        """``where``: ``queued`` / ``decoding`` / ``preempted`` (the
        request expired while parked on the preempted queue)."""
        if not self.enabled:
            return
        self._c_exp.get(where, self._c_exp["decoding"]).inc()

    # ------------------------------------------- optimistic admission
    def on_preempt(self, rid, depth):
        """A live slot was preempted under pool pressure and parked
        (``depth`` = preempted-queue depth after parking). The request
        is back to waiting: its open prefill/decode spans close and a
        ``request.parked`` span opens — the parked/replay detour is a
        distinct phase in the span timeline, and the NEXT admission's
        prefill span is named ``request.replay``."""
        if not self.enabled:
            return
        self._c_preempt.inc()
        self._g_preempted.set(depth)
        st = self._req.get(rid)
        if st is None:
            return
        st.preempted = True
        if st.decode_span is not None:
            st.decode_span.end(preempted=True)
            st.decode_span = None
        if st.prefill_span is not None:
            st.prefill_span.end(preempted=True)
            st.prefill_span = None
        if st.queued_span is None:
            st.queued_span = self.tracer.begin_span(
                "request.parked", rid=rid)

    def on_preempt_resumed(self):
        if self.enabled:
            self._c_preempt_resumed.inc()

    def add_grow_pages(self, n):
        if self.enabled and n:
            self._c_grow_pages.inc(n)

    def add_headroom_pages(self, n):
        if self.enabled and n:
            self._c_headroom.inc(n)

    def set_preempted_depth(self, n):
        if self.enabled:
            self._g_preempted.set(n)

    def on_tick_retry(self):
        if self.enabled:
            self._c_tick_retries.inc()

    def on_breaker_open(self):
        if self.enabled:
            self._c_breaker_open.inc()

    def set_health(self, state):
        """Publish the health gauge; ``state`` is the reliability
        health-state name (healthy/degraded/draining/dead)."""
        if not self.enabled:
            return
        from ..reliability.health import HEALTH_CODES
        self._g_health.set(HEALTH_CODES[state])


class RouterTelemetry:
    """Instrumentation for the multi-replica front door
    (``inference.router.ReplicaRouter``):

    - ``router_routed_total{replica}``      requests dispatched, by
                                            destination
    - ``router_affinity_hits_total``        dispatches won by prefix
      affinity (the chosen replica's sketch covered >= 1 prompt page)
    - ``router_fallback_total``             dispatches that fell back
      to least-loaded (no replica held any prefix)
    - ``router_dispatch_retries_total{replica}``  dispatch attempts
      that failed and moved on to the next candidate
    - ``router_evacuations_total{replica}`` harvest sweeps, by SOURCE
    - ``router_requeued_total{replica}``    failover requeues, by
                                            DESTINATION
    - ``router_replica_lost_total``         requests failed with
      ``ReplicaLostError`` (no sibling could take them)
    - ``router_orphaned_total``             foreign rids harvested from
      an evacuated replica that no route ever claimed, failed typed at
      their source replica once the orphan TTL expired
    - ``router_queue_depth``                harvested requests awaiting
                                            redispatch
    - ``router_replicas_serving``           replicas currently taking
                                            traffic
    - ``router_health``                     aggregate: 0 all serving /
      1 some down / 3 none serving (same coding as ``server_health``)
    - ``router_handoffs_total{result}``     prefill->decode handoffs
      (disaggregated placement), ok = committed on a decode sibling /
      fallback = the request stayed decoding on the prefill specialist
    - ``serving_handoff_seconds``           one handoff end to end:
      pump start (placement on the specialist) through pipelined page
      frames to the commit on the decode target
    - ``router_replica_role{replica}``      each replica's placement
      role: 0 hybrid / 1 prefill / 2 decode

    Same conventions as ``ServerTelemetry``: every method no-ops when
    the registry is disabled, calls happen under the router's lock (or
    from its single supervisor thread), host-side only.
    """

    def __init__(self, registry=None, clock=None):
        self.clock = clock if clock is not None else MonotonicClock()
        self.registry = registry if registry is not None \
            else MetricRegistry()
        self.enabled = self.registry.enabled
        r = self.registry
        self._c_routed = r.counter(
            "router_routed_total",
            "Requests dispatched to a replica (by destination)",
            labelnames=("replica",))
        self._c_affinity = r.counter(
            "router_affinity_hits_total",
            "Dispatches routed by prefix affinity (sketch hit)")
        self._c_fallback = r.counter(
            "router_fallback_total",
            "Dispatches that fell back to least-loaded routing")
        self._c_retry = r.counter(
            "router_dispatch_retries_total",
            "Dispatch attempts that failed over to the next candidate",
            labelnames=("replica",))
        self._c_evac = r.counter(
            "router_evacuations_total",
            "Harvest sweeps over a lost replica's queue (by source)",
            labelnames=("replica",))
        self._c_requeued = r.counter(
            "router_requeued_total",
            "Requests requeued onto a sibling after failover "
            "(by destination)", labelnames=("replica",))
        self._c_lost = r.counter(
            "router_replica_lost_total",
            "Requests failed typed because no sibling could take them")
        self._c_orphaned = r.counter(
            "router_orphaned_total",
            "Foreign evacuated requests failed typed at their source "
            "replica after the orphan TTL expired")
        self._g_backlog = r.gauge(
            "router_queue_depth",
            "Harvested requests held by the router awaiting redispatch")
        self._g_serving = r.gauge(
            "router_replicas_serving",
            "Replicas currently taking traffic (serving health, "
            "breaker closed)")
        self._g_health = r.gauge(
            "router_health",
            "Aggregate router health code: 0 all replicas serving / "
            "1 some down / 3 none (alert on >= 1)")
        handoff = r.counter(
            "router_handoffs_total",
            "Prefill->decode handoffs under disaggregated placement, "
            "by outcome: ok = pages + sampler state committed on a "
            "decode sibling; fallback = staging aborted (frame loss, "
            "no sibling with headroom, target refusal) and the "
            "request kept decoding on the prefill specialist",
            labelnames=("result",))
        self._c_handoff_ok = handoff.labels(result="ok")
        self._c_handoff_fallback = handoff.labels(result="fallback")
        self._h_handoff = r.histogram(
            "serving_handoff_seconds",
            "One prefill->decode handoff end to end: pump start "
            "through pipelined page frames to commit on the decode "
            "target", buckets=TICK_BUCKETS)
        self._g_role = r.gauge(
            "router_replica_role",
            "Replica placement role: 0 hybrid / 1 prefill / 2 decode",
            labelnames=("replica",))

    def on_routed(self, replica, affinity_hit):
        if not self.enabled:
            return
        self._c_routed.labels(replica=str(replica)).inc()
        if affinity_hit:
            self._c_affinity.inc()
        else:
            self._c_fallback.inc()

    def on_dispatch_retry(self, replica):
        if self.enabled:
            self._c_retry.labels(replica=str(replica)).inc()

    def on_evacuation(self, replica):
        if self.enabled:
            self._c_evac.labels(replica=str(replica)).inc()

    def on_requeued(self, replica):
        if self.enabled:
            self._c_requeued.labels(replica=str(replica)).inc()

    def on_replica_lost(self):
        if self.enabled:
            self._c_lost.inc()

    def on_orphaned(self):
        if self.enabled:
            self._c_orphaned.inc()

    def set_backlog(self, n):
        if self.enabled:
            self._g_backlog.set(n)

    def set_serving(self, n):
        if self.enabled:
            self._g_serving.set(n)

    def set_health(self, state):
        if not self.enabled:
            return
        from ..reliability.health import HEALTH_CODES
        self._g_health.set(HEALTH_CODES[state])

    def handoff_started(self):
        """Clock read for ``on_handoff``'s latency observation — only
        taken when a handoff pump actually starts."""
        return self.clock.now() if self.enabled else None

    def on_handoff(self, result, started=None):
        """One prefill->decode handoff settled: ``result`` is ``"ok"``
        (committed on the decode target) or ``"fallback"`` (the
        request stayed on the prefill specialist); latency observed
        from ``started`` = ``handoff_started()``."""
        if not self.enabled:
            return
        (self._c_handoff_ok if result == "ok"
         else self._c_handoff_fallback).inc()
        if started is not None:
            self._h_handoff.observe(self.clock.now() - started)

    def set_replica_role(self, replica, role):
        """Publish a replica's placement role (coded: hybrid 0 /
        prefill 1 / decode 2 — unknown values read as hybrid)."""
        if self.enabled:
            code = {"prefill": 1, "decode": 2}.get(role, 0)
            self._g_role.labels(replica=str(replica)).set(code)
