"""Multi-replica front door: cache-aware routing, failover, live page
migration, disaggregated placement and rolling restarts.

Copied from ``paddle_tpu/inference/router.py`` (host-side, no framework
code): the router only touches the public server surface, so it routes
the port's ``ContinuousBatchingServer`` replicas exactly as it routes
the JAX package's (and any mix of the two).

Routing. Each replica exports a cheap host-side SKETCH of its
radix-tree contents (``PrefixCache.sketch()`` — rolling page-key
fingerprints, no device reads). ``submit()`` routes a prompt to the
replica whose sketch covers its longest page-aligned prefix
(``prefix_fingerprints``): KV reuse only helps if same-prefix traffic
lands on the same pool. Ties (and sketch misses) fall back to
least-loaded by the replicas' queue depth, in-flight slots and
preemption pressure. ``policy="round_robin"`` is the affinity-blind
baseline.

Robustness. A ``RouterSupervisor`` (per-replica ``CircuitBreaker`` +
``RetryPolicy`` backoff + the shared ``is_serving_state`` verdict)
watches each replica's health: when one goes ``draining`` or ``dead``
its queued requests are harvested via
``ContinuousBatchingServer.evacuate()`` and requeued onto siblings —
bit-exact, because the harvested entries carry their RESOLVED sampling
seeds — while a dead replica's mid-decode slots flush their partial
tokens to waiters exactly as ``stop(drain=False)`` does (mid-decode
work is not replayable without double-streaming). A draining replica's
mid-decode requests move LIVE instead: ``migrate_out`` on the source,
``migrate_in`` on a sibling, the KV pages and the sampler state
carried over, zero re-prefill. A harvested request no sibling can take
RIGHT NOW (backpressure, every candidate transiently down) is HELD at
the router — the ``router_queue_depth`` backlog, retried every poll —
and fails with typed ``ReplicaLostError`` only when the whole fleet is
down. Per-replica circuit breakers divert traffic from a flapping
replica after consecutive dispatch failures, and ``rolling_restart()``
bounces the fleet one replica at a time with zero failed requests.
Request-level outcomes (deadline expiry, cancellation, a poisoned
stream, a replica's own breaker opening) pass through to the client
unchanged — the router makes replica LOSS transparent, not request
failure.

Placement. ``placement="disaggregated"`` routes long prompts to
``role="prefill"`` specialists and hands their finished prompt pages to
decode replicas through a pipelined handoff pump (``_run_handoff``, a
thread of its own a request): partial page batches stream while the
specialist still prefills, and the closing pull commits the request on
the target (``inference.placement`` holds the policy).

Deadlines hold end to end: ``submit(deadline_s=...)`` fixes an ABSOLUTE
deadline at the router; every (re)dispatch passes the REMAINING budget
to the replica, so time spent queued at the router — or stranded on a
dead replica — is charged against it.

Chaos: ``fault_injector`` arms ``router.dispatch`` (one replica submit
attempt; fires fall through to the next candidate and feed that
replica's breaker) and ``router.evacuate`` (a harvest sweep; fires
abort the sweep — requests stay put and the next supervisor poll
retries).

The surface the router reads (``submit`` / ``wait`` / ``cancel`` /
``evacuate`` / ``health`` / ``queue_depth`` / ``in_flight`` /
``preempt_pressure`` / ``prefix_sketch`` / ``migrate_*`` / ``abandon``
/ ``stop`` / ``start``) is all a replica needs; a replica without an
in-process registry may offer ``registry_snapshot()`` instead, which
the fleet fold reads (the process replicas behind the wire, ROADMAP
Queue 1 item 9, drop in through it).
"""
import threading
import time

import numpy as np

from ..reliability import (CircuitBreaker, DEAD, DEGRADED, DeadlineExceeded,
                           HEALTHY, MigrationError, QueueFullError,
                           ReliabilityError, ReplicaLostError,
                           RequestCancelled, RetryPolicy, ServerClosed,
                           faults, is_serving_state)
from ..telemetry.clock import MonotonicClock
from . import placement as _placement
from .prefix_cache import prefix_fingerprints

__all__ = ["ReplicaRouter", "RouterSupervisor"]


def _host_ids(input_ids):
    """A prompt as a host numpy array (a torch tensor is copied off its
    device; anything array-like goes through ``np.asarray``)."""
    if hasattr(input_ids, "detach"):
        input_ids = input_ids.detach().cpu().numpy()
    return np.asarray(input_ids)


class _RouterRequest:
    """Everything needed to (re)dispatch one request to any replica."""

    __slots__ = ("rid", "ids", "budget", "seed", "on_token", "deadline",
                 "priority", "cancelled", "journey")

    def __init__(self, rid, ids, budget, seed, on_token, deadline,
                 priority=0, journey=None):
        self.rid = rid
        self.ids = ids
        self.budget = budget
        self.seed = seed              # RESOLVED at router submit: a
        self.on_token = on_token      # requeued sibling draws the
        self.deadline = deadline      # identical sampling chain
        self.priority = priority      # preemption class (optimistic
        self.cancelled = False        # admission), travels on requeue
        self.journey = journey        # fleet trace handle ("router"
        #                               hop); rebound per dispatch so
        #                               replica events carry their own
        #                               location label


class _Route:
    """Where a router rid currently lives. ``gen`` bumps on every
    requeue so a ``wait()`` blocked on the OLD replica can tell a stale
    error from a real one."""

    __slots__ = ("idx", "rrid", "gen", "item")

    def __init__(self, idx, rrid, gen, item):
        self.idx = idx
        self.rrid = rrid
        self.gen = gen
        self.item = item


class RouterSupervisor:
    """Health watcher + failover driver for one ``ReplicaRouter``.

    Built from the existing reliability primitives: the shared
    ``is_serving_state`` verdict decides who takes traffic, per-replica
    ``CircuitBreaker``s (owned by the router) divert flapping replicas,
    and a ``RetryPolicy`` backs off the supervisor thread after a
    failed failover sweep (an injected ``router.evacuate`` fault keeps
    the requests ON the replica; a sibling fleet too full to absorb
    the harvest keeps them in the ROUTER's backlog — both retry here).

    ``poll()`` is ONE deterministic sweep — evacuations first, then a
    retry pass over the router-held backlog. Single-threaded tests
    call it directly; ``ReplicaRouter.start()`` runs it on a
    background thread. It never raises: per-replica failover errors
    are counted (``failed_sweeps``, ``last_error``) and retried on the
    next poll.
    """

    def __init__(self, router, retry=None):
        self._router = router
        self.retry = retry if retry is not None else RetryPolicy()
        n = len(router.replicas)
        self.last_states = [None] * n   # last health seen per replica
        self.failed_sweeps = 0
        self.last_error = None

    def poll(self):
        """One watch sweep: evacuate + requeue every non-serving
        replica that still holds work. Returns the number of failover
        attempts that FAILED this sweep (0 = converged)."""
        r = self._router
        errors = 0
        for idx, rep in enumerate(r.replicas):
            state = rep.health
            prev, self.last_states[idx] = self.last_states[idx], state
            if state != prev and r._rec is not None:
                r._rec.record("replica_health", replica=idx,
                              state=state)
                if state == DEAD and prev != DEAD:
                    # a replica just died under the router: capture the
                    # fleet-level postmortem BEFORE the evacuation
                    # sweep tears its queue apart
                    r._capture_postmortem(f"replica {idx} dead",
                                          replica=idx)
            if is_serving_state(state):
                continue
            dead = state == DEAD
            # cheap pre-check so an idle dead/draining replica costs a
            # few lock-free reads per poll, not an evacuation sweep. A
            # dead replica still holding in-flight slots OR parked
            # preempted requests must be swept: both carry partials
            # their waiters are owed (flush_partials covers them)
            if rep.queue_depth() == 0 \
                    and not (dead and (rep.in_flight() > 0
                                       or rep.preempt_pressure() > 0)):
                continue
            try:
                r._failover(idx, flush_partials=dead)
            except Exception as e:    # injected router.evacuate fault:
                errors += 1           # the requests stay put on the
                self.last_error = e   # replica; retry next poll
        r._drain_backlog()            # router-held requests (sibling
        if errors:                    # backpressure) retry every sweep
            self.failed_sweeps += 1
        r._publish_health()
        return errors


class ReplicaRouter:
    """Cache-aware, failure-tolerant front door over N
    ``ContinuousBatchingServer`` replicas.

    >>> reps = [ContinuousBatchingServer(model, cache_backend="paged",
    ...                                  ...) for _ in range(3)]
    >>> router = ReplicaRouter(reps).start()       # starts replicas +
    >>> rid = router.submit(prompt, max_new_tokens=32)   # supervisor
    >>> tokens = router.wait(rid)
    >>> router.rolling_restart()                   # zero failed requests
    >>> router.stop()

    ``policy``: ``"affinity"`` (default — longest cached prefix wins,
    least-loaded fallback), ``"least_loaded"``, or ``"round_robin"``
    (the affinity-blind bench baseline). ``pressure_weight`` (default
    2.0) scales how strongly a replica's ``preempt_pressure()`` counts
    against it in the least-loaded score relative to one queued or
    in-flight request — raise it to divert traffic from a thrashing
    pool sooner, set 0 to ignore preemption pressure entirely.

    ``telemetry`` (``telemetry.RouterTelemetry``, or ``True`` for a
    default one) publishes per-replica routed/affinity/requeue
    counters, the router backlog gauge, and the aggregate
    ``router_health`` gauge; ``serving.serve_metrics(router)`` fronts
    the fleet with one ``/healthz`` (200 iff >= 1 replica is serving).

    ``journeys`` (``telemetry.JourneyRecorder``, or ``True``) turns on
    request-journey tracing: ``submit()`` mints a fleet trace id,
    every hop appends phase events, ``journey(rid)`` returns the
    cross-replica timeline (also ``/debug/journey/<rid>``), and
    ``export_fleet_trace(path)`` writes one merged Perfetto trace with
    flow events connecting a request's hops. ``recorder``
    (``telemetry.FlightRecorder``, or ``True``) records router-level
    events (evacuations, requeues, replica health flips) and captures
    fleet postmortems on replica death; ``postmortems()`` merges them
    with every replica's bundles (``/debug/postmortem``). Disabled
    recorders are treated exactly like None — zero cost.

    ``slos`` (a list of ``telemetry.SLO`` declarations, or a pre-built
    ``SLOEngine``) arms fleet SLO alerting over the MERGED metrics:
    ``fleet_snapshot()`` folds every replica's registry into one
    snapshot (``fleet_metrics()`` renders it as the ``/fleet``
    Prometheus page), and ``slo_report()`` computes multi-window
    rolling burn rates with ok/warning/page alert states — served on
    ``/slo`` and folded into the aggregated ``/healthz`` detail by
    ``serve_metrics(router)``.

    Clocks: deadline math spans router and replicas, so construct the
    replicas with the SAME clock as the router when injecting a
    ``FakeClock`` (real ``MonotonicClock``s already share a time base).

    All traffic must flow through the router: it requeues only requests
    it routed itself (foreign rids found in an evacuated queue are
    dropped back to their own waiters' timeout).
    """

    def __init__(self, replicas, policy="affinity", seed=0,
                 telemetry=None, journeys=None, recorder=None,
                 slos=None, clock=None, fault_injector=None,
                 breakers=None, retry_policy=None, wait_slice=0.05,
                 pressure_weight=2.0, placement=None,
                 disagg_prefill_min_tokens=256,
                 disagg_handoff_at="first_token"):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if policy not in ("affinity", "least_loaded", "round_robin"):
            raise ValueError(f"policy must be 'affinity', 'least_loaded'"
                             f" or 'round_robin', got {policy!r}")
        if pressure_weight < 0:
            raise ValueError(f"pressure_weight must be >= 0, got "
                             f"{pressure_weight}")
        # disaggregated prefill/decode placement: None (the
        # default) keeps the legacy load/affinity routing byte-for-byte;
        # "disaggregated" routes fresh prompts by PHASE — long prompts
        # to prefill specialists (then a pipelined page handoff to a
        # decode replica), short prompts decode-local
        self.placement = _placement.normalize_placement(placement)
        if disagg_handoff_at not in ("first_token", "eager"):
            raise ValueError(
                f"disagg_handoff_at must be 'first_token' (source "
                f"samples token 0, zero re-prefill on the target) or "
                f"'eager' (hand off mid-prefill, target finishes the "
                f"remainder), got {disagg_handoff_at!r}")
        self.disagg_prefill_min_tokens = int(disagg_prefill_min_tokens)
        self.disagg_handoff_at = disagg_handoff_at
        self.replicas = list(replicas)
        self.policy = policy
        self.pressure_weight = float(pressure_weight)
        self._seed = int(seed)
        if telemetry is True:
            from ..telemetry import RouterTelemetry
            telemetry = RouterTelemetry(clock=clock)
        self.telemetry = telemetry
        self._tele = telemetry if (telemetry is not None
                                   and telemetry.enabled) else None
        self._clock = clock if clock is not None else (
            telemetry.clock if self._tele is not None else MonotonicClock())
        # request-journey tracing (telemetry.JourneyRecorder): the
        # router MINTS the fleet trace id at submit and rebinds the
        # handle per dispatch; a disabled recorder is treated exactly
        # like None (requests carry no handle — zero cost)
        if journeys is True:
            from ..telemetry import JourneyRecorder
            journeys = JourneyRecorder(clock=self._clock)
        self.journeys = journeys
        self._jrec = journeys if (journeys is not None
                                  and journeys.enabled) else None
        # flight recorder for ROUTER-level events (evacuations,
        # requeues, replica health flips, fleet postmortems); replicas
        # each carry their own
        if recorder is True:
            from ..telemetry import FlightRecorder
            recorder = FlightRecorder(clock=self._clock)
        self.recorder = recorder
        self._rec = recorder if (recorder is not None
                                 and recorder.enabled) else None
        # fleet SLOs (telemetry.slo): a list of SLO declarations builds
        # an SLOEngine over this router's fleet-merged snapshot (burn
        # metrics ride the router registry when telemetry is on); a
        # pre-built engine is bound to the fleet source if it has none.
        # A disabled engine is treated exactly like None — zero clock
        # reads, zero locks, the source is never called.
        if slos is not None and not hasattr(slos, "evaluate"):
            from ..telemetry.slo import SLOEngine
            slos = SLOEngine(
                slos, self.fleet_snapshot, clock=self._clock,
                registry=self._tele.registry
                if self._tele is not None else None)
        elif slos is not None and slos.source is None:
            slos.bind(self.fleet_snapshot)
        self.slo_engine = slos
        self._slo = slos if (slos is not None
                             and slos.enabled) else None
        self._faults = fault_injector
        if self._faults is not None:
            if self._tele is not None \
                    and hasattr(self._faults, "publish_to"):
                self._faults.publish_to(self._tele.registry)
            if self._rec is not None \
                    and getattr(self._faults, "recorder", None) is None:
                self._faults.recorder = self._rec
        n = len(self.replicas)
        if breakers is None:
            breakers = [CircuitBreaker(failure_threshold=3,
                                       reset_after_s=5.0,
                                       clock=self._clock)
                        for _ in range(n)]
        if len(breakers) != n:
            raise ValueError(f"need one breaker per replica "
                             f"({n}), got {len(breakers)}")
        self._breakers = list(breakers)
        self._wait_slice = float(wait_slice)
        self._lock = threading.RLock()
        self._routes = {}                    # rid -> _Route
        self._by_replica = [dict() for _ in range(n)]   # rrid -> rid
        self._failures = {}                  # rid -> ReliabilityError
        self._backlog = []                   # rids held at the router:
        #   harvested requests no sibling could take YET (backpressure,
        #   or every candidate transiently down) — retried every poll
        self._orphans = {}                   # (idx, rrid) -> ttl: rids
        #   harvested from a replica BEFORE the dispatching thread
        #   could record the route (the replica died inside that gap);
        #   the recorder claims the entry and re-places instead of
        #   routing to a corpse. Unclaimed entries (true foreign
        #   traffic) age out after a few polls.
        self._next_rid = 0
        self._rr = 0                         # round-robin cursor
        self._stats = {"routed": [0] * n, "affinity_hits": 0,
                       "fallbacks": 0, "dispatch_retries": 0,
                       "evacuations": 0, "requeued": 0,
                       "replica_lost": 0, "orphaned": 0, "restarts": 0,
                       # live KV-page migrations: mid-decode requests
                       # handed to a sibling WITH their pages / attempts
                       # degraded to the evacuate+replay path
                       "migrations": 0, "migration_fallbacks": 0,
                       # disaggregated prefill handoffs: prompts a
                       # prefill specialist shipped to a decode replica
                       # / pump attempts degraded to local decode on
                       # the specialist (never a request failure)
                       "handoffs": 0, "handoff_fallbacks": 0}
        self._pumping = set()          # rids with a live handoff pump
        self.supervisor = RouterSupervisor(self, retry=retry_policy)
        self._stop_evt = threading.Event()
        self._thread = None

    # ------------------------------------------------------------ client
    def submit(self, input_ids, max_new_tokens=32, seed=None,
               on_token=None, deadline_s=None, priority=0):
        """Route one prompt to the best replica; returns a ROUTER
        request id (collect with ``wait``). ``deadline_s`` fixes an
        absolute deadline NOW — any time the request later spends
        queued at the router (failover requeue) or on a replica is
        charged against it. ``priority`` is the preemption class
        (replicas running ``admission="optimistic"``); it travels with
        the request across failover requeues. Raises
        ``QueueFullError`` when every serving replica shed it
        (resubmit with backoff) and ``ReplicaLostError`` when no
        replica is serving at all."""
        ids = _host_ids(input_ids).astype(np.int32)
        if ids.ndim == 2:
            if ids.shape[0] != 1:
                raise ValueError("submit() takes one request; batch by "
                                 "calling submit() per row")
            ids = ids[0]
        if deadline_s is not None and deadline_s <= 0:
            raise DeadlineExceeded(
                f"deadline_s={deadline_s} is already expired")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            if seed is None:
                # resolve NOW: a replica-assigned default seed would
                # change on requeue and break sampled-token parity
                seed = self._seed + rid
        deadline = None if deadline_s is None \
            else self._clock.now() + float(deadline_s)
        journey = None
        if self._jrec is not None:
            # the fleet trace id: one per ROUTER rid, minted here —
            # every later hop (dispatch, admission, preempt/replay,
            # evacuation, requeue, completion) appends to this timeline
            journey = self._jrec.begin(f"r{rid}", where="router")
            journey.event("submitted", rid=rid,
                          prompt_tokens=int(ids.shape[0]),
                          priority=int(priority))
        item = _RouterRequest(rid, ids, int(max_new_tokens), int(seed),
                              on_token, deadline, int(priority), journey)
        self._place(item, exclude=())
        return rid

    def wait(self, rid, timeout=120.0):
        """Block until ``rid`` finishes ANYWHERE in the fleet; returns
        its new tokens (possibly a partial, if its replica died
        mid-decode). Follows the request across failover requeues;
        typed ``ReliabilityError``s are raised directly."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while True:
            with self._lock:
                if rid in self._failures:
                    self._routes.pop(rid, None)
                    raise self._failures.pop(rid)
                route = self._routes.get(rid)
                if route is None:
                    raise KeyError(f"unknown request id {rid} (never "
                                   f"submitted, or already collected)")
                idx, rrid, gen = route.idx, route.rrid, route.gen
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"request {rid} not finished in {timeout}s")
            try:
                out = self.replicas[idx].wait(
                    rrid, timeout=min(remaining, self._wait_slice))
            except ReliabilityError:
                # matched BEFORE TimeoutError: DeadlineExceeded
                # subclasses both, and it is a terminal typed outcome
                # — the old clause order swallowed it as a
                # not-finished-yet poll and the waiter span until its
                # own timeout, surfacing untyped. The
                # stale-gen re-check below still absorbs errors from
                # a replica the request already left.
                with self._lock:
                    cur = self._routes.get(rid)
                    if cur is not None and cur.gen != gen:
                        continue      # requeued mid-wait; stale error
                    if rid in self._failures:
                        self._routes.pop(rid, None)
                        raise self._failures.pop(rid)
                    self._routes.pop(rid, None)
                    self._by_replica[idx].pop(rrid, None)
                raise
            except TimeoutError:
                continue              # re-read the route: it may have
            #                           moved to a sibling meanwhile
            except RuntimeError as e:
                # a DEAD SERVE THREAD raises a generic RuntimeError for
                # every waiter WITHOUT consuming any per-rid state —
                # the request is still queued/in-flight on the corpse
                # and the supervisor's next poll will harvest it; keep
                # waiting instead of leaking a raw thread death to the
                # client. (ReliabilityError subclasses RuntimeError, so
                # typed per-rid failures were already handled above.)
                # Identified by __cause__ IDENTITY with the replica's
                # recorded thread error: a wrapped per-request
                # admission failure also arrives as RuntimeError but
                # DID consume the rid's state — that one must re-raise,
                # even when the thread has also died.
                with self._lock:
                    cur = self._routes.get(rid)
                    if cur is not None and cur.gen != gen:
                        continue
                    if rid in self._failures:
                        self._routes.pop(rid, None)
                        raise self._failures.pop(rid)
                rep = self.replicas[idx]
                if rep._thread_error is not None \
                        and e.__cause__ is rep._thread_error \
                        and not is_serving_state(rep.health):
                    # failover pending; stay blocked (the corpse's
                    # wait() raises instantly, so pace the loop)
                    _time.sleep(min(self._wait_slice, 0.01))
                    continue
                with self._lock:
                    self._routes.pop(rid, None)
                    self._by_replica[idx].pop(rrid, None)
                raise
            else:
                with self._lock:
                    route = self._routes.pop(rid, None)
                    self._by_replica[idx].pop(rrid, None)
                if route is not None and route.item.journey is not None:
                    route.item.journey.event("collected",
                                             tokens=len(out))
                return out

    def cancel(self, rid):
        """Best-effort cancel wherever the request currently lives.
        A request mid-failover (harvested, not yet requeued) is failed
        with ``RequestCancelled`` instead of being requeued."""
        with self._lock:
            route = self._routes.get(rid)
            if route is None:
                return False
            route.item.cancelled = True
            idx, rrid = route.idx, route.rrid
        return self.replicas[idx].cancel(rrid)

    # ----------------------------------------------------------- routing
    def _candidates(self, ids, exclude=(), phase=None):
        """(ordered replica indices to try, {idx: affinity tokens}).
        Serving replicas only (health + closed breaker), best first.
        Under ``placement="disaggregated"`` a ``phase`` rewrites the
        order: prefill work prefers prefill specialists (any serving
        replica as the degradation tail), decode work avoids them
        while anything else serves."""
        if self._tele is not None:
            # gauge from the UNFILTERED health scan (matches .health):
            # a requeue's source exclusion must not read as a capacity
            # dip on dashboards
            self._tele.set_serving(sum(
                1 for rep in self.replicas
                if is_serving_state(rep.health)))
        serving = [idx for idx, rep in enumerate(self.replicas)
                   if idx not in exclude
                   and is_serving_state(rep.health)
                   and self._breakers[idx].would_allow()]
        aff = {idx: 0 for idx in serving}
        if not serving:
            return [], aff
        if self.policy == "round_robin":
            with self._lock:
                k = self._rr % len(serving)
                self._rr += 1
            order = serving[k:] + serving[:k]
            if self.placement is not None and phase is not None:
                order = _placement.order_for_phase(
                    order, self.replicas, phase)
            return order, aff
        # preemption pressure joins the load score, weighted ABOVE
        # plain queue depth (``pressure_weight``, default 2.0): a
        # replica thrashing its KV pool (parked preempted requests it
        # must replay) is slower for EVERY resident request, so the
        # fleet sheds new load away from it until the backlog drains —
        # a higher weight diverts sooner, 0 ignores pressure entirely.
        # Lock-free reads, like the rest.
        w = self.pressure_weight
        load = {idx: (self.replicas[idx].queue_depth()
                      + self.replicas[idx].in_flight()
                      + w * self.replicas[idx].preempt_pressure())
                for idx in serving}
        if self.policy == "affinity":
            fps_by_pg = {}
            for idx in serving:
                pg = self.replicas[idx].page_size
                if not pg:
                    continue          # dense backend: nothing to be
                if pg not in fps_by_pg:                 # affine to
                    fps_by_pg[pg] = prefix_fingerprints(
                        ids, pg, max_tokens=ids.shape[0] - 1)
                sketch = self.replicas[idx].prefix_sketch()
                k = 0
                for fp in fps_by_pg[pg]:
                    if fp not in sketch:
                        break
                    k += 1
                aff[idx] = k * pg
            order = sorted(serving,
                           key=lambda i: (-aff[i], load[i], i))
        else:                         # least_loaded
            order = sorted(serving, key=lambda i: (load[i], i))
        if self.placement is not None and phase is not None:
            order = _placement.order_for_phase(order, self.replicas,
                                               phase)
        return order, aff

    def _dispatch(self, idx, item):
        """One replica submit attempt (the ``router.dispatch`` chaos
        point); returns the REPLICA rid. Charges elapsed time against
        the request's absolute deadline."""
        if item.journey is not None:
            # every ATTEMPT is a journey phase (where="router"): a
            # chaos-failed dispatch shows as this event followed by the
            # next candidate's, so flapping reads straight off the
            # timeline
            item.journey.event("dispatched", replica=idx)
        if self._faults is not None:
            self._faults.check(faults.ROUTER_DISPATCH, rid=item.rid,
                               replica=idx)
        deadline_s = None
        if item.deadline is not None:
            deadline_s = item.deadline - self._clock.now()
            if deadline_s <= 0:
                raise DeadlineExceeded(
                    f"request {item.rid} expired before it could be "
                    f"dispatched to a replica")
        journey = None if item.journey is None \
            else item.journey.at(f"replica{idx}")
        return self.replicas[idx].submit(
            item.ids, max_new_tokens=item.budget, seed=item.seed,
            on_token=item.on_token, deadline_s=deadline_s,
            priority=item.priority, journey=journey)

    def _place(self, item, exclude=()):
        """Dispatch ``item`` to the best willing replica; record the
        route. Raises typed when nobody takes it: ``QueueFullError``
        if every serving replica shed, ``DeadlineExceeded`` if the
        deadline ran out first, else ``ReplicaLostError``."""
        phase = None
        if self.placement is not None:
            phase = _placement.request_phase(
                item.ids, self.disagg_prefill_min_tokens)
        for _rescan in range(4):      # orphan claims force a fresh
            order, aff = self._candidates(item.ids, exclude,    # scan
                                          phase=phase)
            last_err = None
            rescan = False
            for idx in order:
                if not self._breakers[idx].allow():
                    continue   # opened since the candidate scan; the
                try:           # mutating open->half_open probe gate
                    rrid = self._dispatch(idx, item)   # happens HERE
                except DeadlineExceeded:
                    # total expiry: siblings can't help. If allow()
                    # handed us a half-open probe token, return it
                    # UNRESOLVED — the replica was never touched, and
                    # keeping the token would wedge the breaker
                    # half-open with no probe outcome ever recorded
                    self._breakers[idx].release_probe()
                    raise
                except (QueueFullError, ServerClosed) as e:
                    # replica-level shed / drain race: divert, don't
                    # trip the breaker — healthy, just unwilling (and a
                    # shed is no probe VERDICT either: hand a half-open
                    # token back so another attempt may probe)
                    self._breakers[idx].release_probe()
                    last_err = e
                    self._note_retry(idx)
                    continue
                except Exception as e:
                    # dispatch fault / unexpected submit error: this is
                    # what "flapping" looks like from the router — feed
                    # the replica's breaker
                    last_err = e
                    self._breakers[idx].record_failure()
                    self._note_retry(idx)
                    continue
                self._breakers[idx].record_success()
                hit = aff.get(idx, 0) > 0
                with self._lock:
                    if self._orphans.pop((idx, rrid), None) is not None:
                        # the replica accepted this request and died —
                        # and the supervisor already harvested it —
                        # before we could record the route. The request
                        # exists NOWHERE now; recording would point a
                        # waiter at a corpse forever. Start over with a
                        # FRESH candidate scan (the fleet just changed
                        # under us — the stale tail of this order is
                        # not the full picture).
                        rescan = True
                    else:
                        prev = self._routes.get(item.rid)
                        gen = 0 if prev is None else prev.gen + 1
                        self._routes[item.rid] = _Route(idx, rrid, gen,
                                                        item)
                        self._by_replica[idx][rrid] = item.rid
                        self._stats["routed"][idx] += 1
                        if hit:
                            self._stats["affinity_hits"] += 1
                        else:
                            self._stats["fallbacks"] += 1
                if rescan:
                    break
                if self._tele is not None:
                    self._tele.on_routed(idx, hit)
                if (phase == "prefill" and not item.cancelled
                        and _placement.replica_role(
                            self.replicas[idx]) == "prefill"):
                    # a long prompt landed on a prefill specialist:
                    # start the pipelined handoff pump that streams
                    # its pages to a decode sibling as chunks complete
                    self._spawn_handoff(item.rid, idx)
                return idx
            if rescan:
                continue              # re-scan (bounded: each retry
            break                     # needs ANOTHER mid-gap death)
        if isinstance(last_err, QueueFullError):
            raise last_err            # backpressure, not loss: resubmit
        err = ReplicaLostError(
            f"request {item.rid}: no serving replica could take it "
            f"({len(self.replicas)} replicas total)")
        err.__cause__ = last_err
        raise err

    def _note_retry(self, idx):
        with self._lock:
            self._stats["dispatch_retries"] += 1
        if self._tele is not None:
            self._tele.on_dispatch_retry(idx)

    # ----------------------------------------------------- live migration
    def _migrate_live(self, idx):
        """Hand replica ``idx``'s mid-decode requests to siblings WITH
        their KV pages: each migrated request resumes
        exactly where it paused — zero re-prefill, zero token replay,
        zero partial flush. Best-effort per request: any failure (not
        migratable, page frames lost to the wire, no sibling with
        capacity, target refusal) leaves the request decoding on the
        source for the legacy drain/evacuate path and counts a
        fallback — never a request failure. Returns the number
        migrated."""
        rep = self.replicas[idx]
        if not (hasattr(rep, "migrate_out")
                and hasattr(rep, "migrate_in")):
            return 0
        with self._lock:
            pairs = list(self._by_replica[idx].items())  # rrid -> rid
        moved = 0
        for rrid, rid in pairs:
            with self._lock:
                route = self._routes.get(rid)
            if route is None or route.idx != idx \
                    or route.item.cancelled:
                continue
            item = route.item
            try:
                state, payloads = rep.migrate_out(rrid)
            except MigrationError:
                continue    # not mid-decode here (queued, finishing):
                #             nothing to migrate — evacuate covers it
            except Exception:
                continue    # wire down / injected gather fault: the
                #             slot was never paused (or already
                #             resumed); the drain path takes over
            new_rrid = None
            tdx = None
            order, _ = self._candidates(item.ids, exclude=(idx,),
                                        phase="decode")
            for cand in order:
                target = self.replicas[cand]
                if not hasattr(target, "migrate_in"):
                    continue
                journey = None if item.journey is None \
                    else item.journey.at(f"replica{cand}")
                try:
                    new_rrid = target.migrate_in(
                        state, payloads, on_token=item.on_token,
                        journey=journey)
                except Exception:
                    continue    # OutOfPages / restore fault / refusal:
                    #             try the next sibling
                tdx = cand
                break
            if new_rrid is None:
                rep.migrate_abort(rrid)   # resume decoding at home
                with self._lock:
                    self._stats["migration_fallbacks"] += 1
                if item.journey is not None:
                    item.journey.event("migrating", at="router",
                                       source=idx, fallback=True)
                continue
            # COMMIT: the request lives on the target now. Re-home the
            # route FIRST (a waiter blocked on the source re-reads it
            # within one wait slice; the gen bump marks stale errors),
            # THEN release the source slot — so no window exists where
            # a waiter can race a released rid.
            with self._lock:
                self._by_replica[idx].pop(rrid, None)
                cur = self._routes.get(rid)
                if cur is route:
                    route.idx, route.rrid = tdx, new_rrid
                    route.gen += 1
                self._by_replica[tdx][new_rrid] = rid
                self._stats["migrations"] += 1
            if item.journey is not None:
                item.journey.event("migrating", at="router",
                                   source=idx, target=tdx)
            if self._rec is not None:
                self._rec.record("migration", rid=rid, source=idx,
                                 target=tdx)
            rep.migrate_finish(rrid)
            moved += 1
        return moved

    # ------------------------------------------------ prefill->decode handoff
    def _spawn_handoff(self, rid, idx):
        """Start the pipelined handoff pump for router request ``rid``
        placed on prefill specialist ``idx`` (at most one pump per
        rid)."""
        with self._lock:
            if rid in self._pumping:
                return
            self._pumping.add(rid)
        threading.Thread(target=self._run_handoff, args=(rid, idx),
                         daemon=True, name=f"handoff-r{rid}").start()

    def _open_staging(self, item, frag, src_idx):
        """Pick a decode-handoff target (prefix affinity, then pool
        headroom — ``placement.order_handoff_targets``) and open a
        staged restore on it. Returns ``(tdx, target, handle)`` or
        ``None`` when no sibling can stage right now (the pump falls
        back to the one-shot path, or the request just stays put)."""
        begin_state = {
            "rid": int(item.rid), "ids": np.asarray(item.ids),
            "prompt_len": int(np.asarray(item.ids).shape[0]),
            "budget": int(item.budget), "seed": item.seed,
            "page_size": int(frag["page_size"]), "phase": "prefill",
        }
        order, aff = self._candidates(item.ids, exclude=(src_idx,),
                                      phase="decode")
        order = _placement.order_handoff_targets(order, self.replicas,
                                                 aff)
        for cand in order:
            target = self.replicas[cand]
            if not hasattr(target, "migrate_in_begin"):
                continue
            try:
                handle = target.migrate_in_begin(begin_state)
            except Exception:
                continue    # OutOfPages / role refusal / wire down:
            return cand, target, handle   # the next candidate may stage
        return None

    def _run_handoff(self, rid, src_idx):
        """One pipelined prefill->decode handoff (the tentpole's
        pipelining): poll ``migrate_out(partial=True)`` on the prefill
        specialist and stream each completed chunk's pages to a staged
        decode target while later chunks are still prefilling; when the
        source reaches the cut point (first token sampled for
        ``disagg_handoff_at="first_token"``, first shipped batch for
        ``"eager"``) pull the closing state + unshipped tail pages with
        ``migrate_out(from_page=k)`` and commit. Best-effort
        throughout: any failure aborts the target staging and leaves
        the request running on the specialist (it still decodes
        locally — degraded, never lost), counted as a
        ``handoff_fallback``."""
        rep = self.replicas[src_idx]
        t0 = self._tele.handoff_started() if self._tele is not None \
            else None
        tdx = target = handle = None
        delivered = set()   # absolute page indices confirmed on target
        attempted = False   # staged or paused: a failure is a FALLBACK
        try:
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                with self._lock:
                    route = self._routes.get(rid)
                if route is None or route.idx != src_idx \
                        or route.item.cancelled:
                    return          # finished / evacuated / cancelled:
                item = route.item   # nothing to hand off (not a
                rrid = route.rrid   # fallback — the request is fine)
                try:
                    frag, payloads = rep.migrate_out(rrid, partial=True)
                except MigrationError:
                    time.sleep(0.002)   # queued, not admitted yet, or
                    continue            # mid-activation: poll again
                except Exception:
                    break               # wire down: fall back
                if str(frag.get("phase")) != "prefill":
                    break   # first token sampled at the source — cut
                if payloads:
                    if handle is None:
                        staged = self._open_staging(item, frag, src_idx)
                        if staged is None:
                            break   # nobody can stage: one-shot below
                        tdx, target, handle = staged
                        attempted = True
                    if not self._pump_frames(target, handle, frag,
                                             payloads, delivered):
                        # target rejected frames (sha, staging died):
                        # drop it and retry one-shot on the tail pull
                        try:
                            target.migrate_in_abort(handle)
                        except Exception:
                            pass
                        tdx = target = handle = None
                        delivered.clear()
                        break
                    if self.disagg_handoff_at == "eager":
                        break   # hand off mid-prefill: the target
                        #         finishes the remaining chunks
                time.sleep(0.002)
            else:
                if attempted:   # timed out mid-pump: pages staged but
                    self._handoff_fallback(rid, src_idx, t0)   # no cut
                return
            # closing pull: k = pages the target PROVABLY holds as a
            # contiguous prefix; everything >= k rides the tail frames
            k = 0
            while k in delivered:
                k += 1
            for _attempt in range(3):
                with self._lock:
                    route = self._routes.get(rid)
                if route is None or route.idx != src_idx \
                        or route.item.cancelled:
                    return
                item, rrid = route.item, route.rrid
                try:
                    state, tail = rep.migrate_out(rrid, from_page=k)
                except MigrationError:
                    return      # finished / replaced at the source
                except Exception:
                    break
                attempted = True
                if any(p is None for p in tail):
                    rep.migrate_abort(rrid)   # chaos ate tail frames:
                    continue                  # resume, re-pull
                journey = None
                new_rrid = None
                try:
                    if handle is not None:
                        journey = None if item.journey is None else \
                            item.journey.at(f"replica{tdx}")
                        new_rrid = target.migrate_in_commit(
                            handle, state, tail,
                            on_token=item.on_token, journey=journey)
                    else:
                        # nothing was pipelined (short prefill beat the
                        # pump, or no stage-capable sibling): one-shot
                        # handoff through the classic migrate_in
                        staged = self._candidates(
                            item.ids, exclude=(src_idx,),
                            phase="decode")
                        order = _placement.order_handoff_targets(
                            staged[0], self.replicas, staged[1])
                        for cand in order:
                            tgt = self.replicas[cand]
                            if not hasattr(tgt, "migrate_in"):
                                continue
                            journey = None if item.journey is None \
                                else item.journey.at(f"replica{cand}")
                            try:
                                new_rrid = tgt.migrate_in(
                                    state, tail,
                                    on_token=item.on_token,
                                    journey=journey)
                            except Exception:
                                continue
                            tdx, target = cand, tgt
                            break
                        if new_rrid is None:
                            rep.migrate_abort(rrid)
                            break
                except MigrationError:
                    rep.migrate_abort(rrid)   # staging drift / missing
                    continue                  # pages: resume, re-pull
                except Exception:
                    rep.migrate_abort(rrid)
                    break
                if new_rrid is None:
                    continue
                handle = None   # committed: nothing left to abort
                # COMMIT - mirrors _migrate_live: re-home the route
                # FIRST so a waiter never races a released source slot
                with self._lock:
                    self._by_replica[src_idx].pop(rrid, None)
                    cur = self._routes.get(rid)
                    if cur is route:
                        route.idx, route.rrid = tdx, new_rrid
                        route.gen += 1
                    self._by_replica[tdx][new_rrid] = rid
                    self._stats["handoffs"] += 1
                if item.journey is not None:
                    item.journey.event("handoff", at="router",
                                       source=src_idx, target=tdx)
                if self._rec is not None:
                    self._rec.record("handoff", rid=rid,
                                     source=src_idx, target=tdx,
                                     pipelined_pages=len(delivered))
                rep.migrate_finish(rrid)
                if self._tele is not None:
                    self._tele.on_handoff("ok", t0)
                return
            # fall through: every closing attempt failed
            if attempted:
                self._handoff_fallback(rid, src_idx, t0)
        finally:
            if handle is not None:      # staging still open: release
                try:                    # the target's placeholder pages
                    target.migrate_in_abort(handle)
                except Exception:
                    pass
            self._pumping.discard(rid)

    def _pump_frames(self, target, handle, frag, payloads, delivered):
        """Forward one partial batch's page frames to the staged
        target, skipping wire-lost holes (``None`` payloads — the
        closing pull re-ships them). Updates ``delivered`` with the
        ABSOLUTE page indices the target acknowledged. False when the
        target refuses the staging (caller drops it)."""
        base0 = int(frag.get("base") or 0)
        shas = frag.get("sha256") or [None] * len(payloads)
        i = 0
        while i < len(payloads):
            if payloads[i] is None:
                i += 1
                continue
            j = i
            while j < len(payloads) and payloads[j] is not None:
                j += 1
            try:
                got = target.migrate_in_pages(
                    handle, base0 + i, payloads[i:j], shas[i:j])
            except Exception:
                return False
            if isinstance(got, int):    # in-process server: a count
                delivered.update(range(base0 + i, base0 + i + got))
            else:                       # remote client: absolute
                delivered.update(int(p) for p in got)   # landed pages
            i = j
        return True

    def _handoff_fallback(self, rid, src_idx, t0):
        with self._lock:
            self._stats["handoff_fallbacks"] += 1
            route = self._routes.get(rid)
        if route is not None and route.item.journey is not None:
            route.item.journey.event("handoff", at="router",
                                     source=src_idx, fallback=True)
        if self._tele is not None:
            self._tele.on_handoff("fallback", t0)

    # ---------------------------------------------------------- failover
    def _failover(self, idx, flush_partials):
        """Harvest replica ``idx``'s queue (the ``router.evacuate``
        chaos point — an injected fault aborts BEFORE any state moves)
        and requeue everything onto siblings. A draining (not dead)
        replica's mid-decode slots are live-migrated first — pages and
        sampler state hand off to a sibling instead of riding out the
        drain on a sick replica; a dead one has no wire to pull pages
        over, so its mirror-synthesized partial flush stands."""
        if self._faults is not None:
            self._faults.check(faults.ROUTER_EVACUATE, replica=idx)
        if not flush_partials:
            self._migrate_live(idx)
        harvested = self.replicas[idx].evacuate(
            flush_partials=flush_partials)
        with self._lock:
            self._stats["evacuations"] += 1
        if self._tele is not None:
            self._tele.on_evacuation(idx)
        if self._rec is not None:
            self._rec.record("evacuation", replica=idx,
                             harvested=len(harvested),
                             flush_partials=bool(flush_partials))
        self._requeue(idx, harvested)

    def _requeue(self, src, harvested):
        """Re-place harvested requests on siblings, oldest first. A
        request nobody can take RIGHT NOW is held at the router (the
        ``router_queue_depth`` backlog, retried every poll) as long as
        the condition looks transient — sibling backpressure, or every
        candidate momentarily down; it fails typed only when the whole
        fleet is dead (``ReplicaLostError``), its deadline ran out
        while stranded (``DeadlineExceeded``), or it was cancelled."""
        for pending in harvested:
            with self._lock:
                rid = self._by_replica[src].pop(pending.rid, None)
                route = self._routes.get(rid) if rid is not None else None
                if route is None:
                    # either true foreign traffic, or a router dispatch
                    # whose route is not recorded YET (the replica died
                    # between accepting the submit and the dispatching
                    # thread re-taking the router lock): park it so the
                    # recorder can claim-and-replace instead of routing
                    # the waiter to a corpse
                    self._orphans[(src, pending.rid)] = 3   # polls to live
                    continue
            if route.item.journey is not None:
                route.item.journey.event("evacuated", source=src)
            self._try_place(rid, route.item, exclude=(src,))
        self._publish_backlog()

    def _try_place(self, rid, item, exclude=()):
        """One requeue attempt for a router-held request; places it,
        holds it in the backlog, or fails it typed (see ``_requeue``)."""
        if item.cancelled:
            self._record_failure(rid, RequestCancelled(
                f"request {rid} cancelled during failover"))
            return
        if item.deadline is not None \
                and self._clock.now() >= item.deadline:
            self._record_failure(rid, DeadlineExceeded(
                f"request {rid} expired while awaiting requeue"))
            return
        try:
            dst = self._place(item, exclude=exclude)
        except (DeadlineExceeded, RequestCancelled) as e:
            self._record_failure(rid, e)
        except QueueFullError:
            # sibling backpressure is TRANSIENT: hold the request at
            # the router and retry next poll — failing it here would
            # turn a seconds-long full queue into a lost request
            with self._lock:
                self._backlog.append(rid)
            if item.journey is not None:
                item.journey.event("held", why="backpressure")
        except ReliabilityError as e:
            if any(is_serving_state(rep.health)
                   for rep in self.replicas):
                # someone is alive but could not take it this sweep
                # (excluded source, drain race, injected dispatch
                # faults on every candidate): transient — hold it
                with self._lock:
                    self._backlog.append(rid)
                if item.journey is not None:
                    item.journey.event("held", why="no_candidate")
                return
            err = e if isinstance(e, ReplicaLostError) else \
                ReplicaLostError(
                    f"request {rid}: its replica was lost and no "
                    f"sibling could take the requeue")
            if err is not e:
                err.__cause__ = e
            with self._lock:
                self._stats["replica_lost"] += 1
            if self._tele is not None:
                self._tele.on_replica_lost()
            if self._rec is not None:
                self._rec.record("replica_lost", rid=rid)
                # the whole fleet is down and a request just died with
                # it: freeze the routing state for the incident review
                self._capture_postmortem("replica_lost", rid=rid)
            self._record_failure(rid, err)
        else:
            with self._lock:
                self._stats["requeued"] += 1
            if self._tele is not None:
                self._tele.on_requeued(dst)
            if self._rec is not None:
                self._rec.record("requeued", rid=rid, replica=dst)

    def _drain_backlog(self):
        """Retry every router-held request (called once per supervisor
        poll). No source exclusion here: a restarted replica may take
        its old work back. Orphan entries that aged out without a
        route claiming them are TRUE FOREIGN traffic (submitted
        straight to the replica, not through this router): their
        waiters block on the source replica, so fail them THERE, typed
        and promptly, instead of letting them run out their own
        timeouts."""
        with self._lock:
            backlog, self._backlog = self._backlog, []
            expired = [k for k, ttl in self._orphans.items() if ttl <= 1]
            self._orphans = {k: ttl - 1
                             for k, ttl in self._orphans.items()
                             if ttl > 1}
        for src, rrid in expired:
            err = ReplicaLostError(
                f"request {rrid} was evacuated off replica {src} but "
                f"belongs to no route of this router (foreign traffic "
                f"submitted directly to the replica?) — it cannot be "
                f"requeued, submit through the router instead")
            if self.replicas[src].abandon(rrid, err):
                with self._lock:
                    self._stats["orphaned"] += 1
                if self._tele is not None:
                    self._tele.on_orphaned()
        for rid in backlog:
            with self._lock:
                route = self._routes.get(rid)
            if route is None:
                continue              # settled/cancelled meanwhile
            self._try_place(rid, route.item)
        self._publish_backlog()

    def _publish_backlog(self):
        if self._tele is not None:
            with self._lock:
                n = len(self._backlog)
            self._tele.set_backlog(n)

    @property
    def backlog(self):
        """Requests currently held at the router awaiting a sibling
        that can take them (the ``router_queue_depth`` gauge)."""
        with self._lock:
            return len(self._backlog)

    def _record_failure(self, rid, err):
        # wait() notices within one poll slice; no condition variable
        # needed (waiters block on the REPLICA's cv, not the router's)
        with self._lock:
            route = self._routes.pop(rid, None)
            self._failures[rid] = err
        if route is not None and route.item.journey is not None:
            route.item.journey.event("failed",
                                     error=type(err).__name__)

    # ------------------------------------------------------ fleet metrics
    def fleet_snapshot(self):
        """ONE fleet-wide registry snapshot: the router's own metrics
        (when telemetry is on) merged with every replica's —
        counters/gauges summed, histograms folded bucket-wise
        (``telemetry.exposition.merge_snapshots``). Replicas without
        telemetry contribute nothing. This is also the SLO engine's
        default source."""
        from ..telemetry.exposition import merge_snapshots
        snaps = []
        if self._tele is not None:
            snaps.append(self._tele.registry.snapshot())
        for rep in self.replicas:
            tele = getattr(rep, "telemetry", None)
            if tele is not None and getattr(tele, "enabled", False):
                snaps.append(tele.registry.snapshot())
                continue
            # a replica whose registry is not in process (a process
            # replica behind the wire, ROADMAP Queue 1 item 9): its registry
            # lives across the wire — one snapshot op per fleet fold,
            # so /fleet spans process boundaries. Only serving replicas
            # are asked (a stale/dead one would spend the scrape's wire
            # budget to contribute nothing); the snapshot op itself is
            # bounded by the proxy's short snapshot timeout
            remote = getattr(rep, "registry_snapshot", None)
            if callable(remote) and is_serving_state(rep.health):
                snap = remote()
                if snap:
                    snaps.append(snap)
        return merge_snapshots(snaps)

    def fleet_metrics(self):
        """The merged fleet snapshot as ONE Prometheus text page —
        served on ``/fleet`` by ``serve_metrics(router)``, and
        round-trippable through ``telemetry.parse_prometheus`` (parsed
        values equal the element-wise sum of the per-replica pages)."""
        from ..telemetry.exposition import render_snapshot
        return render_snapshot(self.fleet_snapshot())

    def slo_report(self):
        """Evaluate the fleet SLOs NOW (one clock read, one merged
        snapshot) and return the burn-rate report — ``/slo``'s payload
        and the ``/healthz`` ``"slo"`` detail. None without an enabled
        ``SLOEngine``."""
        if self._slo is None:
            return None
        return self._slo.evaluate()

    # ----------------------------------------------- journeys/postmortem
    def journey(self, rid):
        """The fleet-wide timeline for router request ``rid`` — every
        hop's phase events (submitted, dispatched, queued, admitted,
        prefill chunks, grow/preempted/replay, evacuated, requeued,
        finished/failed/collected) in arrival order, each stamped with
        ``where`` ("router" / "replicaN"). None without a journey
        recorder or for an unknown/evicted rid. Served over
        ``/debug/journey/<rid>`` by ``serve_metrics(router)``."""
        if self._jrec is None:
            return None
        return self._jrec.journey(f"r{int(rid)}")

    def _capture_postmortem(self, reason, **extra):
        """Freeze the router's view of the fleet into a postmortem
        bundle: routing table, backlog, orphan count, per-replica
        breaker + health/load snapshots, router stats — alongside the
        recorder's recent events."""
        if self._rec is None:
            return None
        with self._lock:
            routing = {
                "routes": {rid: {"replica": rt.idx, "rrid": rt.rrid,
                                 "gen": rt.gen}
                           for rid, rt in self._routes.items()},
                "backlog": list(self._backlog),
                "orphans": len(self._orphans),
                "stats": {**self._stats,
                          "routed": list(self._stats["routed"])},
            }
        return self._rec.postmortem(
            reason, routing=routing,
            breakers=[b.state for b in self._breakers],
            replicas=[{"health": rep.health,
                       "queue_depth": rep.queue_depth(),
                       "in_flight": rep.in_flight(),
                       "preempt_pressure": rep.preempt_pressure()}
                      for rep in self.replicas],
            **extra)

    def postmortems(self):
        """Every captured bundle across the fleet, oldest first: the
        router's own (tagged ``source="router"``) merged with each
        replica's (``source="replicaN"``) — one artifact stream for
        ``/debug/postmortem``."""
        out = []
        if self._rec is not None:
            for b in self._rec.postmortems():
                out.append({"source": "router", **b})
        for idx, rep in enumerate(self.replicas):
            for b in rep.postmortems():
                out.append({"source": f"replica{idx}", **b})
        out.sort(key=lambda b: b.get("t", 0.0))
        return out

    def export_fleet_trace(self, file):
        """Write ONE merged Chrome/Perfetto trace for the whole fleet:
        each replica's tracer spans on its own pid (pid 0 = router,
        pid i+1 = replica i), every journey's phase events as instant
        markers at the pid of the hop that emitted them, and flow
        events (``ph: s/t/f``, one shared id per journey) connecting a
        request's hops — a failover renders as a connected arrow from
        the dead replica through the router to the sibling. ``file``
        is a path or file object; returns the event count."""
        import json

        events = [{"ph": "M", "name": "process_name", "pid": 0,
                   "tid": 0, "args": {"name": "router"}}]
        for idx, rep in enumerate(self.replicas):
            events.append({"ph": "M", "name": "process_name",
                           "pid": idx + 1, "tid": 0,
                           "args": {"name": f"replica{idx}"}})
            tele = getattr(rep, "telemetry", None)
            if tele is not None and getattr(tele, "enabled", False):
                for ev in tele.tracer.events():
                    ev = dict(ev)
                    ev["pid"] = idx + 1
                    events.append(ev)

        def pid_of(where):
            if isinstance(where, str) and where.startswith("replica"):
                return int(where[len("replica"):]) + 1
            return 0

        if self._jrec is not None:
            for tid in self._jrec.ids():
                timeline = self._jrec.journey(tid) or []
                for ev in timeline:
                    args = {k: v for k, v in ev.items()
                            if k not in ("t", "phase", "where")}
                    args["journey"] = tid
                    events.append({"name": f"journey.{ev['phase']}",
                                   "ph": "i", "s": "p",
                                   "pid": pid_of(ev["where"]), "tid": 0,
                                   "ts": ev["t"] * 1e6, "args": args})
                # one flow per journey, one step bound to EVERY journey
                # event (not one per consecutive-`where` group): each
                # s/t/f step carries the exact timestamp and pid of the
                # event it binds to, so an A->B->A bounce renders as
                # two distinct arrows anchored at the events that
                # crossed the boundary — and interleaved timelines
                # (replica events landing between two router events)
                # cannot collapse or fabricate hops. Journeys that
                # never left one location draw no flow.
                if len(timeline) >= 2 \
                        and len({ev["where"] for ev in timeline}) >= 2:
                    for i, ev in enumerate(timeline):
                        ph = "s" if i == 0 else \
                            ("f" if i == len(timeline) - 1 else "t")
                        fe = {"name": "journey", "cat": "journey",
                              "ph": ph, "id": tid,
                              "pid": pid_of(ev["where"]), "tid": 0,
                              "ts": ev["t"] * 1e6}
                        if ph == "f":
                            fe["bt"] = "e"
                        events.append(fe)
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        if hasattr(file, "write"):
            json.dump(payload, file)
        else:
            with open(file, "w") as f:
                json.dump(payload, f)
        return len(events)

    # ------------------------------------------------------------ health
    @property
    def health(self):
        """Aggregate fleet health: ``healthy`` (all replicas serving),
        ``degraded`` (some down, still taking traffic), ``dead`` (none
        serving). ``/healthz`` via ``serve_metrics(router)`` answers
        200 iff this is a serving state — i.e. >= 1 replica up."""
        n_serving = sum(1 for rep in self.replicas
                        if is_serving_state(rep.health))
        if n_serving == len(self.replicas):
            return HEALTHY
        return DEGRADED if n_serving else DEAD

    def _publish_health(self):
        if self._tele is not None:
            self._tele.set_health(self.health)
            for idx, rep in enumerate(self.replicas):
                # role rides the same publish cadence as health: a
                # restarted host that comes back with a different role
                # (or a pre-role build, -> "hybrid") updates within one
                # supervisor poll
                self._tele.set_replica_role(
                    idx, _placement.replica_role(rep))

    @property
    def stats(self):
        """Copy of the router counters: per-replica ``routed``,
        ``affinity_hits`` / ``fallbacks``, ``dispatch_retries``,
        ``evacuations`` / ``requeued`` / ``replica_lost``,
        ``restarts``."""
        with self._lock:
            out = dict(self._stats)
            out["routed"] = list(out["routed"])
            return out

    @property
    def failures(self):
        """{rid: exception} for requests the router itself failed
        (``wait(rid)`` pops and raises each)."""
        with self._lock:
            return dict(self._failures)

    def poll(self):
        """One supervisor sweep (see ``RouterSupervisor.poll``) —
        single-threaded/deterministic drives call this instead of
        ``start()``."""
        return self.supervisor.poll()

    # --------------------------------------------------------- lifecycle
    def start(self, poll_interval=0.01, start_replicas=True):
        """Start the supervisor thread (and, by default, any replica
        serve thread not already running). The supervisor polls health
        every ``poll_interval`` seconds, backing off by the retry
        policy after a failed failover sweep."""
        if self._thread is not None:
            raise RuntimeError("router already started")
        if start_replicas:
            for rep in self.replicas:
                if rep._thread is None:
                    rep.start()
        self._stop_evt.clear()

        def loop():
            attempt = 0
            delay = poll_interval
            while not self._stop_evt.wait(delay):
                errors = self.supervisor.poll()
                if errors:
                    delay = poll_interval \
                        + self.supervisor.retry.delay(attempt)
                    attempt += 1
                else:
                    delay = poll_interval
                    attempt = 0

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True, timeout=60.0, stop_replicas=True):
        """Stop the supervisor thread, then (by default) every replica
        — gracefully with ``drain=True``."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        if stop_replicas:
            for rep in self.replicas:
                rep.stop(timeout=timeout, drain=drain)
        self._publish_health()

    def rolling_restart(self, drain_timeout=120.0):
        """Bounce every replica one at a time with ZERO failed
        requests: its queued work is evacuated to siblings first (they
        also absorb all new traffic once health goes ``draining``),
        in-flight requests finish during the graceful drain, then the
        replica restarts and rejoins the rotation before the next one
        goes down."""
        for idx, rep in enumerate(self.replicas):
            # mid-decode slots hand off LIVE (KV pages + sampler
            # state) to siblings — zero re-prefill, zero replay; the
            # evacuation below covers the queued remainder, and any
            # failed migration simply rides out the graceful drain
            self._migrate_live(idx)
            harvested = rep.evacuate()      # queued -> siblings now,
            with self._lock:                # instead of riding out the
                self._stats["evacuations"] += 1   # drain wall
            if self._tele is not None:
                self._tele.on_evacuation(idx)
            self._requeue(idx, harvested)
            rep.stop(drain=True, timeout=drain_timeout)
            rep.start()
            if self._rec is not None:
                self._rec.record("restart", replica=idx)
            # requests the requeue parked under sibling backpressure
            # must not wait for a supervisor thread that may not be
            # running — the restarted replica can take them now
            self._drain_backlog()
            with self._lock:
                self._stats["restarts"] += 1
            self._publish_health()
