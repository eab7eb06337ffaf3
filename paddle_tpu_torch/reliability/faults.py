"""Deterministic fault injection for chaos testing.

Copied from ``paddle_tpu/reliability/faults.py`` (the module is
framework-free); the port fires the serving points (``PREFILL``,
``DECODE_TICK``, ``PAGE_ALLOC``, ``KV_GROW``, ``SERVER_PREEMPT``,
``ON_TOKEN``, ``PREFIX_EVICT``, ``PREFIX_DONATE``), the in-process
fleet's (``TIER_SPILL``, ``TIER_RESTORE``, ``ROUTER_DISPATCH``,
``ROUTER_EVACUATE``, ``MIGRATE_GATHER``, ``MIGRATE_RESTORE``; the
``NET_*`` points wait for the wire) and the training and
checkpoint points (``CKPT_WRITE``, ``CKPT_RENAME``, ``CKPT_SWAP``,
``TRAIN_STEP``, ``DATA_NEXT``), and publishes its fires to a telemetry
registry and a flight recorder as the reference does.

A ``FaultInjector`` owns named FAILURE POINTS. Production code calls
``injector.check("train.step")`` at each point (only when an injector
is attached — the default ``None`` costs one attribute check); the
injector decides, deterministically, whether that visit fails, and
raises ``InjectedFault`` if so.

Two trigger modes per point, combinable:

- ``schedule``: explicit 0-based visit indices that ALWAYS fire — exact
  regression scripts ("fail the 3rd prefill").
- ``probability``: each visit fires with probability p, drawn from a
  PER-POINT PRNG seeded by ``(seed, point name)`` — chaos at a rate,
  yet two runs with the same seed and the same visit sequence produce
  IDENTICAL injection traces (the per-point streams make the decision
  sequence independent of how visits to different points interleave).

``trace`` records every fired injection as ``(point, visit_index)`` —
the determinism contract tests assert two runs' traces are equal.
``reset()`` rewinds counters AND re-seeds the RNGs so one injector can
replay itself.
"""
import random
import threading

from .errors import InjectedFault

__all__ = ["FaultInjector", "PREFILL", "DECODE_TICK", "PAGE_ALLOC",
           "KV_GROW", "SERVER_PREEMPT",
           "ON_TOKEN", "PREFIX_EVICT", "PREFIX_DONATE",
           "TIER_SPILL", "TIER_RESTORE",
           "ROUTER_DISPATCH", "ROUTER_EVACUATE",
           "NET_SEND", "NET_RECV", "NET_CONNECT", "NET_PARTITION",
           "NET_PAGE_SEND", "MIGRATE_GATHER", "MIGRATE_RESTORE",
           "CKPT_WRITE",
           "CKPT_RENAME", "CKPT_SWAP", "TRAIN_STEP", "DATA_NEXT"]

# failure points wired into the serving stack (callers may add their own)
PREFILL = "server.prefill"          # _admit_one: admission prefill
DECODE_TICK = "server.decode_tick"  # _step_locked: batched decode dispatch
PAGE_ALLOC = "kv.alloc"             # PagedKVCache.alloc
KV_GROW = "kv.grow"                 # PagedKVCache.grow_slot: optimistic
#                                     mid-decode page growth (fires BEFORE
#                                     the free list is touched — a faulted
#                                     grow is a transient tick failure,
#                                     never a leak)
SERVER_PREEMPT = "server.preempt"   # _grow_one_locked: one victim
#                                     teardown (fires BEFORE the victim
#                                     is touched — an aborted sweep
#                                     leaves it decoding; the tick
#                                     retries)
ON_TOKEN = "server.on_token"        # streamed-token callback delivery
PREFIX_EVICT = "prefix.evict"       # PrefixCache.evict: LRU reclaim sweep
PREFIX_DONATE = "prefix.donate"     # PrefixCache.donate: harvest-time
#                                     adoption of a slot's prompt pages
TIER_SPILL = "tier.spill"           # HostTier.put: demoting one evicted
#                                     page's payload to host RAM (fires
#                                     BEFORE the store — a faulted spill
#                                     falls back to a plain drop, so the
#                                     device page is freed either way)
TIER_RESTORE = "tier.restore"       # HostTier.get: fetching a spilled
#                                     payload at admission (fires BEFORE
#                                     the read — a faulted restore is a
#                                     cache MISS for that run, never a
#                                     request failure)

# failure points wired into the multi-replica router (inference/router.py)
ROUTER_DISPATCH = "router.dispatch"  # ReplicaRouter: one replica submit
ROUTER_EVACUATE = "router.evacuate"  # RouterSupervisor: harvesting a
#                                      lost replica's queued requests

# wire-level failure points (inference/transport.py). A fire's EFFECT
# is chosen by the armed error class — transport.NetDrop (frame
# vanishes), NetDelay (late), NetTruncate (partial frame, then the
# socket hard-closes), NetSever / plain InjectedFault (connection
# severed) — so one injector scripts a whole partition storm.
NET_SEND = "net.send"          # Connection.send: one outbound frame
NET_RECV = "net.recv"          # Connection.recv: one inbound frame
NET_CONNECT = "net.connect"    # RemoteReplica connect/reconnect attempt
NET_PARTITION = "net.partition"  # checked on EVERY send AND recv (and
#                                  at connect): a fired partition cuts
#                                  the link whatever direction traffic
#                                  was flowing
NET_PAGE_SEND = "net.page_send"  # Connection.send_pages: one outbound
#                                  BINARY page frame (header + raw
#                                  payload) — same error-class effects
#                                  as NET_SEND, scoped to migration
#                                  traffic so a storm can corrupt page
#                                  transfers without touching control
#                                  frames

# live KV-page migration failure points. Both fire BEFORE
# any state changes hands, so a faulted migration is a clean typed
# refusal the caller degrades to evacuate+replay — never a leak.
MIGRATE_GATHER = "migrate.gather"    # migrate_out: gathering a paused
#                                      slot's written pages off the pool
MIGRATE_RESTORE = "migrate.restore"  # migrate_in: scattering received
#                                      pages into fresh pool pages

# failure points wired into the training / checkpoint stack
CKPT_WRITE = "ckpt.write"           # durable save: per-file payload write
CKPT_RENAME = "ckpt.rename"         # durable save: the atomic commit rename
CKPT_SWAP = "ckpt.swap"             # overwrite save: between the two
#                                     swap renames (old parked, new not
#                                     yet live — the recovery window)
TRAIN_STEP = "train.step"           # supervised loop: one train step
DATA_NEXT = "data.next"             # supervised loop: next-batch fetch


class _Rule:
    __slots__ = ("probability", "schedule", "error", "start", "stop",
                 "max_fires", "fired")

    def __init__(self, probability, schedule, error, start, stop,
                 max_fires):
        self.probability = float(probability)
        self.schedule = frozenset(int(i) for i in schedule)
        self.error = error
        self.start = int(start)
        self.stop = stop if stop is None else int(stop)
        self.max_fires = max_fires if max_fires is None else int(max_fires)
        self.fired = 0


class FaultInjector:
    """Seeded, thread-safe failure-point registry.

    >>> fi = FaultInjector(seed=7).on(TRAIN_STEP, probability=0.2) \\
    ...                           .on(CKPT_WRITE, schedule=[3])
    >>> sup = TrainSupervisor("/ckpts/run1", injector=fi)

    Observability: ``publish_to(registry)`` mints
    ``fault_fires_total{point}`` so a chaos storm is VISIBLE on
    ``/metrics`` (a server with telemetry attached wires this
    automatically), and ``recorder`` (a ``telemetry.FlightRecorder``;
    the server wires its own at construction) records each fire as a
    ``fault`` event. Neither hook consumes the per-point PRNG streams —
    same-seed injection traces stay identical.

    ``enabled=False`` (or ``disarm()``) turns every ``check`` into a
    counter-only visit, so one test can run the same script with and
    without chaos.
    """

    def __init__(self, seed=0, enabled=True, registry=None):
        self.seed = int(seed)
        self.enabled = bool(enabled)
        self._rules = {}
        self._rngs = {}
        self._visits = {}
        self.trace = []               # (point, visit_index) of FIRES
        self._fires = []              # fault_fires_total counters, one
        #                               per ATTACHED registry
        self.recorder = None          # FlightRecorder (fires -> events)
        self._lock = threading.Lock()
        self.publish_to(registry)

    # ------------------------------------------------------ registration
    def on(self, point, probability=0.0, schedule=(), error=None,
           start=0, stop=None, max_fires=None):
        """Arm ``point``. ``probability`` fires per visit; ``schedule``
        lists visit indices that always fire; ``start``/``stop`` bound
        the probabilistic window (visit indices, half-open); ``max_fires``
        caps total probabilistic fires. ``error``: an exception CLASS
        (instantiated with a message) or zero-arg factory; default
        ``InjectedFault``. Returns self for chaining."""
        if not 0.0 <= float(probability) <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        with self._lock:
            self._rules[point] = _Rule(probability, schedule, error,
                                       start, stop, max_fires)
            self._rngs[point] = random.Random(f"{self.seed}:{point}")
            self._visits.setdefault(point, 0)
        return self

    def publish_to(self, registry):
        """Publish ``fault_fires_total{point}`` to ``registry``
        (``telemetry.MetricRegistry``; None or disabled no-ops).
        Idempotent per registry, CUMULATIVE across registries: an
        injector shared by several components counts every fire in
        every attached registry."""
        if registry is not None and registry.enabled:
            c = registry.counter(
                "fault_fires_total",
                "Injected chaos faults fired, by failure point",
                labelnames=("point",))
            if all(c is not prev for prev in self._fires):
                self._fires.append(c)
        return self

    def arm(self):
        self.enabled = True
        return self

    def disarm(self):
        self.enabled = False
        return self

    def reset(self):
        """Rewind visit counters, fire counts, trace, and RNG streams —
        the injector will replay the exact same decision sequence."""
        with self._lock:
            self.trace = []
            for point, rule in self._rules.items():
                rule.fired = 0
                self._visits[point] = 0
                self._rngs[point] = random.Random(f"{self.seed}:{point}")
        return self

    # ----------------------------------------------------------- runtime
    def check(self, point, **ctx):
        """Count a visit to ``point``; raise if this visit fires.
        ``ctx`` (e.g. ``rid=...``) is attached to the raised error as
        ``.ctx`` for debugging chaos traces."""
        with self._lock:
            n = self._visits.get(point, 0)
            self._visits[point] = n + 1
            rule = self._rules.get(point)
            if rule is None or not self.enabled:
                return
            fire = n in rule.schedule
            if not fire and rule.probability > 0.0:
                in_window = n >= rule.start and (rule.stop is None
                                                 or n < rule.stop)
                budget_ok = (rule.max_fires is None
                             or rule.fired < rule.max_fires)
                # always DRAW when armed+windowed so the stream position
                # depends only on the visit count, not on max_fires state
                if in_window:
                    draw = self._rngs[point].random()
                    fire = budget_ok and draw < rule.probability
            if not fire:
                return
            rule.fired += 1
            self.trace.append((point, n))
        # observability hooks OUTSIDE the injector lock (each has its
        # own short lock): the fire is visible on /metrics and in the
        # flight recorder before the error even propagates
        for fires in self._fires:
            fires.labels(point=point).inc()
        if self.recorder is not None:
            self.recorder.record("fault", point=point, visit=n)
        if rule.error is None:
            err = InjectedFault(point, n)
        else:
            err = rule.error() if not isinstance(rule.error, type) \
                else rule.error(f"injected fault at {point} (visit {n})")
        err.ctx = dict(ctx)
        raise err

    # ------------------------------------------------------ introspection
    def visits(self, point):
        with self._lock:
            return self._visits.get(point, 0)

    def fired(self, point=None):
        """Fires at ``point``, or total across all points."""
        with self._lock:
            if point is not None:
                rule = self._rules.get(point)
                return 0 if rule is None else rule.fired
            return sum(r.fired for r in self._rules.values())
