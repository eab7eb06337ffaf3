"""The batched-request scheduler and the HTTP exposition of a serving
stack's telemetry.

Port of ``paddle_tpu/inference/serving.py`` (framework-free: threads,
numpy, telemetry and the reliability layer's typed errors):
``BatchScheduler`` groups pending requests into one batched call of a
runner (a ``Predictor`` or any callable) and splits the outputs back per
request; ``serve_metrics`` serves a server's or a ``ReplicaRouter``'s
telemetry over HTTP.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..reliability import DeadlineExceeded, QueueFullError, SchedulerClosed

__all__ = ["BatchScheduler", "serve_metrics"]


class _Request:
    __slots__ = ("inputs", "future", "n", "t_submit", "deadline")

    def __init__(self, inputs, t_submit=None, deadline=None):
        self.inputs = inputs
        self.future = Future()
        self.n = int(inputs[0].shape[0])    # rows this request contributes
        self.t_submit = t_submit
        self.deadline = deadline            # absolute clock time, or None

    def settle(self, result=None, error=None):
        """Resolve the future, losing gracefully if the other side of a
        close()/worker race settled it first (whoever wins, the waiter
        sees exactly one outcome)."""
        try:
            if error is not None:
                self.future.set_exception(error)
            else:
                self.future.set_result(result)
        except InvalidStateError:
            pass


class BatchScheduler:
    """Group submitted requests into batched runner calls.

    ``runner``: a ``Predictor`` (its positional ``run(list)`` is used) or
    any callable ``f(list_of_stacked_arrays) -> list_of_arrays`` where
    every output keeps the stacked batch on axis 0.

    ``submit(*arrays)`` returns a ``concurrent.futures.Future`` whose
    result is the list of this request's output slices (numpy).
    Requests are batched up to ``max_batch_size`` rows; a partially
    filled batch launches after ``max_delay_ms``. Requests whose trailing
    shapes or dtypes differ batch separately (an exported program with a
    dynamic batch fixes the other dims; the scheduler never mixes them).
    A single request larger than ``max_batch_size`` runs alone.

    ``max_queue`` bounds the pending-request count: a full queue REJECTS
    the submit with ``QueueFullError`` instead of growing without bound
    under overload. ``submit(..., deadline_s=)`` bounds waiting: a
    request still queued when its deadline passes fails its future with
    ``DeadlineExceeded`` before any runner time is spent on it.
    ``close()`` drains the queue; a runner wedged past its ``timeout``
    fails every pending future with ``SchedulerClosed`` and raises
    ``TimeoutError``.

    ``registry`` (``telemetry.MetricRegistry``) publishes
    ``scheduler_batch_rows`` / ``scheduler_batch_seconds`` /
    ``scheduler_queue_wait_seconds`` histograms and
    ``scheduler_{requests,batches,failures}_total`` counters; with the
    default ``None`` the hot path pays one ``is None`` check. ``clock``
    (``now()``) times deadlines and the histograms; the linger window
    runs on ``time.monotonic``, as the reference's does.
    """

    def __init__(self, runner, max_batch_size=8, max_delay_ms=5.0,
                 registry=None, clock=None, max_queue=None):
        self._run = (runner.run if hasattr(runner, "run") else runner)
        self.max_batch = int(max_batch_size)
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_queue = None if max_queue is None else int(max_queue)
        self._lock = threading.Condition()
        self._queue = []                    # pending _Request, FIFO
        self._inflight = []                 # popped group the runner holds
        self._closed = False
        self.batches_run = 0                # introspection for tests
        self._m = None
        from ..telemetry.clock import MonotonicClock
        self._clock = clock if clock is not None else MonotonicClock()
        if registry is not None and registry.enabled:
            from ..telemetry.serving import OCCUPANCY_BUCKETS, TICK_BUCKETS
            self._m = {
                "rows": registry.histogram(
                    "scheduler_batch_rows", "Rows per batched call",
                    buckets=OCCUPANCY_BUCKETS),
                "batch_s": registry.histogram(
                    "scheduler_batch_seconds", "One batched runner call",
                    buckets=TICK_BUCKETS),
                "wait_s": registry.histogram(
                    "scheduler_queue_wait_seconds",
                    "submit() to batch launch", buckets=TICK_BUCKETS),
                "requests": registry.counter(
                    "scheduler_requests_total", "Requests submitted"),
                "batches": registry.counter(
                    "scheduler_batches_total", "Batched calls run"),
                "failures": registry.counter(
                    "scheduler_failures_total",
                    "Batched calls that raised"),
            }
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ client
    def submit(self, *arrays, deadline_s=None):
        arrays = [np.asarray(a) for a in arrays]
        if not arrays:
            raise ValueError("submit() needs at least one input array")
        deadline = None if deadline_s is None \
            else self._clock.now() + float(deadline_s)
        req = _Request(arrays, deadline=deadline)
        with self._lock:
            if self._closed:
                raise SchedulerClosed("scheduler is closed")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                raise QueueFullError(
                    f"scheduler queue holds {len(self._queue)} requests "
                    f"(max_queue={self.max_queue}) — resubmit with "
                    f"backoff")
            if self._m:        # count only ACCEPTED requests
                req.t_submit = self._clock.now()
                self._m["requests"].inc()
            self._queue.append(req)
            self._lock.notify()
        return req.future

    def close(self, timeout=10.0):
        """Stop the worker after it drains the queue. If the worker is
        WEDGED inside a runner call, every still-pending future (queued
        or held by the stuck batch) is failed with ``SchedulerClosed``
        — a waiter must never hang on a scheduler that already gave up
        — and the join timeout is surfaced as ``TimeoutError``."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            with self._lock:
                victims = list(self._queue) + list(self._inflight)
                self._queue.clear()
            err = SchedulerClosed(
                "scheduler closed while its runner was wedged; this "
                "request will never run")
            for r in victims:
                r.settle(error=err)
            raise TimeoutError(
                f"scheduler worker did not exit within {timeout}s (the "
                f"runner call is still blocked); {len(victims)} pending "
                f"future(s) were failed with SchedulerClosed")

    # ------------------------------------------------------------ worker
    @staticmethod
    def _shape_key(req):
        return tuple((a.shape[1:], str(a.dtype)) for a in req.inputs)

    def _take_group(self):
        """Pop a shape-compatible group (<= max_batch rows) or None."""
        if not self._queue:
            return None
        key = self._shape_key(self._queue[0])
        group, rows, rest = [], 0, []
        for req in self._queue:
            fits = rows + req.n <= self.max_batch or not group
            # `not group`: a single request larger than max_batch still
            # runs (alone) — it must never starve in the queue
            if self._shape_key(req) == key and fits:
                group.append(req)
                rows += req.n
            else:
                rest.append(req)
        self._queue = rest
        return group

    def _expire_locked(self):
        """Fail queued requests whose deadline passed BEFORE any runner
        time is spent on them (called with the lock held)."""
        if not any(r.deadline is not None for r in self._queue):
            return
        now = self._clock.now()
        keep = []
        for r in self._queue:
            if r.deadline is not None and now >= r.deadline:
                r.settle(error=DeadlineExceeded(
                    "request expired in the scheduler queue"))
            else:
                keep.append(r)
        self._queue = keep

    def _loop(self):
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._lock.wait()
                if not self._queue and self._closed:
                    return
                first_seen = time.monotonic()
                # linger for more requests while the batch is open
                while (len(self._queue) > 0
                       and sum(r.n for r in self._queue) < self.max_batch
                       and not self._closed
                       and time.monotonic() - first_seen < self.max_delay):
                    self._lock.wait(timeout=self.max_delay / 4)
                self._expire_locked()
                group = self._take_group()
                self._inflight = group or []
            if not group:
                continue
            try:
                if self._m:
                    t_launch = self._clock.now()
                    for r in group:
                        self._m["wait_s"].observe(t_launch - r.t_submit)
                    self._m["rows"].observe(sum(r.n for r in group))
                stacked = [np.concatenate([r.inputs[i] for r in group], 0)
                           for i in range(len(group[0].inputs))]
                outs = self._run(stacked)
                self.batches_run += 1
                if self._m:
                    self._m["batches"].inc()
                    self._m["batch_s"].observe(
                        self._clock.now() - t_launch)
                off = 0
                for r in group:
                    # settle() resolves the race with a close() that
                    # already failed this future
                    r.settle([np.asarray(o)[off:off + r.n] for o in outs])
                    off += r.n
            except Exception as e:              # propagate to every waiter
                if self._m:
                    self._m["failures"].inc()
                for r in group:
                    r.settle(error=e)
            finally:
                with self._lock:
                    self._inflight = []


def serve_metrics(target, host="127.0.0.1", port=0):
    """Expose a serving stack's telemetry over HTTP: ``/metrics``
    (Prometheus text), ``/stats`` (JSON snapshot + process stats), and
    — when ``target`` reports health — ``/healthz`` (200 while serving,
    503 otherwise: the load-balancer readiness contract).

    ``target`` is a ``ContinuousBatchingServer`` (uses its attached
    ``telemetry``), a ``router.ReplicaRouter`` (its ``/healthz``
    AGGREGATES the fleet: 200 iff >= 1 replica is serving, and ``/stats``
    carries per-replica health, queue, stats and utilization), a
    ``ServerTelemetry``, or a bare ``MetricRegistry``. Returns a started
    ``telemetry.MetricsServer`` (``.url``, ``.port``, ``.close()``).
    ``port=0`` binds an ephemeral port.

    Debug surfaces: server and router targets serve their captured
    bundles on ``/debug/postmortem`` (the router merges its own with
    every replica's; an empty list without a ``FlightRecorder``) and
    per-request journey timelines on ``/debug/journey/<rid>`` (minted at
    the router's front door, or by a standalone server constructed with
    ``journeys=``; 404 for unknown rids — every rid, without a
    ``JourneyRecorder``). ``/stats`` carries the pool's, the prefix
    cache's and the host tier's statistics, and the goodput ledger's and
    the cost catalog's snapshots under ``"goodput"`` and ``"costs"`` when
    the server wires them.

    Fleet surfaces: a router target serves ONE merged Prometheus page
    across every replica's registry on ``/fleet``
    (``router.fleet_metrics()``) and — with an ``SLOEngine`` attached
    (``ReplicaRouter(slos=...)``) — the burn-rate report on ``/slo``,
    whose worst state also rides the ``/healthz`` body as an ``"slo"``
    detail (the 200/503 verdict is unchanged).
    """
    from ..telemetry.exposition import MetricsServer

    extra = None
    tele = getattr(target, "telemetry", target)
    if tele is None:
        raise ValueError(
            "server has no telemetry attached — construct it with "
            "telemetry=True (or a ServerTelemetry) to expose metrics")
    registry = getattr(tele, "registry", tele)
    if hasattr(target, "replicas"):       # ReplicaRouter front door

        def extra():
            stats = dict(target.stats)
            stats["replicas"] = [
                {"health": rep.health,
                 "queue_depth": rep.queue_depth(),
                 "in_flight": rep.in_flight(),
                 "stats": dict(rep.stats),
                 "util": (rep.utilization()
                          if callable(getattr(rep, "utilization", None))
                          else {})}
                for rep in target.replicas]
            return stats
    elif hasattr(target, "stats"):        # ContinuousBatchingServer
        kv = getattr(target, "_kv", None)

        def extra():
            stats = dict(target.stats)
            if kv is not None:
                stats["kv_pool"] = kv.telemetry_stats()
                stats["prefix_cache"] = target._prefix.stats()
                tier = getattr(target, "_host", None)
                if tier is not None:
                    stats["host_tier"] = tier.stats()
            g = target.goodput()
            if g is not None:
                stats["goodput"] = g
            c = target.device_costs()
            if c is not None:
                stats["costs"] = c
            return stats
    health = None
    if hasattr(target, "health"):

        def health():
            return target.health
    journey = None
    if callable(getattr(target, "journey", None)):
        def journey(rid_s, _fn=target.journey):
            try:
                rid = int(rid_s)
            except (TypeError, ValueError):
                return None
            return _fn(rid)
    postmortem = getattr(target, "postmortems", None)
    if not callable(postmortem):
        postmortem = None
    fleet = getattr(target, "fleet_metrics", None)
    if not callable(fleet):
        fleet = None
    slo = slo_states = None
    if getattr(target, "slo_engine", None) is not None \
            and getattr(target.slo_engine, "enabled", False):
        slo = target.slo_report
        # /healthz reads the CACHED states; /slo scrapes are the only
        # evaluation driver
        slo_states = target.slo_engine.states
    return MetricsServer(registry, host=host, port=port,
                         extra_stats=extra, health=health,
                         journey=journey, postmortem=postmortem,
                         fleet=fleet, slo=slo,
                         slo_states=slo_states).start()
