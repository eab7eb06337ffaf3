"""Request-journey tracing across the serving fleet.

Copied from ``paddle_tpu/telemetry/journey.py`` (framework-free; the
port's ``inference.router.ReplicaRouter`` mints fleet journeys, and a
standalone server mints its own). The telemetry's lifecycle spans live inside
ONE replica's tracer under that replica's LOCAL rid — they cannot answer "what happened to request X"
once X crossed a dead replica, was preempted and replayed, or was
evacuated and requeued onto a sibling. A ``JourneyRecorder`` is the
fleet-level answer: the router mints a journey (trace id) at
``ReplicaRouter.submit()`` and hands each hop a rebound ``Journey``
handle (``handle.at("replica2")``), so every participant — router
dispatch, replica admission, ragged prefill chunks, grow/preempt/park/
replay, evacuation/requeue, completion — appends timestamped phase
events to ONE per-request timeline without knowing about any other
participant.

Query/export surfaces:

- ``journey(tid)`` — the per-request timeline, a list of
  ``{"t", "phase", "where", **fields}`` dicts in arrival order; served
  over ``/debug/journey/<rid>`` via ``serve_metrics(router)``.
- ``ReplicaRouter.export_fleet_trace(path)`` — ONE merged Chrome/
  Perfetto JSON: every replica's tracer spans on its own pid, journey
  phase events as instants, and flow events (``ph: s/t/f`` sharing the
  journey id) connecting a request's hops ACROSS replicas, so a
  failover renders as one connected arrow in the Perfetto UI.

Cost contract (mirrors ``FlightRecorder``): recording is one clock
read + one short lock; a DISABLED recorder (``enabled=False``) no-ops
before touching either, and the router/server treat it exactly like
``None`` — requests then carry no handle at all, so the hot path pays
one ``is None`` check per emission site. Timelines are bounded by
``max_journeys`` (oldest journey evicted whole), never by truncating a
live timeline.
"""
import threading

from .clock import MonotonicClock

__all__ = ["Journey", "JourneyRecorder"]


class Journey:
    """A cheap handle binding (recorder, trace id, location label).
    Location labels name the hop ("router", "replica0", ...); ``at``
    rebinds without copying the timeline — the router rebinds when it
    dispatches a request to a replica, and every event the replica
    emits through the handle is stamped with that replica's label."""

    __slots__ = ("_rec", "tid", "where")

    def __init__(self, rec, tid, where):
        self._rec = rec
        self.tid = tid
        self.where = where

    def event(self, phase, /, **fields):
        """Append one phase event at this handle's location.
        ``phase`` is positional-only so even a ``phase=`` field cannot
        collide; the recorder re-keys any reserved field name."""
        self._rec.event(self.tid, phase, self.where, **fields)

    def at(self, where):
        """A sibling handle for the same journey at another location."""
        return Journey(self._rec, self.tid, where)

    def __repr__(self):
        return f"Journey({self.tid!r} @ {self.where})"


class JourneyRecorder:
    """Per-request fleet timelines, keyed by trace id.

    >>> jr = JourneyRecorder()
    >>> router = ReplicaRouter(reps, journeys=jr)
    >>> rid = router.submit(ids)
    >>> router.journey(rid)      # [{"t", "phase", "where", ...}, ...]

    ``max_journeys`` bounds memory: past it the OLDEST journey is
    dropped whole (its ``journey()`` then returns None, like a rid that
    never existed — bounded retention, not truncated timelines).
    """

    def __init__(self, clock=None, enabled=True, max_journeys=2048):
        if max_journeys < 1:
            raise ValueError("max_journeys must be >= 1")
        self.clock = clock if clock is not None else MonotonicClock()
        self.enabled = bool(enabled)
        self.max_journeys = int(max_journeys)
        self.dropped = 0
        self._lock = threading.Lock()
        self._journeys = {}          # tid -> [event dict, ...]

    # ------------------------------------------------------------ write
    def begin(self, tid, where="router"):
        """Register a journey and return its handle. Re-beginning an
        existing tid returns a fresh handle onto the SAME timeline (a
        client retry keeps one history)."""
        if self.enabled:
            with self._lock:
                if tid not in self._journeys:
                    while len(self._journeys) >= self.max_journeys:
                        oldest = next(iter(self._journeys))
                        del self._journeys[oldest]
                        self.dropped += 1
                    self._journeys[tid] = []
        return Journey(self, tid, where)

    def event(self, tid, phase, where, /, **fields):
        """Append a phase event (no-op when disabled — checked FIRST,
        before any clock read or lock). The first three parameters are
        positional-only, and the reserved keys ``t``/``phase``/
        ``where`` are re-keyed with a trailing underscore if they show
        up in ``fields`` — an emission site's bad field name degrades
        the event, never crashes the serve tick that emitted it.
        Events for an evicted or never-begun tid are dropped silently:
        a journey is a debugging artifact, never a correctness
        dependency."""
        if not self.enabled:
            return
        ev = {"t": self.clock.now(), "phase": phase, "where": where}
        if fields:
            for k in ("t", "phase", "where"):
                if k in fields:
                    fields[k + "_"] = fields.pop(k)
            ev.update(fields)
        with self._lock:
            tl = self._journeys.get(tid)
            if tl is not None:
                tl.append(ev)

    # ------------------------------------------------------------- read
    def journey(self, tid):
        """The timeline for ``tid`` (copies), or None if unknown/
        evicted."""
        with self._lock:
            tl = self._journeys.get(tid)
            return None if tl is None else [dict(e) for e in tl]

    def ids(self):
        """Retained trace ids, oldest first."""
        with self._lock:
            return list(self._journeys)

    def __len__(self):
        with self._lock:
            return len(self._journeys)

    def clear(self):
        with self._lock:
            self._journeys.clear()
            self.dropped = 0
