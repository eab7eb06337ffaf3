"""Flight recorder: a bounded ring of structured server events, plus
postmortem bundles.

Copied from ``paddle_tpu/telemetry/flight.py`` (framework-free).
Metrics are AGGREGATES — perfect for dashboards, useless for
"what was the server doing in the 200 ticks before the breaker
opened". The ``FlightRecorder`` fills that gap: production code records
small structured events (admissions, grows, preemptions, evictions,
per-tick dispatch profiles, health transitions, breaker flips, fault
fires) into a fixed-size ring that overwrites oldest-first, so memory
is bounded no matter how long the server runs and the LAST N events
are always available when something dies.

Cost contract (mirrors ``MetricRegistry``/``Tracer``):

- recording is LOCK-CHEAP: one clock read + one short lock around an
  index bump and a slot assign. No allocation beyond the event dict.
- a DISABLED recorder (``enabled=False``) returns before touching the
  clock OR the lock — structurally zero cost, asserted in tests via
  ``FakeClock.reads`` and a counting-lock shim. Components treat a
  disabled recorder exactly like ``None`` (one attribute check on the
  hot path).
- host-side only: never call ``record`` from jit-traced code.

Postmortem bundles: ``postmortem(reason, **sections)`` snapshots the
most recent ring events plus whatever state sections the caller
provides (pool balance, block-table occupancy, radix-tree stats,
parked queue, router routing state — see
``ContinuousBatchingServer._postmortem_locked`` /
``ReplicaRouter._capture_postmortem``) into a plain-data JSON-ready
artifact. The server captures one on tick-retry exhaustion (breaker
open), request failure, and ``kill()``; the router on replica death
and fleet-wide request loss. Bundles are kept in a bounded deque
(newest wins) and served over ``/debug/postmortem``
(``telemetry.MetricsServer`` via ``inference.serving.serve_metrics``).
With ``postmortem_dir=`` each bundle is ALSO persisted to disk as one
JSON file (atomic tmp + rename, ``postmortem-<seq>.json`` numbering
that survives restarts, newest ``max_postmortems`` files retained) —
an incident that takes the process down no longer takes its own
evidence with it. Persistence is best-effort: a failing disk during an
incident increments ``persist_errors`` and never breaks the capture.

Event shape: a flat dict ``{"seq": int, "t": float, "kind": str,
**fields}`` — ``seq``/``t``/``kind`` are reserved keys; keep fields
plain data (ints/strs) so bundles serialize and two same-seed chaos
runs compare equal (the determinism contract: identical drive +
identical injection trace => identical event sequence modulo ``t``).
"""
import threading
from collections import deque

from .clock import MonotonicClock

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring buffer of structured server events + postmortems.

    >>> rec = FlightRecorder(capacity=4096)
    >>> srv = ContinuousBatchingServer(model, ..., recorder=rec)
    >>> rec.events(kind="preempt")[-3:]     # the last three victims
    >>> srv.postmortems()[-1]["pool_balance"]

    ``capacity`` bounds the ring (oldest events overwritten);
    ``keep_events`` is how many recent events each postmortem bundle
    snapshots; ``max_postmortems`` bounds the bundle store (and, with
    ``postmortem_dir``, the on-disk file count — newest win).
    """

    def __init__(self, capacity=4096, clock=None, enabled=True,
                 keep_events=256, max_postmortems=8,
                 postmortem_dir=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.clock = clock if clock is not None else MonotonicClock()
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.keep_events = int(keep_events)
        self._ring = [None] * self.capacity
        self._seq = 0
        self._lock = threading.Lock()
        self._max_postmortems = int(max_postmortems)
        self._postmortems = deque(maxlen=self._max_postmortems)
        self.postmortem_dir = postmortem_dir
        self.persist_errors = 0
        self._pm_file_seq = 0
        if postmortem_dir is not None:
            import os
            import re
            os.makedirs(postmortem_dir, exist_ok=True)
            # numbering continues across restarts so a new process
            # cannot clobber the previous crash's evidence
            pat = re.compile(r"^postmortem-(\d+)\.json$")
            seqs = [int(m.group(1)) for fn in os.listdir(postmortem_dir)
                    for m in [pat.match(fn)] if m]
            self._pm_file_seq = max(seqs) + 1 if seqs else 0

    # ----------------------------------------------------------- record
    def record(self, kind, /, **fields):
        """Append one event. The reserved keys ``seq``/``t``/``kind``
        are re-keyed with a trailing underscore if they appear in
        ``fields`` (``kind`` is positional-only, so even ``kind=...``
        lands there) — a bad field name degrades the event, never
        crashes the recording site. Returns the event's sequence
        number (or None when disabled — the FIRST statement checks
        ``enabled``, so a disabled recorder reads no clock and takes
        no lock)."""
        if not self.enabled:
            return None
        ev = {"seq": 0, "t": self.clock.now(), "kind": kind}
        if fields:
            for k in ("seq", "t", "kind"):
                if k in fields:       # reserved keys degrade, never
                    fields[k + "_"] = fields.pop(k)   # clobber/crash
            ev.update(fields)
        with self._lock:
            seq = self._seq
            ev["seq"] = seq
            self._ring[seq % self.capacity] = ev
            self._seq = seq + 1
        return seq

    # ------------------------------------------------------------ query
    def events(self, last=None, kind=None):
        """The retained events, oldest first (shallow copies — callers
        may annotate them freely). ``last`` keeps only the most recent
        N AFTER the optional ``kind`` filter; without a filter only
        that window is copied, so a postmortem capture on a failure
        path pays O(keep_events), not O(capacity)."""
        with self._lock:
            n = min(self._seq, self.capacity)
            if kind is None and last is not None:
                n = min(n, int(last))
            start = self._seq - n
            out = [dict(self._ring[i % self.capacity])
                   for i in range(start, self._seq)]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
            if last is not None:
                out = out[-int(last):]
        return out

    def __len__(self):
        with self._lock:
            return min(self._seq, self.capacity)

    @property
    def total(self):
        """Events recorded over the recorder's lifetime (>= len(self)
        once the ring has wrapped)."""
        with self._lock:
            return self._seq

    def clear(self):
        with self._lock:
            self._ring = [None] * self.capacity
            self._seq = 0
            self._postmortems.clear()

    # ------------------------------------------------------- postmortem
    def postmortem(self, reason, **sections):
        """Capture a bundle: the last ``keep_events`` ring events plus
        the caller's state ``sections`` (plain data — the bundle is
        served as JSON). Returns the bundle dict, or None when
        disabled. ``reason``/``t``/``events`` are reserved keys."""
        if not self.enabled:
            return None
        bundle = {"reason": reason, "t": self.clock.now(),
                  "events": self.events(last=self.keep_events)}
        bundle.update(sections)
        with self._lock:
            self._postmortems.append(bundle)
            seq, self._pm_file_seq = self._pm_file_seq, \
                self._pm_file_seq + 1
        if self.postmortem_dir is not None:
            self._persist(seq, bundle)     # I/O outside the lock
        return bundle

    def _persist(self, seq, bundle):
        """Write one bundle to ``postmortem_dir`` atomically (tmp +
        rename — a crash mid-write leaves a tmp file, never a torn
        bundle) and prune to the newest ``max_postmortems`` files.
        Best-effort: disk failures during an incident must not break
        the in-memory capture."""
        import json
        import os
        if self._max_postmortems <= 0:
            return          # retention of zero keeps zero files
        try:
            name = f"postmortem-{seq:08d}.json"
            tmp = os.path.join(self.postmortem_dir,
                               f".{name}.{os.getpid()}.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.postmortem_dir, name))
            kept = sorted(fn for fn in os.listdir(self.postmortem_dir)
                          if fn.startswith("postmortem-")
                          and fn.endswith(".json"))
            for fn in kept[:-self._max_postmortems]:
                os.remove(os.path.join(self.postmortem_dir, fn))
        except OSError:
            self.persist_errors += 1

    def postmortems(self):
        """Retained bundles, oldest first (the store is bounded —
        newest ``max_postmortems`` win)."""
        with self._lock:
            return list(self._postmortems)
