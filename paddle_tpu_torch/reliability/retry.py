"""Retry backoff and circuit breaking for the supervised loops.

Copied from ``paddle_tpu/reliability/retry.py`` (framework-free), over
the port's ``telemetry.clock``.

Both pieces are deterministic under test: the jitter RNG is seeded, the
breaker's clock is injectable (``telemetry.FakeClock``), and the
policy's ``sleep`` hook lets tests collect requested delays instead of
actually waiting — chaos runs replay exactly, with zero real sleeps.
"""
import random
import threading
import time

from ..telemetry.clock import MonotonicClock

__all__ = ["RetryPolicy", "CircuitBreaker"]


class RetryPolicy:
    """Exponential backoff schedule with bounded, seeded jitter.

    ``delay(attempt)`` for attempt 0, 1, 2, ... is
    ``min(max_delay_s, base_delay_s * multiplier**attempt)`` scaled by a
    uniform jitter in ``[1 - jitter, 1 + jitter]`` — jitter decorrelates
    retry storms across servers while the seeded RNG keeps any single
    run reproducible.

    ``sleep`` (default ``time.sleep``) performs the wait; tests inject a
    recorder or a fake-clock advance so supervised loops never block.
    """

    def __init__(self, base_delay_s=0.01, multiplier=2.0, max_delay_s=1.0,
                 jitter=0.1, seed=0, sleep=None):
        if base_delay_s < 0 or max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if multiplier < 1.0:
            raise ValueError("multiplier must be >= 1 (backoff grows)")
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._sleep = sleep if sleep is not None else time.sleep
        self.slept = []          # delays handed to ``sleep`` (telemetry)

    def delay(self, attempt):
        d = min(self.max_delay_s,
                self.base_delay_s * self.multiplier ** int(attempt))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return d

    def sleep(self, attempt):
        """Back off for ``attempt`` (0-based); returns the delay used."""
        d = self.delay(attempt)
        self.slept.append(d)
        if len(self.slept) > 1000:     # bounded on long-lived servers
            del self.slept[:-500]
        if d > 0:
            self._sleep(d)
        return d


class CircuitBreaker:
    """Consecutive-failure breaker: ``closed`` -> ``open`` after
    ``failure_threshold`` failures in a row, ``open`` -> ``half_open``
    once ``reset_after_s`` elapses (EXACTLY one probe allowed), and any
    success closes it again. A failed probe re-opens immediately.

    ``allow()`` is the gate the serve loop consults before a tick;
    while open (cooldown running) it returns False so the loop idles
    instead of burning failures. In ``half_open`` it hands out a single
    PROBE TOKEN: the first caller gets True and owns the probe, every
    racing caller gets False until the probe resolves via
    ``record_success()`` / ``record_failure()`` — without the token,
    N submits racing the cooldown edge would all hammer a
    still-recovering resource at once.
    A caller that took the token but abandoned the attempt before
    touching the guarded resource (e.g. its request expired first)
    must hand it back with ``release_probe()``.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold=5, reset_after_s=30.0,
                 clock=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock if clock is not None else MonotonicClock()
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at = None
        self.open_total = 0      # cumulative opens (incl. re-opens)
        # half-open single-probe token: mutated only under _lock (the
        # racing submits this token exists to gate ARE concurrent, so
        # an unsynchronized read-then-write would hand two of them the
        # probe), owner-tagged so release_probe() can only return a
        # token its own caller took
        self._lock = threading.Lock()
        self._probe_inflight = False
        self._probe_owner = None

    def allow(self):
        with self._lock:
            if self.state == self.OPEN:
                if self._clock.now() - self.opened_at \
                        >= self.reset_after_s:
                    self.state = self.HALF_OPEN
                    self._probe_inflight = True
                    self._probe_owner = threading.get_ident()
                    return True
                return False
            if self.state == self.HALF_OPEN:
                if self._probe_inflight:
                    return False     # someone already owns the probe
                self._probe_inflight = True
                self._probe_owner = threading.get_ident()
                return True
            return True

    def would_allow(self):
        """``allow()`` WITHOUT the open->half_open / probe-token side
        effects: a pure read for candidate FILTERING (the router scans
        every replica's breaker per routing decision — flipping one
        half-open from a scan that then routes elsewhere would leave
        its gate open with no probe outcome ever recorded). Call
        ``allow()`` only at the point of actually dispatching."""
        with self._lock:
            if self.state == self.OPEN:
                return self._clock.now() - self.opened_at \
                    >= self.reset_after_s
            if self.state == self.HALF_OPEN:
                return not self._probe_inflight
            return True

    def release_probe(self):
        """Hand back an UNRESOLVED half-open probe token: the caller
        took ``allow()`` but abandoned the attempt without touching the
        guarded resource (request expired, replica shed it), so no
        verdict exists — another caller may probe instead. Without this
        an abandoned probe would wedge the breaker half-open forever.
        Owner-checked: a caller whose ``allow()`` passed while CLOSED
        (no token taken) cannot free a token some OTHER thread is
        probing with."""
        with self._lock:
            if self.state == self.HALF_OPEN and self._probe_inflight \
                    and self._probe_owner == threading.get_ident():
                self._probe_inflight = False
                self._probe_owner = None

    def record_success(self):
        with self._lock:
            self.state = self.CLOSED
            self.consecutive_failures = 0
            self.opened_at = None
            self._probe_inflight = False
            self._probe_owner = None

    def record_failure(self):
        """Returns True when this failure OPENED the breaker (the
        caller fails waiters / flips health exactly once per open)."""
        with self._lock:
            self.consecutive_failures += 1
            if (self.state == self.HALF_OPEN
                    or self.consecutive_failures
                    >= self.failure_threshold):
                self.state = self.OPEN
                self.opened_at = self._clock.now()
                self.open_total += 1
                self.consecutive_failures = 0
                self._probe_inflight = False
                self._probe_owner = None
                return True
            return False
