"""Injectable monotonic clocks for the telemetry subsystem.

Every time read in telemetry goes through a clock object so tests can
drive TTFT/TPOT/queue-wait assertions deterministically: production code
uses ``MonotonicClock`` (``time.perf_counter``), tests inject a
``FakeClock`` and ``advance()`` it between scripted server calls — no
sleeps, exact histogram values.
"""
import time

__all__ = ["MonotonicClock", "FakeClock"]


class MonotonicClock:
    """Wall clock for production: monotonic, sub-microsecond."""

    __slots__ = ()

    def now(self):
        return time.perf_counter()


class FakeClock:
    """Manually-advanced clock for tests. ``reads`` counts ``now()``
    calls — the disabled-telemetry contract ("no clock reads on the hot
    path") is asserted against it, not against flaky wall time."""

    __slots__ = ("_t", "reads")

    def __init__(self, t0=0.0):
        self._t = float(t0)
        self.reads = 0

    def now(self):
        self.reads += 1
        return self._t

    def advance(self, dt):
        if dt < 0:
            raise ValueError("a monotonic clock cannot go backwards")
        self._t += float(dt)
        return self._t
