"""Tick-loop supervision: retry/backoff + circuit-breaker bookkeeping.

Copied from ``paddle_tpu/reliability/supervisor.py`` (framework-free).

``ServeSupervisor`` is the policy brain the continuous-batching serve
thread consults around every tick. It owns no threads and takes no
locks — the loop calls ``allow()`` before a tick, then exactly one of
``success()`` / ``failure(exc)`` after it. ``failure`` sleeps the
retry backoff (so call it WITHOUT holding the server lock) and answers
what the loop must do next:

- ``"retry"``: transient — backoff already slept, run the tick again.
- ``"open"``:  the breaker just opened — fail waiters, flip health to
  degraded, and idle until the cooldown admits a half-open probe.
"""
from .retry import CircuitBreaker, RetryPolicy

__all__ = ["ServeSupervisor"]


class ServeSupervisor:
    def __init__(self, retry=None, breaker=None):
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.attempt = 0              # consecutive-failure backoff rung
        self.retries_total = 0
        self.last_error = None

    def allow(self):
        """May the loop run a tick now? False only while the breaker is
        open and its cooldown has not elapsed."""
        return self.breaker.allow()

    def success(self):
        self.attempt = 0
        self.last_error = None
        self.breaker.record_success()

    def failure(self, exc):
        """Record a tick failure; sleeps the backoff on "retry"."""
        self.last_error = exc
        self.retries_total += 1
        if self.breaker.record_failure():
            self.attempt = 0
            return "open"
        self.retry.sleep(self.attempt)
        self.attempt += 1
        return "retry"
