"""Server health state machine.

Copied from ``paddle_tpu/reliability/health.py`` (framework-free). The
server reads it through its ``health`` property and publishes it as the
``server_health`` gauge and on ``/healthz``. Four states:

- ``healthy``  — serving normally.
- ``degraded`` — serving, but the circuit breaker opened recently;
  in-flight work was failed and the engine is probing its way back.
- ``draining`` — ``stop(drain=True)``: admission closed, in-flight
  requests finishing; terminal-bound (can only go to ``dead``).
- ``dead``     — stopped (or the serve thread was lost). Terminal.

Transitions that would move BACKWARD out of a terminal-bound state are
ignored rather than raised: the reliability layer must never crash the
serve loop over its own bookkeeping (e.g. a breaker open racing a
drain just keeps the server ``draining``).
"""

__all__ = ["HEALTHY", "DEGRADED", "DRAINING", "DEAD", "HEALTH_CODES",
           "HealthMonitor", "is_serving_state"]

HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
DEAD = "dead"

# gauge encoding: higher is worse (alert on server_health >= 2)
HEALTH_CODES = {HEALTHY: 0, DEGRADED: 1, DRAINING: 2, DEAD: 3}


def is_serving_state(state):
    """THE serving verdict (admission gate and /healthz share it):
    healthy and degraded still take traffic; draining/dead (or anything
    unknown) must drop out of rotation."""
    return HEALTH_CODES.get(state, HEALTH_CODES[DEAD]) < HEALTH_CODES[DRAINING]


class HealthMonitor:
    """Holds the current state and enforces the transition order.

    ``on_change(state, code)`` fires after every ACCEPTED transition —
    the server uses it to publish the ``server_health`` gauge. The
    caller provides its own locking (the server mutates health under
    its serve lock).

    A RAISING observer never blocks the transition: by the time
    ``on_change`` runs the state is already committed, and health
    transitions happen on failure paths (breaker opens, drains, thread
    death) where an exception would wedge the very machinery doing the
    failing. Observer errors are swallowed and kept in
    ``observer_errors`` (bounded) for inspection instead.
    """

    MAX_OBSERVER_ERRORS = 16

    def __init__(self, on_change=None):
        self.state = HEALTHY
        self._on_change = on_change
        self.observer_errors = []   # [(state, exception)], newest last

    def _notify(self, state):
        if self._on_change is None:
            return
        try:
            self._on_change(state, HEALTH_CODES[state])
        except Exception as e:      # isolate: telemetry must never
            self.observer_errors.append((state, e))   # block health
            del self.observer_errors[:-self.MAX_OBSERVER_ERRORS]

    @property
    def code(self):
        return HEALTH_CODES[self.state]

    @property
    def is_serving(self):
        """Admission + /healthz gate: healthy and degraded still serve."""
        return is_serving_state(self.state)

    def to(self, state):
        """Request a transition; returns the state actually in effect.
        ``dead`` is terminal and ``draining`` only advances to ``dead``
        — invalid requests are ignored (see module docstring)."""
        if state not in HEALTH_CODES:
            raise ValueError(f"unknown health state {state!r}")
        if state == self.state:
            return self.state
        if self.state == DEAD:
            return self.state
        if self.state == DRAINING and state != DEAD:
            return self.state
        self.state = state
        self._notify(state)
        return self.state

    def reset(self):
        """Back to ``healthy`` unconditionally — only for an explicit
        restart (``start()`` after ``stop()``), never mid-flight."""
        changed = self.state != HEALTHY
        self.state = HEALTHY
        if changed:
            self._notify(HEALTHY)
        return self.state
