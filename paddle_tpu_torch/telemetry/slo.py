"""Declarative fleet SLOs with multi-window rolling burn rates.

Copied from ``paddle_tpu/telemetry/slo.py`` (framework-free).

An operator's question is never "what is the TTFT p-whatever right
now" — it is "are we burning the error budget fast enough to page a
human". This module turns fleet-merged metrics (``exposition.
merge_snapshots`` over every replica's registry) into exactly that
verdict:

- ``SLO(name, objective, target, window, ...)`` declares one
  objective: ``"ttft"`` / ``"tpot"`` / ``"e2e"`` (a latency histogram
  + a ``threshold``: the fraction of requests at or under the
  threshold must stay >= ``target``) or ``"availability"``
  (``serving_requests_total``: finished / (finished + failed) >=
  ``target``).
- ``SLOEngine.evaluate()`` samples the merged counters on the
  injectable clock, computes the BURN RATE — (bad fraction over the
  window) / (1 - target), i.e. how many times faster than sustainable
  the budget is burning — over TWO rolling windows (``window`` and the
  short ``fast_window``, default window/12), and runs the alert state
  machine: ``page`` when BOTH windows burn at >= ``page_burn``,
  ``warning`` when both >= ``warn_burn``, else ``ok``. Requiring both
  windows is the classic multi-window rule: the long window keeps a
  brief spike from paging, the short window clears the alert promptly
  once the bleeding stops.

Everything is pull-driven and deterministic: ``evaluate()`` is the
only clock read and the only sampling point (the router's ``/slo`` and
``/healthz`` endpoints call it per request; tests drive it directly on
a ``FakeClock`` — no sleeps, no background thread). A DISABLED engine
(``enabled=False``) returns before touching the clock, the lock, or
the snapshot source — the zero-cost contract shared with the flight
recorder and the goodput ledger.

Latency thresholds should sit ON a histogram bucket bound: the good
count is read from the largest bucket whose bound is <= threshold, so
an off-bucket threshold is evaluated conservatively at the bucket
below it.
"""
import threading
from collections import deque

from .clock import MonotonicClock

__all__ = ["SLO", "SLOEngine", "OK", "WARNING", "PAGE", "STATE_CODES"]

OK, WARNING, PAGE = "ok", "warning", "page"
# one mapping serves both the slo_state gauge encoding and the
# severity order SLOEngine.worst() compares by
STATE_CODES = {OK: 0, WARNING: 1, PAGE: 2}

# objective -> the fleet-merged histogram it reads
LATENCY_METRICS = {"ttft": "serving_ttft_seconds",
                   "tpot": "serving_tpot_seconds",
                   "e2e": "serving_e2e_seconds"}
AVAILABILITY = "availability"


class SLO:
    """One declarative objective. ``target`` is the good-event fraction
    to defend (0 < target < 1); ``window`` (seconds) the long rolling
    window; ``fast_window`` the short one (default ``window / 12``,
    the classic 1h/5m shape); ``warn_burn`` / ``page_burn`` the burn
    multiples that trip each alert level on BOTH windows."""

    __slots__ = ("name", "objective", "target", "window", "threshold",
                 "fast_window", "warn_burn", "page_burn")

    def __init__(self, name, objective, target, window, threshold=None,
                 fast_window=None, warn_burn=2.0, page_burn=10.0):
        if objective not in LATENCY_METRICS \
                and objective != AVAILABILITY:
            raise ValueError(
                f"objective must be one of "
                f"{tuple(LATENCY_METRICS) + (AVAILABILITY,)}, "
                f"got {objective!r}")
        if objective in LATENCY_METRICS and threshold is None:
            raise ValueError(
                f"latency objective {objective!r} needs threshold= "
                f"(seconds; put it on a histogram bucket bound)")
        if not 0.0 < float(target) < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        if window <= 0:
            raise ValueError("window must be > 0 seconds")
        if fast_window is None:
            fast_window = window / 12.0
        if not 0 < fast_window <= window:
            raise ValueError("fast_window must be in (0, window]")
        if not 0 < float(warn_burn) <= float(page_burn):
            raise ValueError("need 0 < warn_burn <= page_burn")
        self.name = str(name)
        self.objective = objective
        self.target = float(target)
        self.window = float(window)
        self.threshold = None if threshold is None else float(threshold)
        self.fast_window = float(fast_window)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)


def _counts(slo, snap):
    """(good, total) cumulative event counts for ``slo`` out of a
    merged registry snapshot. Missing metrics read as (0, 0) — no
    traffic, nothing burning."""
    if slo.objective == AVAILABILITY:
        m = snap.get("serving_requests_total")
        if m is None:
            return 0, 0
        try:
            idx = tuple(m["labelnames"]).index("state")
        except ValueError:
            return 0, 0
        good = bad = 0
        for key, v in m["samples"].items():
            if key[idx] == "finished":
                good += v
            elif key[idx] == "failed":
                bad += v
        return good, good + bad
    m = snap.get(LATENCY_METRICS[slo.objective])
    if m is None:
        return 0, 0
    s = m["samples"].get(())
    if s is None:
        return 0, 0
    good = 0
    for le, cum in s["buckets"]:
        if le == "+Inf":
            continue
        if float(le) <= slo.threshold:
            good = cum
    return good, s["count"]


class SLOEngine:
    """Rolling burn-rate evaluator + alert state machine over a
    snapshot source.

    ``source`` is a zero-arg callable returning a (fleet-merged)
    registry snapshot — normally ``ReplicaRouter.fleet_snapshot``; the
    router binds itself when given a bare SLO list. ``registry``
    (optional) publishes ``slo_burn_rate{slo,window}``,
    ``slo_state{slo}`` and ``slo_transitions_total{slo,to}``.
    """

    def __init__(self, slos, source=None, clock=None, registry=None,
                 enabled=True):
        slos = list(slos)
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self.slos = slos
        self.source = source
        self.clock = clock if clock is not None else MonotonicClock()
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._samples = {s.name: [] for s in slos}   # [(t, good, total)]
        self._states = {s.name: OK for s in slos}
        # bounded like every other buffer in this stack: a flapping
        # SLO probed by a load balancer for weeks must not grow a list
        # without limit (newest transitions win)
        self.transitions = deque(maxlen=256)
        #                          [{"t", "slo", "from", "to"}]
        self._g_burn = self._g_state = self._c_trans = None
        self._children = {}
        # optional background evaluator: start(interval)
        self._thread = None
        self._stop_evt = threading.Event()
        self.eval_errors = 0
        self.last_eval_error = None
        if (self.enabled and registry is not None
                and getattr(registry, "enabled", False)):
            self._g_burn = registry.gauge(
                "slo_burn_rate",
                "Error-budget burn multiple per SLO and window (1.0 = "
                "burning exactly the sustainable rate)",
                labelnames=("slo", "window"))
            self._g_state = registry.gauge(
                "slo_state",
                "Alert state per SLO: 0 ok / 1 warning / 2 page",
                labelnames=("slo",))
            self._c_trans = registry.counter(
                "slo_transitions_total",
                "Alert state transitions per SLO, by destination state",
                labelnames=("slo", "to"))

    def bind(self, source):
        """Late-bind the snapshot source (the router does this when it
        is handed a pre-built engine). Returns self."""
        self.source = source
        return self

    # -------------------------------------------- background evaluator
    def start(self, interval=1.0):
        """Run ``evaluate()`` on a background daemon thread every
        ``interval`` (wall-clock) seconds, so the cached ``states()``
        that ``/healthz`` folds into its SLO detail stay fresh without
        depending on anything scraping ``/slo``.
        Sample TIMESTAMPS still come from the injectable ``clock`` —
        only the wake-up cadence is wall time. An evaluation that
        raises is counted (``eval_errors`` / ``last_eval_error``) and
        the thread keeps going: a flaky snapshot source must not
        silently stop alerting. No-op (no thread) when disabled.
        Returns self."""
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        if not self.enabled:
            return self
        if self._thread is not None:
            raise RuntimeError("SLO engine already started")
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval):
                try:
                    self.evaluate()
                except Exception as e:
                    self.eval_errors += 1
                    self.last_eval_error = e

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def close(self, timeout=5.0):
        """Stop the background evaluator (if any) and JOIN its thread.
        Idempotent; the engine remains usable for pull-driven
        ``evaluate()`` calls afterwards."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise RuntimeError(
                    f"SLO evaluator thread did not stop within "
                    f"{timeout}s (an evaluate() call is wedged)")
            self._thread = None

    # ------------------------------------------------------- evaluate
    def evaluate(self):
        """Sample the source once and return the per-SLO report:
        ``[{"name", "objective", "state", "sli", "burn": {"long",
        "short"}, "target", "window", "good", "total"}, ...]``.
        Disabled engines return ``[]`` before reading the clock,
        taking the lock, or calling the source."""
        if not self.enabled:
            return []
        t = self.clock.now()
        snap = self.source()
        report = []
        with self._lock:
            for slo in self.slos:
                good, total = _counts(slo, snap)
                samples = self._samples[slo.name]
                samples.append((t, float(good), float(total)))
                # retain one sample at-or-before the long cutoff so
                # the full window always has a base to diff against
                cutoff = t - slo.window
                while len(samples) >= 2 and samples[1][0] <= cutoff:
                    samples.pop(0)
                burn_long, sli = self._burn(slo, samples, t, slo.window)
                burn_short, _ = self._burn(slo, samples, t,
                                           slo.fast_window)
                worst = min(burn_long, burn_short)   # both-window rule
                if worst >= slo.page_burn:
                    state = PAGE
                elif worst >= slo.warn_burn:
                    state = WARNING
                else:
                    state = OK
                prev = self._states[slo.name]
                if state != prev:
                    self._states[slo.name] = state
                    self.transitions.append(
                        {"t": t, "slo": slo.name, "from": prev,
                         "to": state})
                    if self._c_trans is not None:
                        self._c_trans.labels(slo=slo.name,
                                             to=state).inc()
                if self._g_burn is not None:
                    self._gauge(slo.name, "long").set(burn_long)
                    self._gauge(slo.name, "short").set(burn_short)
                    self._g_state.labels(slo=slo.name).set(
                        STATE_CODES[state])
                report.append({
                    "name": slo.name, "objective": slo.objective,
                    "state": state, "sli": sli,
                    "burn": {"long": burn_long, "short": burn_short},
                    "target": slo.target, "window": slo.window,
                    "good": good, "total": total,
                })
        return report

    def _gauge(self, name, window):
        key = (name, window)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = \
                self._g_burn.labels(slo=name, window=window)
        return child

    @staticmethod
    def _burn(slo, samples, t, window):
        """(burn multiple, sli) over the trailing ``window``: diff the
        newest sample against the newest sample at-or-before the
        cutoff (or the oldest retained — a partially covered window is
        evaluated over what exists). No events in the window = no
        burn (sli 1.0)."""
        cutoff = t - window
        base = samples[0]
        for s in samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        cur = samples[-1]
        dtotal = cur[2] - base[2]
        if dtotal <= 0:
            return 0.0, 1.0
        bad_frac = max(0.0, (dtotal - (cur[1] - base[1])) / dtotal)
        return bad_frac / (1.0 - slo.target), 1.0 - bad_frac

    # ----------------------------------------------------------- read
    def states(self):
        """{slo name: current alert state} (from the last evaluate)."""
        with self._lock:
            return dict(self._states)

    def state(self, name):
        with self._lock:
            return self._states[name]

    @staticmethod
    def worst(report):
        """The most severe state in an ``evaluate()`` report (``ok``
        for an empty report) — the ``/healthz`` detail verdict."""
        worst = OK
        for entry in report:
            if STATE_CODES[entry["state"]] > STATE_CODES[worst]:
                worst = entry["state"]
        return worst
