"""Lightweight host-side trace spans on an injectable clock.

``Tracer`` collects named spans (context manager, decorator, or
explicit ``begin_span``/``Span.end`` for ranges that open and close on
different call paths — e.g. a request's *queued* span opens in
``submit()`` and closes on the serve thread). Export is Chrome-trace
JSON (``chrome://tracing`` / Perfetto "traceEvents" with complete 'X'
events), the format ``torch.profiler``'s traces export to.

Copied from ``paddle_tpu/telemetry/tracing.py``. Interop with
``torch.profiler``:
- ``annotate=True`` mirrors every span into a
  ``torch.profiler.record_function(name)`` range, so spans show up in a
  trace that ``torch.profiler.profile`` captures (a span must open and
  close while the profiler runs to be recorded there). Off by default.
- spans are host-side: on the card they time the host's view, which
  includes device work only where the host waits for it.

A disabled tracer returns a shared null span and performs NO clock
reads — the hot-path off switch mirrors ``MetricRegistry``.
"""
import functools
import json
import threading

from .clock import MonotonicClock

__all__ = ["Tracer", "Span", "NullSpan", "NULL_SPAN"]


class NullSpan:
    """No-op span (disabled tracer / overflowed buffer)."""

    __slots__ = ()

    def set(self, **args):
        return self

    def end(self, **args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = NullSpan()


class Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_tid", "_record")

    def __init__(self, tracer, name, args, t0, tid, record):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = t0
        self._tid = tid
        self._record = record     # mirrored record_function or None

    def set(self, **args):
        """Attach/override span args before it ends."""
        self.args.update(args)
        return self

    def end(self, **args):
        if self._tracer is None:      # double end() is a no-op
            return
        if args:
            self.args.update(args)
        tracer, self._tracer = self._tracer, None
        if self._record is not None:
            self._record.__exit__(None, None, None)
        tracer._finish(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class Tracer:
    """Bounded in-memory span collector.

    >>> tr = Tracer()
    >>> with tr.span("prefill", tokens=128):
    ...     ...
    >>> tr.export_chrome_trace("/tmp/trace.json")

    ``max_events`` bounds memory on long-running servers: past it, new
    spans become null spans (``dropped`` counts them).
    """

    def __init__(self, clock=None, enabled=True, annotate=False,
                 max_events=100_000):
        self.clock = clock if clock is not None else MonotonicClock()
        self.enabled = bool(enabled)
        self.annotate = bool(annotate)
        self.max_events = int(max_events)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events = []

    # ------------------------------------------------------------- spans
    def span(self, name, **args):
        if not self.enabled:
            return NULL_SPAN
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return NULL_SPAN
        record = None
        if self.annotate:
            import torch
            record = torch.profiler.record_function(name)
            record.__enter__()
        return Span(self, name, dict(args), self.clock.now(),
                    threading.get_ident(), record)

    begin_span = span     # explicit-end alias for cross-scope lifecycles

    def trace(self, name=None):
        """Decorator form: ``@tracer.trace("step")``."""
        def wrap(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*a, **kw):
                with self.span(label):
                    return fn(*a, **kw)
            return inner
        return wrap

    def _finish(self, span):
        t1 = self.clock.now()
        ev = {"name": span.name, "ph": "X", "pid": 0, "tid": span._tid,
              "ts": span._t0 * 1e6, "dur": (t1 - span._t0) * 1e6}
        if span.args:
            ev["args"] = span.args
        with self._lock:
            self._events.append(ev)

    def instant(self, name, **args):
        """Zero-duration marker event."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "pid": 0,
              "tid": threading.get_ident(), "ts": self.clock.now() * 1e6,
              "s": "t"}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self.dropped += 1

    # ------------------------------------------------------------ export
    def events(self):
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events = []
            self.dropped = 0

    def export_chrome_trace(self, file):
        """Write Chrome-trace JSON; ``file`` is a path or file object.
        Returns the event count."""
        payload = {"traceEvents": self.events(),
                   "displayTimeUnit": "ms"}
        if hasattr(file, "write"):
            json.dump(payload, file)
        else:
            with open(file, "w") as f:
                json.dump(payload, f)
        return len(payload["traceEvents"])
