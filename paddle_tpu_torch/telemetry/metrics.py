"""Thread-safe metric registry: Counter / Gauge / fixed-bucket Histogram.

Copied from ``paddle_tpu/telemetry/metrics.py`` (framework-free).

Prometheus-shaped surface (labels, text exposition via
``telemetry.exposition``) without the client-library dependency — the
container is frozen, and the serving hot path needs tighter guarantees
than prometheus_client gives:

- a DISABLED registry hands out shared null instruments whose methods
  are single-statement no-ops: no locks, no allocation, no clock reads.
  Instrumented code keeps one code path; the off switch costs an
  attribute call.
- instruments are host-side only. Nothing here may be called from
  jit-traced code (values are plain floats, not arrays).

Label values are bound up front with ``labels(**kv)`` (returns a child
handle callers should cache); unlabeled instruments are their own child.
"""
import bisect
import threading

__all__ = ["MetricRegistry", "Counter", "Gauge", "Histogram",
           "NullInstrument", "NULL_INSTRUMENT", "DEFAULT_BUCKETS"]

# Latency-oriented default upper bounds (seconds): decode ticks are
# milliseconds, queue waits under load are seconds.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class NullInstrument:
    """Shared no-op stand-in for every instrument kind when the registry
    is disabled. ``labels()`` returns itself so cached child handles are
    also free."""

    __slots__ = ()

    def labels(self, **kv):
        return self

    def inc(self, value=1.0):
        pass

    def dec(self, value=1.0):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    @property
    def value(self):
        return 0.0


NULL_INSTRUMENT = NullInstrument()


def _check_labels(labelnames, kv):
    if set(kv) != set(labelnames):
        raise ValueError(f"expected labels {tuple(labelnames)}, got "
                         f"{tuple(sorted(kv))}")
    return tuple(str(kv[n]) for n in labelnames)


class _Instrument:
    kind = None

    def __init__(self, name, help="", labelnames=()):  # noqa: A002
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children = {}
        if not self.labelnames:     # unlabeled: one implicit child
            self._children[()] = self._new_child()

    def labels(self, **kv):
        key = _check_labels(self.labelnames, kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(f"metric {self.name!r} has labels "
                             f"{self.labelnames}; bind them with "
                             f".labels(...) first")
        return self._children[()]

    def samples(self):
        """{labelvalues_tuple: child_snapshot} (point-in-time copy)."""
        with self._lock:
            return {k: c.snapshot() for k, c in self._children.items()}


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, value=1.0):
        if value < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += value

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Counter(_Instrument):
    kind = "counter"
    _new_child = staticmethod(_CounterChild)

    def inc(self, value=1.0):
        self._default_child().inc(value)

    @property
    def value(self):
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def inc(self, value=1.0):
        with self._lock:
            self._value += value

    def dec(self, value=1.0):
        with self._lock:
            self._value -= value

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return self._value


class Gauge(_Instrument):
    kind = "gauge"
    _new_child = staticmethod(_GaugeChild)

    def set(self, value):
        self._default_child().set(value)

    def inc(self, value=1.0):
        self._default_child().inc(value)

    def dec(self, value=1.0):
        self._default_child().dec(value)

    @property
    def value(self):
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds):
        self._lock = threading.Lock()
        self._bounds = bounds            # sorted upper bounds, no +Inf
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def snapshot(self):
        """Cumulative Prometheus shape: [(le, cum_count)...] ending at
        ('+Inf', count), plus sum/count."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
        cum, buckets = 0, []
        for le, c in zip(self._bounds, counts):
            cum += c
            buckets.append((le, cum))
        buckets.append(("+Inf", n))
        return {"buckets": buckets, "sum": s, "count": n}


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),  # noqa: A002
                 buckets=DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if len(set(bounds)) != len(bounds):
            raise ValueError(f"duplicate bucket bounds in {buckets}")
        self.buckets = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value):
        self._default_child().observe(value)

    @property
    def count(self):
        return self._default_child().count

    @property
    def sum(self):
        return self._default_child().sum


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Named instrument registry. Registration is idempotent — asking
    for an existing name with the same kind and labelnames returns the
    SAME instrument (instrumented modules can be re-imported / servers
    re-created against one registry); a conflicting re-registration
    raises.

    ``enabled=False`` freezes the registry as a null sink: every
    ``counter()``/``gauge()``/``histogram()`` call returns the shared
    ``NULL_INSTRUMENT`` and ``snapshot()`` is empty. The flag is fixed
    at construction so instrument handles cached by callers never need
    revalidation on the hot path.
    """

    def __init__(self, enabled=True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_make(self, cls, name, help, labelnames, **kw):  # noqa: A002
        if not self.enabled:
            return NULL_INSTRUMENT
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != labelnames or \
                        kw.get("buckets") is not None and \
                        tuple(sorted(float(b) for b in kw["buckets"])) \
                        != m.buckets:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                return m
            m = cls(name, help, labelnames, **{k: v
                                               for k, v in kw.items()
                                               if v is not None})
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):  # noqa: A002
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):  # noqa: A002
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),  # noqa: A002
                  buckets=None):
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self):
        """{name: {"kind", "help", "labelnames", "samples"}} — a plain-
        data copy safe to serialize (``/stats`` JSON payload)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"kind": m.kind, "help": m.help,
                         "labelnames": m.labelnames,
                         "samples": m.samples()}
                for m in metrics}

    def render(self):
        """Prometheus text exposition (format 0.0.4)."""
        from .exposition import render_prometheus
        return render_prometheus(self)
