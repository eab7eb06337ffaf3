"""paddle_tpu_torch.telemetry — runtime observability subsystem.

Port of ``paddle_tpu/telemetry``: the modules are framework-free and
copied, except ``costs`` (an analytic price in place of XLA's cost
analysis) and the tracer's mirror (``torch.profiler.record_function``
in place of the profiler's ``RecordEvent``). Metrics + tracing, built
for the serving/training stack:

- ``MetricRegistry`` / ``Counter`` / ``Gauge`` / ``Histogram``
  (metrics.py): thread-safe, labeled, snapshot + Prometheus text
  exposition. A disabled registry hands out no-op instruments — zero
  locks and zero clock reads on the hot path.
- ``Tracer`` / ``Span`` (tracing.py): host-side trace spans on an
  injectable clock, Chrome-trace JSON export, optional mirroring into
  ``torch.profiler.record_function`` so spans land inside a
  ``torch.profiler`` trace.
- ``MetricsServer`` (exposition.py): ``/metrics`` (Prometheus text) +
  ``/stats`` (JSON) scrape endpoint, plus ``/debug/journey/<rid>`` and
  ``/debug/postmortem`` when the owner wires them.
- ``FlightRecorder`` (flight.py): bounded ring of structured server
  events + postmortem bundles (optionally persisted to disk) — the
  "what just happened" companion to the aggregate metrics.
- ``GoodputLedger`` (goodput.py): per-tick attribution of every device
  token to goodput or a named waste reason (null redirects, chunk pad,
  masked page DMAs, preemption replay, registered-tail re-prefill,
  block waste) — conservation-checked, the perf-tier baseline.
- ``CostCatalog`` (costs.py): priced-program catalog + compile watch +
  tick-phase attribution — every dispatch priced in FLOPs/bytes by an
  analytic model (``models.costs``), new tick shapes after warmup
  surfaced, MFU/roofline gauges.
- ``SLO`` / ``SLOEngine`` (slo.py): declarative fleet SLOs over the
  merged metrics, multi-window rolling burn rates on the injectable
  clock, ok/warning/page alert states.
- ``JourneyRecorder`` / ``Journey`` (journey.py): per-request fleet
  timelines (trace id minted at the router, handles rebound per hop)
  merged into one Perfetto trace with cross-replica flow events.
- ``ServerTelemetry`` (serving.py): the continuous-batching server's
  SLO instrumentation — TTFT/TPOT/queue-wait, tick occupancy, page-pool
  gauges, prefix-cache counters, per-request lifecycle spans.
- ``TelemetryCallback`` (training.py): hapi bridge for step time,
  loss, tokens/s.
- ``MonotonicClock`` / ``FakeClock`` (clock.py): every time read is
  injectable; tests script exact latencies with a fake clock.

``default_registry()`` returns the process-wide registry (enabled;
opt-in wiring — nothing publishes to it unless you pass it somewhere).
"""
from .clock import FakeClock, MonotonicClock  # noqa: F401
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge,  # noqa: F401
                      Histogram, MetricRegistry, NULL_INSTRUMENT,
                      NullInstrument)
from .tracing import NULL_SPAN, NullSpan, Span, Tracer  # noqa: F401
from .exposition import (MetricsServer, merge_snapshots,  # noqa: F401
                         parse_prometheus, render_prometheus,
                         render_snapshot)
from .costs import CostCatalog  # noqa: F401
from .flight import FlightRecorder  # noqa: F401
from .goodput import GoodputLedger  # noqa: F401
from .journey import Journey, JourneyRecorder  # noqa: F401
from .serving import RouterTelemetry, ServerTelemetry  # noqa: F401
from .slo import SLO, SLOEngine  # noqa: F401
from .training import TelemetryCallback  # noqa: F401

__all__ = ["MetricRegistry", "Counter", "Gauge", "Histogram",
           "NullInstrument", "NULL_INSTRUMENT", "DEFAULT_BUCKETS",
           "Tracer", "Span", "NullSpan", "NULL_SPAN",
           "MonotonicClock", "FakeClock",
           "MetricsServer", "render_prometheus", "render_snapshot",
           "merge_snapshots", "parse_prometheus",
           "CostCatalog", "FlightRecorder", "GoodputLedger", "Journey",
           "JourneyRecorder", "SLO", "SLOEngine",
           "ServerTelemetry", "RouterTelemetry", "TelemetryCallback",
           "default_registry"]

_default_registry = None


def default_registry():
    """Process-wide shared registry (created on first use)."""
    global _default_registry
    if _default_registry is None:
        _default_registry = MetricRegistry()
    return _default_registry
