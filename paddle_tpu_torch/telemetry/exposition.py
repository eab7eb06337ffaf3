"""Prometheus text exposition + a minimal scrape endpoint.

Copied from ``paddle_tpu/telemetry/exposition.py`` (framework-free).

``render_prometheus`` serializes a ``MetricRegistry`` in text format
0.0.4 (the format every Prometheus-compatible scraper speaks);
``parse_prometheus`` is the inverse for the sample lines — it exists so
tests can assert the exposition ROUND-TRIPS (render -> parse -> same
values), not for scraping production endpoints.

``merge_snapshots`` folds N registry snapshots (one per replica) into
one fleet-wide snapshot — counters and gauges sum, histograms sum
bucket-wise (bounds must agree) plus sum/count, labeled children merge
by label values — and ``render_snapshot`` serializes any snapshot, so
``render_snapshot(merge_snapshots(...))`` is ONE Prometheus page for
the whole fleet (``ReplicaRouter.fleet_metrics()``; round-trippable
through ``parse_prometheus``). Gauges SUM across replicas — right for
depths/occupancy/pool pages — EXCEPT gauges named ``*_ratio``, which
fold by arithmetic mean (summing two replicas' 0.7 goodput ratios
into an impossible 1.4 would be exactly the page no scraper could
trust).

Gauges that are RATIOS but not named ``*_ratio`` opt into mean-folding
via ``MEAN_GAUGES`` (today: ``serving_mfu`` — two replicas at 0.4 MFU
are a 0.4-MFU fleet, not 0.8).

``MetricsServer`` is a stdlib ThreadingHTTPServer exposing
- ``/metrics`` — Prometheus text (scrape target),
- ``/stats``   — the registry snapshot as JSON plus any extra
  process-level stats the owner passes (e.g. the batching server's
  ``stats`` dict), for humans and ad-hoc dashboards, and
- ``/healthz`` — when a ``health`` callback is wired (see
  ``inference.serving.serve_metrics``): 200 with ``{"state": ...}``
  while the server is healthy or degraded, 503 while draining or dead
  — the load-balancer / readiness contract; with an ``slo_states``
  callback also wired the body carries an ``"slo"`` detail (worst
  alert state + the non-ok alerts) read from the engine's CACHED
  states — a probe stays one health read plus a dict copy, never a
  fleet evaluation, and a failing detail is dropped rather than
  allowed to kill the probe (the 200/503 verdict survives telemetry
  errors),
- ``/fleet``   — when a ``fleet`` callback is wired (a router):
  ONE merged Prometheus page across every replica's registry (a merge
  error answers 500 + error JSON, like ``/slo``),
- ``/slo``     — when an ``slo`` callback is wired (a router with an
  ``SLOEngine``): the burn-rate report as JSON. Each GET evaluates —
  ``/slo`` scrapes are THE alerting cadence (point your scraper
  here); an evaluation error answers 500 with the error body instead
  of a dropped connection,
- ``/debug/journey/<rid>`` — when a ``journey`` callback is wired (a
  router with a ``JourneyRecorder``): the request's fleet-wide phase
  timeline as JSON; 404 for an unknown/evicted rid,
- ``/debug/postmortem`` — when a ``postmortem`` callback is wired (a
  server/router with a ``FlightRecorder``): the captured incident
  bundles as JSON.
"""
import json
import threading

__all__ = ["render_prometheus", "render_snapshot", "merge_snapshots",
           "parse_prometheus", "MetricsServer", "snapshot_json"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# ratio-semantics gauges whose names don't end in "_ratio": folded by
# MEAN in merge_snapshots like the *_ratio family
MEAN_GAUGES = frozenset({"serving_mfu"})


def _escape_help(s):
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s):
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_value(v):
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(names, values, extra=()):
    pairs = [f'{n}="{_escape_label(str(v))}"'
             for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry):
    """Serialize every instrument in ``registry`` (text format 0.0.4)."""
    return render_snapshot(registry.snapshot())


def render_snapshot(snap):
    """Serialize a registry SNAPSHOT (``MetricRegistry.snapshot()``
    shape — or a ``merge_snapshots`` fold of several) in text format
    0.0.4."""
    out = []
    for name in sorted(snap):
        m = snap[name]
        if m["help"]:
            out.append(f"# HELP {name} {_escape_help(m['help'])}")
        out.append(f"# TYPE {name} {m['kind']}")
        lnames = m["labelnames"]
        for lvalues in sorted(m["samples"]):
            sample = m["samples"][lvalues]
            if m["kind"] == "histogram":
                for le, cum in sample["buckets"]:
                    le_s = "+Inf" if le == "+Inf" else _fmt_value(le)
                    out.append(
                        f"{name}_bucket"
                        f"{_labels_str(lnames, lvalues, [('le', le_s)])}"
                        f" {_fmt_value(cum)}")
                out.append(f"{name}_sum{_labels_str(lnames, lvalues)} "
                           f"{repr(float(sample['sum']))}")
                out.append(f"{name}_count{_labels_str(lnames, lvalues)} "
                           f"{_fmt_value(sample['count'])}")
            else:
                out.append(f"{name}{_labels_str(lnames, lvalues)} "
                           f"{_fmt_value(sample)}")
    return "\n".join(out) + "\n"


def merge_snapshots(snapshots):
    """Fold registry snapshots (one per replica) into one fleet-wide
    snapshot of the same shape. Counters and gauges SUM; histograms
    sum bucket-wise (identical bounds required) plus ``sum``/``count``;
    labeled children merge by label-value tuple (a child present on
    one replica only passes through). Gauges named ``*_ratio`` — plus
    the ratio-semantics names in ``MEAN_GAUGES`` (``serving_mfu``) —
    fold by MEAN over the replicas that report them (a ratio has no
    meaningful sum). A metric registered with a different kind or
    labelnames on different replicas is a config error and raises —
    silently mixing them would render a page no scraper could trust.
    Inputs are never mutated."""
    merged = {}
    ratio_n = {}                 # (name, key) -> replicas contributing
    for snap in snapshots:
        for name, m in snap.items():
            cur = merged.get(name)
            if cur is None:
                cur = merged[name] = {
                    "kind": m["kind"], "help": m["help"],
                    "labelnames": tuple(m["labelnames"]), "samples": {}}
            elif cur["kind"] != m["kind"] \
                    or cur["labelnames"] != tuple(m["labelnames"]):
                raise ValueError(
                    f"metric {name!r} disagrees across replicas: "
                    f"{cur['kind']}{cur['labelnames']} vs "
                    f"{m['kind']}{tuple(m['labelnames'])}")
            for key, s in m["samples"].items():
                have = cur["samples"].get(key)
                if m["kind"] == "histogram":
                    if have is None:
                        cur["samples"][key] = {
                            "buckets": [(le, c) for le, c in
                                        s["buckets"]],
                            "sum": s["sum"], "count": s["count"]}
                        continue
                    if [le for le, _ in have["buckets"]] \
                            != [le for le, _ in s["buckets"]]:
                        raise ValueError(
                            f"histogram {name!r} bucket bounds "
                            f"disagree across replicas")
                    have["buckets"] = [
                        (le, a + b) for (le, a), (_, b)
                        in zip(have["buckets"], s["buckets"])]
                    have["sum"] += s["sum"]
                    have["count"] += s["count"]
                else:
                    cur["samples"][key] = \
                        (0.0 if have is None else have) + s
                    if m["kind"] == "gauge" \
                            and (name.endswith("_ratio")
                                 or name in MEAN_GAUGES):
                        k = (name, key)
                        ratio_n[k] = ratio_n.get(k, 0) + 1
    for (name, key), n in ratio_n.items():
        merged[name]["samples"][key] /= n
    return merged


def snapshot_json(registry):
    """Registry snapshot re-keyed for JSON: the tuple-keyed ``samples``
    map becomes a list of ``{"labels": {...}, "value"|histogram
    fields}`` entries (the ``/stats`` payload)."""
    out = {}
    for name, m in registry.snapshot().items():
        samples = []
        for lvalues, sample in sorted(m["samples"].items()):
            entry = {"labels": dict(zip(m["labelnames"], lvalues))}
            if m["kind"] == "histogram":
                entry.update(
                    {"buckets": [[str(le), c]
                                 for le, c in sample["buckets"]],
                     "sum": sample["sum"], "count": sample["count"]})
            else:
                entry["value"] = sample
            samples.append(entry)
        out[name] = {"kind": m["kind"], "help": m["help"],
                     "samples": samples}
    return out


def _parse_labels(s):
    """``a="x",b="y"`` -> tuple of (name, value) pairs (unescaped)."""
    pairs, i = [], 0
    while i < len(s):
        eq = s.index("=", i)
        name = s[i:eq].strip()
        if s[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {s[eq:]!r}")
        j, val = eq + 2, []
        while s[j] != '"':
            if s[j] == "\\":
                nxt = s[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
            else:
                val.append(s[j])
                j += 1
        pairs.append((name, "".join(val)))
        i = j + 1
        if i < len(s) and s[i] == ",":
            i += 1
    return tuple(pairs)


def parse_prometheus(text):
    """Parse exposition text back into
    ``{(metric_name, ((label, value), ...)): float}`` — the inverse of
    ``render_prometheus`` over sample lines (HELP/TYPE lines are
    validated for shape and skipped)."""
    samples = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"malformed comment line: {line!r}")
            continue
        if "{" in line:
            name = line[:line.index("{")]
            rest = line[line.index("{") + 1:]
            labels_s, _, value_s = rest.rpartition("}")
            labels = _parse_labels(labels_s)
        else:
            name, _, value_s = line.partition(" ")
            labels = ()
        key = (name, labels)
        if key in samples:
            raise ValueError(f"duplicate sample {key}")
        samples[key] = float(value_s)
    return samples


class _Handler:
    """Request handler factory bound to a registry (built lazily so the
    http.server import stays off the non-serving path)."""

    def __new__(cls, registry, extra_stats, health=None, journey=None,
                postmortem=None, fleet=None, slo=None,
                slo_states=None):
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                path = self.path.split("?", 1)[0]
                status = 200
                if path == "/metrics":
                    body = render_prometheus(registry).encode()
                    ctype = CONTENT_TYPE
                elif path == "/fleet" and fleet is not None:
                    # one merged Prometheus page for the whole fleet.
                    # Same hardening as /slo: a merge error (mixed-
                    # version fleet registries disagreeing) answers
                    # 500, never a dropped connection
                    try:
                        body = fleet().encode()
                        ctype = CONTENT_TYPE
                    except Exception as e:
                        status = 500
                        body = json.dumps({"error": repr(e)}).encode()
                        ctype = "application/json"
                elif path == "/slo" and slo is not None:
                    # each GET evaluates the burn rates NOW (alerting
                    # is scrape-driven; tests drive evaluate() on a
                    # FakeClock instead). An evaluation error — e.g. a
                    # mixed-version fleet whose registries disagree —
                    # answers 500 with the error, not a dropped
                    # connection
                    try:
                        payload = {"slos": slo()}
                    except Exception as e:
                        status = 500
                        payload = {"error": repr(e)}
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                elif path == "/stats":
                    stats = {"metrics": snapshot_json(registry)}
                    if extra_stats is not None:
                        stats["stats"] = extra_stats()
                    body = json.dumps(stats, default=str).encode()
                    ctype = "application/json"
                elif path == "/debug/postmortem" and postmortem is not None:
                    # the captured incident bundles (recent recorder
                    # events + frozen pool/routing state), newest last
                    body = json.dumps({"postmortems": postmortem()},
                                      default=str).encode()
                    ctype = "application/json"
                elif path.startswith("/debug/journey/") \
                        and journey is not None:
                    rid = path[len("/debug/journey/"):]
                    timeline = journey(rid)
                    if timeline is None:
                        self.send_error(404, "unknown journey")
                        return
                    body = json.dumps({"rid": rid, "journey": timeline},
                                      default=str).encode()
                    ctype = "application/json"
                elif path == "/healthz" and health is not None:
                    # the serving verdict lives in ONE place
                    # (reliability.health, shared with the admission
                    # gate); late import keeps telemetry loadable
                    # without the reliability package on odd paths
                    from ..reliability.health import is_serving_state
                    state = health()
                    status = 200 if is_serving_state(state) else 503
                    payload = {"state": state}
                    if slo_states is not None:
                        # fold the SLO verdict into the health DETAIL
                        # — from the engine's CACHED states (the last
                        # /slo evaluation), so a probe never pays a
                        # fleet evaluation and probe frequency never
                        # becomes the alert cadence. Best-effort, and
                        # it never flips the 200/503 verdict: a
                        # paging (or crashing) SLO layer on a serving
                        # fleet must not make the LB drain it
                        try:
                            from .slo import OK, STATE_CODES
                            states = slo_states()
                            payload["slo"] = {
                                "worst": max(
                                    states.values(), default=OK,
                                    key=STATE_CODES.__getitem__),
                                "alerts": {n: s
                                           for n, s in states.items()
                                           if s != OK}}
                        except Exception:
                            pass        # detail dropped, probe lives
                    body = json.dumps(payload, default=str).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):    # keep scrapes out of stderr
                pass

        return Handler


class MetricsServer:
    """Background scrape endpoint for one registry.

    >>> ms = MetricsServer(registry, port=0).start()   # 0 = ephemeral
    >>> ms.url            # http://127.0.0.1:<port>
    >>> ms.close()
    """

    def __init__(self, registry, host="127.0.0.1", port=0,
                 extra_stats=None, health=None, journey=None,
                 postmortem=None, fleet=None, slo=None,
                 slo_states=None):
        self.registry = registry
        self._host = host
        self._port = int(port)
        self._extra = extra_stats
        self._health = health      # () -> health-state name, for /healthz
        self._journey = journey    # (rid str) -> timeline | None, for
        #                            /debug/journey/<rid>
        self._postmortem = postmortem   # () -> [bundle, ...], for
        #                                 /debug/postmortem
        self._fleet = fleet        # () -> merged Prometheus text, /fleet
        self._slo = slo            # () -> burn-rate report (evaluates),
        #                            for /slo
        self._slo_states = slo_states   # () -> {slo: state} CACHED,
        #                                 for the /healthz "slo" detail
        self._httpd = None
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self):
        return f"http://{self._host}:{self.port}"

    def start(self):
        if self._httpd is not None:
            raise RuntimeError("metrics server already started")
        from http.server import ThreadingHTTPServer
        self._httpd = ThreadingHTTPServer(
            (self._host, self._port),
            _Handler(self.registry, self._extra, self._health,
                     self._journey, self._postmortem, self._fleet,
                     self._slo, self._slo_states))
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True)
        self._thread.start()
        return self

    def close(self, timeout=5.0):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=timeout)
            self._httpd = self._thread = None

    def __enter__(self):
        return self.start() if self._httpd is None else self

    def __exit__(self, *a):
        self.close()
