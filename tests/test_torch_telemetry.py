"""The port's telemetry classes against the JAX package's, fed the same
scripted inputs on a ``FakeClock``: the registry and its instruments,
the Prometheus text (byte for byte), the snapshot merge, the tracer and
its Chrome trace, ``MetricsServer`` on the loopback interface,
``SLOEngine``, ``JourneyRecorder``, ``FlightRecorder``,
``ServerTelemetry``, ``RouterTelemetry``, ``GoodputLedger`` and the
training callback. Each script runs once against each package and the
outputs are compared exactly.

Then the port's server against the JAX server with telemetry on: the
port on the torch stub of ``tests/test_torch_preemption.py``, the JAX
server on ``tests/_serving_stub.StubModel`` (the same closed-form
recurrence), both on a ``FakeClock``: every sample of the registry and
every span of the tracer equal, on the dense backend and the paged
pool, split and fused. The tracer's mirror puts its spans in a
``torch.profiler`` trace, and a disabled registry reads no clock.
"""
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.telemetry as JT
import paddle_tpu_torch.telemetry as TT
from _serving_stub import StubModel, stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu_torch.inference import ContinuousBatchingServer
from test_torch_preemption import TorchStub

def _both(script, *args):
    """The script's output on the JAX package and on the port."""
    return script(JT, *args), script(TT, *args)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _samples(reg):
    """A registry's snapshot without the help strings."""
    return {k: (v["kind"], v["samples"]) for k, v in reg.snapshot().items()}


# ------------------------------------------------------------ registry

def _registry_script(T):
    reg = T.MetricRegistry()
    c = reg.counter("req_total", "Requests", labelnames=("state", "code"))
    c.labels(state="ok", code="200").inc()
    c.labels(state="ok", code="200").inc(2.5)
    c.labels(state='we"ird\\', code="5\n0").inc()
    g = reg.gauge("depth", "Queue depth")
    g.set(7)
    g.inc(2)
    g.dec(0.5)
    h = reg.histogram("lat_seconds", "Latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 3.0, 30.0):
        h.observe(v)
    hl = reg.histogram("per_op_seconds", "by op", labelnames=("op",))
    hl.labels(op="decode").observe(0.002)
    hl.labels(op="prefill").observe(0.2)
    same = reg.counter("req_total", "Requests",
                       labelnames=("state", "code")) is c
    errors = []
    for bad in (lambda: reg.gauge("req_total", "x"),
                lambda: reg.counter("req_total", "x", labelnames=("a",)),
                lambda: c.inc(-1),
                lambda: c.labels(state="x"),
                lambda: reg.histogram("h2", "x", buckets=(1.0, 1.0))):
        try:
            bad()
            errors.append(None)
        except Exception as e:
            errors.append((type(e).__name__, str(e)))
    return reg.render(), reg.snapshot(), same, errors, T.DEFAULT_BUCKETS


def _disabled_script(T):
    reg = T.MetricRegistry(enabled=False)
    c = reg.counter("a_total")
    c.inc()
    c.labels(anything="x").inc()
    reg.gauge("g").set(5)
    reg.histogram("h").observe(1.0)
    return (c is T.NULL_INSTRUMENT, reg.snapshot(),
            T.render_prometheus(reg))


def _exposition_script(T):
    r1, r2 = T.MetricRegistry(), T.MetricRegistry()
    for r, k in ((r1, 1), (r2, 2)):
        r.counter("c_total", "c").inc(k)
        r.gauge("serving_goodput_ratio", "g").set(0.2 * k)
        r.gauge("serving_mfu", "m").set(0.1 * k)
        r.histogram("h_seconds", "h", buckets=(0.1, 1.0)).observe(0.3 * k)
        r.counter("lab_total", "l", labelnames=("k",)) \
            .labels(k=f"x{k}").inc(k)
    merged = T.merge_snapshots([r1.snapshot(), r2.snapshot()])
    page = T.render_snapshot(merged)
    errors = []
    r3, r4 = T.MetricRegistry(), T.MetricRegistry()
    r3.counter("x", "x")
    r4.gauge("x", "x")
    try:
        T.merge_snapshots([r3.snapshot(), r4.snapshot()])
    except ValueError as e:
        errors.append(str(e))
    return (page, T.parse_prometheus(page), T.parse_prometheus(r1.render()),
            errors)


@pytest.mark.parametrize("script", [_registry_script, _disabled_script,
                                    _exposition_script],
                         ids=["registry", "disabled", "exposition"])
def test_registry_and_prometheus_text_equal_the_reference(script):
    """Render, snapshot, parse and merge give the JAX package's output,
    the Prometheus text byte for byte."""
    ref, port = _both(script)
    assert port == ref


# --------------------------------------------------------------- tracer

def _tracer_script(T):
    fc = T.FakeClock(10.0)
    tr = T.Tracer(clock=fc, max_events=4)
    with tr.span("prefill", tokens=128) as sp:
        fc.advance(0.5)
        sp.set(extra=1)
    cross = tr.begin_span("request.queued", rid=3)
    fc.advance(0.25)
    tr.instant("marker", k="v")

    @tr.trace("decorated")
    def f(x):
        fc.advance(0.125)
        return x + 1

    f(1)
    cross.end(done=True)
    cross.end()                        # a second end is a no-op
    with tr.span("over"):              # past max_events: dropped
        pass
    buf = io.StringIO()
    n = tr.export_chrome_trace(buf)
    off = T.Tracer(clock=fc, enabled=False)
    reads = fc.reads
    with off.span("x"):
        pass
    off.instant("y")
    return (n, tr.dropped, json.loads(buf.getvalue()),
            [{k: v for k, v in e.items() if k != "tid"}
             for e in tr.events()], fc.reads - reads,
            off.span("z") is T.NULL_SPAN)


def test_tracer_and_chrome_trace_equal_the_reference():
    """Spans, instants, the decorator, cross-scope spans, the event bound
    and the Chrome-trace JSON under a FakeClock; a disabled tracer reads
    no clock."""
    ref, port = _both(_tracer_script)
    strip = [{k: v for k, v in e.items() if k != "tid"}
             for e in ref[2]["traceEvents"]]
    assert [{k: v for k, v in e.items() if k != "tid"}
            for e in port[2]["traceEvents"]] == strip
    assert port[:2] == ref[:2] and port[3:] == ref[3:]
    assert port[4] == 0 and port[5] is True


def test_tracer_mirror_lands_in_a_torch_profiler_trace():
    """``annotate=True`` wraps each span in
    ``torch.profiler.record_function``: the span names appear among the
    profiler's events; off by default."""
    from torch.profiler import ProfilerActivity, profile
    tr = TT.Tracer(annotate=True)
    assert TT.Tracer().annotate is False
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("server.tick"):
            torch.ones(4).sum()
        sp = tr.begin_span("request.decode", rid=1)
        torch.ones(4).sum()
        sp.end()
    names = {e.key for e in prof.key_averages()}
    assert {"server.tick", "request.decode"} <= names
    assert [e["name"] for e in tr.events()] == ["server.tick",
                                                "request.decode"]


# ------------------------------------------- flight recorder / journeys

def _flight_script(T, tmp):
    fc = T.FakeClock()
    rec = T.FlightRecorder(capacity=4, clock=fc, keep_events=3,
                           max_postmortems=2,
                           postmortem_dir=str(tmp / T.__name__))
    for i in range(6):
        fc.advance(1.0)
        rec.record("tick" if i % 2 else "admit", rid=i, pages=i * 2)
    rec.record("fault", kind="shadowed", point="x")
    bundles = [rec.postmortem(f"r{i}", pool={"free": i}) for i in range(3)]
    files = sorted(p.name for p in (tmp / T.__name__).iterdir())
    disk = [json.loads((tmp / T.__name__ / n).read_text()) for n in files]
    off = T.FlightRecorder(clock=fc, enabled=False)
    reads = fc.reads
    off.record("x", a=1)
    off.postmortem("y")
    return (rec.events(), rec.events(kind="tick"), rec.events(last=2),
            bundles, rec.postmortems(), files, disk, fc.reads - reads,
            off.events(), off.postmortems())


def _journey_script(T):
    fc = T.FakeClock(5.0)
    jr = T.JourneyRecorder(clock=fc, max_journeys=2)
    j = jr.begin("r1", where="router")
    j.event("submitted", rid=1)
    fc.advance(0.5)
    j2 = j.at("replica0")
    j2.event("queued", rid=7, where="shadow")
    fc.advance(0.25)
    j2.event("finished", tokens=3)
    jr.begin("r2", where="server").event("submitted")
    jr.begin("r3", where="server").event("submitted")    # evicts r1
    off = T.JourneyRecorder(clock=fc, enabled=False)
    reads = fc.reads
    oj = off.begin("x", where="server")
    oj.event("submitted")
    return (jr.journey("r1"), jr.journey("r2"), jr.journey("r3"),
            sorted(jr.ids()) if hasattr(jr, "ids") else None,
            fc.reads - reads, off.journey("x"))


def test_flight_recorder_equals_the_reference(tmp_path):
    """The ring's bound and order, the kind and last filters, a field
    named like a reserved key, postmortem bundles bounded in memory and
    on disk (atomic files, newest kept); a disabled recorder reads no
    clock."""
    ref, port = _both(_flight_script, tmp_path)
    assert port == ref


def test_journey_recorder_equals_the_reference():
    """Timelines, rebinding to a location, a reserved key degraded,
    eviction of the oldest whole journey; a disabled recorder reads no
    clock and keeps nothing."""
    ref, port = _both(_journey_script)
    assert port == ref


# ------------------------------------------------------------------ SLOs

def _slo_script(T):
    reg = T.MetricRegistry()
    h = reg.histogram("serving_ttft_seconds", "ttft",
                      buckets=(0.05, 0.1, 0.25, 1.0))
    req = reg.counter("serving_requests_total", "req",
                      labelnames=("state",))
    fc = T.FakeClock()
    eng = T.SLOEngine(
        [T.SLO("ttft", "ttft", target=0.9, window=60, threshold=0.1,
               fast_window=5, page_burn=10.0, warn_burn=2.0),
         T.SLO("avail", "availability", target=0.99, window=60,
               fast_window=5)],
        lambda: reg.snapshot(), clock=fc, registry=reg)
    out = []
    for step in range(8):
        for _ in range(10):
            h.observe(0.5 if 2 <= step < 5 else 0.05)
        req.labels(state="finished").inc(10)
        if step == 3:
            req.labels(state="failed").inc(5)
        fc.advance(3)
        out.append(eng.evaluate())
    errors = []
    for bad in (lambda: T.SLO("x", "nope", 0.9, 60),
                lambda: T.SLO("x", "ttft", 1.5, 60),
                lambda: T.SLOEngine([T.SLO("a", "availability", 0.9, 60),
                                     T.SLO("a", "availability", 0.9, 60)],
                                    lambda: {})):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    off_clock = T.FakeClock()
    off = T.SLOEngine([T.SLO("a", "availability", 0.9, 60)],
                      lambda: 1 / 0, clock=off_clock, enabled=False)
    return (out, eng.states(), list(eng.transitions), _samples(reg),
            errors, off.evaluate(), off_clock.reads)


def test_slo_engine_equals_the_reference():
    """Multi-window burn rates on a FakeClock: a sustained TTFT burn
    pages, a failure burst burns the availability budget, recovery
    clears; the reports, states, transitions and published gauges are
    the reference's; a disabled engine reads no clock and never calls
    its source."""
    ref, port = _both(_slo_script)
    assert port == ref


# ----------------------------------------------- server / router / ledger

def _server_telemetry_script(T):
    fc = T.FakeClock()
    tele = T.ServerTelemetry(clock=fc, tracer=T.Tracer(clock=fc))
    tele.set_health("healthy")
    tele.on_submit(0, 8, 1)
    fc.advance(1.0)
    tele.on_submit(1, 5, 2)
    tele.on_admit(0, 1)
    tele.on_admission_deferred(0, 2)
    fc.advance(0.5)
    tele.on_admit(0, 1)
    t = tele.prefill_started()
    fc.advance(0.25)
    tele.on_prefill_batch(t, 8)
    tele.on_first_token(0, 8, 0)
    tele.on_admit(1, 0)
    tele.on_first_token(1, 3, 2)
    for _ in range(3):
        t = tele.tick_started()
        fc.advance(0.05)
        tele.on_tick(t, 2, 2)
    tele.on_tick_dispatches({"decode": 1, "state_push": 2})
    tele.set_pool(10, 4, 1, 2, 0)
    tele.set_pool_shards(1, 4096)
    tele.on_prefix_auto(True, 16)
    tele.on_prefix_auto(False, 0)
    tele.on_prefix_donate(3)
    tele.on_prefix_evict(1)
    tele.add_null_writes(2)
    tele.add_wasted_block_tokens(1)
    tele.add_prefill_tokens(4)
    tele.add_prefill_dispatches(3)
    tele.on_preempt(1, 1)
    tele.on_admit(1, 0)
    tele.on_first_token(1, 5, 0)
    tele.on_preempt_resumed()
    tele.add_grow_pages(2)
    tele.add_headroom_pages(1)
    tele.set_preempted_depth(0)
    tele.on_shed("reject")
    tele.on_deadline_expired("queued")
    tele.on_tick_retry()
    tele.on_breaker_open()
    tele.set_health("degraded")
    fc.advance(0.2)
    tele.on_finish(0, 4)
    tele.on_cancel(1)
    tele.on_submit(2, 3, 1)
    tele.on_admission_failure(2, ValueError("boom"))
    tele.set_queue_depth(0)
    tele.set_active_slots(0)
    ev = [{k: v for k, v in e.items() if k != "tid"}
          for e in tele.tracer.events()]
    return _samples(tele.registry), ev


def _router_telemetry_script(T):
    fc = T.FakeClock()
    rt = T.RouterTelemetry(clock=fc)
    rt.on_routed(0, True)
    rt.on_routed(1, False)
    rt.on_dispatch_retry(1)
    rt.on_evacuation(1)
    rt.on_requeued(0)
    rt.on_replica_lost()
    rt.on_orphaned()
    rt.set_backlog(3)
    rt.set_serving(1)
    rt.set_health("degraded")
    t = rt.handoff_started()
    fc.advance(0.5)
    rt.on_handoff("ok", t)
    rt.set_replica_role(0, "prefill")
    return _samples(rt.registry)


def _ledger_script(T):
    reg = T.MetricRegistry()
    led = T.GoodputLedger(registry=reg)
    ticks = []
    for kinds in ({"goodput": 3, "null_redirect": 1},
                  {}, {"replay": 2, "chunk_pad": 0, "goodput": 1},
                  {"skipped_page_dma": 16, "block_waste": 1}):
        for k, n in kinds.items():
            led.add(k, n)
        ticks.append(led.flush_tick())
    return (ticks, led.totals(), led.snapshot(), led.goodput_ratio(),
            _samples(reg), T.GoodputLedger().goodput_ratio())


def _training_script(T):
    from paddle_tpu.telemetry.training import TelemetryCallback as J
    from paddle_tpu_torch.telemetry.training import TelemetryCallback as P
    fc = T.FakeClock()
    tr = T.Tracer(clock=fc)
    cb = (J if T is JT else P)(T.MetricRegistry(), tracer=tr, clock=fc,
                               tokens_per_batch=64)
    cb.on_train_begin()
    cb.on_epoch_begin(0)
    for step, loss in enumerate((2.5, 2.25, 2.0)):
        cb.on_train_batch_begin(step)
        fc.advance(0.25 * (step + 1))
        cb.on_train_batch_end(step, {"loss": loss})
    cb.on_epoch_end(0)
    cb.on_train_end()
    return _samples(cb.registry), [
        {k: v for k, v in e.items() if k != "tid"} for e in tr.events()]


@pytest.mark.parametrize("script", [
    _server_telemetry_script, _router_telemetry_script, _ledger_script,
    _training_script], ids=["server", "router", "ledger", "training"])
def test_instrumentation_classes_equal_the_reference(script):
    """``ServerTelemetry`` (every hook the server calls),
    ``RouterTelemetry`` (ported ahead of its router), ``GoodputLedger``
    and ``TelemetryCallback``, scripted on a FakeClock: the same samples
    and spans."""
    ref, port = _both(script)
    assert port == ref


# -------------------------------------------------------- MetricsServer

def _http_script(T, state):
    reg = T.MetricRegistry()
    reg.counter("served_total", "s", labelnames=("k",)).labels(k="a").inc(3)
    reg.histogram("lat_seconds", "l", buckets=(0.5,)).observe(0.25)
    timelines = {"7": [{"t": 1.0, "phase": "submitted"}]}
    ms = T.MetricsServer(
        reg, extra_stats=lambda: {"prefill_tokens": 12},
        health=lambda: state[0], journey=timelines.get,
        postmortem=lambda: [{"reason": "request_failed", "rid": 7}],
        slo=lambda: [{"name": "avail", "state": "ok"}],
        slo_states=lambda: {"avail": "warning"}).start()
    try:
        out = {}
        for path in ("/metrics", "/stats", "/debug/journey/7",
                     "/debug/journey/9", "/debug/postmortem", "/slo",
                     "/nope"):
            code, body = _get(ms.url + path)
            if path == "/stats":
                body = json.loads(body)["stats"]
            out[path] = (code, body)
        for s in ("healthy", "degraded", "draining", "dead"):
            state[0] = s
            out[f"/healthz {s}"] = _get(ms.url + "/healthz")
        return out
    finally:
        ms.close()


def test_metrics_server_on_loopback_equals_the_reference():
    """The port's ``MetricsServer`` on 127.0.0.1 answers every route as
    the reference's does: ``/metrics`` byte for byte, ``/stats``' stats,
    ``/debug/journey/<rid>`` (200 and 404), ``/debug/postmortem``,
    ``/slo``, an unknown route, and ``/healthz`` through the four health
    states (200 while serving, 503 after; the SLO detail in the body)."""
    ref, port = _both(_http_script, ["healthy"])
    assert port == ref
    assert port["/healthz healthy"][0] == 200
    assert port["/healthz draining"][0] == 503


# ------------------------------------ the server's telemetry, end to end

# sampled, so that both servers push each activation's key (a greedy
# port server pushes none: its dispatch profile has one state push fewer
# a flush, pinned below)
SAMPLE = {"do_sample": True, "temperature": 0.7, "top_k": 4}
SERVER_MODES = {
    "dense": dict(SAMPLE),
    "paged split": dict(SAMPLE, cache_backend="paged", page_size=4,
                        prefill_tokens_per_tick=3),
    "paged fused": dict(SAMPLE, cache_backend="paged", page_size=4,
                        serving_mode="fused"),
    "paged optimistic": dict(SAMPLE, cache_backend="paged", page_size=4,
                             num_pages=6, admission="optimistic"),
}


def _served(Server, model, T, kw):
    fc = T.FakeClock()
    tele = T.ServerTelemetry(clock=fc, tracer=T.Tracer(clock=fc))
    srv = Server(model, max_slots=2, max_cache_len=16, telemetry=tele,
                 **kw)
    prompts = ([1, 2, 3, 4], [5, 6, 7, 8], [9, 3])
    rids = []
    for p in prompts:
        rids.append(srv.submit(np.asarray(p, np.int32), max_new_tokens=6))
        fc.advance(0.5)
    while srv.step() or srv._busy_locked():
        fc.advance(0.25)
    out = srv.run()
    for r, p in zip(rids, prompts):
        np.testing.assert_array_equal(out[r], stub_tokens(p, 6))
    ev = [{k: v for k, v in e.items() if k != "tid"}
          for e in tele.tracer.events()]
    return _samples(tele.registry), ev


@pytest.mark.parametrize("mode", list(SERVER_MODES))
def test_server_telemetry_equals_the_jax_servers(mode):
    """The same requests through the port's server (torch stub) and the
    JAX server (its stub), telemetry on, on a FakeClock advanced between
    ticks: every sample of every metric (TTFT, TPOT, queue wait, ticks,
    dispatches by op, pool gauges, prefix and preemption counters, the
    health gauge) and every request span equal."""
    ref = _served(JaxServer, StubModel(), JT, SERVER_MODES[mode])
    port = _served(ContinuousBatchingServer, TorchStub(), TT,
                   SERVER_MODES[mode])
    assert port[1] == ref[1]
    assert port[0] == ref[0]


def test_disabled_telemetry_reads_no_clock_on_the_server():
    """A disabled registry: the server keeps ``_tele`` None, serves, and
    its telemetry's clock is never read; the disabled hooks themselves
    read none either."""
    fc = TT.FakeClock()
    tele = TT.ServerTelemetry(registry=TT.MetricRegistry(enabled=False),
                              clock=fc)
    srv = ContinuousBatchingServer(TorchStub(), max_slots=1,
                                   max_cache_len=16, telemetry=tele,
                                   cache_backend="paged", page_size=4)
    assert srv._tele is None
    rid = srv.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
    np.testing.assert_array_equal(srv.run()[rid], stub_tokens([1, 2, 3], 3))
    tele.on_submit(0, 8, 1)
    tele.on_first_token(0, 8, 0)
    assert tele.tick_started() is None
    assert fc.reads == 0 and tele.registry.snapshot() == {}


def test_greedy_port_server_pushes_no_key():
    """Pinned difference in the dispatch profile: a greedy JAX server
    pushes every activation's PRNG key to the device; the port's greedy
    server keeps no key to push. One request, one activation: one
    ``state_push`` fewer, every other sample equal."""
    kw = {"cache_backend": "paged", "page_size": 4}

    def served(Server, model, T):
        fc = T.FakeClock()
        tele = T.ServerTelemetry(clock=fc, tracer=T.Tracer(clock=fc))
        srv = Server(model, max_slots=2, max_cache_len=16, telemetry=tele,
                     **kw)
        srv.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
        srv.run()
        return _samples(tele.registry)

    ref = served(JaxServer, StubModel(), JT)
    port = served(ContinuousBatchingServer, TorchStub(), TT)
    push = "server_dispatches_total"
    assert port[push][1][("state_push",)] == \
        ref[push][1][("state_push",)] - 1
    assert port["server_prefill_dispatches_total"][1][()] == \
        ref["server_prefill_dispatches_total"][1][()] - 1
    differ = {push, "server_prefill_dispatches_total",
              "serving_tick_dispatches"}
    assert {k: v for k, v in port.items() if k not in differ} == \
        {k: v for k, v in ref.items() if k not in differ}
