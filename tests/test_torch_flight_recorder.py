"""The port's flight recorder, postmortems and journeys on its server,
against the JAX server's.

The port's server runs the torch stub of ``tests/test_torch_preemption.py``
and the JAX server ``tests/_serving_stub.StubModel``, sampled (both
servers then push each activation's key, so their tick profiles are the
same) on a ``FakeClock``:

- the recorder's event stream (admissions, ticks with their dispatch
  profiles, grows, preemptions, donations, replays, faults, retries,
  the breaker, health, finishes, flushes, fails) is the reference's,
  field for field, in five scenarios;
- a postmortem bundle's sections are the reference's — the fleet's
  ``migration`` section, the pool balance's shard and host-tier keys and
  the routing sketch's size included — but for the server's own
  ``stats``;
- journeys, self-minted by a server built with ``journeys=`` or handed
  in through ``submit(journey=)``, hold the reference's timelines;
- ``serve_metrics``' debug routes serve the journeys and the bundles;
- a server with every option None reads no clock at any hook site, and
  a disabled recorder or journey recorder is treated as None: no clock
  read, no lock.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.reliability as JR
import paddle_tpu.telemetry as JT
import paddle_tpu_torch.reliability as TR
import paddle_tpu_torch.telemetry as TT
from _serving_stub import StubModel, stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                        ReplicaRouter, serve_metrics)
from test_torch_preemption import TorchStub

SAMPLE = {"do_sample": True, "temperature": 0.7, "top_k": 4}
JAX = (JaxServer, StubModel, JT, JR)
PORT = (ContinuousBatchingServer, TorchStub, TT, TR)


class _CountingLock:
    def __init__(self):
        self.acquisitions = 0

    def __enter__(self):
        self.acquisitions += 1
        return self

    def __exit__(self, *exc):
        return False


def _strip(events):
    return [{k: v for k, v in e.items() if k != "t"} for e in events]


def _p(*toks):
    return np.asarray(toks, np.int32)


def _lifecycle(srv, R):
    a = srv.submit(_p(1, 2, 3), max_new_tokens=5)
    b = srv.submit(_p(9, 9), max_new_tokens=3)
    c = srv.submit(_p(4, 4, 4, 4), max_new_tokens=4)
    srv.cancel(c)
    srv.run()
    return a, b


def _pressure(srv, R):
    """A high-priority grower and a low-priority victim over a 5-page
    pool: the victim is preempted, then the breaker opens."""
    f = srv.submit(_p(1, 2, 3, 4), max_new_tokens=28, priority=1)
    v = srv.submit(_p(5, 6, 7, 8, 9, 10, 11, 12), max_new_tokens=28,
                   priority=0)
    while srv.preempt_pressure() == 0:
        srv.step()
    srv._on_tick_failure(RuntimeError("chaos"))
    return f, v


def _faulted(srv, R):
    a = srv.submit(_p(1, 1, 1), max_new_tokens=4)
    b = srv.submit(_p(2, 3), max_new_tokens=4)
    srv.run()
    return a, b


def _shed(srv, R):
    old = srv.submit(_p(1), max_new_tokens=2)
    new = srv.submit(_p(2), max_new_tokens=2)
    srv.run()
    return old, new


SCENARIOS = {
    "lifecycle split": (_lifecycle, {}),
    "lifecycle fused": (_lifecycle, {"serving_mode": "fused"}),
    "preemption and breaker": (_pressure, {
        "num_pages": 6, "admission": "optimistic",
        "retry_policy": "nodelay", "breaker": 1}),
    "prefill fault": (_faulted, {"fault_injector": [0]}),
    "evict_oldest shed": (_shed, {"max_queue": 1,
                                  "shed_policy": "evict_oldest"}),
}


def _run(impl, scenario):
    Server, Model, T, R = impl
    script, extra = SCENARIOS[scenario]
    fc = T.FakeClock()
    rec = T.FlightRecorder(clock=fc)
    jrn = T.JourneyRecorder(clock=fc)
    kw = dict(max_slots=2, max_cache_len=64, cache_backend="paged",
              page_size=8, recorder=rec, journeys=jrn, clock=fc, **SAMPLE)
    for k, v in extra.items():
        if k == "retry_policy":
            v = R.RetryPolicy(base_delay_s=0.0, jitter=0.0)
        elif k == "breaker":
            v = R.CircuitBreaker(failure_threshold=v)
        elif k == "fault_injector":
            v = R.FaultInjector(seed=0).on(R.faults.PREFILL, schedule=v)
        kw[k] = v
    srv = Server(Model(), **kw)
    rids = script(srv, R)
    return (srv, _strip(rec.events()), srv.postmortems(),
            [_strip(srv.journey(r) or []) for r in rids], rids)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_recorder_events_and_journeys_equal_the_jax_servers(scenario):
    """The same scenario on both servers: the recorder's events, each
    request's journey and each postmortem bundle are the reference's
    (bundles: but for the stats dict)."""
    srv, events, bundles, journeys, rids = _run(PORT, scenario)
    _, ref_events, ref_bundles, ref_journeys, _ = _run(JAX, scenario)
    assert events == ref_events
    assert journeys == ref_journeys and all(journeys)
    assert len(bundles) == len(ref_bundles)
    for got, want in zip(bundles, ref_bundles):
        assert set(want) == set(got)
        for k in set(got) - {"stats"}:
            assert got[k] == want[k], k
        bal = got["pool_balance"]
        assert bal["free"] + bal["live"] + bal["pinned"] + bal["cached"] \
            == srv._kv.num_pages - 1
    if scenario == "preemption and breaker":
        (b,) = bundles
        assert b["reason"] == "breaker_open" and b["parked"]
        assert any(e["kind"] == "breaker" for e in b["events"])
        assert all(isinstance(srv.failures[r], TR.CircuitOpenError)
                   for r in rids)
    if scenario == "prefill fault":
        assert bundles[0]["reason"] == "request_failed"
        assert any(e["kind"] == "fault" for e in events)
    if scenario == "evict_oldest shed":
        assert bundles == [] and any(e["kind"] == "fail" for e in events)


def test_handed_in_journeys_win_over_self_minted_ones():
    """``submit(journey=)``: a handle minted elsewhere (a router) traces
    the request there, the server mints none for it, and its timeline is
    the reference server's."""
    out = []
    for Server, Model, T, R in (PORT, JAX):
        fc = T.FakeClock()
        outer = T.JourneyRecorder(clock=fc)
        own = T.JourneyRecorder(clock=fc)
        srv = Server(Model(), max_slots=1, max_cache_len=32,
                     cache_backend="paged", page_size=8, journeys=own,
                     clock=fc)
        h = outer.begin("r-1", where="router")
        h.event("submitted", rid=-1)
        rid = srv.submit(_p(3, 1, 4), max_new_tokens=3,
                         journey=h.at("replica0"))
        fc.advance(0.5)
        np.testing.assert_array_equal(srv.run()[rid],
                                      stub_tokens([3, 1, 4], 3))
        assert srv.journey(rid) is None and own.journey(f"s{rid}") is None
        out.append(_strip(outer.journey("r-1")))
    assert out[0] == out[1]
    assert [e["phase"] for e in out[0]] == [
        "submitted", "queued", "admitted", "prefill_chunk", "first_token",
        "finished"]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_serve_metrics_debug_routes():
    """On the loopback interface: ``/debug/journey/<rid>`` serves a
    self-minted timeline (404 for an unknown rid), ``/debug/postmortem``
    the bundles, ``/healthz`` the health verdict, ``/stats`` the pool's,
    the prefix cache's and the ledger's statistics; a server without
    telemetry refuses; a router target aggregates its replicas'
    health."""
    fi = TR.FaultInjector(seed=0).on(TR.faults.PREFILL, schedule=[1])
    srv = ContinuousBatchingServer(TorchStub(), max_slots=2,
                                   max_cache_len=32, cache_backend="paged",
                                   page_size=8, telemetry=True,
                                   recorder=True, journeys=True,
                                   ledger=True, fault_injector=fi)
    ok = srv.submit(_p(1, 2, 3), max_new_tokens=3)
    bad = srv.submit(_p(4, 5), max_new_tokens=3)
    srv.run()
    ms = serve_metrics(srv)
    try:
        code, body = _get(ms.url + f"/debug/journey/{ok}")
        assert code == 200
        phases = [e["phase"] for e in json.loads(body)["journey"]]
        assert phases[0] == "submitted" and phases[-1] == "finished"
        assert _get(ms.url + "/debug/journey/99")[0] == 404
        code, body = _get(ms.url + "/debug/postmortem")
        pms = json.loads(body)["postmortems"]
        assert code == 200 and [b["rid"] for b in pms] == [bad]
        assert _get(ms.url + "/healthz")[0] == 200
        stats = json.loads(_get(ms.url + "/stats")[1])["stats"]
        assert stats["kv_pool"]["num_pages"] == srv._kv.num_pages
        assert stats["prefix_cache"]["cached_pages"] == \
            srv._prefix.cached_pages
        assert stats["goodput"]["tokens"] == srv.goodput()["tokens"]
        page = _get(ms.url + "/metrics")[1]
        parsed = TT.parse_prometheus(page)
        assert parsed[("fault_fires_total",
                       (("point", TR.faults.PREFILL),))] == 1.0
    finally:
        ms.close()
    with pytest.raises(ValueError, match="telemetry"):
        serve_metrics(ContinuousBatchingServer(TorchStub(), max_slots=1,
                                               max_cache_len=16))

    # a router front door: /healthz aggregates its replicas
    rep = ContinuousBatchingServer(TorchStub(), max_slots=1,
                                   max_cache_len=16)
    router = ReplicaRouter([rep], telemetry=True)
    ms = serve_metrics(router)
    try:
        assert _get(ms.url + "/healthz")[0] == 200
        stats = json.loads(_get(ms.url + "/stats")[1])["stats"]
        assert stats["replicas"][0]["health"] == "healthy"
    finally:
        ms.close()


@pytest.mark.parametrize("mode", ["dense", "split", "fused"])
def test_every_option_none_reads_no_clock(mode):
    """The off path: with telemetry, recorder, ledger, costs and
    journeys all None, a served wave (with a cancel and a failure) reads
    the server's clock nowhere — every hook site is one ``is None``
    check."""
    fc = TT.FakeClock()
    kw = {"dense": {}, "split": {"cache_backend": "paged", "page_size": 4},
          "fused": {"cache_backend": "paged", "page_size": 4,
                    "serving_mode": "fused"}}[mode]
    fi = TR.FaultInjector(seed=0).on(TR.faults.PREFILL, schedule=[1])
    srv = ContinuousBatchingServer(TorchStub(), max_slots=2,
                                   max_cache_len=16, clock=fc,
                                   fault_injector=fi, **kw)
    assert (srv._tele, srv._rec, srv._led, srv._costs, srv._jrec) == \
        (None,) * 5
    a = srv.submit(_p(1, 2, 3), max_new_tokens=4)
    srv.submit(_p(5, 6), max_new_tokens=4)
    c = srv.submit(_p(7), max_new_tokens=4)
    srv.cancel(c)
    out = srv.run()
    np.testing.assert_array_equal(out[a], stub_tokens([1, 2, 3], 4))
    assert fc.reads == 0
    assert srv.postmortems() == [] and srv.journey(a) is None
    assert srv.goodput() is None and srv.device_costs() is None


@pytest.mark.parametrize("which", ["recorder", "journeys"])
def test_disabled_recorders_are_treated_as_none(which):
    """A disabled flight recorder or journey recorder: the server keeps
    None, the object's clock is never read and its lock never taken."""
    fc = TT.FakeClock()
    obj = (TT.FlightRecorder(clock=fc, enabled=False) if which == "recorder"
           else TT.JourneyRecorder(clock=fc, enabled=False))
    lock = _CountingLock()
    obj._lock = lock
    srv = ContinuousBatchingServer(TorchStub(), max_slots=2,
                                   max_cache_len=16, cache_backend="paged",
                                   page_size=4, **{which: obj})
    assert (srv._rec if which == "recorder" else srv._jrec) is None
    rid = srv.submit(_p(1, 2, 3), max_new_tokens=4)
    np.testing.assert_array_equal(srv.run()[rid], stub_tokens([1, 2, 3], 4))
    assert fc.reads == 0 and lock.acquisitions == 0
    assert srv.postmortems() == [] and srv.journey(rid) is None
