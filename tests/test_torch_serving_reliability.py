"""The port's supervised serve loop, health states and drain, on the CPU.

The JAX package's ``tests/test_serving_reliability.py`` classes
``TestSupervisedLoop`` and ``TestHealthAndDrain`` on the port's server
(``/healthz`` and the metrics are held in ``tests/test_torch_telemetry.py``
and ``tests/test_torch_flight_recorder.py``). They run on the torch stub of
``tests/test_torch_preemption.py`` (the decode-bundle contract with the
closed-form oracle ``stub_tokens``) and ``FakeClock`` deadlines:

- a tick fault is retried and the in-flight requests survive;
- an injected prefill fault fails one request only;
- the breaker opens, unblocks every waiter with ``CircuitOpenError``,
  and recovers after its cooldown (also when the server is idle);
- deadlines expire during the cooldown;
- drain, hard stop and restart after stop walk the health states.

``HealthMonitor`` and ``ServeSupervisor`` are copies of the JAX
package's: the same transitions and answers on the same inputs. And one
case against the JAX server itself: a sampled paged server under a
``server.decode_tick`` storm, driven tick by tick with the same
injector seed, emits the JAX server's tokens (a key split by a failed
tick and again by its retry would not).
"""
import threading
import time

import numpy as np
import pytest

from _serving_stub import stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.reliability import FaultInjector as JaxInjector
from paddle_tpu.reliability import HealthMonitor as JaxHealth
from paddle_tpu.reliability import RetryPolicy as JaxRetry
from paddle_tpu.reliability import CircuitBreaker as JaxBreaker
from paddle_tpu.reliability import ServeSupervisor as JaxSupervisor
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.reliability import (CallbackError, CircuitBreaker,
                                          CircuitOpenError,
                                          DeadlineExceeded, FaultInjector,
                                          HealthMonitor, QueueFullError,
                                          RetryPolicy, ServeSupervisor,
                                          ServerClosed, faults,
                                          is_serving_state)
from paddle_tpu_torch.telemetry.clock import FakeClock
from test_torch_preemption import (SAMPLE, TorchStub, _llama_prompts,
                                   _models)


def _prompt(*toks):
    return np.asarray(toks, np.int32)


def _srv(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_cache_len", 64)
    return ContinuousBatchingServer(TorchStub(), **kw)


def _fast_retry():
    return RetryPolicy(base_delay_s=0.0, jitter=0.0)


def _until_queue_drains(srv, timeout=10.0):
    """Block until the serve thread has admitted everything queued."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with srv._lock:
            if not srv._queue:
                return
        time.sleep(0.005)
    raise AssertionError("queue never drained into slots")


# ------------------------------------------------- supervised serving


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_tick_fault_retries_in_flight_survive(backend):
    """A tick exception no longer kills the serve thread: the other
    slots finish and new submits are served without a restart."""
    fi = FaultInjector().on(faults.DECODE_TICK, schedule=[1])
    srv = _srv(retry_policy=_fast_retry(), fault_injector=fi,
               cache_backend=backend).start()
    a, b = _prompt(1, 2, 3), _prompt(4, 5)
    ra = srv.submit(a, max_new_tokens=6)
    rb = srv.submit(b, max_new_tokens=6)
    np.testing.assert_array_equal(srv.wait(ra, timeout=60),
                                  stub_tokens(a, 6))
    np.testing.assert_array_equal(srv.wait(rb, timeout=60),
                                  stub_tokens(b, 6))
    assert fi.fired(faults.DECODE_TICK) == 1
    assert srv._sup.retries_total == 1
    c = _prompt(7, 8)
    rc = srv.submit(c, max_new_tokens=3)
    np.testing.assert_array_equal(srv.wait(rc, timeout=60),
                                  stub_tokens(c, 3))
    assert srv.health == "healthy"
    srv.stop()


def test_injected_prefill_fault_fails_one_request_only():
    fi = FaultInjector().on(faults.PREFILL, schedule=[0])
    srv = _srv(max_slots=1, retry_policy=_fast_retry(),
               fault_injector=fi).start()
    a, b = _prompt(1, 2), _prompt(3, 4)
    ra = srv.submit(a, max_new_tokens=4)
    rb = srv.submit(b, max_new_tokens=4)
    with pytest.raises(Exception, match="injected fault"):
        srv.wait(ra, timeout=60)
    np.testing.assert_array_equal(srv.wait(rb, timeout=60),
                                  stub_tokens(b, 4))
    srv.stop()


def test_breaker_opens_unblocks_waiters_then_recovers():
    fcb = FakeClock()
    fi = FaultInjector().on(faults.DECODE_TICK, schedule=range(0, 1000))
    srv = _srv(retry_policy=_fast_retry(),
               breaker=CircuitBreaker(failure_threshold=3,
                                      reset_after_s=10.0, clock=fcb),
               fault_injector=fi).start()
    rid = srv.submit(_prompt(1, 2), max_new_tokens=4)
    with pytest.raises(CircuitOpenError, match="circuit breaker"):
        srv.wait(rid, timeout=60)
    assert srv.health == "degraded"
    assert fi.fired(faults.DECODE_TICK) == 3
    fi.disarm()
    fcb.advance(11.0)
    p = _prompt(5, 6)
    rid2 = srv.submit(p, max_new_tokens=4)       # degraded still accepts
    np.testing.assert_array_equal(srv.wait(rid2, timeout=60),
                                  stub_tokens(p, 4))
    assert srv.health == "healthy"
    srv.stop()


def test_breaker_open_fails_parked_and_frees_every_page():
    """The breaker opening over an optimistic paged server fails queued,
    in-flight and parked requests alike, and leaves no live page."""
    fcb = FakeClock()
    fi = FaultInjector()
    srv = _srv(max_slots=2, cache_backend="paged", page_size=8,
               num_pages=17, admission="optimistic",
               retry_policy=_fast_retry(), fault_injector=fi,
               breaker=CircuitBreaker(failure_threshold=2,
                                      reset_after_s=10.0, clock=fcb))
    prompts = [_prompt(*range(1, 9)), _prompt(*range(2, 11)),
               _prompt(3, 4, 5)]
    rids = [srv.submit(p, max_new_tokens=28) for p in prompts]
    for _ in range(4):
        srv.step()
    with srv._lock:
        # the production teardown (an organic victim is usually
        # re-admitted within its own tick)
        srv._preempt_slot_locked(0)
    assert len(srv._preempted) == 1 and srv._queue
    fi.on(faults.DECODE_TICK, schedule=range(fi.visits(faults.DECODE_TICK),
                                             10_000))
    srv.start()
    for rid in rids:
        with pytest.raises(CircuitOpenError):
            srv.wait(rid, timeout=60)
    bal = srv.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0
    assert srv.health == "degraded"
    srv.stop()


def test_idle_degraded_server_recovers_without_traffic():
    fcb = FakeClock()
    fi = FaultInjector().on(faults.DECODE_TICK, schedule=range(3))
    srv = _srv(retry_policy=_fast_retry(),
               breaker=CircuitBreaker(failure_threshold=3,
                                      reset_after_s=5.0, clock=fcb),
               fault_injector=fi).start()
    rid = srv.submit(_prompt(1), max_new_tokens=4)
    with pytest.raises(CircuitOpenError):
        srv.wait(rid, timeout=60)
    assert srv.health == "degraded"
    fcb.advance(6.0)                  # the cooldown elapses; NO traffic
    deadline = time.monotonic() + 10
    while srv.health != "healthy" and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.health == "healthy"
    srv.stop()


def test_deadline_enforced_during_breaker_cooldown():
    fcb = FakeClock()                  # never advanced: cooldown
    fi = FaultInjector().on(faults.DECODE_TICK, schedule=range(3))
    srv = _srv(retry_policy=_fast_retry(),
               breaker=CircuitBreaker(failure_threshold=3,
                                      reset_after_s=1e9, clock=fcb),
               fault_injector=fi).start()
    rid = srv.submit(_prompt(1), max_new_tokens=4)
    with pytest.raises(CircuitOpenError):
        srv.wait(rid, timeout=60)
    rid2 = srv.submit(_prompt(2), max_new_tokens=4, deadline_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded):
        srv.wait(rid2, timeout=30)
    assert time.monotonic() - t0 < 10   # not the wait() timeout
    srv.stop()


def test_final_chunk_callback_error_no_phantom_failure():
    """budget=1 finishes at admission, so the poisoned callback fires
    AFTER harvest: the result stands and no phantom failure appears."""
    srv = _srv(max_slots=1).start()
    rid = srv.submit(_prompt(5), max_new_tokens=1,
                     on_token=lambda r, t: 1 / 0)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with srv._lock:
            if rid in srv._results:
                break
        time.sleep(0.005)
    time.sleep(0.1)
    assert rid not in srv.failures
    np.testing.assert_array_equal(srv.wait(rid, timeout=10),
                                  stub_tokens(_prompt(5), 1))
    srv.stop()


def test_on_token_fault_fails_that_stream_only():
    """An injected ``server.on_token`` fault fails the request whose
    chunk it hit (typed ``CallbackError``); the other stream finishes."""
    fi = FaultInjector().on(faults.ON_TOKEN, schedule=[0])
    srv = _srv(retry_policy=_fast_retry(), fault_injector=fi).start()
    seen = {}
    a, b = _prompt(1, 2), _prompt(3, 4)
    ra = srv.submit(a, max_new_tokens=5,
                    on_token=lambda r, t: seen.setdefault(r, []).extend(t))
    with pytest.raises(CallbackError):
        srv.wait(ra, timeout=60)
    rb = srv.submit(b, max_new_tokens=5,
                    on_token=lambda r, t: seen.setdefault(r, []).extend(t))
    np.testing.assert_array_equal(srv.wait(rb, timeout=60),
                                  stub_tokens(b, 5))
    np.testing.assert_array_equal(seen[rb], stub_tokens(b, 5))
    assert fi.fired(faults.ON_TOKEN) == 1
    srv.stop()


def test_breaker_open_drops_stale_stream_chunks():
    fcb = FakeClock()
    fi = FaultInjector().on(faults.DECODE_TICK, schedule=[0, 1, 2])
    seen = []
    srv = _srv(retry_policy=_fast_retry(),
               breaker=CircuitBreaker(failure_threshold=3,
                                      reset_after_s=5.0, clock=fcb),
               fault_injector=fi).start()
    rid = srv.submit(_prompt(1, 2), max_new_tokens=4,
                     on_token=lambda r, t: seen.append(r))
    with pytest.raises(CircuitOpenError):
        srv.wait(rid, timeout=60)
    fcb.advance(6.0)
    p = _prompt(3, 4)
    rid2 = srv.submit(p, max_new_tokens=3,
                      on_token=lambda r, t: seen.append(r))
    np.testing.assert_array_equal(srv.wait(rid2, timeout=60),
                                  stub_tokens(p, 3))
    assert rid not in seen, "stale chunk for a failed request fired"
    assert rid2 in seen
    srv.stop()


def test_wait_raises_typed_errors_directly():
    srv = _srv(max_slots=1, max_queue=1, max_cache_len=8192,
               shed_policy="evict_oldest").start()
    long_rid = srv.submit(_prompt(1), max_new_tokens=5000)
    _until_queue_drains(srv)
    old = srv.submit(_prompt(2), max_new_tokens=2)
    srv.submit(_prompt(3), max_new_tokens=2)       # evicts `old`
    with pytest.raises(QueueFullError):
        srv.wait(old, timeout=10)
    srv.cancel(long_rid)
    srv.stop()


# ------------------------------------------------- health and drain


def test_drain_finishes_queue_then_dies():
    srv = _srv(max_slots=1).start()
    a, b = _prompt(1, 2), _prompt(3)
    ra = srv.submit(a, max_new_tokens=5)
    rb = srv.submit(b, max_new_tokens=5)
    srv.stop(drain=True)
    assert srv.health == "dead"
    with pytest.raises(ServerClosed, match="dead"):
        srv.submit(_prompt(9), max_new_tokens=2)
    np.testing.assert_array_equal(srv.wait(ra, timeout=5), stub_tokens(a, 5))
    np.testing.assert_array_equal(srv.wait(rb, timeout=5), stub_tokens(b, 5))


def test_hard_stop_fails_queued_flushes_partials():
    srv = _srv(max_slots=1, max_cache_len=8192).start()
    ra = srv.submit(_prompt(1), max_new_tokens=5000)
    _until_queue_drains(srv)
    rb = srv.submit(_prompt(2), max_new_tokens=2)
    srv.stop()
    out = srv.wait(ra, timeout=5)
    assert 1 <= len(out) < 5000
    np.testing.assert_array_equal(
        out, stub_tokens(_prompt(1), 5000)[:len(out)])
    with pytest.raises(ServerClosed):
        srv.wait(rb, timeout=5)
    assert srv.health == "dead"


def test_submit_racing_drain_rejected_typed():
    """A submit racing ``stop(drain=True)`` is refused typed
    (``ServerClosed``) for the whole drain window, while health reads
    ``draining``; the in-flight request, gated open by its callback,
    completes in full; the server ends ``dead``."""
    srv = _srv(max_slots=1).start()
    entered, release = threading.Event(), threading.Event()

    def gate(rid, toks):
        entered.set()
        assert release.wait(timeout=30)

    p = _prompt(1, 2, 3)
    rid = srv.submit(p, max_new_tokens=8, on_token=gate)
    assert entered.wait(timeout=30)
    t = threading.Thread(target=lambda: srv.stop(drain=True, timeout=60))
    t.start()
    try:
        deadline = time.monotonic() + 30
        while srv.health != "draining":
            assert time.monotonic() < deadline, "never saw draining"
            time.sleep(0.002)
        assert not is_serving_state(srv.health)
        with pytest.raises(ServerClosed, match="draining"):
            srv.submit(_prompt(9), max_new_tokens=2)
    finally:
        release.set()
        t.join(timeout=60)
    assert not t.is_alive()
    np.testing.assert_array_equal(srv.wait(rid, timeout=5), stub_tokens(p, 8))
    assert srv.health == "dead"


def test_queued_requests_complete_during_drain_race():
    srv = _srv(max_slots=1).start()
    entered, release = threading.Event(), threading.Event()

    def gate(rid, toks):
        entered.set()
        assert release.wait(timeout=30)

    a, b = _prompt(1, 2), _prompt(3, 4)
    ra = srv.submit(a, max_new_tokens=4, on_token=gate)
    assert entered.wait(timeout=30)
    rb = srv.submit(b, max_new_tokens=4)
    stopper = threading.Thread(
        target=lambda: srv.stop(drain=True, timeout=60))
    stopper.start()
    deadline = time.monotonic() + 30
    while srv.health != "draining":
        assert time.monotonic() < deadline
        time.sleep(0.002)
    with pytest.raises(ServerClosed):
        srv.submit(_prompt(5), max_new_tokens=1)
    release.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    np.testing.assert_array_equal(srv.wait(ra, timeout=5), stub_tokens(a, 4))
    np.testing.assert_array_equal(srv.wait(rb, timeout=5), stub_tokens(b, 4))
    assert not srv.failures


def test_restart_after_stop_resets_health():
    srv = _srv().start()
    srv.stop()
    assert srv.health == "dead"
    srv.start()
    assert srv.health == "healthy"
    p = _prompt(4, 4)
    rid = srv.submit(p, max_new_tokens=3)
    np.testing.assert_array_equal(srv.wait(rid, timeout=60),
                                  stub_tokens(p, 3))
    srv.stop()


# ---------------------------------------- the copies against the reference


def test_health_monitor_walks_as_the_reference():
    """The same requested transitions, the same states and codes (dead
    is terminal, draining only goes on to dead), observer errors
    swallowed."""
    seq = ["degraded", "healthy", "draining", "healthy", "degraded",
           "dead", "healthy", "draining"]
    got, want = [], []
    for cls, out in ((HealthMonitor, got), (JaxHealth, want)):
        seen = []
        hm = cls(on_change=lambda s, c: seen.append((s, c)) or 1 / 0)
        for state in seq:
            out.append((hm.to(state), hm.code, hm.is_serving))
        out.append((hm.reset(), tuple(seen), len(hm.observer_errors)))
    assert got == want
    with pytest.raises(ValueError):
        HealthMonitor().to("sleepy")


def test_serve_supervisor_answers_as_the_reference():
    sleeps = {"port": [], "jax": []}
    answers = {}
    for name, sup_cls, retry_cls, br_cls in (
            ("port", ServeSupervisor, RetryPolicy, CircuitBreaker),
            ("jax", JaxSupervisor, JaxRetry, JaxBreaker)):
        clock = FakeClock()
        sup = sup_cls(retry=retry_cls(base_delay_s=0.5, jitter=0.0,
                                      sleep=sleeps[name].append),
                      breaker=br_cls(failure_threshold=3,
                                     reset_after_s=5.0, clock=clock))
        out = [sup.failure(RuntimeError("a")), sup.failure(RuntimeError())]
        sup.success()
        out += [sup.failure(RuntimeError()) for _ in range(3)]
        out.append(sup.allow())
        clock.advance(6.0)
        out += [sup.allow(), sup.retries_total, sup.attempt]
        answers[name] = out
    assert answers["port"] == answers["jax"]
    assert sleeps["port"] == sleeps["jax"]
    assert "open" in answers["port"]


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_sampled_decode_tick_storm_equals_jax(mode):
    """A seeded sampled paged server under a 30% ``server.decode_tick``
    storm, both servers stepped tick by tick with the same injector
    seed: the same ticks fail and the tokens equal the JAX server's. A
    failed tick must leave the keys it would have split untouched."""
    jm, tm = _models()
    prompts = _llama_prompts(6, seed=17)
    fis = {"jax": JaxInjector(seed=5).on(faults.DECODE_TICK,
                                         probability=0.3),
           "port": FaultInjector(seed=5).on(faults.DECODE_TICK,
                                            probability=0.3)}
    servers = {}
    for name, cls, model in (("jax", JaxServer, jm),
                             ("port", ContinuousBatchingServer, tm)):
        servers[name] = cls(model, max_slots=3, max_cache_len=64,
                            cache_backend="paged", page_size=8,
                            prefill_tokens_per_tick=5, serving_mode=mode,
                            seed=2**31 - 4, fault_injector=fis[name],
                            **SAMPLE)
        for p in prompts:
            servers[name].submit(p, max_new_tokens=10)
    failed = {"jax": [], "port": []}
    for _ in range(500):
        if not any(s._busy_locked() for s in servers.values()):
            break
        for name, srv in servers.items():
            try:
                srv.step()
                failed[name].append(False)
            except Exception:
                failed[name].append(True)
    assert failed["port"] == failed["jax"] and any(failed["port"])
    assert fis["port"].trace == fis["jax"].trace
    js, ts = servers["jax"], servers["port"]
    assert sorted(ts._results) == sorted(js._results) == list(range(6))
    for rid in js._results:
        np.testing.assert_array_equal(ts._results[rid], js._results[rid])
    assert ts.pool_balance()[1] == 0
