"""The port's ``ReplicaRouter`` against the JAX package's, on the CPU.

The in-process classes of the JAX package's ``tests/test_router.py``
(routing, deadlines on the injectable clock, failover, chaos, telemetry,
the evacuate hook, the orphan TTL, preemption-pressure routing and the
dead replica's parked flush): each script runs through the JAX router
over ``StubModel`` replicas and the port's router over ``TorchStub``
replicas (``stub_tokens`` is the oracle), driven single-threaded with
``router.poll()`` and each serving replica's ``step()``, and must give
equal routing decisions, router ``stats``, tokens, typed failures and
pool balances. A same-seed chaos storm gives the same fault trace in
both. One threaded drill (the supervisor thread notices a kill) and
``serve_metrics(router)`` (``/healthz`` 200, then 503 once every
replica is down) run on the port alone.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.reliability as JR
import paddle_tpu.telemetry as JT
import paddle_tpu_torch.reliability as TR
import paddle_tpu_torch.telemetry as TT
from _serving_stub import StubModel, stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.inference.router import ReplicaRouter as JaxRouter
from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                        ReplicaRouter, prefix_fingerprints,
                                        serve_metrics)
from test_torch_preemption import TorchStub

REP_KW = dict(max_slots=2, max_cache_len=64, cache_backend="paged",
              page_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SIDES = {
    "jax": dict(Server=JaxServer, Model=StubModel, Router=JaxRouter,
                R=JR, T=JT),
    "port": dict(Server=ContinuousBatchingServer, Model=TorchStub,
                 Router=ReplicaRouter, R=TR, T=TT),
}


def _both(script, *args, **kw):
    a = script(SIDES["jax"], *args, **kw)
    b = script(SIDES["port"], *args, **kw)
    assert a == b
    return b


def _p(*toks):
    return np.asarray(toks, np.int32)


def _rep(side, **kw):
    return side["Server"](side["Model"](), **dict(REP_KW, **kw))


def _router(side, n=3, rep_kw=None, **kw):
    reps = [_rep(side, **(rep_kw or {})) for _ in range(n)]
    return side["Router"](reps, **kw), reps


def _drive(router, reps, max_iters=3000):
    idle = 0
    for _ in range(max_iters):
        router.poll()
        busy = False
        for rep in reps:
            if rep.health == "dead":
                continue
            if rep.queue_depth() or rep.in_flight():
                rep.step()
                busy = True
        idle = 0 if busy else idle + 1
        if idle >= 2:
            return
    raise AssertionError("router drive did not converge")


def _tok(out):
    return tuple(int(x) for x in out)


def _outcome(router, rid):
    """The request's tokens, or its typed failure's class name."""
    try:
        return _tok(router.wait(rid, timeout=5))
    except Exception as e:
        return type(e).__name__


def _balances(reps):
    out = []
    for rep in reps:
        bal = rep.pool_balance()
        out.append(None if bal is None else tuple(bal))
        if bal is not None:
            assert bal[1] == 0, "leaked pages"
    return out


def _stats(router):
    st = router.stats
    return {k: st[k] for k in ("routed", "affinity_hits", "fallbacks",
                               "dispatch_retries", "evacuations",
                               "requeued", "replica_lost", "orphaned",
                               "migrations", "handoffs")}


def _raises(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None


# --------------------------------------------------------------- routing


def _affinity_script(side):
    router, reps = _router(side)
    shared = np.arange(16, dtype=np.int32) % 16
    outs = []
    for i in range(5):
        p = np.concatenate([shared, _p(i + 1)])
        rid = router.submit(p, max_new_tokens=3)
        _drive(router, reps)
        outs.append(_tok(router.wait(rid, timeout=5)))
        assert outs[-1] == _tok(stub_tokens(p, 3))
    return (outs, _stats(router),
            [r.stats["prefix_auto_hit_tokens"] for r in reps],
            _balances(reps))


def test_affinity_routes_a_shared_prefix_to_one_replica():
    out = _both(_affinity_script)
    assert out[1]["affinity_hits"] == 4 and out[1]["fallbacks"] == 1
    assert max(out[1]["routed"]) == 5 and max(out[2]) == 4 * 16


def _policy_script(side, policy, rep_kw):
    router, reps = _router(side, policy=policy, rep_kw=rep_kw)
    rids = []
    for i in range(6):
        rids.append(router.submit(_p(1, 2, i + 1), max_new_tokens=2))
        if policy == "round_robin":
            _drive(router, reps)
    routed_before_drive = list(router.stats["routed"])
    _drive(router, reps)
    return (routed_before_drive, [_outcome(router, r) for r in rids],
            _stats(router), _balances(reps))


@pytest.mark.parametrize("policy,rep_kw", [
    ("round_robin", {}), ("affinity", {}), ("least_loaded", {}),
    ("affinity", {"cache_backend": "dense"})],
    ids=["round_robin", "fallback_least_loaded", "least_loaded",
         "dense_by_load"])
def test_policies_route_like_the_jax_router(policy, rep_kw):
    out = _both(_policy_script, policy, rep_kw)
    assert out[0] == [2, 2, 2]
    assert out[2]["affinity_hits"] == 0


def _refusal_script(side):
    R = side["R"]
    seen = []
    router, reps = _router(side, n=2)
    for rep in reps:
        rep.kill()
    seen.append(_raises(lambda: router.submit(_p(1, 2))))
    router, reps = _router(side, n=2, rep_kw={"max_queue": 0})
    seen.append(_raises(lambda: router.submit(_p(1, 2))))
    seen.append(router.stats["dispatch_retries"])
    seen.append(_raises(lambda: _router(side, policy="sideways")))
    seen.append(_raises(lambda: _router(side, pressure_weight=-1.0)))
    router, _ = _router(side, n=1)
    seen.append(_raises(lambda: router.submit(_p(1), deadline_s=0.0)))
    assert issubclass(R.ReplicaLostError, R.ReliabilityError)
    return seen


def test_refusals_typed_like_the_jax_router():
    assert _both(_refusal_script) == [
        "ReplicaLostError", "QueueFullError", 2, "ValueError",
        "ValueError", "DeadlineExceeded"]


def test_sketch_agrees_with_the_fingerprints():
    router, reps = _router(SIDES["port"], n=1)
    p = np.arange(20, dtype=np.int32) % 16
    rid = router.submit(p, max_new_tokens=3)
    _drive(router, reps)
    router.wait(rid, timeout=5)
    sketch = reps[0].prefix_sketch()
    fps = prefix_fingerprints(p, 8)
    assert fps[0] in sketch and fps[1] in sketch
    assert prefix_fingerprints(_p(*([9] * 8)), 8)[0] not in sketch
    # the JAX server's sketch of the same traffic is the same set
    jrouter, jreps = _router(SIDES["jax"], n=1)
    rid = jrouter.submit(p, max_new_tokens=3)
    _drive(jrouter, jreps)
    jrouter.wait(rid, timeout=5)
    assert jreps[0].prefix_sketch() == sketch


# ------------------------------------------------------------- deadlines


def _deadline_script(side, expire):
    fc = side["T"].FakeClock()
    router, reps = _router(side, n=2, clock=fc, rep_kw={"clock": fc})
    t0 = fc.now()
    rid = router.submit(_p(1, 2, 3), max_new_tokens=4, deadline_s=5.0)
    victim = int(np.argmax(router.stats["routed"]))
    fc.advance(10.0 if expire else 2.0)
    reps[victim].kill()
    router.poll()
    sib = reps[1 - victim]
    deadline = None if not sib.queue_depth() \
        else sib._queue[0].deadline - t0
    _drive(router, reps)
    return victim, deadline, _outcome(router, rid), _stats(router)


@pytest.mark.parametrize("expire", [True, False],
                         ids=["expired_while_stranded", "remaining_passed"])
def test_requeue_charges_the_absolute_deadline(expire):
    victim, deadline, out, _ = _both(_deadline_script, expire)
    if expire:
        assert out == "DeadlineExceeded"
    else:
        assert deadline == pytest.approx(5.0)
        assert out == _tok(stub_tokens(_p(1, 2, 3), 4))


# -------------------------------------------------------------- failover


def _kill_script(side):
    router, reps = _router(side)
    shared = np.arange(16, dtype=np.int32) % 16
    rid = router.submit(np.concatenate([shared, _p(1)]), max_new_tokens=3)
    _drive(router, reps)
    router.wait(rid, timeout=5)
    vi = int(np.argmax(router.stats["routed"]))
    victim = reps[vi]
    blk = np.concatenate([shared, _p(9)])
    blockers = [router.submit(blk, max_new_tokens=30) for _ in range(2)]
    for _ in range(3):
        victim.step()
    q_p = [np.concatenate([shared, _p(7, i)]) for i in range(3)]
    queued = [router.submit(p, max_new_tokens=4) for p in q_p]
    assert victim.in_flight() == 2 and victim.queue_depth() == 3
    victim.kill()
    _drive(router, reps)
    outs = [_outcome(router, r) for r in queued]
    for o, p in zip(outs, q_p):
        assert o == _tok(stub_tokens(p, 4))
    parts = [_outcome(router, r) for r in blockers]
    for o in parts:
        assert 1 <= len(o) < 30 and o == _tok(stub_tokens(blk, 30)[:len(o)])
    return outs, parts, _stats(router), _balances(reps)


def test_kill_mid_decode_completes_queued_work_on_siblings():
    outs, parts, st, _ = _both(_kill_script)
    assert st["requeued"] == 3 and st["replica_lost"] == 0


def _sampled_failover_script(side):
    kw = {"do_sample": True, "temperature": 0.8, "top_k": 8, "seed": 123}
    ref_router, ref_reps = _router(side, n=1, rep_kw=kw)
    p = _p(5, 11, 2)
    ref = ref_router.submit(p, max_new_tokens=6, seed=77)
    _drive(ref_router, ref_reps)
    expect = _tok(ref_router.wait(ref, timeout=5))
    router, reps = _router(side, rep_kw=kw)
    rid = router.submit(p, max_new_tokens=6, seed=77)
    reps[int(np.argmax(router.stats["routed"]))].kill()
    _drive(router, reps)
    out = _tok(router.wait(rid, timeout=5))
    assert out == expect
    return out, _stats(router)


def test_failover_sampled_tokens_bit_exact():
    out, st = _both(_sampled_failover_script)
    assert st["requeued"] == 1


def _lost_script(side):
    seen = []
    router, reps = _router(side, n=2)
    rid = router.submit(_p(1, 2), max_new_tokens=2)
    for rep in reps:
        rep.kill()
    router.poll()
    seen.append((router.stats["replica_lost"], _outcome(router, rid)))
    # a cancel while the request sits in the router's hands
    router, reps = _router(side, n=2)
    rid = router.submit(_p(1, 2, 3), max_new_tokens=4)
    vi = int(np.argmax(router.stats["routed"]))
    reps[vi].kill()
    harvested = reps[vi].evacuate(flush_partials=True)
    seen.append(router.cancel(rid))
    router._requeue(vi, harvested)
    seen.append((router.stats["requeued"], _outcome(router, rid)))
    return seen


def test_lost_fleet_and_cancel_during_failover_fail_typed():
    assert _both(_lost_script) == [
        (1, "ReplicaLostError"), False, (0, "RequestCancelled")]


def _backpressure_script(side):
    reps = [_rep(side, max_slots=1), _rep(side, max_slots=1, max_queue=0)]
    router = side["Router"](reps)
    p = _p(1, 2, 3)
    rid = router.submit(p, max_new_tokens=4)
    seen = [list(router.stats["routed"])]
    reps[0].kill()
    router.poll()
    seen.append((router.backlog, rid in router.failures))
    router.poll()
    seen.append(router.backlog)
    # the source comes back (restart without a serve thread: health
    # resets, admission reopens) and takes its old work back
    reps[0]._accepting = True
    reps[0]._health.reset()
    router.poll()
    seen.append((router.backlog, router.stats["requeued"]))
    _drive(router, reps)
    seen.append(_outcome(router, rid))
    return seen, _balances(reps)


def test_backpressure_holds_at_the_router_until_a_sibling_can_take():
    seen, _ = _both(_backpressure_script)
    assert seen[1] == (1, False) and seen[2] == 1 and seen[3] == (0, 1)
    assert seen[4] == _tok(stub_tokens(_p(1, 2, 3), 4))


def _breaker_script(side):
    R, T = side["R"], side["T"]
    fc = T.FakeClock()
    breakers = [R.CircuitBreaker(failure_threshold=2, reset_after_s=10.0,
                                 clock=fc) for _ in range(2)]
    router, reps = _router(side, n=2, policy="least_loaded",
                           breakers=breakers, clock=fc)
    calls = {"n": 0}
    real = reps[0].submit

    def flaky(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("replica wedged")

    reps[0].submit = flaky
    p = _p(1, 2, 3)
    rids = [router.submit(p, max_new_tokens=2) for _ in range(3)]
    seen = [calls["n"], breakers[0].state, list(router.stats["routed"])]
    reps[0].submit = real
    fc.advance(11.0)
    rids.append(router.submit(p, max_new_tokens=2))
    seen += [list(router.stats["routed"]), breakers[0].state]
    _drive(router, reps)
    seen.append([_outcome(router, r) for r in rids])
    return seen


def test_breaker_diverts_a_flapping_replica():
    seen = _both(_breaker_script)
    assert seen[0] == 2 and seen[2] == [0, 3] and seen[3] == [1, 3]
    assert seen[1] == "open" and seen[4] == "closed"


def _orphan_replace_script(side):
    router, reps = _router(side, n=2)
    with router._lock:
        router._orphans[(0, reps[0]._next_rid)] = 3
    rid = router.submit(_p(1, 2), max_new_tokens=2)
    seen = [list(router.stats["routed"]), router._routes[rid].idx,
            dict(router._orphans)]
    reps[0].evacuate()
    _drive(router, reps)
    seen.append(_outcome(router, rid))
    return seen


def test_orphaned_dispatch_is_placed_again():
    seen = _both(_orphan_replace_script)
    assert seen[:3] == [[0, 1], 1, {}]


def test_threaded_kill_failover():
    """The supervisor THREAD notices a crash and requeues; waiters
    blocked across the failover follow their requests to a sibling."""
    router, reps = _router(SIDES["port"], rep_kw={"max_cache_len": 1024})
    router.start(poll_interval=0.005)
    try:
        blockers = [router.submit(_p(9, i), max_new_tokens=1000)
                    for i in range(6)]
        deadline = time.monotonic() + 30
        while any(r.queue_depth() for r in reps):
            assert time.monotonic() < deadline, "blockers never admitted"
            time.sleep(0.005)
        q_p = [_p(1, 2, i + 1) for i in range(3)]
        queued = [router.submit(p, max_new_tokens=4) for p in q_p]
        victim = max(range(3), key=lambda i: reps[i].queue_depth())
        reps[victim].kill()
        assert reps[victim]._thread is None      # joined: nothing in flight
        for rid, p in zip(queued, q_p):
            np.testing.assert_array_equal(router.wait(rid, timeout=60),
                                          stub_tokens(p, 4))
        assert router.stats["requeued"] >= 1
        for rid in blockers:
            router.cancel(rid)
    finally:
        router.stop(drain=False)
    for rep in reps:
        assert rep.pool_balance()[1] == 0


# ----------------------------------------------------------------- chaos


def _storm_script(side, seed=777):
    R = side["R"]
    fi = R.FaultInjector(seed=seed).on(R.faults.ROUTER_DISPATCH,
                                       probability=0.25)
    router, reps = _router(
        side, fault_injector=fi, seed=9,
        breakers=[R.CircuitBreaker(failure_threshold=10_000)
                  for _ in range(3)])
    results, fails = {}, {}
    for i in range(6):
        try:
            rid = router.submit(_p(3, 1, i + 1), max_new_tokens=3)
        except R.ReliabilityError as e:
            fails[i] = type(e).__name__
            continue
        _drive(router, reps)
        results[i] = _outcome(router, rid)
    rids = {}
    for i in range(6, 12):
        try:
            rids[i] = router.submit(_p(3, 1, i + 1), max_new_tokens=3)
        except R.ReliabilityError as e:
            fails[i] = type(e).__name__
    victim = int(np.argmax([r.queue_depth() for r in reps]))
    reps[victim].kill()
    _drive(router, reps)
    for i, rid in rids.items():
        results[i] = _outcome(router, rid)
    fi.disarm()
    rid = router.submit(_p(8, 8), max_new_tokens=3)
    _drive(router, reps)
    results["after"] = _outcome(router, rid)
    return (fi.trace, results, fails, _stats(router), _balances(reps))


def test_same_seed_dispatch_storm_equals_the_jax_router():
    """A 25% ``router.dispatch`` storm, then a kill and a failover: the
    same fault trace, results, typed failures, counters and balances as
    the JAX router; every served request is the oracle's."""
    trace, results, fails, st, _ = _both(_storm_script)
    assert trace, "the storm injected nothing"
    assert st["dispatch_retries"] >= len(trace)
    for i, out in results.items():
        if isinstance(out, tuple):
            p = _p(8, 8) if i == "after" else _p(3, 1, i + 1)
            assert out == _tok(stub_tokens(p, 3))


def _evacuate_fault_script(side):
    R = side["R"]
    fi = R.FaultInjector(seed=0).on(R.faults.ROUTER_EVACUATE,
                                    schedule=[0])
    router, reps = _router(side, n=2, fault_injector=fi)
    rid = router.submit(_p(1, 2, 3), max_new_tokens=4)
    vi = int(np.argmax(router.stats["routed"]))
    reps[vi].kill()
    seen = [router.poll(), reps[vi].queue_depth(),
            router.supervisor.failed_sweeps, router.poll(),
            router.stats["requeued"]]
    _drive(router, reps)
    seen.append(_outcome(router, rid))
    return seen


def test_evacuate_fault_aborts_then_retries():
    seen = _both(_evacuate_fault_script)
    assert seen[:5] == [1, 1, 1, 0, 1]
    assert seen[5] == _tok(stub_tokens(_p(1, 2, 3), 4))


# ------------------------------------------------------------- telemetry


def _telemetry_script(side):
    router, reps = _router(side, n=2, telemetry=True)
    rid = router.submit(_p(1, 2, 3), max_new_tokens=3)
    reps[int(np.argmax(router.stats["routed"]))].kill()
    _drive(router, reps)
    out = _outcome(router, rid)
    text = router.telemetry.registry.render()
    names = [n for n in ("router_routed_total", "router_requeued_total",
                         "router_evacuations_total", "router_queue_depth",
                         "router_replicas_serving", "router_health")
             if n in text]
    parsed = side["T"].parse_prometheus(text)
    return out, names, sorted((k, v) for k, v in parsed.items())


def test_router_counters_equal_the_jax_routers():
    out, names, _ = _both(_telemetry_script)
    assert len(names) == 6


def test_serve_metrics_of_a_router_aggregates_healthz():
    router, reps = _router(SIDES["port"], telemetry=True)
    ms = serve_metrics(router)
    try:
        with urllib.request.urlopen(ms.url + "/healthz", timeout=10) as r:
            assert r.status == 200
        reps[0].kill()
        assert router.health == "degraded"
        with urllib.request.urlopen(ms.url + "/healthz", timeout=10) as r:
            assert r.status == 200
        router.stop(drain=False)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(ms.url + "/healthz", timeout=10)
        assert ei.value.code == 503
        with urllib.request.urlopen(ms.url + "/stats", timeout=10) as r:
            body = json.loads(r.read().decode())
        assert "replicas" in body["stats"] and "routed" in body["stats"]
        with urllib.request.urlopen(ms.url + "/fleet", timeout=10) as r:
            assert b"router_health" in r.read()
    finally:
        ms.close()


def _affinity_vs_rr_script(side, policy):
    router, reps = _router(side, policy=policy)
    rng = np.random.default_rng(0)
    groups = [rng.integers(0, 16, (16,)).astype(np.int32)
              for _ in range(2)]
    for rnd in range(6):
        for g in groups:
            p = np.concatenate([g, _p(rnd + 1)])
            rid = router.submit(p, max_new_tokens=2)
            _drive(router, reps)
            assert _outcome(router, rid) == _tok(stub_tokens(p, 2))
    return (sum(r.stats["prefix_auto_hits"] for r in reps),
            router.stats["affinity_hits"])


def test_affinity_beats_round_robin_counters():
    aff = _both(_affinity_vs_rr_script, "affinity")
    rr = _both(_affinity_vs_rr_script, "round_robin")
    assert aff == (10, 10) and rr[0] < aff[0]


# ------------------------------------------------------ evacuate() hook


def _evacuate_script(side):
    srv = _rep(side, max_slots=1)
    ra = srv.submit(_p(1, 2), max_new_tokens=6)
    srv.step()
    rb = srv.submit(_p(3, 4), max_new_tokens=2)
    harvested = srv.evacuate()
    seen = [[h.rid for h in harvested], srv.queue_depth(),
            srv.in_flight()]
    out = srv.run()
    seen += [_tok(out[ra]), rb in out, rb in srv.failures]
    srv = _rep(side, max_slots=1)
    ra = srv.submit(_p(1, 2), max_new_tokens=10)
    srv.step()
    srv.step()
    seen += [srv.evacuate(flush_partials=True), _tok(srv._results[ra])]
    # kill keeps the queue and the slot for the harvest, then restarts
    srv = _rep(side, max_slots=1)
    ra = srv.submit(_p(1, 2), max_new_tokens=50)
    srv.step()
    rb = srv.submit(_p(5, 6), max_new_tokens=4)
    srv.kill()
    seen += [srv.health, srv.queue_depth(), srv.in_flight(),
             rb in srv.failures]
    seen.append([h.rid for h in srv.evacuate(flush_partials=True)])
    seen.append(_tok(srv._results.pop(ra)))
    seen.append(_balances([srv]))
    return seen


def test_evacuate_hook_equals_the_jax_server():
    seen = _both(_evacuate_script)
    assert seen[0] == [1] and seen[1:3] == [0, 1]
    assert seen[3] == _tok(stub_tokens(_p(1, 2), 6))
    assert seen[6] == [] and seen[8:12] == ["dead", 1, 1, False]


# ------------------------------------------------------------ orphan TTL


def _orphan_ttl_script(side):
    router, reps = _router(side, n=2, telemetry=True)
    foreign = reps[0].submit(_p(1, 2, 3), max_new_tokens=4)
    reps[0].kill()
    seen = []
    for _ in range(3):
        router.poll()
        seen.append(router.stats["orphaned"])
    seen.append(_raises(lambda: reps[0].wait(foreign, timeout=1.0)))
    seen.append(router.telemetry.registry.get(
        "router_orphaned_total").value)
    # router-owned rids are never orphan-failed
    router, reps = _router(side, n=2, rep_kw={"max_slots": 1})
    rid = router.submit(_p(4, 5), max_new_tokens=4)
    src = next(i for i, r in enumerate(reps)
               if r.queue_depth() or r.in_flight())
    reps[src].kill()
    for _ in range(4):
        router.poll()
    seen.append(router.stats["orphaned"])
    _drive(router, reps)
    seen.append(_outcome(router, rid))
    return seen


def test_orphan_ttl_equals_the_jax_router():
    seen = _both(_orphan_ttl_script)
    assert seen[:5] == [0, 0, 1, "ReplicaLostError", 1.0]
    assert seen[5] == 0


# ----------------------------------------------- preemption pressure


def _pressure_script(side):
    seen = []
    router, reps = _router(side, n=2, policy="least_loaded")
    reps[0]._preempted.extend(object() for _ in range(3))
    for _ in range(3):
        router.submit(_p(1, 2), max_new_tokens=2)
    seen.append(list(router.stats["routed"]))
    reps[0]._preempted.clear()
    router.submit(_p(1, 2), max_new_tokens=2)
    seen.append(list(router.stats["routed"]))
    for w in (5.0, 1.0, 0.0):
        router, reps = _router(side, n=2, policy="least_loaded",
                               pressure_weight=w)
        reps[0]._preempted.append(object())
        for _ in range(2):
            reps[1].submit(_p(9, 9), max_new_tokens=2)
        router.submit(_p(1, 2), max_new_tokens=2)
        seen.append(list(router.stats["routed"]))
    router, reps = _router(side, n=2)
    router.submit(_p(7, 7), max_new_tokens=2, priority=2)
    seen.append(next(r._queue[0] for r in reps if r.queue_depth()).priority)
    return seen


def test_preempt_pressure_routing_equals_the_jax_router():
    assert _both(_pressure_script) == [
        [0, 3], [1, 3], [0, 1], [1, 0], [1, 0], 2]


def _parked_flush_script(side):
    router, reps = _router(side, n=2, rep_kw={
        "admission": "optimistic", "num_pages": 17})
    rid = router.submit(_p(1, 2, 3, 4), max_new_tokens=12)
    rep = reps[router._routes[rid].idx]
    for _ in range(4):
        rep.step()
    with rep._lock:
        slot = next(s for s in range(rep.max_slots)
                    if rep._slots[s] is not None)
        rep._preempt_slot_locked(slot)
    seen = [rep.in_flight(), rep.queue_depth(), rep.preempt_pressure()]
    rep.kill()
    router.poll()
    out = _outcome(router, rid)
    assert 0 < len(out) and out == _tok(
        stub_tokens(_p(1, 2, 3, 4), 12)[:len(out)])
    return seen, out, _balances(reps)


def test_dead_replica_flushes_its_parked_requests():
    seen, _, _ = _both(_parked_flush_script)
    assert seen == [0, 0, 1]
