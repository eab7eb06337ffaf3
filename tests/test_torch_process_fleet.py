"""Kill drills on the port's process replicas, on the CPU: each replica
is a SPAWNED process (``spawn_replica_host`` over the factories of
``tests/_torch_remote_stub.py``, ``TorchStub`` servers) behind the wire,
and the crash is ``SIGKILL`` — no atexit, no drain, no goodbye frame.

- ``tests/test_process_fleet.py``'s drill under a 20–30% ``net.*``
  storm: the supervisor reads the dead wire, the evacuated queue
  replays on the sibling process, requests caught mid-decode flush
  their streamed partials, the survivor leaks no page, and the
  failed-over request's journey is one flow across pids. The greedy
  drill is held to ``stub_tokens``' closed form (the JAX package's
  drill is flaky and is not re-run here); the sampled one, to a port
  oracle server on the same resolved seeds, is marked ``slow`` as in the
  reference.
- ``TestMidMigrationKillDrill`` and ``TestPrefillSpecialistKillDrill``
  of ``tests/test_migration.py``: the migration target, then a prefill
  specialist, SIGKILLed mid-move; the request still finishes of the
  closed form with zero leaked pages.
- A spawned port host's ``sys.modules`` holds no JAX module.

Every spawned child is killed and joined by the ``procs`` fixture.
"""
import json
import os
import signal
import socket
import time

import numpy as np
import pytest

from _torch_remote_stub import (TorchStub, jax_free_report,
                                make_slow_stub_server, make_stub_server,
                                stub_tokens)
from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                        RemoteReplica, ReplicaRouter,
                                        spawn_replica_host)
from paddle_tpu_torch.inference.transport import NetDrop
from paddle_tpu_torch.reliability import (FaultInjector, QueueFullError,
                                          ReplicaLostError,
                                          TransportError, faults)


def _loopback_available():
    try:
        s = socket.create_server(("127.0.0.1", 0))
        s.close()
        return True
    except OSError:
        return False


pytestmark = [
    pytest.mark.net,
    pytest.mark.skipif(not _loopback_available(),
                       reason="cannot bind a loopback socket here"),
]

SERVER_KW = {"max_slots": 2, "max_cache_len": 64, "page_size": 8}
PROMPT = (np.arange(1, 12, dtype=np.int32) % 13)
BUDGET = 48


@pytest.fixture
def procs():
    spawned = []
    yield spawned
    for proc in spawned:
        if proc.is_alive():
            proc.kill()
        proc.join(10)


def _wait(pred, timeout=30, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out on: {msg}"
        time.sleep(0.005)


def _spawn(procs, factory, kw, **extra):
    proc, addr = spawn_replica_host(factory, kw, heartbeat_s=0.05,
                                    start_server=True, **extra)
    procs.append(proc)
    return addr


def _one_flow(router, rid, tmp_path):
    """The journey of router request ``rid`` in the merged fleet trace:
    one flow, first event ``s`` and last ``f``, across >= 2 pids."""
    path = tmp_path / "fleet.json"
    router.export_fleet_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    flows = [e for e in evs if e.get("cat") == "journey"
             and e.get("id") == f"r{rid}"]
    assert len(flows) >= 2
    assert flows[0]["ph"] == "s" and flows[-1]["ph"] == "f"
    assert len({e["pid"] for e in flows}) >= 2


@pytest.mark.parametrize(
    "do_sample",
    [False, pytest.param(True, marks=pytest.mark.slow)],
    ids=["greedy", "sampled"])
def test_sigkill_drill_under_net_storm(procs, tmp_path, do_sample):
    server_kw = dict(SERVER_KW, do_sample=do_sample, telemetry=True)
    if do_sample:
        server_kw["temperature"] = 1.3
    addrs = [_spawn(procs, make_slow_stub_server,
                    dict(server_kw, tick_sleep_s=0.05))
             for _ in range(2)]
    fi = FaultInjector(seed=42, enabled=False) \
        .on(faults.NET_SEND, probability=0.25, error=NetDrop) \
        .on(faults.NET_RECV, probability=0.20, error=NetDrop) \
        .on(faults.NET_CONNECT, probability=0.25)
    reps = [RemoteReplica(addr, fault_injector=fi, call_timeout_s=1.0,
                          dead_after_s=0.6, draining_after_s=0.3)
            for addr in addrs]
    router = ReplicaRouter(reps, policy="least_loaded", journeys=True,
                           recorder=True)
    router.start(poll_interval=0.05, start_replicas=False)

    def submit_retrying(p, n, deadline):
        while True:
            try:
                return router.submit(p, max_new_tokens=n)
            except (ReplicaLostError, QueueFullError):
                assert time.monotonic() < deadline, \
                    "fleet never accepted a submit"
                time.sleep(0.05)

    try:
        deadline = time.monotonic() + 60
        warm = [submit_retrying(np.asarray([9, i + 1], np.int32), 2,
                                deadline) for i in range(4)]
        for rid in warm:
            router.wait(rid, timeout=60)
        K, budget = 8, 20
        prompts = [np.asarray([5, 3, i + 1], np.int32) for i in range(K)]
        fi.arm()
        deadline = time.monotonic() + 60
        rids = [submit_retrying(p, budget, deadline) for p in prompts]
        with router._lock:
            seeds = {rid: router._routes[rid].item.seed for rid in rids}
        deadline = time.monotonic() + 60
        victim = None
        while victim is None:
            for idx, rep in enumerate(reps):
                queued, decoding = rep._mirror_counts()
                if queued >= 1 and decoding >= 1:
                    victim = idx
                    break
            if victim is None:
                assert time.monotonic() < deadline, \
                    "fleet never reached mid-decode with a backlog"
                time.sleep(0.005)
        with router._lock:
            victim_rids = {rid for rid, rt in router._routes.items()
                           if rt.idx == victim}
        os.kill(procs[victim].pid, signal.SIGKILL)
        procs[victim].join(10)
        deadline = time.monotonic() + 60
        while router.stats["evacuations"] < 1 \
                or router.stats["requeued"] < 1:
            assert time.monotonic() < deadline, \
                f"no failover observed: {router.stats}"
            time.sleep(0.02)
        fi.disarm()
        results = {rid: router.wait(rid, timeout=60) for rid in rids}
        if do_sample:
            oracle = ContinuousBatchingServer(
                TorchStub(), cache_backend="paged",
                **{k: v for k, v in server_kw.items()
                   if k != "telemetry"})
            orid = {rid: oracle.submit(p, max_new_tokens=budget,
                                       seed=seeds[rid])
                    for rid, p in zip(rids, prompts)}
            out = oracle.run()
            expected = {rid: out[orid[rid]] for rid in rids}
        else:
            expected = {rid: stub_tokens(p, budget)
                        for rid, p in zip(rids, prompts)}
        full = partial = 0
        for rid in rids:
            exp, got = expected[rid], results[rid]
            if len(got) == len(exp):
                np.testing.assert_array_equal(got, exp)
                full += 1
            else:
                assert len(got) < len(exp)
                np.testing.assert_array_equal(got, exp[:len(got)])
                partial += 1
                assert rid in victim_rids
        assert full + partial == K
        assert full >= 1 and partial >= 1
        bal = reps[1 - victim].pool_balance()
        assert bal is not None and bal[1] == 0, f"leaked: {bal}"
        replayed = [rid for rid in rids if rid in victim_rids
                    and len(results[rid]) == budget]
        assert replayed
        where = f"replica{1 - victim}"
        requeued = next(
            (rid for rid in replayed
             if any(e["where"] == where
                    for e in router._jrec.journey(f"r{rid}") or ())),
            replayed[0])
        _one_flow(router, requeued, tmp_path)
    finally:
        router.stop(drain=False, timeout=20, stop_replicas=False)
        for rep in reps:
            rep.close()


class TestMidMigrationKillDrill:
    def test_sigkill_target_falls_back_zero_leaks_one_flow(self, procs,
                                                           tmp_path):
        """The migration TARGET process dies between the source's gather
        and the restore: the router counts a fallback, the source
        resumes the paused slot and finishes of the closed form, zero
        leaked pages, one journey flow across pids."""
        kw = dict(SERVER_KW, num_pages=17, tick_sleep_s=0.03)
        addrs = [_spawn(procs, make_slow_stub_server, kw)
                 for _ in range(2)]
        reps = [RemoteReplica(addr, call_timeout_s=2.0) for addr in addrs]
        router = ReplicaRouter(reps, policy="least_loaded", journeys=True,
                               recorder=True)
        got = []
        try:
            rid = router.submit(PROMPT, max_new_tokens=BUDGET,
                                on_token=lambda r, t: got.extend(
                                    int(x) for x in t))
            _wait(lambda: len(got) >= 6, timeout=60,
                  msg="first streamed tokens from the child")
            with router._lock:
                src = router._routes[rid].idx
            victim = 1 - src
            os.kill(procs[victim].pid, signal.SIGKILL)
            procs[victim].join(10)
            assert router._migrate_live(src) == 0
            assert router._stats["migration_fallbacks"] == 1
            assert router._stats["migrations"] == 0
            out = router.wait(rid, timeout=60)
            np.testing.assert_array_equal(out,
                                          stub_tokens(PROMPT, BUDGET))
            assert got == [int(t) for t in stub_tokens(PROMPT, BUDGET)]
            bal = reps[src].pool_balance()
            assert bal is not None and bal[1] == 0, f"leaked: {bal}"
            assert any(e["phase"] == "migrating" and e.get("fallback")
                       for e in router.journey(rid))
            _one_flow(router, rid, tmp_path)
        finally:
            router.stop(drain=False, timeout=20, stop_replicas=False)
            for rep in reps:
                rep.close()


class TestPrefillSpecialistKillDrill:
    def test_sigkill_prefill_specialist_mid_handoff(self, procs, tmp_path):
        """The prefill specialist process dies mid-prompt: the prompt
        requeues on the decode replica (which prefills it itself) and
        finishes of the closed form, zero lost requests, zero leaked
        pages on the survivor, one journey flow across pids."""
        base = dict(SERVER_KW, max_cache_len=96, num_pages=24,
                    tick_sleep_s=0.01, prefill_tokens_per_tick=8)
        addrs = [_spawn(procs, make_slow_stub_server, dict(base, role=r))
                 for r in ("prefill", "decode")]
        reps = [RemoteReplica(addr, call_timeout_s=2.0) for addr in addrs]
        router = ReplicaRouter(reps, placement="disaggregated",
                               disagg_prefill_min_tokens=16,
                               journeys=True, recorder=True)
        prompt = (np.arange(1, 41, dtype=np.int32) % 13)
        budget = 16
        got = []
        try:
            _wait(lambda: reps[0].role == "prefill"
                  and reps[1].role == "decode", timeout=30,
                  msg="roles ride the heartbeat digests")
            router.start(poll_interval=0.02, start_replicas=False)
            rid = router.submit(prompt, max_new_tokens=budget,
                                on_token=lambda r, t: got.extend(
                                    int(x) for x in t))
            with router._lock:
                assert router._routes[rid].idx == 0
            time.sleep(0.04)
            os.kill(procs[0].pid, signal.SIGKILL)
            procs[0].join(10)
            out = router.wait(rid, timeout=60)
            ref = stub_tokens(prompt, budget)
            np.testing.assert_array_equal(out, ref)
            _wait(lambda: len(got) >= budget, timeout=15,
                  msg="stream drained")
            assert got == [int(t) for t in ref]
            _wait(lambda: (reps[1].pool_balance() or (0, 1))[1] == 0,
                  timeout=30, msg="decode pool settles to zero live")
            _one_flow(router, rid, tmp_path)
        finally:
            router.stop(drain=False, timeout=20, stop_replicas=False)
            for rep in reps:
                rep.close()


def test_spawned_port_host_holds_no_jax(procs):
    """The child builds its server from a factory that records the
    process's JAX modules into ``stats``; the wire brings back an empty
    list, and the child serves the closed form."""
    addr = _spawn(procs, jax_free_report, dict(SERVER_KW))
    rep = RemoteReplica(addr)
    try:
        assert rep.stats["jax_modules"] == []
        p = np.asarray([2, 5, 9], np.int32)
        np.testing.assert_array_equal(
            rep.wait(rep.submit(p, max_new_tokens=6), timeout=30),
            stub_tokens(p, 6))
        rep.shutdown()
        procs[0].join(10)
        assert procs[0].exitcode == 0
    finally:
        rep.close()


def test_fork_after_cuda_init_is_refused(monkeypatch):
    """``method="fork"`` from a process whose CUDA is initialised raises
    ``TransportError`` naming the reason, and starts no child."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(TransportError, match="initialised CUDA"):
        spawn_replica_host(make_stub_server, dict(SERVER_KW),
                           method="fork")
