"""The port's process replicas (``paddle_tpu_torch.inference.remote``)
against the JAX package's, on the CPU, with the hosts on threads in
this process and the real wire protocol over loopback TCP.

- The contracts of ``tests/test_remote_replica.py`` run on both packages
  (``side``: the JAX host over ``StubModel``, the port's over
  ``TorchStub``), each held to ``stub_tokens``' closed form: submit,
  wait and stream, the seeded sampled chain, the default seed reported
  to the client's mirror, typed errors, cancel, deadlines re-anchored on
  the host, the wire evacuation, digests and the staleness walk (on an
  injected ``FakeClock``: the clock is advanced, nothing sleeps), the
  sketch, the router over remote replicas (affinity, a mixed local and
  remote fleet, a rolling restart, ``/fleet`` over remote snapshots)
  and the host fuzz. Two of them are flaky on the JAX side
  (``test_wait_survives_lost_reply_via_delivery_stash`` and
  ``test_sigkill_less_crash_failover_bit_exact``): they run on the port
  alone.
- The wire migration classes of ``tests/test_migration.py``
  (``TestWireMigration``, ``TestMigrationChaosStorm``: one seed gives
  the JAX run's fault trace and tokens; ``TestPartialHandoffStorm``)
  and a ``llama_tiny`` f32 wire move between port hosts.
- The heartbeat's utilization (``tests/test_costs.py``).
- A port host's digest against a JAX host's on the same script.
- Mixed fleets over the wire: a port router over a JAX host and a port
  host, a JAX router over the same pair, equal tokens, and an f32 wire
  move each way.
"""
import json
import random
import socket
import struct
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu.reliability as JR
import paddle_tpu.telemetry as JT
import paddle_tpu_torch.reliability as TR
import paddle_tpu_torch.telemetry as TT
from _serving_stub import StubModel, stub_tokens
from _torch_remote_stub import TorchStub
from _torch_remote_stub import stub_tokens as port_stub_tokens
from paddle_tpu.inference import transport as jax_transport
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.inference.prefix_cache import \
    prefix_fingerprints as jax_fingerprints
from paddle_tpu.inference.remote import RemoteReplica as JaxRemote
from paddle_tpu.inference.remote import ReplicaHost as JaxHost
from paddle_tpu.inference.router import ReplicaRouter as JaxRouter
from paddle_tpu.telemetry.clock import FakeClock as JaxFakeClock
from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                        RemoteReplica, ReplicaHost,
                                        ReplicaRouter, prefix_fingerprints)
from paddle_tpu_torch.inference import transport as torch_transport
from paddle_tpu_torch.telemetry.clock import FakeClock


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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SIDES = {
    "jax": types.SimpleNamespace(
        Server=JaxServer, Model=StubModel, Host=JaxHost, Remote=JaxRemote,
        Router=JaxRouter, R=JR, Tele=JT, T=jax_transport,
        fingerprints=jax_fingerprints, FakeClock=JaxFakeClock),
    "port": types.SimpleNamespace(
        Server=ContinuousBatchingServer, Model=TorchStub, Host=ReplicaHost,
        Remote=RemoteReplica, Router=ReplicaRouter, R=TR, Tele=TT,
        T=torch_transport, fingerprints=prefix_fingerprints,
        FakeClock=FakeClock),
}


def _server(s, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("cache_backend", "paged")
    kw.setdefault("page_size", 8)
    return s.Server(s.Model(), **kw)


class _Fleet:
    """Hosts, replicas, routers and servers of one side, torn down after
    each test."""

    def __init__(self, side):
        self.s = side
        self.hosts, self.reps, self.routers, self.servers = [], [], [], []

    def host_rep(self, heartbeat_s=0.02, server_kw=None, rep_kw=None):
        s = self.s
        srv = _server(s, **(server_kw or {}))
        host = s.Host(srv, heartbeat_s=heartbeat_s).start()
        rep = s.Remote(host.address, **(rep_kw or {}))
        self.hosts.append(host)
        self.reps.append(rep)
        self.servers.append(srv)
        return host, rep, srv

    def close(self):
        for router in self.routers:
            try:
                router.stop(drain=False, timeout=10, stop_replicas=False)
            except RuntimeError:
                pass
        for rep in self.reps:
            rep.close()
        for host in self.hosts:
            host.close()
        for srv in self.servers:
            if srv._thread is not None:
                try:
                    srv.stop(timeout=10)
                except RuntimeError:
                    pass


@pytest.fixture(params=sorted(SIDES))
def fleet(request):
    f = _Fleet(SIDES[request.param])
    yield f
    f.close()


@pytest.fixture
def port_fleet():
    f = _Fleet(SIDES["port"])
    yield f
    f.close()


def _prompt(*toks):
    return np.asarray(toks, np.int32)


def _until(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out on: {msg}"
        time.sleep(0.005)


def test_stub_oracles_agree():
    for p, n in (([2, 5, 9], 6), ([1], 9), (list(range(17)), 4)):
        np.testing.assert_array_equal(port_stub_tokens(p, n),
                                      stub_tokens(p, n))


# ================================================== test_remote_replica.py
class TestWireContract:
    def test_submit_wait_bit_exact_with_streaming(self, fleet):
        _, rep, _ = fleet.host_rep()
        rep.start()
        chunks = []
        p = _prompt(2, 5, 9)
        rid = rep.submit(p, max_new_tokens=6,
                         on_token=lambda r, t: chunks.append(list(t)))
        out = rep.wait(rid, timeout=20)
        exp = stub_tokens(p, 6)
        np.testing.assert_array_equal(out, exp)
        assert [t for c in chunks for t in c] == list(exp)

    def test_sampled_chain_parity_with_local_server(self, fleet):
        _, rep, _ = fleet.host_rep(
            server_kw={"do_sample": True, "temperature": 1.3})
        rep.start()
        local = _server(fleet.s, do_sample=True, temperature=1.3)
        p = _prompt(4, 4, 8)
        rid = rep.submit(p, max_new_tokens=8, seed=123)
        got = rep.wait(rid, timeout=20)
        lrid = local.submit(p, max_new_tokens=8, seed=123)
        np.testing.assert_array_equal(got, local.run()[lrid])

    def test_default_seed_reported_to_mirror_matches_server(self, fleet):
        _, rep, srv = fleet.host_rep(
            server_kw={"do_sample": True, "seed": 31})
        rid = rep.submit(_prompt(2, 2), max_new_tokens=4)   # no seed
        with rep._state_lock:
            mirrored = rep._mirror[rid].seed
        with srv._lock:
            actual = next(i.seed for i in srv._queue if i.rid == rid)
        assert mirrored == actual == 31 + rid

    def test_typed_errors_cross_the_wire(self, fleet):
        _, rep, _ = fleet.host_rep(
            server_kw={"max_queue": 0, "shed_policy": "reject"})
        with pytest.raises(fleet.s.R.DeadlineExceeded):
            rep.submit(_prompt(1), max_new_tokens=2, deadline_s=-1)
        with pytest.raises(fleet.s.R.QueueFullError):
            rep.submit(_prompt(1), max_new_tokens=2)

    def test_cancel_queued_raises_typed(self, fleet):
        _, rep, _ = fleet.host_rep()        # serve thread NOT started
        rid = rep.submit(_prompt(3, 1), max_new_tokens=4)
        assert rep.cancel(rid) is True
        with pytest.raises(fleet.s.R.RequestCancelled):
            rep.wait(rid, timeout=5)

    def test_deadline_reanchors_on_host_clock(self, fleet):
        _, rep, _ = fleet.host_rep()        # not started: stays queued
        rid = rep.submit(_prompt(7, 7), max_new_tokens=4, deadline_s=0.1)
        time.sleep(0.2)
        rep.start()
        with pytest.raises(fleet.s.R.DeadlineExceeded):
            rep.wait(rid, timeout=10)

    def test_wire_evacuate_returns_remaining_deadline(self, fleet):
        _, rep, _ = fleet.host_rep()        # not started: stays queued

        def sink(rid_, toks):
            pass

        rid = rep.submit(_prompt(6, 2), max_new_tokens=4, on_token=sink,
                         deadline_s=30.0, priority=2)
        harvested = rep.evacuate()
        assert [h.rid for h in harvested] == [rid]
        h = harvested[0]
        np.testing.assert_array_equal(h.ids, _prompt(6, 2))
        assert h.budget == 4 and h.priority == 2
        assert h.on_token is sink
        assert 25.0 < h.deadline - rep._clock.now() <= 30.0
        assert rep._call("stats")["admissions"] == 0


def test_wait_survives_lost_reply_via_delivery_stash(port_fleet):
    """A wait whose REPLY frame is dropped retries and still gets the
    result from the host's delivery stash (the port alone). Made
    deterministic: the host's heartbeats are paused, so the first frame
    it sends after the drop is armed on its connection IS the reply."""
    host, rep, _ = port_fleet.host_rep()
    rep.start()
    p = _prompt(5, 5)
    rid = rep.submit(p, max_new_tokens=4)
    np.testing.assert_array_equal(rep.wait(rid, timeout=20),
                                  port_stub_tokens(p, 4))
    host.pause_heartbeats()
    time.sleep(0.1)                     # a digest already in flight lands
    fi = TR.FaultInjector(seed=2).on(TR.faults.NET_SEND, schedule=[0],
                                     error=torch_transport.NetDrop)
    (conn,) = host._conns
    conn._faults = fi
    np.testing.assert_array_equal(rep.wait(rid, timeout=20),
                                  port_stub_tokens(p, 4))
    assert fi.fired(TR.faults.NET_SEND) == 1     # the first reply vanished
    assert host._delivered[rid][0] == "ok"


class TestDigestsAndStaleness:
    def test_routing_reads_come_from_pushed_digest(self, fleet):
        host, rep, srv = fleet.host_rep()
        for i in range(3):
            rep.submit(_prompt(1, 1, i + 1), max_new_tokens=2)
        _until(lambda: rep._digest is not None
               and rep._digest.get("queue_depth") == 3,
               msg="digest refreshed")
        assert rep.queue_depth() == srv.queue_depth() == 3
        assert rep.health == "healthy"
        assert rep.stats["admissions"] == 0

    def test_staleness_walks_draining_then_dead_then_recovers(self,
                                                              fleet):
        clock = fleet.s.FakeClock(100.0)
        host, rep, _ = fleet.host_rep(
            rep_kw={"draining_after_s": 0.15, "dead_after_s": 0.4,
                    "clock": clock})
        assert rep.health == "healthy"
        host.pause_heartbeats()
        time.sleep(0.1)                 # a digest already in flight lands
        seq = rep._digest["seq"]
        clock.advance(0.2)
        assert rep.health == "draining"
        clock.advance(0.25)
        assert rep.health == "dead"
        assert rep._digest["seq"] == seq       # nothing arrived meanwhile
        host.resume_heartbeats()
        _until(lambda: rep.health == "healthy", msg="recovered")

    def test_sketch_crosses_the_wire_for_affinity(self, fleet):
        _, rep, _ = fleet.host_rep()
        rep.start()
        p = np.arange(16, dtype=np.int32)
        rid = rep.submit(np.concatenate([p, _prompt(1)]),
                         max_new_tokens=2)
        rep.wait(rid, timeout=20)
        fps = fleet.s.fingerprints(p, 8)
        _until(lambda: all(fp in rep.prefix_sketch() for fp in fps),
               msg="sketch arrived")


class TestRouterOverRemote:
    def test_affinity_routes_to_the_remote_holding_the_pages(self, fleet):
        reps = [fleet.host_rep()[1] for _ in range(3)]
        router = fleet.s.Router(reps)
        fleet.routers.append(router)
        router.start(poll_interval=0.02)
        shared = np.arange(16, dtype=np.int32) % 16
        for i in range(5):
            p = np.concatenate([shared, _prompt(i + 1)])
            rid = router.submit(p, max_new_tokens=3)
            np.testing.assert_array_equal(router.wait(rid, timeout=30),
                                          stub_tokens(p, 3))
            fps = fleet.s.fingerprints(p[:16], 8)
            _until(lambda: any(all(fp in r.prefix_sketch() for fp in fps)
                               for r in reps), msg="donation reached a "
                   "sketch")
        assert router.stats["affinity_hits"] == 4
        assert router.stats["fallbacks"] == 1
        assert max(router.stats["routed"]) == 5

    def test_mixed_local_and_remote_fleet_failover(self, fleet):
        host, remote, _ = fleet.host_rep(rep_kw={"dead_after_s": 0.3})
        local = _server(fleet.s)
        fleet.servers.append(local)
        router = fleet.s.Router([remote, local], policy="least_loaded")
        fleet.routers.append(router)
        router.start(poll_interval=0.02)
        rids = [(router.submit(_prompt(4, i + 1), max_new_tokens=3), i)
                for i in range(6)]
        for rid, i in rids:
            np.testing.assert_array_equal(
                router.wait(rid, timeout=30),
                stub_tokens(_prompt(4, i + 1), 3))
        routed = router.stats["routed"]
        assert routed[0] > 0 and routed[1] > 0
        host.sever()
        more = [(router.submit(_prompt(6, i + 1), max_new_tokens=3), i)
                for i in range(4)]
        for rid, i in more:
            got = router.wait(rid, timeout=30)
            exp = stub_tokens(_prompt(6, i + 1), 3)
            np.testing.assert_array_equal(got, exp[:len(got)])
        assert router.health == "degraded"

    def test_rolling_restart_over_the_wire_zero_failures(self, fleet):
        reps = [fleet.host_rep()[1] for _ in range(2)]
        router = fleet.s.Router(reps, policy="least_loaded")
        fleet.routers.append(router)
        router.start(poll_interval=0.02)
        rids = [(router.submit(_prompt(3, i + 1), max_new_tokens=4), i)
                for i in range(6)]
        router.rolling_restart(drain_timeout=60.0)
        for rid, i in rids:
            np.testing.assert_array_equal(
                router.wait(rid, timeout=30),
                stub_tokens(_prompt(3, i + 1), 4))
        assert router.stats["restarts"] == 2

    def test_fleet_page_merges_remote_snapshots(self, fleet):
        rt = fleet.s.Tele.RouterTelemetry()
        host, rep, srv = fleet.host_rep(
            server_kw={"telemetry": True},
            rep_kw={"registry": rt.registry})
        router = fleet.s.Router([rep], telemetry=rt)
        fleet.routers.append(router)
        router.start(poll_interval=0.02)
        rid = router.submit(_prompt(9, 1), max_new_tokens=3)
        router.wait(rid, timeout=30)
        page = router.fleet_metrics()
        for name in ("serving_requests_total", "net_frames_total",
                     "net_call_seconds", "net_heartbeats_total"):
            assert name in page
        snap = router.fleet_snapshot()
        assert snap["serving_requests_total"]["samples"][
            ("finished",)] >= 1


def test_sigkill_less_crash_failover_bit_exact(port_fleet):
    """``host.close()`` stands in for a crash: the supervisor reads the
    dead wire, the synthesized evacuation requeues unstreamed
    requests on the sibling and flushes streamed ones as partials — all
    of the closed form (the port alone), zero pages left live. Made
    deterministic: the replicas start only after the eight submits, and
    the victim is stepped by hand through one admission tick (two slots
    streaming) before its network face goes. ``close()`` takes the
    listener too, so the client cannot reconnect (a reconnect would let
    the draining path move the two streaming requests live instead):
    two partials, six full."""
    host0, rep0, srv0 = port_fleet.host_rep(rep_kw={"dead_after_s": 0.3})
    host1, rep1, srv1 = port_fleet.host_rep()
    router = ReplicaRouter([rep0, rep1], policy="least_loaded",
                           telemetry=True)
    port_fleet.routers.append(router)
    router.start(poll_interval=0.02, start_replicas=False)
    rids = [(router.submit(_prompt(2, i + 1), max_new_tokens=4), i)
            for i in range(8)]
    assert router.stats["routed"] == [4, 4]
    srv0.step()                             # admit two, stream their first
    # the tick streams each slot's prefill token and then its first
    # decode token, as two frames: wait until the mirror holds every
    # token the victim emitted, not just the first frame of each
    with srv0._lock:
        emitted = {int(st.rid): len(st.emitted) for st in srv0._slots
                   if st is not None}

    def mirrored():
        with rep0._state_lock:
            return {rid: len(m.tokens) for rid, m in rep0._mirror.items()
                    if m.tokens}

    _until(lambda: rep0._mirror_counts() == (2, 2)
           and mirrored() == emitted,
           msg="the victim's streamed tokens reached the mirror")
    with rep0._state_lock:
        streamed = {m.rid: len(m.tokens) for m in rep0._mirror.values()
                    if m.tokens}
    rep1.start()
    host0.close()
    full = partial = 0
    for rid, i in rids:
        got = router.wait(rid, timeout=30)
        exp = port_stub_tokens(_prompt(2, i + 1), 4)
        np.testing.assert_array_equal(got, exp[:len(got)])
        if len(got) == len(exp):
            full += 1
        else:
            partial += 1
            assert len(got) in streamed.values()
    assert (full, partial) == (6, 2)
    assert router.stats["evacuations"] >= 1
    assert router.stats["requeued"] == 2
    assert srv1.pool_balance()[1] == 0


class TestHostFuzz:
    def test_garbage_frames_do_not_kill_host_or_real_client(self, fleet):
        host, rep, _ = fleet.host_rep()
        rep.start()
        rng = random.Random(77)
        raw = socket.create_connection(host.address, timeout=5)
        try:
            for _ in range(30):
                kind = rng.randrange(3)
                if kind == 0:
                    junk = bytes(rng.randrange(256)
                                 for _ in range(rng.randrange(1, 60)))
                    raw.sendall(struct.pack("!I", len(junk)) + junk)
                elif kind == 1:
                    body = json.dumps({"id": rng.randrange(99),
                                       "op": "nope"}).encode()
                    raw.sendall(struct.pack("!I", len(body)) + body)
                else:
                    body = json.dumps([1, 2, 3]).encode()
                    raw.sendall(struct.pack("!I", len(body)) + body)
            p = _prompt(8, 3)
            rid = rep.submit(p, max_new_tokens=4)
            np.testing.assert_array_equal(rep.wait(rid, timeout=20),
                                          stub_tokens(p, 4))
            raw.sendall(struct.pack("!I", 0xFFFFFFFF) + b"xx")
            time.sleep(0.1)
            rid = rep.submit(p, max_new_tokens=2)
            np.testing.assert_array_equal(rep.wait(rid, timeout=20),
                                          stub_tokens(p, 2))
        finally:
            raw.close()

    def test_unknown_op_fails_that_call_typed(self, fleet):
        _, rep, _ = fleet.host_rep()
        with pytest.raises(ValueError, match="unknown wire op"):
            rep._call("definitely_not_an_op")
        assert rep.health == "healthy"
        assert rep._call("ping") == "pong"


# ======================================== the port host against the JAX host
def _digest_script(s):
    srv = _server(s, do_sample=True, temperature=0.8, ledger=True,
                  page_size=4, max_cache_len=32)
    for p, seed in (([1, 2, 3, 4, 5], 3), ([6, 7], 4)):
        srv.submit(np.asarray(p, np.int32), max_new_tokens=4, seed=seed)
    out = srv.run()
    host = s.Host(srv)                  # not started: the digest is pure
    try:
        d = host._digest()
        bal = host._op_pool_balance({})
    finally:
        host.close()
    json.dumps(d)
    return d, bal, {k: [int(t) for t in v] for k, v in out.items()}


def test_digest_and_stats_equal_the_jax_hosts():
    """The same sampled stub script behind a JAX host and a port host:
    the digests carry the same keys in the same order with equal values
    (the sketch, health, role, loads and the goodput ratio), the pool
    balance op the same dict, and ``stats`` equal on every key the two
    servers keep (the port's server adds its launch counters; the JAX
    server a prefill wall time)."""
    jd, jbal, jout = _digest_script(SIDES["jax"])
    td, tbal, tout = _digest_script(SIDES["port"])
    assert tout == jout
    assert list(td) == list(jd)
    for k in jd:
        if k != "stats":
            assert td[k] == jd[k], k
    shared = [k for k in jd["stats"] if k in td["stats"]]
    assert len(shared) >= 15
    assert {k: td["stats"][k] for k in shared} == \
        {k: jd["stats"][k] for k in shared}
    assert set(jd["stats"]) - set(td["stats"]) == {"prefill_wall_s"}
    assert tbal == jbal and tbal["live"] == 0


# ================================================ test_migration.py, wire
MIG_KW = dict(num_pages=17)
PROMPT = (np.arange(1, 12, dtype=np.int32) % 13)
BUDGET = 48


def _stub_server(s, **kw):
    return _server(s, **dict(MIG_KW, **kw))


def _slow(srv, tick_sleep_s):
    inner = srv._fire_callbacks

    def paced():
        time.sleep(tick_sleep_s)
        inner()

    srv._fire_callbacks = paced
    return srv


def _throttle_cls(s):
    class _Throttle(s.T.NetDelay):
        """Every host send dawdles 10 ms: the deferred token pushes fire
        on the serving thread, so this paces the decode loop."""
        SECONDS = 0.01
    return _Throttle


def _throttle_fi(s):
    return s.R.FaultInjector(seed=1).on(s.R.faults.NET_SEND,
                                        probability=1.0,
                                        error=_throttle_cls(s))


class _StormFactory:
    """Capped seeded drop storm over paced sends (see the reference)."""

    def __init__(self, s, seed, p_drop=0.25, max_drops=6):
        self.s = s
        self.rng = random.Random(seed)
        self.p_drop, self.max_drops = p_drop, max_drops
        self.drops = 0
        self.throttle = _throttle_cls(s)

    def __call__(self):
        if self.drops < self.max_drops \
                and self.rng.random() < self.p_drop:
            self.drops += 1
            return self.s.T.NetDrop("storm drop")
        return self.throttle("pacing")


@pytest.fixture(params=sorted(SIDES))
def pair(request):
    s = SIDES[request.param]
    opened = []

    def make(src_faults=None, **kw):
        src = _stub_server(s, **kw)
        tgt = _stub_server(s, **kw)
        hs = s.Host(src, heartbeat_s=30, fault_injector=src_faults).start()
        ht = s.Host(tgt, heartbeat_s=30).start()
        rs, rt = s.Remote(hs.address), s.Remote(ht.address)
        src.start()
        tgt.start()
        opened.append((rs, rt, hs, ht, src, tgt))
        return src, tgt, hs, ht, rs, rt

    make.s = s
    yield make
    for rs, rt, hs, ht, src, tgt in opened:
        rs.close()
        rt.close()
        hs.close()
        ht.close()
        src.stop()
        tgt.stop()


class TestWireMigration:
    @pytest.mark.parametrize("do_sample", [False, True],
                             ids=["greedy", "sampled"])
    def test_wire_migration_bitexact(self, pair, do_sample):
        s = pair.s
        kw = dict(do_sample=do_sample)
        if do_sample:
            kw.update(temperature=0.7, top_k=8)
        src, tgt, hs, ht, rs, rt = pair(src_faults=_throttle_fi(s), **kw)
        oracle = _stub_server(s, **kw)
        got = []
        rid_o = oracle.submit(PROMPT, max_new_tokens=BUDGET, seed=5)
        ref = oracle.run()[rid_o]
        rid = rs.submit(PROMPT, max_new_tokens=BUDGET, seed=5,
                        on_token=lambda r, t: got.extend(int(x) for x in t))
        _until(lambda: len(got) >= 6, timeout=30, msg="first tokens")
        state, payloads = rs.migrate_out(rid)
        assert state.get("delivered") is not None
        new_rid = rt.migrate_in(
            state, payloads,
            on_token=lambda r, t: got.extend(int(x) for x in t))
        assert rs.migrate_finish(rid) is True
        out = rt.wait(new_rid, timeout=60)
        np.testing.assert_array_equal(out, ref)
        if not do_sample:
            np.testing.assert_array_equal(out, stub_tokens(PROMPT, BUDGET))
        _until(lambda: len(got) >= BUDGET, msg="stream drained")
        assert got == [int(t) for t in ref]
        assert tgt.stats["prefill_tokens"] == 0
        assert tgt.stats["admissions"] == 0
        assert src.stats["migrations"] == 1
        assert tgt.stats["migrated_in"] == 1
        for srv in (src, tgt):
            assert srv.pool_balance()[1] == 0

    def test_wire_checksum_mismatch_falls_back(self, pair):
        s = pair.s
        src, tgt, hs, ht, rs, rt = pair(src_faults=_throttle_fi(s))
        got = []
        rid = rs.submit(PROMPT, max_new_tokens=BUDGET, seed=5,
                        on_token=lambda r, t: got.extend(int(x) for x in t))
        _until(lambda: len(got) >= 6, timeout=30, msg="first tokens")
        state, payloads = rs.migrate_out(rid)
        tampered = [np.array(p) for p in payloads]
        tampered[0].flat[0] += 1.0
        with pytest.raises(s.R.MigrationError):
            rt.migrate_in(state, tampered)
        assert rs.migrate_abort(rid) is True
        np.testing.assert_array_equal(rs.wait(rid, timeout=60),
                                      stub_tokens(PROMPT, BUDGET))
        assert src.stats["migration_fallbacks"] == 1
        assert tgt.stats["migrated_in"] == 0
        for srv in (src, tgt):
            assert srv.pool_balance()[1] == 0

    def test_drop_storm_backfill_heals_token_stream(self, pair):
        s = pair.s
        storm = _StormFactory(s, seed=8)
        fi = s.R.FaultInjector(seed=8, enabled=False) \
            .on(s.R.faults.NET_SEND, probability=1.0, error=storm)
        src, tgt, hs, ht, rs, rt = pair(src_faults=fi)
        got = []
        rid = rs.submit(PROMPT, max_new_tokens=BUDGET, seed=5,
                        on_token=lambda r, t: got.extend(int(x) for x in t))
        _until(lambda: len(got) >= 4, timeout=30, msg="stream started")
        fi.arm()
        np.testing.assert_array_equal(rs.wait(rid, timeout=60),
                                      stub_tokens(PROMPT, BUDGET))
        _until(lambda: len(got) >= BUDGET, timeout=15,
               msg="backfill healed the stream")
        assert got == [int(t) for t in stub_tokens(PROMPT, BUDGET)]
        assert storm.drops >= 1

    def test_cut_in_callback_window_no_double_delivery(self, pair):
        s = pair.s
        src = _stub_server(s)
        tgt = _stub_server(s)
        hs = s.Host(src, heartbeat_s=30).start()
        ht = s.Host(tgt, heartbeat_s=30).start()
        rs, rt = s.Remote(hs.address), s.Remote(ht.address)
        tgt.start()
        got = []
        try:
            rid = rs.submit(PROMPT, max_new_tokens=BUDGET, seed=5,
                            on_token=lambda r, t: got.extend(
                                int(x) for x in t))
            fire = src._fire_callbacks
            src._fire_callbacks = lambda: None
            for _ in range(200):
                if any(st is not None and st.emitted for st in src._slots):
                    break
                src.step()
            assert got == []
            out = {}

            def cut():
                out["state"], out["payloads"] = rs.migrate_out(rid)

            th = threading.Thread(target=cut)
            th.start()
            time.sleep(0.15)
            src._fire_callbacks = fire
            fire()
            th.join(timeout=10)
            assert not th.is_alive(), "migrate_out never returned"
            state = out["state"]
            assert len(state["delivered"]) == state["streamed"] >= 1
            new_rid = rt.migrate_in(state, out["payloads"],
                                    on_token=lambda r, t: got.extend(
                                        int(x) for x in t))
            rs.migrate_finish(rid)
            np.testing.assert_array_equal(rt.wait(new_rid, timeout=60),
                                          stub_tokens(PROMPT, BUDGET))
            _until(lambda: len(got) >= BUDGET, timeout=15,
                   msg="stream complete")
            assert got == [int(t) for t in stub_tokens(PROMPT, BUDGET)]
        finally:
            rs.close()
            rt.close()
            hs.close()
            ht.close()
            tgt.stop()


def _storm_run(s, seed):
    """The reference's single-threaded 25% storm over ``net.*`` and
    ``migrate.*``: a socketpair wire, manual ``step()``."""
    F = s.R.faults
    fi = s.R.FaultInjector(seed=seed) \
        .on(F.NET_SEND, probability=0.25, error=s.T.NetDrop) \
        .on(F.NET_RECV, probability=0.25, error=s.T.NetDrop) \
        .on(F.NET_PAGE_SEND, probability=0.25, error=s.T.NetDrop) \
        .on(F.MIGRATE_GATHER, probability=0.25) \
        .on(F.MIGRATE_RESTORE, probability=0.25)
    src = _server(s, fault_injector=fi, **MIG_KW)
    tgt = _server(s, fault_injector=fi, **MIG_KW)
    sa, sb = socket.socketpair()
    a = s.T.Connection(sa, fault_injector=fi, peer="src-host")
    b = s.T.Connection(sb, peer="tgt-host")
    b._faults = fi
    got = []
    budget = 24
    rid = src.submit(PROMPT, max_new_tokens=budget, seed=5,
                     on_token=lambda r, t: got.extend(int(x) for x in t))

    def step_until(srv, pred, cap=4000):
        for _ in range(cap):
            if pred():
                return
            srv.step()
        raise AssertionError("stepped past the cap")

    step_until(src, lambda: len(got) >= 6)
    carrier, wait_rid = src, rid
    for _ in range(8):
        try:
            state, payloads = src.migrate_out(rid)
        except s.R.InjectedFault:
            continue
        try:
            lost = not a.send({"op": "migrate_in", "n": len(payloads)})
            for i, p in enumerate(payloads):
                arr = np.ascontiguousarray(np.stack(p))
                if not a.send_pages({"i": i, "shape": list(arr.shape),
                                     "dtype": str(arr.dtype)},
                                    arr.tobytes()):
                    lost = True
            frames, header = {}, None
            while True:
                try:
                    msg = b.recv(timeout=0.1)
                except TimeoutError:
                    break
                if "op" in msg:
                    header = msg
                else:
                    frames[int(msg["i"])] = np.frombuffer(
                        msg["_payload"], dtype=np.dtype(msg["dtype"])) \
                        .reshape(msg["shape"])
            if lost or header is None or len(frames) != len(payloads):
                src.migrate_abort(rid)
                continue
            new_rid = tgt.migrate_in(
                state, [frames[i] for i in range(len(payloads))],
                on_token=lambda r, t: got.extend(int(x) for x in t))
        except (s.R.InjectedFault, s.R.MigrationError):
            src.migrate_abort(rid)
            continue
        src.migrate_finish(rid)
        carrier, wait_rid = tgt, new_rid
        break
    step_until(carrier, lambda: len(got) >= budget)
    out = carrier.wait(wait_rid, timeout=5)
    assert src.pool_balance()[1] == 0
    assert tgt.pool_balance()[1] == 0
    a.close()
    b.close()
    return list(fi.trace), [int(t) for t in out], list(got)


@pytest.mark.chaos
def test_migration_chaos_storm_same_seed_same_trace_as_jax():
    """``TestMigrationChaosStorm``: one seed gives one fault trace and
    one token stream — the JAX run's, on the port — and another seed
    another trace."""
    t1, out1, got1 = _storm_run(SIDES["port"], 13)
    t2, out2, got2 = _storm_run(SIDES["port"], 13)
    tj, outj, gotj = _storm_run(SIDES["jax"], 13)
    t3, _, _ = _storm_run(SIDES["port"], 14)
    assert t1 == t2 == tj
    assert out1 == out2 == got1 == got2 == outj == gotj
    assert t1 != t3
    assert out1 == [int(t) for t in stub_tokens(PROMPT, 24)]
    assert len(t1) >= 1


class _PageStorm:
    """Capped ``net.page_send`` drop storm over paced page frames."""

    def __init__(self, s, seed, p_drop=0.25, max_drops=4):
        self.s = s
        self.rng = random.Random(seed)
        self.p_drop, self.max_drops = p_drop, max_drops
        self.drops = 0
        self.throttle = _throttle_cls(s)

    def __call__(self):
        if self.drops < self.max_drops \
                and self.rng.random() < self.p_drop:
            self.drops += 1
            return self.s.T.NetDrop("page storm")
        return self.throttle("pacing")


@pytest.mark.chaos
@pytest.mark.parametrize("name", sorted(SIDES))
def test_partial_frames_survive_page_send_storm(name):
    """``TestPartialHandoffStorm``: dropped partial-handoff page frames
    come back as holes, holes are not forwarded, and the closing pull
    re-ships everything above the delivered prefix — the handoff lands
    bit-exact with zero re-prefill and zero leaks."""
    s = SIDES[name]
    storm = _PageStorm(s, seed=8)
    fi = s.R.FaultInjector(seed=8).on(s.R.faults.NET_PAGE_SEND,
                                      probability=1.0, error=storm)
    kw = dict(max_slots=2, max_cache_len=96, page_size=8, num_pages=24,
              prefill_tokens_per_tick=8)
    src = _slow(_server(s, role="prefill", **kw), 0.03)
    tgt = _server(s, role="decode", **kw)
    hs = s.Host(src, heartbeat_s=30, fault_injector=fi).start()
    ht = s.Host(tgt, heartbeat_s=30).start()
    rs, rt = s.Remote(hs.address), s.Remote(ht.address)
    src.start()
    tgt.start()
    prompt = (np.arange(1, 41, dtype=np.int32) % 13)
    budget = 8
    got = []

    def collect(r, t):
        got.extend(int(x) for x in t)

    try:
        assert rs.role == "prefill" and rt.role == "decode"
        rid = rs.submit(prompt, max_new_tokens=budget, seed=5,
                        on_token=collect)
        delivered, handle = set(), None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                frag, payloads = rs.migrate_out(rid, partial=True)
            except s.R.MigrationError:
                time.sleep(0.005)
                continue
            if frag["phase"] != "prefill":
                break
            if payloads:
                if handle is None:
                    handle = rt.migrate_in_begin(
                        {"rid": int(rid), "ids": prompt,
                         "prompt_len": len(prompt), "budget": budget,
                         "seed": 5, "page_size": 8, "phase": "prefill"})
                base0, shas = int(frag["base"]), frag["sha256"]
                i = 0
                while i < len(payloads):
                    if payloads[i] is None:
                        i += 1
                        continue
                    j = i
                    while j < len(payloads) and payloads[j] is not None:
                        j += 1
                    landed = rt.migrate_in_pages(
                        handle, base0 + i, payloads[i:j], shas[i:j])
                    delivered.update(int(p) for p in landed)
                    i = j
            time.sleep(0.005)
        else:
            raise AssertionError("source never reached decode")
        k = 0
        while k in delivered:
            k += 1
        new_rid = None
        for _ in range(6):
            try:
                state, tail = rs.migrate_out(rid, from_page=k)
            except s.R.MigrationError:
                time.sleep(0.01)
                continue
            if any(p is None for p in tail):
                rs.migrate_abort(rid)
                continue
            try:
                if handle is not None:
                    new_rid = rt.migrate_in_commit(handle, state, tail,
                                                   on_token=collect)
                else:
                    new_rid = rt.migrate_in(state, tail, on_token=collect)
            except s.R.MigrationError:
                rs.migrate_abort(rid)
                continue
            break
        assert new_rid is not None, "handoff never committed"
        rs.migrate_finish(rid)
        ref = stub_tokens(prompt, budget)
        np.testing.assert_array_equal(rt.wait(new_rid, timeout=60), ref)
        _until(lambda: len(got) >= budget, timeout=15, msg="stream drained")
        assert got == [int(t) for t in ref]
        assert storm.drops >= 1
        assert tgt.stats["prefill_tokens"] == 0
        assert tgt.stats["admissions"] == 0
        for srv in (src, tgt):
            assert srv.pool_balance()[1] == 0
    finally:
        rs.close()
        rt.close()
        hs.close()
        ht.close()
        src.stop()
        tgt.stop()


# ========================================================= llama_tiny
@pytest.mark.parametrize("mode", ["split", "fused"])
def test_llama_tiny_wire_move_bit_exact(mode):
    """A ``llama_tiny`` f32 request moved mid-decode between two port
    hosts over the wire continues with the never-migrated run's tokens,
    zero re-prefill on the target, zero pages left live."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    kw = dict(max_slots=2, max_cache_len=64, cache_backend="paged",
              page_size=8, num_pages=17, prefill_tokens_per_tick=16,
              serving_mode=mode)
    p = np.random.default_rng(4).integers(
        0, llama_tiny().vocab_size, (37,)).astype(np.int32)
    ref_srv = ContinuousBatchingServer(model, **kw)
    r0 = ref_srv.submit(p, max_new_tokens=12, seed=9)
    ref = ref_srv.run()[r0]
    src = ContinuousBatchingServer(model, **kw)
    tgt = ContinuousBatchingServer(model, **kw)
    hs, ht = ReplicaHost(src).start(), ReplicaHost(tgt).start()
    rs, rt = RemoteReplica(hs.address), RemoteReplica(ht.address)
    try:
        rid = rs.submit(p, max_new_tokens=12, seed=9)
        for _ in range(100):
            if src._slots[0] is not None and len(src._slots[0].emitted) >= 5:
                break
            src.step()
        state, payloads = rs.migrate_out(rid)
        assert len(payloads) == 6 and payloads[0].dtype == np.float32
        new = rt.migrate_in(state, payloads)
        assert rs.migrate_finish(rid) is True
        tgt.start()
        np.testing.assert_array_equal(rt.wait(new, timeout=60), ref)
        assert tgt.stats["prefill_tokens"] == 0
        assert src.pool_balance()[1] == tgt.pool_balance()[1] == 0
    finally:
        rs.close()
        rt.close()
        hs.close()
        ht.close()
        tgt.stop()


# ============================================== utilization (test_costs.py)
def _llama_util_server(**kw):
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    model = LlamaForCausalLM(llama_tiny(), device="cpu", seed=3)
    return ContinuousBatchingServer(
        model, max_slots=2, max_cache_len=32, cache_backend="paged",
        page_size=4, **kw)


def _util_server(name, **kw):
    """A JAX stub server (its programs priced by XLA) or a port
    ``llama_tiny`` server (priced by ``models.costs``; the torch stub has
    no price, so its MFU reads 0)."""
    if name == "jax":
        return _server(SIDES["jax"], max_cache_len=32, page_size=4, **kw)
    return _llama_util_server(**kw)


@pytest.mark.parametrize("name", sorted(SIDES))
def test_heartbeat_digest_carries_utilization(name):
    s = SIDES[name]
    srv = _util_server(name, costs=True, ledger=True)
    srv.submit(_prompt(1, 2, 3), max_new_tokens=4)
    srv.run()
    host = s.Host(srv)
    try:
        d = host._digest()
    finally:
        host.close()
    assert 0.0 <= d["util"]["goodput_ratio"] <= 1.0
    assert d["util"]["mfu"] > 0
    json.dumps(d)


class TestUtilizationOverWire:
    @pytest.mark.parametrize("name", sorted(SIDES))
    def test_remote_replica_reads_util_from_digest(self, name):
        s = SIDES[name]
        srv = _util_server(name, costs=True, ledger=True)
        host = s.Host(srv, heartbeat_s=0.01).start()
        rep = s.Remote(host.address)
        try:
            rep.start()
            p = _prompt(2, 5, 9)
            out = rep.wait(rep.submit(p, max_new_tokens=5), timeout=60)
            assert len(out) == 5
            if name == "jax":
                np.testing.assert_array_equal(out, stub_tokens(p, 5))
            util = {}
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                util = rep.utilization()
                if util.get("mfu"):
                    break
                time.sleep(0.02)
            assert util.get("mfu", 0) > 0
            assert 0.0 <= util["goodput_ratio"] <= 1.0
        finally:
            rep.close()
            host.close()
            if srv._thread is not None:
                srv.stop(timeout=10)


# ================================================ mixed fleets over the wire
def _mixed(router_side):
    """A JAX host and a port host behind ``router_side``'s router and
    clients: the same prompts routed to both, tokens of the closed form,
    then one f32 wire move each way (JAX host -> port host and back),
    each continued bit-exactly with zero re-prefill. Returns the tokens."""
    S = SIDES[router_side]
    servers = [_stub_server(SIDES["jax"]), _stub_server(SIDES["port"])]
    hosts = [SIDES["jax"].Host(servers[0]).start(),
             SIDES["port"].Host(servers[1]).start()]
    reps = [S.Remote(h.address) for h in hosts]
    router = S.Router(reps, policy="round_robin")
    router.start(poll_interval=0.02)
    toks = []
    try:
        rids = [router.submit(_prompt(5, i + 1), max_new_tokens=6)
                for i in range(4)]
        for i, rid in enumerate(rids):
            out = router.wait(rid, timeout=60)
            np.testing.assert_array_equal(
                out, stub_tokens(_prompt(5, i + 1), 6))
            toks.append([int(t) for t in out])
        assert router.stats["routed"] == [2, 2]
        for a, b in ((0, 1), (1, 0)):
            _slow(servers[a], 0.02)
            got = []
            rid = reps[a].submit(PROMPT, max_new_tokens=40, seed=5,
                                 on_token=lambda r, t: got.extend(
                                     int(x) for x in t))
            _until(lambda: len(got) >= 4, timeout=30, msg="tokens")
            state, payloads = reps[a].migrate_out(rid)
            assert payloads[0].dtype == np.float32
            before = servers[b].stats["prefill_tokens"]
            new = reps[b].migrate_in(state, payloads)
            assert reps[a].migrate_finish(rid) is True
            out = reps[b].wait(new, timeout=60)
            np.testing.assert_array_equal(out, stub_tokens(PROMPT, 40))
            assert servers[b].stats["prefill_tokens"] == before
            assert servers[b].stats["migrated_in"] == 1
            servers[a]._fire_callbacks = type(servers[a])._fire_callbacks \
                .__get__(servers[a])
            toks.append([int(t) for t in out])
        for srv in servers:
            assert srv.pool_balance()[1] == 0
    finally:
        router.stop(drain=False, timeout=10)
        for rep in reps:
            rep.close()
        for h in hosts:
            h.close()
    return toks


def test_mixed_fleets_over_the_wire():
    """A port router over a JAX host and a port host, then a JAX router
    over the same pair: equal tokens, and an f32 wire move each way."""
    assert _mixed("port") == _mixed("jax")


def test_digest_reads_no_device_tensor(monkeypatch):
    """The heartbeat runs every 20 ms beside the serve thread: on the
    card a tensor read there (``item``, ``cpu``, ``tolist``) would sync
    the device. A ``llama_tiny`` server with the ledger and the cost
    catalog wired: its digest is built with those reads made to raise."""
    srv = _llama_util_server(costs=True, ledger=True)
    srv.submit(_prompt(1, 2, 3), max_new_tokens=4)
    srv.run()
    host = ReplicaHost(srv)

    def refuse(*a, **k):
        raise AssertionError("the digest read a tensor")

    try:
        for name in ("item", "cpu", "tolist", "numpy"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
        d = host._digest()
    finally:
        monkeypatch.undo()
        host.close()
    assert d["util"]["mfu"] > 0 and d["stats"]["decode_ticks"] > 0
    json.dumps(d)
