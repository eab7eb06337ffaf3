"""Optimistic admission with bit-exact preemption in the port, on the CPU.

First the port's server against the JAX server on ``llama_tiny`` f32
(weights bridged from the JAX model, ``max_cache_len=64``,
``page_size=8``) over a pool that forces preemption, both servers built
with the same arguments and fed the same numpy prompts:

- optimistic split and fused, greedy and seeded sampled: tokens EQUAL,
  ``stats`` (preemptions, resumes, grown and headroom pages, admissions,
  prefill tokens) equal, and ``pool_balance()`` equal with its
  ``preempted`` and ``preemptions`` attributes; at least one preemption
  in each; greedy tokens equal the port's reserve-mode tokens;
- priorities: the victims and the admission order equal the JAX
  server's;
- victims preempted while they are still prefilling (a 2-token prefill
  budget a tick, no headroom pages);
- a ``FaultInjector`` storm on ``kv.grow``, ``kv.alloc``,
  ``prefix.evict`` and ``server.preempt`` with one seed on both servers
  driven tick by tick in lockstep: the same tick failures, pool balances
  and ``fired()`` counts at every point, equal tokens and failures, no
  leaked page.

Then the JAX package's ``tests/test_preemption.py`` contracts on
``TorchStub`` (``tests/_torch_remote_stub.py``), a torch model that
follows the decode-bundle contract and the closed-form token recurrence
of ``tests/_serving_stub.py`` (``stub_tokens`` is the oracle): victim
order, resumed seniority, the grower parking itself, streaming never
re-sent, deadline expiry, cancel, drain and hard stop of parked
requests, the config guards, ``submit`` still bounding the full extent,
and the chaos storms. Tokens are compared for equality everywhere; no
tolerance is involved.
"""
import functools
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from _serving_stub import stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.inference.continuous_batching import \
    PreemptionPolicy as JaxPolicy
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.reliability import FaultInjector as JaxInjector
from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                        PoolBalance, PreemptionPolicy)
from paddle_tpu_torch.inference.continuous_batching import _Slot
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.reliability import (CircuitBreaker, FaultInjector,
                                          PreemptedError, ReliabilityError,
                                          RetryPolicy, faults)
from paddle_tpu_torch.telemetry.clock import FakeClock
from _torch_remote_stub import TorchStub  # noqa: E402  (re-exported)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The steps here are tiny: one torch thread keeps the test workers
    (several a machine) from oversubscribing its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ the stub
# ``TorchStub`` lives in ``_torch_remote_stub`` (spawned replica hosts
# import it from there without the JAX package); re-exported here for
# the port's serving tests that import it from this module.


def test_stub_follows_the_serving_stub_oracle():
    """The torch stub served on both backends and both tick kinds gives
    ``stub_tokens``, the JAX stub's oracle."""
    p = np.asarray([3, 1, 4, 1, 5, 9, 2], np.int32)
    for kw in ({}, {"cache_backend": "paged", "page_size": 8},
               {"cache_backend": "paged", "page_size": 8,
                "serving_mode": "fused"}):
        srv = ContinuousBatchingServer(TorchStub(), max_slots=2,
                                       max_cache_len=32, **kw)
        rid = srv.submit(p, max_new_tokens=12)
        np.testing.assert_array_equal(srv.run()[rid], stub_tokens(p, 12))


# ----------------------------------------------- parity with the JAX server

MCL, PG = 64, 8
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
STATS = ("preemptions", "preempt_resumed", "grow_pages", "headroom_pages",
         "admissions", "prefill_tokens")


@functools.lru_cache(maxsize=1)
def _models():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _llama_prompts(n=6, seed=3, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    vocab = llama_tiny().vocab_size
    return [rng.integers(0, vocab, (int(k),)).astype(np.int32)
            for k in rng.integers(lo, hi, (n,))]


def _llama_server(cls, model, num_pages=9, admission="optimistic", **kw):
    kw.setdefault("prefill_tokens_per_tick", 6)
    return cls(model, max_slots=4, max_cache_len=MCL, cache_backend="paged",
               page_size=PG, num_pages=num_pages, admission=admission,
               seed=5, **kw)


def _serve(srv, prompts, budget=24, priorities=None):
    rids = [srv.submit(p, max_new_tokens=budget,
                       priority=0 if priorities is None else priorities[i])
            for i, p in enumerate(prompts)]
    out = srv.run()
    return [out[r] for r in rids]


def _balance(srv):
    bal = srv.pool_balance()
    return tuple(bal), bal.preempted, bal.preemptions


@pytest.mark.parametrize("mode,sample", [("split", False), ("split", True),
                                         ("fused", False), ("fused", True)])
def test_optimistic_tokens_stats_and_pool_equal_jax(mode, sample):
    jm, tm = _models()
    prompts = _llama_prompts()
    kw = dict(serving_mode=mode, **(SAMPLE if sample else {}))
    js = _llama_server(JaxServer, jm, **kw)
    ts = _llama_server(ContinuousBatchingServer, tm, **kw)
    want, got = _serve(js, prompts), _serve(ts, prompts)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert ts.stats["preemptions"] >= 1, "the pool never preempted"
    assert {k: ts.stats[k] for k in STATS} == \
        {k: js.stats[k] for k in STATS}
    assert isinstance(ts.pool_balance(), PoolBalance)
    assert _balance(ts) == _balance(js)
    bal = ts.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0
    assert bal[0] + bal[2] + bal[3] == ts._kv.num_pages - 1
    assert ts._kv.grown_total == ts.stats["grow_pages"]
    if not sample:
        # an unpressured full-extent run of the port emits the same
        # tokens: preemption degrades throughput, never the output
        ref = _llama_server(ContinuousBatchingServer, tm, num_pages=33,
                            admission="reserve", serving_mode=mode)
        for r, g in zip(_serve(ref, prompts), got):
            np.testing.assert_array_equal(g, r)
        assert ref.stats["preemptions"] == ref.stats["grow_pages"] == 0


def _recording(policy_cls, picks):
    class Recording(policy_cls):
        def pick(self, grower, candidates):
            v = super().pick(grower, candidates)
            if v is not None:
                by_slot = dict(candidates)
                picks.append((by_slot[v].rid,
                              sorted(st.rid for _, st in candidates)))
            return v
    return Recording()


def _record_admissions(srv, order):
    pop = srv._pop_admission_locked

    def recorded(src):
        item = pop(src)
        order.append((item.rid, src[0]))
        return item
    srv._pop_admission_locked = recorded


def test_priorities_pick_and_admit_as_jax():
    """Mixed priority classes: the victims (and the live candidates at
    each pick) and the admission order (queue or parked) equal the JAX
    server's, and so do the tokens."""
    jm, tm = _models()
    prompts = _llama_prompts(8, seed=9)
    prio = [0, 1, 0, 2, 1, 0, 2, 1]
    runs = {}
    for name, cls, model, pol in (("jax", JaxServer, jm, JaxPolicy),
                                  ("port", ContinuousBatchingServer, tm,
                                   PreemptionPolicy)):
        picks, order = [], []
        srv = _llama_server(cls, model, num_pages=10,
                            preemption_policy=_recording(pol, picks))
        _record_admissions(srv, order)
        toks = _serve(srv, prompts, budget=20, priorities=prio)
        runs[name] = (toks, picks, order, _balance(srv))
    (jt, jp, jo, jb), (tt, tp, to, tb) = runs["jax"], runs["port"]
    for w, g in zip(jt, tt):
        np.testing.assert_array_equal(g, w)
    assert tp == jp and to == jo and tb == jb
    assert tp, "no preemption happened"
    assert any(src == "preempted" for _, src in to)


def test_mid_prefill_victim_equals_jax():
    """A 2-token prefill budget keeps slots prefilling for several
    ticks, and ``headroom_pages=0`` makes every decoding slot grow at
    its first page boundary; the policy ranks prefilling slots first
    (no tokens yet), so grows park them mid-prefill: only their written
    full pages are donated, they leave the prefill FIFO, and the replays
    still give the JAX server's and the reserve run's tokens."""
    jm, tm = _models()
    prompts = _llama_prompts(6, seed=5, lo=14, hi=22)
    mid = []

    class Watch(PreemptionPolicy):
        def pick(self, grower, candidates):
            v = super().pick(grower, candidates)
            if v is not None and v in ts._prefill_fifo:
                mid.append(dict(candidates)[v].filled)
            return v

    kw = dict(prefill_tokens_per_tick=2, num_pages=10, headroom_pages=0)
    js = _llama_server(JaxServer, jm, **kw)
    ts = _llama_server(ContinuousBatchingServer, tm,
                       preemption_policy=Watch(), **kw)
    want, got = _serve(js, prompts, budget=16), _serve(ts, prompts,
                                                       budget=16)
    assert mid, "no slot was preempted mid-prefill"
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert {k: ts.stats[k] for k in STATS} == \
        {k: js.stats[k] for k in STATS}
    assert _balance(ts) == _balance(js)
    ref = _llama_server(ContinuousBatchingServer, tm, num_pages=33,
                        admission="reserve", prefill_tokens_per_tick=2)
    for r, g in zip(_serve(ref, prompts, budget=16), got):
        np.testing.assert_array_equal(g, r)


STORM = ((faults.KV_GROW, 0.25), (faults.PAGE_ALLOC, 0.05),
         (faults.PREFIX_EVICT, 0.3), (faults.SERVER_PREEMPT, 0.2))


def _lockstep(js, ts, max_ticks=2000):
    """Step both servers until both drain, a tick each in turn; returns
    each tick's (failure type or None, pool balance) per server."""
    trace = {"jax": [], "port": []}
    for _ in range(max_ticks):
        busy = [s._busy_locked() for s in (js, ts)]
        if not any(busy):
            return trace
        for name, srv in (("jax", js), ("port", ts)):
            err = None
            try:
                srv.step()
            except Exception as e:        # the supervisor would retry
                err = type(e).__name__
            trace[name].append((err, tuple(srv.pool_balance())))
    raise AssertionError("the storm did not drain")


@pytest.mark.parametrize("mode,sample", [("split", False), ("fused", True)])
def test_fault_storm_equals_jax_tick_by_tick(mode, sample):
    jm, tm = _models()
    prompts = _llama_prompts(8, seed=21)
    fis = {"jax": JaxInjector(seed=77), "port": FaultInjector(seed=77)}
    for fi in fis.values():
        for point, p in STORM:
            fi.on(point, probability=p)
    kw = dict(serving_mode=mode, **(SAMPLE if sample else {}))
    js = _llama_server(JaxServer, jm, fault_injector=fis["jax"], **kw)
    ts = _llama_server(ContinuousBatchingServer, tm,
                       fault_injector=fis["port"], **kw)
    rj = [js.submit(p, max_new_tokens=20) for p in prompts]
    rt = [ts.submit(p, max_new_tokens=20) for p in prompts]
    assert rj == rt
    trace = _lockstep(js, ts)
    assert trace["port"] == trace["jax"]
    assert any(err for err, _ in trace["port"]), "no tick failed"
    for point, _ in STORM:
        assert fis["port"].fired(point) == fis["jax"].fired(point)
        assert fis["port"].visits(point) == fis["jax"].visits(point)
    assert fis["port"].trace == fis["jax"].trace
    assert fis["port"].fired(faults.KV_GROW) > 0
    assert ts.stats["preemptions"] >= 1
    assert sorted(ts._results) == sorted(js._results)
    for rid in ts._results:
        np.testing.assert_array_equal(ts._results[rid], js._results[rid])
    assert {r: type(e) .__name__ for r, e in ts._failures.items()} == \
        {r: type(e).__name__ for r, e in js._failures.items()}
    assert {k: ts.stats[k] for k in STATS} == \
        {k: js.stats[k] for k in STATS}
    bal = ts.pool_balance()
    assert _balance(ts) == _balance(js)
    assert bal[1] == 0 and bal.preempted == 0
    assert bal[0] + bal[2] + bal[3] == ts._kv.num_pages - 1


# ---------------------------------------------- the contracts on the stub


def _prompts(n, rng_seed=3, lo=4, hi=12):
    rng = np.random.default_rng(rng_seed)
    return [rng.integers(0, 16, (int(k),)).astype(np.int32)
            for k in rng.integers(lo, hi, (n,))]


def _server(admission="optimistic", num_pages=9, max_slots=4, fi=None,
            **kw):
    kw.setdefault("max_cache_len", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("retry_policy", RetryPolicy(base_delay_s=0.0,
                                              jitter=0.0))
    kw.setdefault("breaker", CircuitBreaker(failure_threshold=10_000))
    return ContinuousBatchingServer(
        TorchStub(), max_slots=max_slots, cache_backend="paged",
        num_pages=num_pages, admission=admission, fault_injector=fi,
        **kw)


def _drive(srv, max_ticks=20_000):
    """Single-threaded stand-in for the supervised loop: retry every
    failed tick (injected kv.grow / server.preempt faults surface as
    tick errors the loop would back off and retry)."""
    ticks = 0
    while True:
        with srv._lock:
            busy = srv._busy_locked()
        if not busy:
            return
        try:
            srv.step()
        except Exception:
            pass
        ticks += 1
        assert ticks < max_ticks, "drive did not converge"


def _pressured_run(admission, num_pages, do_sample=False, fi=None,
                   budget=28, n=10, seeds=None, on_token=None,
                   serving_mode="split"):
    srv = _server(admission, num_pages=num_pages, do_sample=do_sample,
                  fi=fi, seed=5, serving_mode=serving_mode)
    prompts = _prompts(n)
    rids = []
    for i, p in enumerate(prompts):
        kw = {"seed": seeds[i]} if seeds is not None else {}
        if on_token is not None:
            kw["on_token"] = on_token
        rids.append(srv.submit(p, max_new_tokens=budget, **kw))
    _drive(srv)
    return srv, prompts, rids, dict(srv._results)


@pytest.mark.parametrize("serving_mode", ["split", "fused"])
def test_greedy_bit_exact_under_pressure(serving_mode):
    """A pool 2.5x too small for the requests' full extents completes
    every request with the oracle's tokens (and an unpressured reserve
    run's), with real preemptions, and the pool returns to baseline."""
    srv, prompts, rids, outs = _pressured_run("optimistic", 9,
                                              serving_mode=serving_mode)
    srv2, _, rids2, outs2 = _pressured_run("reserve", 49,
                                           serving_mode=serving_mode)
    for rid, rid2, p in zip(rids, rids2, prompts):
        np.testing.assert_array_equal(outs[rid], stub_tokens(p, 28))
        np.testing.assert_array_equal(outs[rid], outs2[rid2])
    assert srv.stats["preemptions"] > 0, "pool never pressured"
    assert srv.stats["preempt_resumed"] == srv.stats["preemptions"]
    bal = srv.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0
    assert bal[0] + bal[2] + bal[3] == srv._kv.num_pages - 1


def test_sampled_bit_exact_under_pressure():
    """The replayed chain restarts from the same resolved seed, so a
    preempted request draws what an unpressured run draws."""
    seeds = list(range(100, 110))
    srv, _, rids, outs = _pressured_run("optimistic", 9, do_sample=True,
                                        seeds=seeds)
    _, _, rids2, outs2 = _pressured_run("reserve", 49, do_sample=True,
                                        seeds=seeds)
    assert srv.stats["preemptions"] > 0
    for rid, rid2 in zip(rids, rids2):
        np.testing.assert_array_equal(outs[rid], outs2[rid2])


def test_streaming_never_resends_across_preemption():
    """The concatenated on_token stream equals the final result exactly:
    the replay below the old offset is not sent, the tail once."""
    chunks = {}

    def on_token(rid, toks):
        chunks.setdefault(rid, []).append(np.asarray(toks))

    srv, prompts, rids, outs = _pressured_run("optimistic", 9,
                                              on_token=on_token)
    assert srv.stats["preemptions"] > 0
    for rid, p in zip(rids, prompts):
        got = np.concatenate(chunks[rid])
        np.testing.assert_array_equal(got, outs[rid])
        np.testing.assert_array_equal(got, stub_tokens(p, 28))


def test_grow_and_headroom_counters():
    srv, _, _, _ = _pressured_run("optimistic", 9)
    assert srv.stats["grow_pages"] > 0
    assert srv.stats["headroom_pages"] > 0
    assert srv._kv.grown_total == srv.stats["grow_pages"]
    srv2, _, _, _ = _pressured_run("reserve", 49)
    assert srv2.stats["grow_pages"] == 0
    assert srv2.stats["headroom_pages"] == 0
    assert srv2.stats["preemptions"] == 0


def test_pool_balance_keeps_4_tuple_with_attrs():
    srv = _server(num_pages=9)
    bal = srv.pool_balance()
    assert isinstance(bal, PoolBalance)
    free, live, pinned, cached = bal
    assert (free, live, pinned, cached) == (8, 0, 0, 0)
    assert bal.preempted == 0 and bal.preemptions == 0
    assert srv.preempt_pressure() == 0


def test_optimistic_dense_raises_with_roadmap_pointer():
    """The reference's own refusal, and the message says so: the dense
    backend has no pool to admit optimistically against."""
    with pytest.raises(NotImplementedError, match="as in the reference"):
        ContinuousBatchingServer(TorchStub(), max_slots=2,
                                 max_cache_len=32, admission="optimistic")


def test_config_guards():
    with pytest.raises(ValueError, match="admission"):
        _server(admission="eager")
    with pytest.raises(ValueError, match="headroom_pages"):
        _server(headroom_pages=-1)


def test_submit_still_bounds_full_extent():
    """A request whose FULL extent cannot fit the pool on its own fails
    at submit (the top-ranked request could never finish it)."""
    srv = _server(num_pages=4)        # 3 usable pages = 24 tokens
    with pytest.raises(ValueError, match="pages"):
        srv.submit(np.arange(8, dtype=np.int32) % 16, max_new_tokens=24)


def test_victim_order_priority_then_fewest_tokens():
    """Every pick takes a slot of the LOWEST priority class present and,
    within it, the fewest tokens generated (ties to the youngest rid)."""
    picks = []

    class Recording(PreemptionPolicy):
        def pick(self, grower, candidates):
            v = super().pick(grower, candidates)
            if v is not None:
                by_slot = dict(candidates)
                picks.append(
                    (self.key(v, by_slot[v]),
                     [self.key(s, st) for s, st in candidates],
                     by_slot[v].priority,
                     {st.priority for _, st in candidates}))
            return v

    srv = _server(num_pages=9, max_slots=2, preemption_policy=Recording())
    prompts = _prompts(4, rng_seed=9)
    low = [srv.submit(prompts[0], max_new_tokens=28, priority=0)]
    srv.step()
    low.append(srv.submit(prompts[1], max_new_tokens=28, priority=0))
    high = [srv.submit(p, max_new_tokens=28, priority=1)
            for p in prompts[2:]]
    _drive(srv)
    assert picks, "no preemption happened; shrink the pool"
    mixed = 0
    for vkey, cand_keys, vpri, cand_pris in picks:
        assert vkey == min(cand_keys)
        assert vpri == min(cand_pris)
        mixed += len(cand_pris) > 1
    assert mixed > 0, "never picked among mixed priority classes"
    for rid, p in zip(low + high, prompts):
        np.testing.assert_array_equal(srv._results[rid], stub_tokens(p, 28))


def test_resumed_victim_keeps_pre_preemption_seniority():
    """A resumed slot early in its replay ranks by its TRUE partial, not
    its replay progress."""
    policy = PreemptionPolicy()
    resumed = _Slot(0, np.arange(4, dtype=np.int32), 4, 48)
    resumed.emitted = [1, 2]
    resumed.replayed = tuple(range(40))
    fresh = _Slot(1, np.arange(4, dtype=np.int32), 4, 48)
    fresh.emitted = list(range(10))
    assert policy.pick(0, [(0, resumed), (1, fresh)]) == 1
    fresh.priority = 1
    assert policy.pick(0, [(0, resumed), (1, fresh)]) == 0


def test_priority_aware_admission_order():
    srv = _server(num_pages=17, max_slots=1)
    prompts = _prompts(3, rng_seed=11)
    r_low = srv.submit(prompts[0], max_new_tokens=6, priority=0)
    r_mid = srv.submit(prompts[1], max_new_tokens=6, priority=1)
    r_high = srv.submit(prompts[2], max_new_tokens=6, priority=2)
    _drive(srv)
    assert list(srv._results) == [r_high, r_mid, r_low]


def test_grower_parks_itself_when_least_valuable():
    srv = _server(num_pages=9, max_slots=2)
    prompts = _prompts(2, rng_seed=13)
    r_low = srv.submit(prompts[0], max_new_tokens=28, priority=0)
    r_high = srv.submit(prompts[1], max_new_tokens=28, priority=1)
    _drive(srv)
    assert srv.stats["preemptions"] > 0
    np.testing.assert_array_equal(srv._results[r_low],
                                  stub_tokens(prompts[0], 28))
    np.testing.assert_array_equal(srv._results[r_high],
                                  stub_tokens(prompts[1], 28))
    assert not srv.failures


def _park_one(clock=None, deadline_s=None):
    """A server with one request PARKED on the preempted queue and one
    decoding: a few ticks for a real partial, then the production
    teardown (an organic victim is usually re-admitted in its tick)."""
    srv = _server(num_pages=17, max_slots=2, clock=clock)
    prompts = _prompts(2, rng_seed=13)
    kw = {} if deadline_s is None else {"deadline_s": deadline_s}
    victim = srv.submit(prompts[0], max_new_tokens=28, **kw)
    other = srv.submit(prompts[1], max_new_tokens=28)
    for _ in range(5):
        srv.step()
    with srv._lock:
        slot = next(s for s in range(srv.max_slots)
                    if srv._slots[s] is not None
                    and srv._slots[s].rid == victim)
        srv._preempt_slot_locked(slot)
        assert srv._preempted and srv._preempted[0].rid == victim
    assert srv.preempt_pressure() == 1
    return srv, dict(zip((victim, other), prompts)), victim


def test_deadline_expiry_while_parked():
    """A deadline passing on the preempted queue: the pre-preemption
    partial is the result and decode never resumes for it."""
    fc = FakeClock()
    srv, by_rid, parked = _park_one(clock=fc, deadline_s=60.0)
    resumed_before = srv.stats["preempt_resumed"]
    parked_partial = list(srv._preempted[0].emitted)
    fc.advance(61.0)
    _drive(srv)
    np.testing.assert_array_equal(srv._results[parked], parked_partial)
    assert 0 < len(parked_partial) < 28
    assert srv.stats["preempt_resumed"] == resumed_before
    other = next(r for r in by_rid if r != parked)
    np.testing.assert_array_equal(srv._results[other],
                                  stub_tokens(by_rid[other], 28))
    bal = srv.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0
    assert bal[0] + bal[2] + bal[3] == srv._kv.num_pages - 1


def test_cancel_while_parked_records_partial():
    srv, _, parked = _park_one()
    parked_partial = list(srv._preempted[0].emitted)
    assert srv.cancel(parked)
    np.testing.assert_array_equal(srv._results[parked], parked_partial)
    _drive(srv)
    bal = srv.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0


def test_stop_drain_finishes_parked_requests():
    """``stop(drain=True)`` counts parked requests as pending work."""
    srv = _server(num_pages=9, max_slots=2).start()
    prompts = _prompts(4, rng_seed=13)
    rids = [srv.submit(p, max_new_tokens=28) for p in prompts]
    srv.stop(drain=True, timeout=120.0)
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(srv._results[rid], stub_tokens(p, 28))
    assert srv.stats["preemptions"] > 0, "drain saw no pressure"
    bal = srv.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0


def test_hard_stop_flushes_parked_partial():
    srv, _, parked = _park_one()
    parked_partial = list(srv._preempted[0].emitted)
    srv.stop(drain=False)
    np.testing.assert_array_equal(srv._results[parked], parked_partial)
    bal = srv.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0


def test_grow_fault_storm_bit_exact_no_leaks():
    """A 30% ``kv.grow`` and 20% ``server.preempt`` storm on an
    undersized pool under the supervised loop: every request completes
    (zero ``PreemptedError`` escapes), the outputs equal an unpressured
    run's (greedy and sampled), no page leaks."""
    for do_sample in (False, True):
        seeds = list(range(200, 210))
        fi = (FaultInjector(seed=77)
              .on(faults.KV_GROW, probability=0.3)
              .on(faults.SERVER_PREEMPT, probability=0.2))
        srv = _server("optimistic", num_pages=9, fi=fi,
                      do_sample=do_sample).start()
        prompts = _prompts(10)
        rids = [srv.submit(p, max_new_tokens=28, seed=seeds[i])
                for i, p in enumerate(prompts)]
        outs, escapes = {}, []
        for rid in rids:
            try:
                outs[rid] = srv.wait(rid, timeout=240)
            except ReliabilityError as e:
                if isinstance(e, PreemptedError):
                    escapes.append(e)
        assert not escapes, f"PreemptedError escaped: {escapes}"
        assert len(outs) == len(rids), "a request failed or wedged"
        assert fi.fired() > 0
        assert srv.stats["preemptions"] > 0
        srv.stop()
        ref = _server("reserve", num_pages=49, do_sample=do_sample)
        rref = [ref.submit(p, max_new_tokens=28, seed=seeds[i])
                for i, p in enumerate(prompts)]
        ref_outs = ref.run()
        for rid, rid2 in zip(rids, rref):
            np.testing.assert_array_equal(outs[rid], ref_outs[rid2])
        bal = srv.pool_balance()
        assert bal[1] == 0, f"leaked {bal[1]} pages"
        assert bal.preempted == 0
        assert bal[0] + bal[2] + bal[3] == srv._kv.num_pages - 1


def test_same_seed_identical_trace_and_state():
    """Same chaos seed, same submissions: the same injection trace,
    results, final pool balance and preemptions."""
    def run_once():
        fi = (FaultInjector(seed=4242)
              .on(faults.KV_GROW, probability=0.25)
              .on(faults.SERVER_PREEMPT, probability=0.15))
        srv = _server("optimistic", num_pages=9, fi=fi)
        for p in _prompts(8, rng_seed=21):
            srv.submit(p, max_new_tokens=24)
        _drive(srv)
        results = {r: tuple(int(x) for x in v)
                   for r, v in srv._results.items()}
        return (list(fi.trace), results, tuple(srv.pool_balance()),
                srv.stats["preemptions"])

    a, b = run_once(), run_once()
    assert a == b
    assert a[0], "deterministic run injected nothing"
    assert a[3] > 0, "deterministic run never preempted"


def test_mixed_alloc_evict_grow_storm_converges():
    """kv.grow faults compose with the alloc and evict chaos: deferrals,
    aborted reclaim sweeps and preemption interleave; still no failed
    request and no leak."""
    fi = (FaultInjector(seed=9)
          .on(faults.KV_GROW, probability=0.2)
          .on(faults.PAGE_ALLOC, probability=0.1)
          .on(faults.PREFIX_EVICT, probability=0.2))
    srv = _server("optimistic", num_pages=9, fi=fi)
    prompts = _prompts(8, rng_seed=31)
    rids = [srv.submit(p, max_new_tokens=20) for p in prompts]
    _drive(srv)
    assert fi.fired() > 0
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(srv._results[rid], stub_tokens(p, 20))
    bal = srv.pool_balance()
    assert bal[1] == 0 and bal.preempted == 0
    assert bal[0] + bal[2] + bal[3] == srv._kv.num_pages - 1


def test_donate_fault_frees_the_pages_and_cold_donation_is_evicted_first():
    """An injected ``prefix.donate`` fault leaves the tree untouched and
    the pages freed; a cold donation sits at the LRU's cold end."""
    fi = FaultInjector().on(faults.PREFIX_DONATE, schedule=[0])
    srv = _server("optimistic", num_pages=17, fi=fi)
    p = np.arange(16, dtype=np.int32) % 16
    rid = srv.submit(p, max_new_tokens=3)
    _drive(srv)
    np.testing.assert_array_equal(srv._results[rid], stub_tokens(p, 3))
    assert fi.fired(faults.PREFIX_DONATE) == 1
    assert tuple(srv.pool_balance()) == (16, 0, 0, 0)
    kv, prefix = srv._kv, srv._prefix
    hot = kv.alloc(2)
    prefix.donate(np.arange(16, dtype=np.int32), hot, 16)
    cold = kv.alloc(2)
    prefix.donate(np.arange(16, 32, dtype=np.int32) % 16 + 1, cold, 16,
                  cold=True)
    freed_before = kv.free_pages()
    assert prefix.evict(2) == 2
    assert kv.free_pages() == freed_before + 2
    assert prefix.lookup(np.arange(16, dtype=np.int32), 16) is not None


def test_preempted_error_never_reaches_wait_under_threads():
    """The threaded loop with pressure and no faults: every wait()
    returns the oracle's tokens and no failure is recorded."""
    srv = _server("optimistic", num_pages=9).start()
    prompts = _prompts(8, rng_seed=41)
    rids = [srv.submit(p, max_new_tokens=24) for p in prompts]
    t0 = time.monotonic()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(srv.wait(rid, timeout=120),
                                      stub_tokens(p, 24))
    assert time.monotonic() - t0 < 120
    assert srv.stats["preemptions"] > 0
    assert not srv.failures
    srv.stop()
    assert srv.health == "dead"
