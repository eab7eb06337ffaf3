"""The port's host KV tier and tiered prefix cache against the JAX
package's, on the CPU.

- ``HostTier`` on the same numpy payloads as the reference's: equal
  sha256 digests, byte accounting, budget errors and fault order (a
  ``tier.spill`` or ``tier.restore`` fault changes no state).
- The tiered radix tree over a bare ``PagedKVCache`` under one scripted
  sequence of donations, evictions, lookups, ``drop_subtree`` and
  budget shrinks: equal ``stats()``, ``sketch()`` and host residency
  after every step; ``prefix_fingerprints`` equal too.
- Servers on the stubs (``TorchStub`` against the JAX tests'
  ``StubModel``): spill then restore through the normal admit path,
  tokens equal to the oracle, ``PoolBalance`` (``host``,
  ``host_bytes``), the tier's counters and the telemetry equal to the
  JAX server's; a corrupted host buffer is a miss plus
  ``kv_host_restore_corrupt_total``, never a failure; a seeded storm on
  the tier points gives the JAX server's fault trace and state.
- ``llama_tiny`` in f32 (weights bridged from the JAX model): a
  session's history spilled by later sessions and restored on its next
  turn gives the never-evicted run's tokens and the JAX tiered server's,
  greedy and seeded sampled.

Tokens are compared for equality everywhere; no tolerance is involved.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from _serving_stub import StubModel, stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.inference.kv_cache import PagedKVCache as JaxKV
from paddle_tpu.inference.kv_tier import HostTier as JaxTier
from paddle_tpu.inference.prefix_cache import PrefixCache as JaxCache
from paddle_tpu.inference.prefix_cache import \
    prefix_fingerprints as jax_fingerprints
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.reliability import FaultInjector as JaxInjector
from paddle_tpu.telemetry import MetricRegistry as JaxRegistry
from paddle_tpu.telemetry import ServerTelemetry as JaxTele
from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                        HostTier, PagedKVCache,
                                        PrefixCache, prefix_fingerprints)
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.reliability import (CircuitBreaker, FaultInjector,
                                          InjectedFault, RetryPolicy,
                                          faults)
from paddle_tpu_torch.telemetry import MetricRegistry, ServerTelemetry
from test_torch_preemption import TorchStub

PG = 4
PAGE_NBYTES = 64          # stub pool: K+V rows of one page, float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _arrs(x=1.0):
    return [np.full((1, PG, 1, 2), x, np.float32),
            np.full((1, PG, 1, 2), x + 0.5, np.float32)]


# ------------------------------------------------------------ HostTier


@pytest.mark.parametrize("budget", [None, 2 * PAGE_NBYTES])
def test_host_tier_equals_the_reference(budget):
    """Same payloads: same digests, bytes, counters and budget verdicts;
    a corrupted buffer is a miss on both."""
    tiers = [JaxTier(budget_bytes=budget), HostTier(budget_bytes=budget)]
    rows = []
    for tier in tiers:
        entries = [tier.put(_arrs(float(i))) for i in range(3)]
        digests = [e.sha256 for e in entries]
        over = tier.over_budget()
        back = tier.get(entries[1])
        entries[2].payload = (entries[2].payload[0] + 1.0,
                              entries[2].payload[1])
        miss = tier.get(entries[2])
        tier.discard(entries[0], evicted=True)
        st = tier.stats()
        st.pop("memory_kind")
        rows.append((digests, over, [a.tobytes() for a in back], miss,
                     st))
    assert rows[0] == rows[1]
    assert rows[1][3] is None


def test_host_tier_budget_and_fault_order():
    """A negative budget is refused on both; each fault fires strictly
    before any state changes."""
    for Tier in (JaxTier, HostTier):
        with pytest.raises(ValueError):
            Tier(budget_bytes=-1)
    fi = FaultInjector(seed=1).on(faults.TIER_SPILL, schedule=[0]) \
        .on(faults.TIER_RESTORE, schedule=[0])
    tier = HostTier(fault_injector=fi)
    with pytest.raises(InjectedFault):
        tier.put(_arrs())
    assert tier.stats()["entries"] == 0 and tier.bytes_used == 0
    entry = tier.put(_arrs())
    with pytest.raises(InjectedFault):
        tier.get(entry)
    assert tier.restored_pages_total == 0
    assert tier.get(entry) is not None
    assert fi.trace == [(faults.TIER_SPILL, 0), (faults.TIER_RESTORE, 0)]


# --------------------------------------------------- tiered radix tree


def _tree(pkg, budget=None, fail_spill=False):
    KV, Cache, Tier, Inj = ((JaxKV, JaxCache, JaxTier, JaxInjector)
                            if pkg == "jax" else
                            (PagedKVCache, PrefixCache, HostTier,
                             FaultInjector))
    fi = Inj(seed=3).on("tier.spill", schedule=[2]) if fail_spill \
        else None
    kv = KV(num_pages=17, page_size=PG, max_slots=4, pages_per_slot=8)
    tier = Tier(budget_bytes=budget, fault_injector=fi)
    cache = Cache(kv, host_tier=tier,
                  spill=lambda page: _arrs(float(page)))
    return cache, kv, tier


def _tree_script(cache, kv, tier):
    """Donations, evictions, lookups, a subtree drop and a re-donation;
    returns the observable state after every step."""
    seen = []

    def snap(tag):
        cache.flush_sketch()
        m = cache.lookup(np.arange(16, dtype=np.int32), 16)
        seen.append((tag, cache.stats(), sorted(cache.sketch()),
                     tier.stats()["entries"], tier.bytes_used,
                     tier.evicted_pages_total, kv.free_pages(),
                     None if m is None else (m.tokens, m.hot_len())))

    def donate(ids):
        ids = np.asarray(ids, np.int32)
        cache.donate(ids, kv.alloc(-(-len(ids) // PG)), len(ids))

    donate(np.arange(16))
    snap("donate A")
    donate(np.r_[np.arange(8), [9, 9, 9, 9]])
    snap("donate B")
    cache.evict(3)
    snap("evict 3")
    donate(np.arange(12))             # re-donation adopts host nodes
    snap("re-donate")
    cache.evict(5)
    snap("evict 5")
    m = cache.lookup(np.r_[np.arange(8), [9, 9, 9, 9]], 12)
    cache.drop_subtree(m.nodes[-1])
    snap("drop")
    donate((np.arange(20) * 3) % 11)
    cache.evict(8)
    snap("evict 8")
    return seen


@pytest.mark.parametrize("budget,fail_spill",
                         [(None, False), (3 * PAGE_NBYTES, False),
                          (None, True)],
                         ids=["unbounded", "budget", "spill_fault"])
def test_tiered_tree_equals_the_reference(budget, fail_spill):
    """One scripted sequence through both trees: equal stats, sketches,
    host residency and free pages after every step."""
    a = _tree_script(*_tree("jax", budget, fail_spill))
    b = _tree_script(*_tree("port", budget, fail_spill))
    assert a == b
    assert any(s[1]["host_pages"] for s in b)


def test_prefix_fingerprints_equal_the_reference():
    ids = np.random.default_rng(0).integers(0, 50, (37,)).astype(np.int32)
    for pg in (4, 8, 16):
        assert prefix_fingerprints(ids, pg) == jax_fingerprints(ids, pg)
        assert prefix_fingerprints(ids, pg, max_tokens=20) \
            == jax_fingerprints(ids, pg, max_tokens=20)


# ----------------------------------------------- servers on the stubs

A8 = np.arange(8, dtype=np.int32)
B8 = (np.arange(8, dtype=np.int32) + 8) % 16
C8 = np.asarray([5, 5, 5, 5, 9, 9, 9, 9], np.int32)


def _ext_A(n=2):
    return np.concatenate([A8, stub_tokens(A8, 4)[:n],
                           np.asarray([1, 2], np.int32)])


def _tier_pair(mode="split", **kw):
    kw = dict(dict(max_slots=1, max_cache_len=32, cache_backend="paged",
                   page_size=PG, num_pages=6, serving_mode=mode), **kw)
    jt, pt_ = JaxTele(registry=JaxRegistry()), \
        ServerTelemetry(registry=MetricRegistry())
    jax_srv = JaxServer(StubModel(), telemetry=jt, host_tier=JaxTier(),
                        **kw)
    port = ContinuousBatchingServer(TorchStub(), telemetry=pt_,
                                    host_tier=HostTier(), **kw)
    return jax_srv, port


def _tier_view(srv):
    bal = srv.pool_balance()
    st = srv.host_tier.stats()
    st.pop("memory_kind")
    reg = srv.telemetry.registry
    return (tuple(bal), bal.host, bal.host_bytes, st,
            srv._prefix.stats(), srv.stats["prefix_auto_hit_tokens"],
            reg.get("kv_host_spilled_pages_total").value,
            reg.get("kv_host_restored_pages_total").value,
            reg.get("kv_host_restore_corrupt_total").value,
            reg.get("kv_pool_pages").labels(state="host").value)


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_spill_then_restore_equals_the_jax_server(mode):
    """A's pages spill under B and C; A's next turn restores them:
    tokens equal the oracle, and the pool balance, tier counters and
    gauges equal the JAX server's after every request."""
    pair = _tier_pair(mode)
    for p in (A8, B8, C8, _ext_A()):
        views = []
        for srv in pair:
            rid = srv.submit(p, max_new_tokens=4)
            np.testing.assert_array_equal(srv.run()[rid],
                                          stub_tokens(p, 4))
            views.append(_tier_view(srv))
        assert views[0] == views[1]
    port = pair[1]
    assert port.host_tier.spilled_pages_total >= 2
    assert port.host_tier.restored_pages_total == 2
    # the restored pages hold A's tokens (the stub writes token values)
    m = port._prefix.lookup(_ext_A(), 8)
    assert m.hot_len() == len(m.nodes) == 2
    for i, nd in enumerate(m.nodes):
        np.testing.assert_array_equal(
            port._caches["pool"]["k"][0, nd.page, :, 0, 0].numpy(),
            _ext_A()[i * PG:(i + 1) * PG].astype(np.float32))


def test_corrupt_host_buffer_is_a_miss_on_both():
    """A rotted host buffer: the restore misses, the counter moves, the
    request is served from a fresh prefill on both servers alike."""
    pair = _tier_pair()
    for srv in pair:
        for p in (A8, B8, C8):
            srv.submit(p, max_new_tokens=4)
            srv.run()
        full = np.concatenate([A8, stub_tokens(A8, 4)])
        entry = srv._prefix.lookup(full, 12).nodes[0].host
        rotten = [np.array(a) for a in entry.payload]
        rotten[0][0, 0, 0, 0] += 1.0
        entry.payload = tuple(rotten)
        rid = srv.submit(_ext_A(), max_new_tokens=4)
        np.testing.assert_array_equal(srv.run()[rid],
                                      stub_tokens(_ext_A(), 4))
        assert srv.host_tier.restore_corrupt_total == 1
        assert srv.failures == {}
    assert _tier_view(pair[0]) == _tier_view(pair[1])


def test_tier_options_and_postmortem():
    """``host_tier_bytes`` builds a bounded tier, a disabled tier is
    None inside, the dense backend refuses one, and a postmortem freezes
    the host counts — as the JAX server does."""
    kw = dict(max_slots=1, max_cache_len=32, cache_backend="paged",
              page_size=PG, num_pages=6)
    srv = ContinuousBatchingServer(TorchStub(), host_tier_bytes=PAGE_NBYTES,
                                   recorder=True, **kw)
    assert isinstance(srv.host_tier, HostTier)
    for p in (A8, B8, C8):
        srv.submit(p, max_new_tokens=4)
        srv.run()
    assert srv.host_tier.evicted_pages_total == 1
    assert srv.pool_balance().host == srv.host_tier.entries == 1
    srv.kill(timeout=5.0)
    pm = srv.postmortems()[-1]
    assert pm["pool_balance"]["host"] == 1
    assert pm["pool_balance"]["host_bytes"] == srv.host_tier.bytes_used
    assert pm["block_table"]["host_tier"]["entries"] == 1
    off = ContinuousBatchingServer(TorchStub(),
                                   host_tier=HostTier(enabled=False), **kw)
    assert off._host is None and off._prefix._tier is None
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingServer(TorchStub(), max_slots=1,
                                 max_cache_len=32, host_tier=True)


def test_spill_and_restore_priced_like_the_jax_server():
    """``page_spill`` / ``page_restore`` ride the cost catalog as bytes
    moved both ways (zero FLOPs), equal to the JAX server's, and never
    as a tick dispatch."""
    from paddle_tpu.telemetry import CostCatalog as JaxCatalog
    from paddle_tpu_torch.telemetry import CostCatalog
    totals = []
    for srv, Cat in zip(_tier_pair(), (JaxCatalog, CostCatalog)):
        cat = Cat(registry=srv.telemetry.registry)
        srv.costs = srv._costs = cat
        for p in (A8, B8, C8, _ext_A()):
            srv.submit(p, max_new_tokens=4)
            srv.run()
        cat.flush_tick()
        tot = cat.totals()
        totals.append({op: (tot[op]["hbm_bytes"], tot[op]["flops"])
                       for op in ("page_spill", "page_restore")})
        disp = srv.telemetry.registry.get("server_dispatches_total")
        assert not any("page_spill" in str(k) or "page_restore" in str(k)
                       for k in disp._children)
    assert totals[0] == totals[1]
    assert totals[1]["page_restore"] == (2 * 2 * PG * (PAGE_NBYTES // PG),
                                         0.0)


def _storm(pkg):
    Inj, Srv, Model, Tier = (
        (JaxInjector, JaxServer, StubModel, JaxTier) if pkg == "jax"
        else (FaultInjector, ContinuousBatchingServer, TorchStub,
              HostTier))
    if pkg == "jax":
        from paddle_tpu.reliability import CircuitBreaker as CB
        from paddle_tpu.reliability import RetryPolicy as RP
    else:
        CB, RP = CircuitBreaker, RetryPolicy
    fi = (Inj(seed=4242).on("server.prefill", probability=0.15)
          .on("kv.alloc", probability=0.1)
          .on("prefix.evict", probability=0.2)
          .on("prefix.donate", probability=0.2)
          .on("tier.spill", probability=0.3)
          .on("tier.restore", probability=0.3))
    srv = Srv(Model(), max_slots=2, max_cache_len=32,
              cache_backend="paged", page_size=PG, num_pages=8,
              host_tier=Tier(budget_bytes=8 * PAGE_NBYTES),
              retry_policy=RP(base_delay_s=0.0, jitter=0.0),
              breaker=CB(failure_threshold=10_000), fault_injector=fi)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 16, (int(k),)).astype(np.int32)
               for k in rng.integers(8, 14, (12,))]
    exts = [np.concatenate([p, stub_tokens(p, 4)[:2],
                            np.asarray([int(p[0]) % 16, 3], np.int32)])
            for p in prompts[:8]]
    trace = []
    for batch in (prompts, exts):
        for p in batch:
            srv.submit(p, max_new_tokens=4)
        for _ in range(5000):
            with srv._lock:
                if not srv._busy_locked():
                    break
            try:
                srv.step()
            except Exception as e:
                trace.append(type(e).__name__)
    results = {r: tuple(int(x) for x in v) for r, v in srv._results.items()}
    fails = {r: type(e).__name__ for r, e in srv.failures.items()}
    st = srv.host_tier.stats()
    st.pop("memory_kind")
    bal = srv.pool_balance()
    return (fi.trace, trace, results, fails, tuple(bal), bal.host,
            bal.host_bytes, srv._prefix.stats(), st)


def test_tier_storm_equals_the_jax_server():
    """One seeded storm over the tier, prefix and admission points: the
    same fault trace, tick failures, results, failures and state in both
    tiers on both servers, and no device page leaked."""
    a, b = _storm("jax"), _storm("port")
    assert a == b
    assert any(p in ("tier.spill", "tier.restore") for p, _ in b[0])
    assert b[4][1] == 0


# --------------------------------------------------- llama_tiny parity


@functools.lru_cache(maxsize=1)
def _llamas():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_llama_restore_equals_never_evicted_and_jax(sample):
    """Session A's history is spilled by three later sessions; its next
    turn restores it. Every request's tokens equal the never-evicted
    port server's and the JAX tiered server's; the tier's counters and
    the balances equal the JAX server's."""
    jm, tm = _llamas()
    kw = dict(max_slots=1, max_cache_len=64, cache_backend="paged",
              page_size=8)
    if sample:
        kw.update(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    oracle = ContinuousBatchingServer(tm, num_pages=24, **kw)
    tiered = ContinuousBatchingServer(tm, num_pages=7,
                                      host_tier=HostTier(), **kw)
    jaxt = JaxServer(jm, num_pages=7, host_tier=JaxTier(), **kw)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, (16,)).astype(np.int32)
               for _ in range(4)]
    hist = None
    for i, p in enumerate(prompts + [None]):
        if p is None:
            p = np.concatenate([hist, rng.integers(0, 256, (3,)).astype(
                np.int32)])
        outs = []
        for srv in (oracle, tiered, jaxt):
            rid = srv.submit(p, max_new_tokens=4, seed=101 + i)
            outs.append(np.asarray(srv.run()[rid]))
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[1], outs[2])
        if i == 0:
            hist = np.concatenate([p, outs[0].astype(np.int32)])
    assert tiered.host_tier.restored_pages_total >= 2
    st_p, st_j = tiered.host_tier.stats(), jaxt.host_tier.stats()
    for k in ("spilled_pages_total", "restored_pages_total",
              "evicted_pages_total", "entries", "bytes_used"):
        assert st_p[k] == st_j[k], k
    bp, bj = tiered.pool_balance(), jaxt.pool_balance()
    assert tuple(bp) == tuple(bj) and bp.host == bj.host
