"""The port's goodput ledger against the JAX server's, tick by tick.

The port's server runs the torch stub of ``tests/test_torch_preemption.py``
and the JAX server ``tests/_serving_stub.StubModel`` (the same
closed-form recurrence, the same scheduling), each with a
``GoodputLedger``; each tick's flushed kinds are compared. On the CPU
the port's routes are its plain versions, which gather every slot's
whole block-table width, so a split decode step and a ragged prefill
launch charge the reference's masked-page model, and the two ledgers are
equal tick by tick on the dense backend, the paged pool with dense or
ragged prefill, a registered prefix's re-prefilled tail, optimistic
admission with a preemption and its replay, and ``tick_block`` 3.

Where the port does other device work, the difference is pinned here:

- a fused tick charges the plain fused-tick version's page reads (each
  live slot's whole table width, each pass) where the reference charges
  its schedule's ladder pad;
- a fused tick with prefill chunks and decode rows runs the decode rows
  in a pass of their own at ``[S, 1]``: no ``C - 1`` pad rows;
- on the card every route reads no page past a slot's frontier: a server
  there charges no ``skipped_page_dma``.

Each tick's kinds sum to the rows its launches ran (counted from the
bundle entries' arguments) plus the masked page reads; a disabled ledger
is treated as None and takes no lock.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.telemetry as JT
import paddle_tpu_torch.telemetry as TT
from _serving_stub import StubModel, stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.reliability import FaultInjector
from test_torch_preemption import TorchStub


def _ticks(Server, model, T, reqs, prefix=None, rows=False, **kw):
    """Serve ``reqs`` ([(prompt, budget)]) tick by tick; returns each
    tick's flushed ledger kinds ({} for a tick that attributed nothing),
    the outputs, and (port only) each tick's launched rows, the server's
    ``device_rows``."""
    led = T.GoodputLedger()
    srv = Server(model, ledger=led, **kw)
    if prefix is not None:
        srv.register_prefix(np.asarray(prefix, np.int32))
    rids = [srv.submit(np.asarray(p, np.int32), max_new_tokens=n)
            for p, n in reqs]
    ticks, launched = [], []
    while srv._busy_locked():
        n0 = led.ticks
        r0 = srv.stats["device_rows"] if rows else 0
        srv.step()
        ticks.append(led.snapshot()["last_tick"] if led.ticks > n0 else {})
        if rows:
            launched.append(srv.stats["device_rows"] - r0)
    out = srv.run()
    for r, (p, n) in zip(rids, reqs):
        np.testing.assert_array_equal(out[r], stub_tokens(p, n))
    return ticks, launched, srv


A, B = ([1, 2, 3], 4), ([4, 5, 6, 7, 8, 9], 3)
PAGED = dict(cache_backend="paged", page_size=4)
CASES = {
    "dense": ([A, B], None, {}),
    "dense chunked, tick_block 3": ([([1, 2, 3, 4, 5], 5), B], None,
                                    dict(prefill_chunk=2, tick_block=3)),
    "paged dense prefill": ([A, B], None, dict(PAGED,
                                               prefill_mode="dense")),
    "paged ragged": ([A, B], None, PAGED),
    "paged ragged mid-prefill": ([A, B], None,
                                 dict(PAGED, prefill_tokens_per_tick=3)),
    "paged ragged tick_block 3": ([A, B], None, dict(PAGED, tick_block=3)),
    "registered tail": ([([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 2)],
                        [1, 2, 3, 4, 5, 6], dict(PAGED, max_slots=1,
                                                 max_cache_len=32)),
    "optimistic preemption": ([([1, 2, 3, 4], 8), ([5, 6, 7, 8], 8)], None,
                              dict(PAGED, num_pages=6,
                                   admission="optimistic")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_equals_the_jax_servers_tick_by_tick(case):
    """Split ticks and dense prefill on the CPU: the port's ledger is
    the reference's, every tick, every kind; and each tick's kinds sum
    to the rows the port's launches ran plus its masked page reads."""
    reqs, prefix, kw = CASES[case]
    kw = dict({"max_slots": 2, "max_cache_len": 16}, **kw)
    ref, _, _ = _ticks(JaxServer, StubModel(), JT, reqs, prefix, **kw)
    port, launched, srv = _ticks(ContinuousBatchingServer, TorchStub(), TT,
                                 reqs, prefix, rows=True, **kw)
    assert port == ref
    assert any(port)
    if case == "optimistic preemption":
        assert srv.stats["preemptions"] >= 1
        assert sum(t.get("replay", 0) for t in port) > 0
    if case == "registered tail":
        assert sum(t.get("tail_reprefill", 0) for t in port) == 2
    for tick, n in zip(port, launched):
        assert sum(tick.values()) - tick.get("skipped_page_dma", 0) == n


FUSED = dict(PAGED, serving_mode="fused", max_cache_len=16)


def test_fused_tick_charges_the_plain_versions_page_reads():
    """Pinned difference: one request (prompt 3, 3 tokens) on fused
    ticks over a 4-page table of 4-token pages. The port's CPU route
    (``_ref_fused_tick``) reads the slot's whole table, so it charges
    the pages past its frontier: 3 x 4 while 1 page is live, then 2 x 4.
    The reference charges its schedule's ladder pad (8 entries at least):
    7 x 4, 7 x 4, then 6 x 4. Every other kind is equal."""
    reqs = [([1, 2, 3], 3)]
    ref, _, _ = _ticks(JaxServer, StubModel(), JT, reqs, max_slots=1,
                       **FUSED)
    port, launched, _ = _ticks(ContinuousBatchingServer, TorchStub(), TT,
                               reqs, rows=True, max_slots=1, **FUSED)
    assert [t["skipped_page_dma"] for t in port] == [12, 12, 8]
    assert [t["skipped_page_dma"] for t in ref] == [28, 28, 24]
    drop = lambda ts: [{k: v for k, v in t.items()
                        if k != "skipped_page_dma"} for t in ts]
    assert drop(port) == drop(ref)
    for tick, n in zip(port, launched):
        assert sum(tick.values()) - tick["skipped_page_dma"] == n


def test_mixed_fused_tick_charges_no_decode_row_pad():
    """Pinned difference: request B prefills 3 tokens a tick (C = 4)
    while A decodes. The reference's fused program runs A's decode row
    at the tick's width and charges its ``C - 1 = 3`` pad rows; the port
    runs decode rows as a pass of their own at ``[S, 1]``, one device
    row each. So on those two ticks the port's ``chunk_pad`` is the
    reference's less 3; goodput and replay are equal every tick."""
    reqs = [A, B]
    kw = dict(FUSED, max_slots=2, prefill_tokens_per_tick=3)
    ref, _, _ = _ticks(JaxServer, StubModel(), JT, reqs, **kw)
    port, launched, _ = _ticks(ContinuousBatchingServer, TorchStub(), TT,
                               reqs, rows=True, **kw)
    assert [t.get("chunk_pad", 0) for t in ref] == [1, 4, 4, 0, 0]
    assert [t.get("chunk_pad", 0) for t in port] == [1, 1, 1, 0, 0]
    for k in ("goodput", "replay", "tail_reprefill", "null_redirect"):
        assert [t.get(k, 0) for t in port] == [t.get(k, 0) for t in ref]
    for tick, n in zip(port, launched):
        assert sum(tick.values()) - tick["skipped_page_dma"] == n


def test_no_masked_page_read_is_charged_on_the_card():
    """Pinned difference: K1, K2 and K3 on the card read no K/V column at
    or past a slot's frontier (the bf16 split body, the f32 SIMT body,
    K3's schedule walk), so a server whose device is the card charges no
    ``skipped_page_dma``; on the CPU it charges the plain versions' reads
    past the frontier, the reference's model."""
    srv = ContinuousBatchingServer(TorchStub(), max_slots=1,
                                   max_cache_len=16, **PAGED)
    assert srv._skipped_dma(5) == (4 - 2) * 4
    srv.device = torch.device("cuda")
    assert srv._skipped_dma(5) == 0


class _CountingLock:
    def __init__(self):
        self.acquisitions = 0

    def __enter__(self):
        self.acquisitions += 1
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("mode", ["dense", "paged", "fused"])
def test_disabled_ledger_takes_no_lock_and_is_none(mode):
    """A disabled ledger is treated as None: the server serves, the
    ledger's lock is never taken, and ``goodput()`` is None."""
    led = TT.GoodputLedger(enabled=False)
    lock = _CountingLock()
    led._lock = lock
    kw = {"dense": {}, "paged": PAGED,
          "fused": dict(PAGED, serving_mode="fused")}[mode]
    srv = ContinuousBatchingServer(TorchStub(), max_slots=2,
                                   max_cache_len=16, ledger=led, **kw)
    assert srv._led is None
    rid = srv.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
    np.testing.assert_array_equal(srv.run()[rid], stub_tokens([1, 2, 3], 3))
    assert lock.acquisitions == 0 and led._tick == {}
    assert srv.goodput() is None and srv.utilization() == {}


def test_stats_postmortem_and_utilization_carry_goodput():
    """``goodput()``, ``utilization()`` and a postmortem bundle (a
    request failed by an injected prefill fault) carry the ledger's
    snapshot; the published ``server_tokens_total{kind}`` samples equal
    its totals."""
    tele = TT.ServerTelemetry()
    led = TT.GoodputLedger(registry=tele.registry)
    fi = FaultInjector(seed=0).on("server.prefill", schedule=[1])
    srv = ContinuousBatchingServer(TorchStub(), max_slots=2,
                                   max_cache_len=16, telemetry=tele,
                                   ledger=led, recorder=True,
                                   fault_injector=fi, **PAGED)
    ok = srv.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
    assert ok in srv.run()
    # the second admission fails before any device work: the bundle
    # captures the ledger as the first request left it
    bad = srv.submit(np.asarray([4, 5], np.int32), max_new_tokens=3)
    srv.run()
    assert bad in srv.failures
    assert srv.goodput()["tokens"] == led.totals()
    assert srv.utilization() == {"goodput_ratio": led.goodput_ratio()}
    (bundle,) = srv.postmortems()
    assert bundle["reason"] == "request_failed" and bundle["rid"] == bad
    assert bundle["goodput"]["tokens"] == led.totals()
    tok = tele.registry.get("server_tokens_total")
    assert {k: tok.labels(kind=k).value for k in led.totals()} == \
        led.totals()
