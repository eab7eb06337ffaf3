"""Live KV-page migration and the prefill handoff in the port, against
the JAX package, on the CPU.

The in-process contracts of the JAX package's ``tests/test_migration.py``
(``TestMigrationInProcess``, ``TestPrefillHandoff``), each script run
through the JAX server over ``StubModel`` and the port's over
``TorchStub`` (``stub_tokens`` is the oracle), driven tick by tick with
``step()``:

- greedy and seeded sampled requests migrate mid-decode bit-exactly with
  zero re-prefill on the target (``prefill_tokens`` and ``admissions``
  stay 0; a fused target's ``prefill_dispatches`` stays frozen); the
  state dicts, page payloads and sha256 digests equal the JAX server's;
- ``migrate_abort`` resumes bit-exactly; refusals are typed
  (``MigrationError``, ``OutOfPages``) and leak nothing;
  ``migrate.gather`` / ``migrate.restore`` chaos falls back;
- empty-emitted, staged (pipelined) and aborted handoffs are bit-exact;
  ``placement="disaggregated"`` hands a long prompt from a prefill
  specialist to a decode replica through the router's pump, and degrades
  to hybrid routing when the specialist is down.

On ``llama_tiny`` in f32 (weights bridged from the JAX model): a
mid-decode migration, split and fused, greedy and sampled, continues
with the never-migrated run's tokens; and the mixed fleet — a request
moves from the JAX server to the port's and back, a prefill handoff each
way, every page's sha256 checked on arrival, and the port's router over
one JAX and one port replica routes a shared prefix by their (equal)
sketches.

Tokens are compared for equality everywhere; no tolerance is involved.
"""
import functools
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from _serving_stub import StubModel, stub_tokens
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.inference.kv_tier import _sha256 as jax_sha256
from paddle_tpu.inference.router import ReplicaRouter as JaxRouter
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.reliability import FaultInjector as JaxInjector
from paddle_tpu.reliability import InjectedFault as JaxInjected
from paddle_tpu.reliability import MigrationError as JaxMigrationError
from paddle_tpu_torch.inference import (ContinuousBatchingServer,
                                        OutOfPages, ReplicaRouter)
from paddle_tpu_torch.inference.kv_tier import _sha256
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.reliability import (FaultInjector, InjectedFault,
                                          MigrationError, faults)
from paddle_tpu_torch.telemetry import (FlightRecorder, MetricRegistry,
                                        ServerTelemetry)
from test_torch_preemption import TorchStub

SERVER_KW = dict(max_slots=2, max_cache_len=64, cache_backend="paged",
                 page_size=8, num_pages=17)
HANDOFF_KW = dict(SERVER_KW, prefill_tokens_per_tick=8)
PROMPT = (np.arange(1, 12, dtype=np.int32) % 13)
LONG_PROMPT = (np.arange(1, 25, dtype=np.int32) % 13)    # 3 chunks of 8
SHORT_PROMPT = np.asarray([3, 1, 4], np.int32)
BUDGET = 48
HBUDGET = 12
SAMPLE = dict(do_sample=True, temperature=0.7, top_k=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# the two packages' pieces, addressed the same way by every script
SIDES = {
    "jax": dict(srv=lambda **kw: JaxServer(StubModel(), **kw),
                Injector=JaxInjector, MigErr=JaxMigrationError,
                Injected=JaxInjected, Router=JaxRouter),
    "port": dict(srv=lambda **kw: ContinuousBatchingServer(TorchStub(),
                                                           **kw),
                 Injector=FaultInjector, MigErr=MigrationError,
                 Injected=InjectedFault, Router=ReplicaRouter),
}


def _both(script, *args, **kw):
    """Run ``script`` on each package; assert equal results; return the
    port's."""
    a = script(SIDES["jax"], *args, **kw)
    b = script(SIDES["port"], *args, **kw)
    assert a == b
    return b


def _step_until_idle(*servers, cap=5000):
    for _ in range(cap):
        busy = False
        for srv in servers:
            if srv._busy_locked():
                srv.step()
                busy = True
        if not busy:
            return
    raise AssertionError("servers never went idle")


def _step_until(srv, pred, cap=500):
    for _ in range(cap):
        if pred():
            return
        srv.step()
    raise AssertionError("condition never reached")


def _sink(got):
    return lambda rid, toks: got.extend(int(t) for t in toks)


def _oracle(side, prompt=PROMPT, budget=BUDGET, seed=5, **kw):
    srv = side["srv"](**dict(SERVER_KW, **kw))
    rid = srv.submit(prompt, max_new_tokens=budget, seed=seed)
    return [int(t) for t in srv.run()[rid]]


def _pool(srv):
    return tuple(srv.pool_balance())


def _stats(srv, keys=("prefill_tokens", "admissions", "migrations",
                      "migrated_in", "migration_fallbacks",
                      "handoff_pages_out", "handoff_pages_in")):
    return {k: srv.stats[k] for k in keys}


def _state_view(state, payloads):
    return (dict(state), [[np.asarray(a).tobytes() for a in p]
                          for p in payloads],
            [_sha256(p) for p in payloads])


# ------------------------------------------------ mid-decode migration


def _migrate_script(side, sample, src_mode, tgt_mode):
    kw = dict(SAMPLE) if sample else {}
    src = side["srv"](serving_mode=src_mode, telemetry=True,
                      journeys=True, **dict(SERVER_KW, **kw))
    tgt = side["srv"](serving_mode=tgt_mode, **dict(SERVER_KW, **kw))
    got = []
    rid = src.submit(PROMPT, max_new_tokens=BUDGET, seed=5,
                     on_token=_sink(got))
    _step_until(src, lambda: len(got) >= 6)
    state, payloads = src.migrate_out(rid)
    view = _state_view(state, payloads)
    before = tgt.stats["prefill_dispatches"]
    new_rid = tgt.migrate_in(state, payloads, on_token=_sink(got))
    src.migrate_finish(rid)
    _step_until_idle(tgt)
    out = [int(t) for t in tgt.run()[new_rid]]
    assert out == _oracle(side, serving_mode=tgt_mode, **kw)
    assert got == out                       # every token once, in order
    assert tgt.stats["prefill_tokens"] == 0
    assert tgt.stats["admissions"] == 0
    if tgt_mode == "fused":
        assert tgt.stats["prefill_dispatches"] == before
    timeline = src.journey(rid)
    assert any(e["phase"] == "migrating" for e in timeline)
    snap = src.telemetry.registry.snapshot()
    assert snap["server_migrations_total"]["samples"][("ok",)] == 1
    return (view, out, _stats(src), _stats(tgt), _pool(src), _pool(tgt))


@pytest.mark.parametrize("sample,src_mode,tgt_mode", [
    (False, "split", "split"), (True, "split", "split"),
    (False, "split", "fused"), (True, "fused", "split")],
    ids=["greedy-split-split", "sampled-split-split", "greedy-split-fused",
         "sampled-fused-split"])
def test_mid_decode_migration_equals_the_jax_server(sample, src_mode,
                                                    tgt_mode):
    out = _both(_migrate_script, sample, src_mode, tgt_mode)
    if not sample:
        np.testing.assert_array_equal(out[1], stub_tokens(PROMPT, BUDGET))
    assert out[2]["migrations"] == 1 and out[3]["migrated_in"] == 1
    assert out[4][1] == 0 and out[5][1] == 0


def _abort_script(side, mode):
    src = side["srv"](serving_mode=mode, recorder=True,
                      **dict(SERVER_KW, **SAMPLE))
    got = []
    rid = src.submit(PROMPT, max_new_tokens=BUDGET, seed=9,
                     on_token=_sink(got))
    _step_until(src, lambda: len(got) >= 6)
    src.migrate_out(rid)
    for _ in range(3):
        src.step()                 # a paused slot neither steps nor emits
    assert len(got) == 6
    assert src.migrate_abort(rid) is True
    assert src.migrate_abort(rid) is False
    out = [int(t) for t in src.run()[rid]]
    assert out == _oracle(side, seed=9, serving_mode=mode, **SAMPLE)
    assert got == out
    pm = src.postmortems()[-1]
    assert pm["reason"] == "migration_fallback"
    return (out, _stats(src), _pool(src), pm["migration"])


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_abort_resumes_bit_exact_like_the_jax_server(mode):
    out = _both(_abort_script, mode)
    assert out[1]["migration_fallbacks"] == 1 and out[2][1] == 0


def _refusal_script(side):
    src = side["srv"](**SERVER_KW)
    tgt = side["srv"](**SERVER_KW)
    dense = side["srv"](**dict(SERVER_KW, cache_backend="dense",
                               num_pages=None))
    seen = []
    for call in (lambda: src.migrate_out(12345),
                 lambda: dense.migrate_out(0)):
        with pytest.raises(side["MigErr"]) as e:
            call()
        seen.append(str(e.value))
    done = src.submit(PROMPT, max_new_tokens=4)
    src.run()
    with pytest.raises(side["MigErr"]):
        src.migrate_out(done)
    got = []
    rid = src.submit(PROMPT, max_new_tokens=BUDGET, seed=5,
                     on_token=_sink(got))
    _step_until(src, lambda: len(got) >= 6)
    state, payloads = src.migrate_out(rid)
    tampered = [[np.array(a) for a in p] for p in payloads]
    tampered[0][0].flat[0] += 1.0
    for bad in ((dict(state, page_size=4), payloads),
                (state, payloads[:-1]), (state, tampered),
                (dict(state, base=2), payloads)):
        with pytest.raises(side["MigErr"]) as e:
            tgt.migrate_in(*bad)
        seen.append(str(e.value))
    with pytest.raises(side["MigErr"]):
        src.migrate_out(rid)                  # already paused
    assert tgt.stats["migrated_in"] == 0
    assert src.migrate_abort(rid) is True
    out = [int(t) for t in src.run()[rid]]
    return seen, out, _pool(src), _pool(tgt)


def test_refusals_typed_and_leak_free_like_the_jax_server():
    seen, out, psrc, ptgt = _both(_refusal_script)
    assert out == [int(t) for t in stub_tokens(PROMPT, BUDGET)]
    assert psrc[1] == 0 and ptgt[1] == 0
    assert "sha256" in seen[4] and "migrate_in_begin" in seen[5]


def _chaos_script(side):
    fi_src = side["Injector"](seed=6).on("migrate.gather", schedule=[0])
    fi_tgt = side["Injector"](seed=6).on("migrate.restore", schedule=[0])
    src = side["srv"](fault_injector=fi_src, **SERVER_KW)
    tgt = side["srv"](fault_injector=fi_tgt, **SERVER_KW)
    got = []
    rid = src.submit(PROMPT, max_new_tokens=BUDGET, seed=5,
                     on_token=_sink(got))
    _step_until(src, lambda: len(got) >= 6)
    with pytest.raises(side["Injected"]):
        src.migrate_out(rid)                  # fires before the pause
    src.step()                                # still decoding
    state, payloads = src.migrate_out(rid)
    with pytest.raises(side["Injected"]):
        tgt.migrate_in(state, payloads)       # fires before any alloc
    assert src.migrate_abort(rid) is True
    out = [int(t) for t in src.run()[rid]]
    return (out, got == out, fi_src.trace, fi_tgt.trace, _stats(src),
            _pool(src), _pool(tgt))


def test_gather_and_restore_chaos_fall_back_like_the_jax_server():
    out = _both(_chaos_script)
    assert out[0] == [int(t) for t in stub_tokens(PROMPT, BUDGET)]
    assert out[1] and out[5][1] == 0 and out[6][1] == 0


def _no_slot_script(side):
    src = side["srv"](**SERVER_KW)
    tgt = side["srv"](**SERVER_KW)
    hold = [tgt.submit(PROMPT, max_new_tokens=BUDGET) for _ in range(2)]
    tgt.step()
    rid = src.submit(PROMPT, max_new_tokens=BUDGET, seed=5)
    for _ in range(8):
        src.step()
    state, payloads = src.migrate_out(rid)
    with pytest.raises(Exception) as e:
        tgt.migrate_in(state, payloads)
    assert type(e.value).__name__ == "OutOfPages"
    assert src.migrate_abort(rid) is True
    out = [int(t) for t in src.run()[rid]]
    outs = tgt.run()
    return (out, [[int(t) for t in outs[h]] for h in hold], _pool(src),
            _pool(tgt))


def test_target_without_free_slot_refuses_typed():
    out = _both(_no_slot_script)
    assert out[0] == [int(t) for t in stub_tokens(PROMPT, BUDGET)]
    assert out[2][1] == 0 and out[3][1] == 0
    assert issubclass(OutOfPages, Exception)


# ------------------------------------------------------ prefill handoff


def _handoff_oracle(side, prompt=LONG_PROMPT, budget=HBUDGET, seed=5,
                    **kw):
    srv = side["srv"](**dict(HANDOFF_KW, **kw))
    rid = srv.submit(prompt, max_new_tokens=budget, seed=seed)
    return [int(t) for t in srv.run()[rid]]


def _empty_emitted_script(side, sample, tgt_mode):
    kw = dict(SAMPLE) if sample else {}
    src = side["srv"](role="prefill", **dict(HANDOFF_KW, **kw))
    tgt = side["srv"](role="decode", serving_mode=tgt_mode,
                      **dict(HANDOFF_KW, **kw))
    got = []
    rid = src.submit(LONG_PROMPT, max_new_tokens=HBUDGET, seed=5,
                     on_token=_sink(got))
    src.step()
    src.step()                      # admit + chunks 1, 2: 16 of 24 rows
    state, payloads = src.migrate_out(rid)
    assert state["phase"] == "prefill" and state["filled"] == 16
    assert len(payloads) == 2
    view = _state_view(state, payloads)
    new_rid = tgt.migrate_in(state, payloads, on_token=_sink(got))
    src.migrate_finish(rid)
    _step_until_idle(tgt)
    out = [int(t) for t in tgt.run()[new_rid]]
    assert out == _handoff_oracle(side, serving_mode=tgt_mode, **kw)
    assert got == out
    assert src.stats["prefill_tokens"] == 16
    assert tgt.stats["prefill_tokens"] == len(LONG_PROMPT) - 16
    return view, out, _stats(src), _stats(tgt), _pool(src), _pool(tgt)


@pytest.mark.parametrize("sample,tgt_mode", [
    (False, "split"), (True, "split"), (True, "fused")],
    ids=["greedy-split", "sampled-split", "sampled-fused"])
def test_empty_emitted_handoff_equals_the_jax_server(sample, tgt_mode):
    out = _both(_empty_emitted_script, sample, tgt_mode)
    assert out[3]["admissions"] == 1 and out[5][1] == 0


def _staged_script(side):
    src = side["srv"](role="prefill", **HANDOFF_KW)
    tgt = side["srv"](role="decode", **HANDOFF_KW)
    got = []
    rid = src.submit(LONG_PROMPT, max_new_tokens=HBUDGET, seed=5,
                     on_token=_sink(got))
    src.step()                                 # 8 of 24 rows
    frag, payloads = src.migrate_out(rid, partial=True)
    assert frag["partial"] and frag["base"] == 0 and len(payloads) == 1
    handle = tgt.migrate_in_begin(
        {"rid": int(rid), "ids": LONG_PROMPT,
         "prompt_len": len(LONG_PROMPT), "budget": HBUDGET, "seed": 5,
         "page_size": 8, "phase": "prefill"})
    assert tgt.migrate_in_pages(handle, 0, payloads, frag["sha256"]) == 1
    src.step()                                 # 16 rows
    frag2, payloads2 = src.migrate_out(rid, partial=True)
    tgt.migrate_in_pages(handle, 1, payloads2, frag2["sha256"])
    state, tail = src.migrate_out(rid, from_page=2)
    assert state["base"] == 2 and tail == []
    new_rid = tgt.migrate_in_commit(handle, state, tail,
                                    on_token=_sink(got))
    src.migrate_finish(rid)
    out = [int(t) for t in tgt.run()[new_rid]]
    assert out == _handoff_oracle(side) and got == out
    return (frag, frag2, dict(state), out, _stats(src), _stats(tgt),
            _pool(src), _pool(tgt))


def test_staged_pipelined_handoff_equals_the_jax_server():
    out = _both(_staged_script)
    assert out[4]["handoff_pages_out"] == 2
    assert out[5]["handoff_pages_in"] == 2


def _handoff_refusal_script(side):
    src = side["srv"](**HANDOFF_KW)
    pre = side["srv"](role="prefill", **HANDOFF_KW)
    got = []
    rid = src.submit(PROMPT, max_new_tokens=HBUDGET, seed=5,
                     on_token=_sink(got))
    _step_until(src, lambda: len(got) >= 4)
    state, payloads = src.migrate_out(rid)
    seen = []
    for call in (lambda: pre.migrate_in(state, payloads),
                 lambda: pre.migrate_in_pages(999, 0, payloads),
                 lambda: pre.migrate_in_begin(state)):
        with pytest.raises(side["MigErr"]) as e:
            call()
        seen.append(str(e.value))
    assert src.migrate_abort(rid) is True
    out = [int(t) for t in src.run()[rid]]
    assert out == _handoff_oracle(side, prompt=PROMPT)
    # a mid-prefill pause resumes chunking where it stopped
    rid2 = pre.submit(LONG_PROMPT, max_new_tokens=HBUDGET, seed=5)
    pre.step()
    st2, _ = pre.migrate_out(rid2)
    assert st2["phase"] == "prefill"
    assert pre.migrate_abort(rid2) is True
    out2 = [int(t) for t in pre.run()[rid2]]
    assert out2 == _handoff_oracle(side)
    # an open staging aborts without a leak, idempotently
    free0 = pre.pool_balance()[0]
    handle = src.migrate_in_begin(
        {"rid": 1, "ids": LONG_PROMPT, "prompt_len": len(LONG_PROMPT),
         "budget": HBUDGET, "seed": 5, "page_size": 8,
         "phase": "prefill"})
    assert src.in_flight() == 1
    assert src.migrate_in_abort(handle) is True
    assert src.migrate_in_abort(handle) is False
    return (seen, out, out2, _stats(pre), _pool(src), _pool(pre),
            free0 == pre.pool_balance()[0])


def test_handoff_refusals_and_aborts_like_the_jax_server():
    out = _both(_handoff_refusal_script)
    assert all("role 'prefill'" in m or "staged" in m for m in out[0])
    assert out[4][1] == 0 and out[5][1] == 0 and out[6]


def _drive_router(router, reps, timeout=60):
    """Step the serving replicas while the router's handoff pump runs
    on its own thread: while a pump is live each round leaves it 5 ms
    to take the servers' locks, so the handoff lands before the
    request could finish on the specialist however loaded the host."""
    deadline = time.monotonic() + timeout
    idle = 0
    while time.monotonic() < deadline:
        router.poll()
        busy = False
        for rep in reps:
            if rep.health == "dead":
                continue
            if rep.queue_depth() or rep.in_flight():
                rep.step()
                busy = True
        idle = 0 if busy else idle + 1
        if idle >= 3 and not router._pumping:
            return
        time.sleep(0.005 if router._pumping else 0.0005)
    raise AssertionError("router drive did not converge")


def _disagg_script(side):
    pre = side["srv"](role="prefill", **HANDOFF_KW)
    dec = side["srv"](role="decode", **HANDOFF_KW)
    router = side["Router"]([pre, dec], placement="disaggregated",
                            disagg_prefill_min_tokens=16, journeys=True,
                            recorder=True)
    got = []
    rid = router.submit(LONG_PROMPT, max_new_tokens=HBUDGET, seed=5,
                        on_token=_sink(got))
    _drive_router(router, [pre, dec])
    out = [int(t) for t in router.wait(rid, timeout=30)]
    assert out == _handoff_oracle(side) and got == out
    assert any(e["phase"] == "handoff" for e in router.journey(rid))
    dec_prefill = dec.stats["prefill_tokens"]
    rid2 = router.submit(SHORT_PROMPT, max_new_tokens=4)
    _drive_router(router, [pre, dec])
    out2 = [int(t) for t in router.wait(rid2, timeout=30)]
    stats = router.stats
    return (out, out2, stats["handoffs"], stats["handoff_fallbacks"],
            stats["routed"], dec_prefill,
            pre.stats["prefill_tokens"], _pool(pre), _pool(dec))


def test_disaggregated_router_handoff_end_to_end():
    """The long prompt prefills on the specialist and decodes on the
    decode replica with zero re-prefill there; the short one bypasses
    the specialist. Outcomes equal the JAX router's."""
    out = _both(_disagg_script)
    assert out[0] == [int(t) for t in stub_tokens(LONG_PROMPT, HBUDGET)]
    assert out[2] == 1 and out[3] == 0 and out[4] == [1, 1]
    assert out[5] == 0 and out[6] == len(LONG_PROMPT)
    assert out[7][1] == 0 and out[8][1] == 0


def _degrade_script(side):
    pre = side["srv"](role="prefill", **HANDOFF_KW)
    dec = side["srv"](role="decode", **HANDOFF_KW)
    router = side["Router"]([pre, dec], placement="disaggregated",
                            disagg_prefill_min_tokens=16)
    pre.stop(drain=False)
    rid = router.submit(LONG_PROMPT, max_new_tokens=HBUDGET, seed=5)
    _drive_router(router, [pre, dec])
    out = [int(t) for t in router.wait(rid, timeout=30)]
    return (out, router.stats["routed"], router.stats["handoffs"],
            dec.stats["prefill_tokens"])


def test_all_specialists_down_degrades_to_hybrid():
    out = _both(_degrade_script)
    assert out[0] == [int(t) for t in stub_tokens(LONG_PROMPT, HBUDGET)]
    assert out[1][1] == 1 and out[2] == 0
    assert out[3] == len(LONG_PROMPT)


# ------------------------------------------------------- llama_tiny


@functools.lru_cache(maxsize=1)
def _llamas():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


LLAMA_KW = dict(max_slots=2, max_cache_len=64, cache_backend="paged",
                page_size=8, num_pages=17, prefill_tokens_per_tick=16)


def _llama_prompt(n=21, seed=3):
    vocab = llama_tiny().vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


def _serve(srv, prompt, budget, seed):
    rid = srv.submit(prompt, max_new_tokens=budget, seed=seed)
    return [int(t) for t in srv.run()[rid]]


@pytest.mark.parametrize("sample,mode", [(True, "fused")],
                         ids=["sampled-fused"])
def test_llama_mid_decode_migration_bit_exact(sample, mode):
    """The port's servers on llama_tiny: a request moved mid-decode
    continues with the never-migrated run's tokens (and the JAX
    server's), zero re-prefill on the target. Greedy split moves are
    the mixed fleet's (below)."""
    jm, tm = _llamas()
    kw = dict(LLAMA_KW, serving_mode=mode)
    if sample:
        kw.update(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    p = _llama_prompt()
    ref = _serve(ContinuousBatchingServer(tm, **kw), p, 16, 7)
    assert ref == _serve(JaxServer(jm, **kw), p, 16, 7)
    src = ContinuousBatchingServer(tm, **kw)
    tgt = ContinuousBatchingServer(tm, **kw)
    rid = src.submit(p, max_new_tokens=16, seed=7)
    _step_until(src, lambda: src._slots[0] is not None
                and len(src._slots[0].emitted) >= 5)
    state, payloads = src.migrate_out(rid)
    new_rid = tgt.migrate_in(state, payloads)
    src.migrate_finish(rid)
    assert [int(t) for t in tgt.run()[new_rid]] == ref
    assert tgt.stats["prefill_tokens"] == 0
    assert src.pool_balance()[1] == tgt.pool_balance()[1] == 0


def _cross(src, tgt, p, budget, seed, prefill):
    """Move one request ``src`` -> ``tgt`` (mid-prefill when
    ``prefill``, else mid-decode); the target recomputes every page's
    sha256 (``_sha256`` of either package: the same bytes) and the
    digests equal the source's. Returns the continued tokens."""
    rid = src.submit(p, max_new_tokens=budget, seed=seed)
    if prefill:
        src.step()
    else:
        _step_until(src, lambda: src._slots[0] is not None
                    and len(src._slots[0].emitted) >= 4)
    state, payloads = src.migrate_out(rid)
    assert state["phase"] == ("prefill" if prefill else "decode")
    assert state["sha256"] == [jax_sha256(pg) for pg in payloads] \
        == [_sha256(pg) for pg in payloads]
    new_rid = tgt.migrate_in(state, payloads)
    src.migrate_finish(rid)
    return [int(t) for t in tgt.run()[new_rid]]


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_mixed_fleet_moves_requests_both_ways(sample):
    """A JAX server hands a request to a port server and back: mid-decode
    and as a prefill handoff, each way. The continued tokens equal the
    never-migrated runs' in both packages."""
    jm, tm = _llamas()
    kw = dict(LLAMA_KW)
    if sample:
        kw.update(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    p = _llama_prompt(n=37, seed=4)
    ref = _serve(ContinuousBatchingServer(tm, **kw), p, 12, 9)
    assert ref == _serve(JaxServer(jm, **kw), p, 12, 9)
    for prefill in (False, True):
        for src, tgt in ((JaxServer(jm, **kw),
                          ContinuousBatchingServer(tm, **kw)),
                         (ContinuousBatchingServer(tm, **kw),
                          JaxServer(jm, **kw))):
            assert _cross(src, tgt, p, 12, 9, prefill) == ref
            assert src.pool_balance()[1] == tgt.pool_balance()[1] == 0


def test_mixed_fleet_router_routes_by_equal_sketches():
    """The port's router over one JAX and one port replica: after a
    donor finishes on each, a request sharing a donor's prefix routes to
    that donor's replica (an affinity hit), whichever package serves
    it; tokens equal a single port server's."""
    jm, tm = _llamas()
    reps = [JaxServer(jm, **LLAMA_KW), ContinuousBatchingServer(tm,
                                                                **LLAMA_KW)]
    router = ReplicaRouter(reps)
    shared = [_llama_prompt(n=24, seed=s) for s in (5, 6)]
    oracle = ContinuousBatchingServer(tm, **LLAMA_KW)
    # two donors at once: the second sees the first's load and takes
    # the other replica
    donors = [router.submit(pre, max_new_tokens=2, seed=1)
              for pre in shared]
    _step_until_idle(*reps)
    for rid in donors:
        router.wait(rid, timeout=5)
    assert router.stats["routed"] == [1, 1]
    assert reps[0].prefix_sketch() and reps[1].prefix_sketch()
    for i, pre in enumerate(shared):
        p = np.concatenate([pre, _llama_prompt(n=5, seed=20 + i)])
        hits = router.stats["affinity_hits"]
        rid = router.submit(p, max_new_tokens=4, seed=3)
        _step_until_idle(*reps)
        assert router.wait(rid, timeout=5).tolist() \
            == _serve(oracle, p, 4, 3)
        assert router.stats["affinity_hits"] == hits + 1
        assert router.stats["routed"][i] == 2


def test_bf16_pages_travel_as_uint16_bit_patterns():
    """A bf16 pool's pages leave as ``uint16`` bit patterns (numpy has no
    bfloat16), the state names the dtype, and the scatter writes the
    exact bits back."""
    torch.manual_seed(0)
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", dtype=torch.bfloat16)
    kw = LLAMA_KW
    src = ContinuousBatchingServer(tm, **kw)
    tgt = ContinuousBatchingServer(tm, **kw)
    p = _llama_prompt()
    rid = src.submit(p, max_new_tokens=12, seed=7)
    _step_until(src, lambda: src._slots[0] is not None
                and len(src._slots[0].emitted) >= 4)
    state, payloads = src.migrate_out(rid)
    assert state["page_dtype"] == "bfloat16"
    assert all(a.dtype == np.uint16 for pg in payloads for a in pg)
    pages = src._kv.slot_pages(0)[:len(payloads)]
    want = src._caches["pool"]["k"][:, pages].view(torch.uint16)
    new_rid = tgt.migrate_in(state, payloads)
    got = tgt._caches["pool"]["k"][:, tgt._kv.slot_pages(0)[:len(
        payloads)]].view(torch.uint16)
    assert torch.equal(want, got)
    src.migrate_finish(rid)
    ref = _serve(ContinuousBatchingServer(tm, **kw), p, 12, 7)
    assert [int(t) for t in tgt.run()[new_rid]] == ref


def test_postmortem_carries_the_migration_section():
    src = ContinuousBatchingServer(TorchStub(), recorder=FlightRecorder(),
                                   telemetry=ServerTelemetry(
                                       registry=MetricRegistry()),
                                   **SERVER_KW)
    rid = src.submit(PROMPT, max_new_tokens=BUDGET, seed=5)
    for _ in range(8):
        src.step()
    src.migrate_out(rid)
    src.kill(timeout=5.0)
    pm = src.postmortems()[-1]
    assert pm["migration"]["in_flight"] == [rid]
    assert pm["pool_balance"]["num_shards"] == 1
    assert {"host", "host_bytes", "shard_page_bytes"} \
        <= set(pm["pool_balance"])
    assert isinstance(faults.MIGRATE_GATHER, str)
