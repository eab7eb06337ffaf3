"""The port's paged Llama serving path against the JAX package's, on CPU.

Weights are made once on the JAX side (``llama_tiny``: 2 layers, 4
query heads over 2 kv heads, head_dim 16) and copied into the port with
``models.bridge.load_jax_params``; the same numpy inputs go through
both packages.

- page writes: ``_page_write``/``_page_write_seq`` bit-equal to the JAX
  functions, null-page redirection with zeroed payloads included;
- rope: equal within 1e-6 at in-range positions; out-of-range positions
  are clamped in the port (finite) where JAX fills NaN — the one
  documented divergence, in rows nobody reads;
- the paged bundle: ragged-prefill logits and a decode step's logits
  within atol 1e-4 of the JAX paged bundle (float32; two layers of
  products summed in another order by another BLAS);
- the server, the slice end to end: greedy tokens EQUAL to the JAX
  paged server over mixed prompt lengths, a per-tick token budget that
  straddles chunks across ticks, and an automatic prefix hit on a
  second wave; ``pool_balance()`` ends with ``live == 0`` on both;
- the fused tick on the same squeezed pool (``tests/test_torch_fused_tick.py``
  holds the rest of ``serving_mode="fused"``);
- serving stays graph-free now that the parameters are trainable: a
  wave leaves every ``.grad`` None and the bundle's outputs carry no
  ``grad_fn``;
- refusals: the JAX server's options that are not ported raise
  ``NotImplementedError`` naming the ROADMAP, and entry points refuse
  to run without a CUDA device unless given ``device="cpu"``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops import rope as trope
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_prefill as trp

MCL, PG = 64, 8


@functools.lru_cache(maxsize=1)
def _models():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _server(cls, model, **kw):
    kw.setdefault("prefill_tokens_per_tick", 4)
    return cls(model, max_slots=2, max_cache_len=MCL,
               cache_backend="paged", page_size=PG, **kw)


# ------------------------------------------------------------ page writes


def test_page_write_matches_jax_with_null_redirect():
    rng = np.random.RandomState(0)
    P, pg, h, hd, maxp = 9, 4, 2, 8, 3
    pool = rng.randn(P, pg, h, hd).astype(np.float32)
    kv = rng.randn(4, 1, h, hd).astype(np.float32)
    bt = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8], [0, 0, 0]], np.int32)
    # a live write mid-page, a write into a null tail entry (finite
    # garbage in page 0), and two writes past the table (zeroed, page 0)
    t = np.array([5, 9, 12, 14], np.int32)
    want = np.asarray(jgen._page_write(jnp.asarray(pool), jnp.asarray(kv),
                                       jnp.asarray(bt), jnp.asarray(t)))
    got = tgen._page_write(torch.from_numpy(pool.copy()),
                           torch.from_numpy(kv), torch.from_numpy(bt),
                           torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, 0].any() and not got[0, 2].any()


@pytest.mark.parametrize("with_last", [False, True])
def test_page_write_seq_matches_jax(with_last):
    rng = np.random.RandomState(1)
    P, pg, h, hd, maxp, s = 12, 4, 2, 8, 4, 5
    pool = rng.randn(P, pg, h, hd).astype(np.float32)
    kv = rng.randn(3, s, h, hd).astype(np.float32)
    bt = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], np.int32)
    # a cold chunk, a mid-page resume, and the idle sentinel (t0 = T)
    t = np.array([0, 3, maxp * pg], np.int32)
    last = np.array([3, 6, -1], np.int32) if with_last else None
    kw = {}
    if with_last:
        kw = {"last": jnp.asarray(last)}
    want = np.asarray(jgen._page_write_seq(
        jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(bt),
        jnp.asarray(t), **kw))
    got = tgen._page_write_seq(
        torch.from_numpy(pool.copy()), torch.from_numpy(kv),
        torch.from_numpy(bt), torch.from_numpy(t),
        last=None if last is None else torch.from_numpy(last)).numpy()
    # page 0 takes colliding writes (zeroed redirects and null-entry
    # garbage) whose order differs between scatter implementations;
    # it is masked everywhere, so compare every real page exactly
    np.testing.assert_array_equal(got[1:], want[1:])


def test_rope_matches_jax_and_clamps_past_the_table():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 2, 16).astype(np.float32)
    pos = np.array([[0, 5, 31], [7, 32, 40]], np.int32)   # table: 32 rows
    jc, js = jrope.precompute_freqs(16, 32)
    tc, ts = trope.precompute_freqs(16, 32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    want = np.asarray(jrope._apply_rotary_jnp(jnp.asarray(x), jc, js,
                                              jnp.asarray(pos)))
    got = trope.apply_rotary(torch.from_numpy(x), tc, ts,
                             torch.from_numpy(pos)).numpy()
    inside = pos < 32
    np.testing.assert_allclose(got[inside], want[inside], atol=1e-6)
    assert np.isnan(want[~inside]).all() and np.isfinite(got).all()
    clamped = trope.apply_rotary(torch.from_numpy(x), tc, ts,
                                 torch.from_numpy(np.minimum(pos, 31)))
    np.testing.assert_array_equal(got, clamped.numpy())


# ------------------------------------------------------ the paged bundle


def test_paged_bundle_logits_match_jax_with_bridged_weights():
    jm, tm = _models()
    NP, S = 17, 3
    jb = jm._decode_bundle(MCL, cache_backend="paged", page_size=PG,
                           num_pages=NP)
    tb = tm._decode_bundle(MCL, cache_backend="paged", page_size=PG,
                           num_pages=NP)
    rng = np.random.default_rng(0)
    bt = np.zeros((S, MCL // PG), np.int32)
    bt[0, :2], bt[1, :3] = [1, 2], [3, 4, 5]
    C = 16
    toks = np.zeros((S, C), np.int32)
    toks[0, :12] = rng.integers(0, 256, 12)
    toks[1, :9] = rng.integers(0, 256, 9)
    t0 = np.array([0, 11, MCL], np.int32)       # cold, resumed, idle
    out_idx = np.array([11, 8, 0], np.int32)

    jc = dict(jb[0](S), bt=jnp.asarray(bt))
    jl, jc = jb[5](jnp.asarray(toks), jnp.asarray(t0), jc,
                   jnp.asarray(out_idx))
    tc = tb[0](S)
    tc["bt"].copy_(torch.from_numpy(bt))
    tl, tc = tb[5](torch.from_numpy(toks), torch.from_numpy(t0), tc,
                   torch.from_numpy(out_idx))
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc["pool"]["k"][:, 1:].numpy(),
                               np.asarray(jc["pool"]["k"])[:, 1:],
                               rtol=0, atol=1e-4)

    # one decode step: slot 0 at position 12, slot 1 at 20, slot 2 idle
    # past the table (rope clamped here, NaN there: its row is skipped)
    tok = np.array([7, 9, 0], np.int32)
    t = np.array([12, 20, MCL], np.int32)
    x = jb[1](jnp.asarray(tok), jnp.asarray(t))
    jo, jc = jb[4](x, jc, jnp.asarray(t))
    jl2 = np.asarray(jb[3](jo))[:, -1]
    to, tc = tb[4](tb[1](torch.from_numpy(tok), torch.from_numpy(t)), tc,
                   torch.from_numpy(t))
    tl2 = tb[3](to)[:, -1].numpy()
    np.testing.assert_allclose(tl2[:2], jl2[:2], rtol=0, atol=1e-4)
    assert np.isfinite(tl2).all()


@pytest.mark.parametrize("how", ["missing", "extra", "shape"])
def test_bridge_refuses_mismatched_parameters(how):
    jm, _ = _models()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu", seed=1)
    arrays = {n: p.numpy() for n, p in jm.named_parameters()}
    if how == "missing":
        arrays.pop("lm_head.weight")
    elif how == "extra":
        arrays["lm_head.bias"] = np.zeros(256, np.float32)
    else:
        arrays["model.norm.weight"] = np.zeros(65, np.float32)
    before = tm.lm_head.weight.clone()
    with pytest.raises(KeyError if how != "shape" else ValueError):
        load_jax_params(tm, arrays)
    assert torch.equal(tm.lm_head.weight, before)   # nothing copied


# ------------------------------------------------------------ the server


def _waves(n_vocab=256):
    rng = np.random.default_rng(3)
    wave1 = [rng.integers(0, n_vocab, (n,)).astype(np.int32)
             for n in (1, 7, 8, 13, 17)]
    wave2 = [np.concatenate([wave1[4][:16],
                             rng.integers(0, n_vocab, (n,))
                             .astype(np.int32)]) for n in (2, 5)]
    return wave1, wave2


def _serve(srv, waves, n_new=6):
    toks = []
    for wave in waves:
        rids = [srv.submit(p, max_new_tokens=n_new) for p in wave]
        out = srv.run()
        toks += [out[r] for r in rids]
    return toks


def test_server_greedy_tokens_equal_jax_paged_server():
    jm, tm = _models()
    waves = _waves()
    js, ts = _server(JaxServer, jm), _server(ContinuousBatchingServer, tm)
    want, got = _serve(js, waves), _serve(ts, waves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ts.stats["prefix_auto_hits"] == js.stats["prefix_auto_hits"] >= 1
    assert ts.stats["prefill_tokens"] == js.stats["prefill_tokens"]
    assert ts.stats["admissions"] == js.stats["admissions"] == 7
    assert ts.stats["nonfinite_logit_rows"] == 0
    assert js.pool_balance()[1] == 0 and ts.pool_balance()[1] == 0
    assert tuple(ts.pool_balance()) == tuple(js.pool_balance())
    # CPU tensors take the plain versions: no kernel launch
    assert tpa.paged_attention.launches == 0
    assert trp.ragged_prefill_attention.launches == 0


def test_serving_builds_no_graph_with_trainable_parameters():
    """The parameters require grad (the training slice), yet serving
    runs under torch.no_grad: a wave leaves every .grad None, the
    bundle's outputs carry no grad_fn, and the tokens still equal the
    JAX paged server's."""
    jm, tm = _models()
    assert all(p.requires_grad for p in tm.parameters())
    waves = _waves()
    ts = _server(ContinuousBatchingServer, tm)
    got = _serve(ts, waves)
    want = _serve(_server(JaxServer, jm), waves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert all(isinstance(t, np.ndarray) for t in got)
    assert all(p.grad is None for p in tm.parameters())
    assert not ts._caches["pool"]["k"].requires_grad

    tb = tm._decode_bundle(MCL, cache_backend="paged", page_size=PG,
                           num_pages=9)
    caches = tb[0](2)
    caches["bt"][:, :2] = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    toks = torch.tensor([[5, 6, 7, 8], [9, 10, 0, 0]], dtype=torch.int32)
    t0 = torch.tensor([0, 0], dtype=torch.int32)
    logits, caches = tb[5](toks, t0, caches,
                           torch.tensor([3, 1], dtype=torch.int32))
    x = tb[1](torch.tensor([1, 2], dtype=torch.int32), 4)
    out, caches = tb[4](x, caches, 4)
    outs = [logits, x, out, tb[3](out), caches["pool"]["k"],
            caches["pool"]["v"]]
    assert all(t.grad_fn is None and not t.requires_grad for t in outs)
    assert all(p.grad is None for p in tm.parameters())


def test_server_matches_jax_on_a_pool_that_evicts():
    """Five usable pages for two slots of up to four: donated prompt
    pages must be evicted (LRU) to admit later requests, on both
    sides alike."""
    jm, tm = _models()
    waves = _waves()
    js = _server(JaxServer, jm, num_pages=6)
    ts = _server(ContinuousBatchingServer, tm, num_pages=6)
    want, got = _serve(js, waves), _serve(ts, waves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert js._prefix.evicted_pages_total > 0
    for k in ("admissions", "prefill_tokens", "prefix_auto_hits",
              "prefix_auto_hit_tokens"):
        assert ts.stats[k] == js.stats[k], k
    assert tuple(ts.pool_balance()) == tuple(js.pool_balance())
    assert ts.pool_balance()[1] == 0


def test_fused_server_matches_jax_on_a_pool_that_evicts():
    """The same squeezed pool through the port's fused tick: tokens,
    prefix hits and the final pool equal the JAX paged server's."""
    jm, tm = _models()
    waves = _waves()
    js = _server(JaxServer, jm, num_pages=6)
    ts = _server(ContinuousBatchingServer, tm, num_pages=6,
                 serving_mode="fused")
    want, got = _serve(js, waves), _serve(ts, waves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k in ("admissions", "prefill_tokens", "prefix_auto_hits",
              "prefix_auto_hit_tokens"):
        assert ts.stats[k] == js.stats[k], k
    assert tuple(ts.pool_balance()) == tuple(js.pool_balance())
    assert ts.pool_balance()[1] == 0 and ts.stats["fused_launches"] > 0


def test_serve_thread_wait_cancel_and_limits():
    _, tm = _models()
    wave1, _ = _waves()
    want = _serve(_server(ContinuousBatchingServer, tm), [wave1[:2]])
    srv = _server(ContinuousBatchingServer, tm, max_queue=2).start()
    try:
        rids = [srv.submit(p, max_new_tokens=6) for p in wave1[:2]]
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(srv.wait(rid, timeout=60), w)
    finally:
        srv.stop(drain=True)
    with pytest.raises(pt_errors().ServerClosed):
        srv.submit(wave1[0])

    srv = _server(ContinuousBatchingServer, tm, max_queue=1)
    a = srv.submit(wave1[3], max_new_tokens=6)
    with pytest.raises(pt_errors().QueueFullError):
        srv.submit(wave1[4])
    srv.step()                      # a is mid-prefill (4 of 13 rows)
    assert srv.in_flight() == 1 and srv.cancel(a)
    b = srv.submit(wave1[2], max_new_tokens=3, deadline_s=1e-9)
    out = srv.run()
    assert len(out[a]) == 0 and b not in out
    assert isinstance(srv.failures[b], pt_errors().DeadlineExceeded)
    assert srv.pool_balance()[1] == 0
    with pytest.raises(ValueError):
        srv.submit(np.zeros(60, np.int32), max_new_tokens=8)


def test_concurrent_submitters_against_the_serve_thread():
    """More submitter threads than slots, with a short switch interval
    to shake out lost updates on the queue/slot state: every request
    gets the tokens a sequential run gives it and no page leaks."""
    import sys
    import threading
    _, tm = _models()
    wave1, wave2 = _waves()
    prompts = wave1 + wave2
    want = _serve(_server(ContinuousBatchingServer, tm), [prompts])
    srv = _server(ContinuousBatchingServer, tm).start()
    got, errors = {}, []

    def client(i):
        try:
            rid = srv.submit(prompts[i], max_new_tokens=6)
            got[i] = srv.wait(rid, timeout=60)
        except Exception as e:          # reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        srv.stop(drain=True)
    assert not errors
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i], w)
    assert srv.pool_balance()[1] == 0


def pt_errors():
    from paddle_tpu_torch.reliability import errors
    return errors


@pytest.mark.parametrize("kw", [
    {"do_sample": True}, {"cache_backend": "dense"},
    {"prefill_mode": "dense"},
    {"tick_block": 2}, {"admission": "optimistic"}, {"mesh": object()},
    {"telemetry": True}, {"recorder": True}, {"ledger": True},
    {"costs": True}, {"journeys": True}, {"host_tier": True},
    {"fault_injector": object()}, {"breaker": object()},
    {"weight_dtype": "int8"}, {"cache_dtype": "int8"},
], ids=lambda kw: next(iter(kw)))     # ids must not vary per process
def test_unported_options_raise_with_a_roadmap_pointer(kw):
    _, tm = _models()
    kw = dict({"cache_backend": "paged"}, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingServer(tm, max_slots=2, max_cache_len=MCL,
                                 page_size=PG, **kw)


def test_other_refusals_point_at_the_roadmap():
    _, tm = _models()
    srv = _server(ContinuousBatchingServer, tm)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        srv.register_prefix(np.arange(8, dtype=np.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        srv.submit(np.arange(4, dtype=np.int32), journey=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.pipeline_decompose()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny())
    assert resolve_device("cpu") == torch.device("cpu")
    _, tm = _models()
    srv = _server(ContinuousBatchingServer, tm)
    assert srv.device == torch.device("cpu")
    assert srv._caches["pool"]["k"].device.type == "cpu"
