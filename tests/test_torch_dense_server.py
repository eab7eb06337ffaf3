"""The port's dense serving paths against the JAX server's, on the CPU.

``llama_tiny`` f32 with weights bridged from the JAX model, as in
``tests/test_torch_llama_serving.py``. Two waves of prompts (lengths 1 to
17; the second wave's prompts start with 16 tokens of the first wave's
longest) go through the JAX server and the port's server built with the
same arguments; tokens must be EQUAL, and ``stats`` (prefill tokens,
prefix hit tokens, automatic hits, admissions, prefill dispatches) and
``pool_balance()`` equal to the JAX server's:

- the dense backend (``cache_backend="dense"``), whole and chunked
  prefill, greedy and seeded sampled;
- the paged pool with ``prefill_mode="dense"`` (tree hits gathered into
  dense caches, rows scattered into pages);
- ``register_prefix`` on all three modes (dense, paged with dense
  prefill, paged ragged through pinned tree pages), registered between
  the waves with a sub-page tail, registering twice a no-op;
- ``tick_block`` 2 and 4, greedy and sampled, on both backends, with
  budgets that end requests mid-block at ``max_cache_len`` (the block's
  later rows dropped by the caches);
- ``register_prefix``'s two refusals (a queued request's remainder pad,
  and pinned pages stranding a queued request), raised by both servers
  and leaving the port's server serving equal tokens after; a prompt
  that IS a registered prefix decodes from the stored logits and rows;
- the fused tick still refuses ``tick_block > 1``.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_prefill as trp
from paddle_tpu_torch.ops.kernels import sample_rows as tsr

MCL, PG = 64, 8
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
              seed=2**31 - 4)
STATS = ("prefill_tokens", "prefix_hit_tokens", "prefix_auto_hits",
         "prefix_auto_hit_tokens", "admissions")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one torch thread each keeps the
    test workers (several a machine) from oversubscribing its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=1)
def _models():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _waves():
    rng = np.random.default_rng(3)
    wave1 = [rng.integers(0, 256, (n,)).astype(np.int32)
             for n in (1, 7, 8, 13, 17)]
    wave2 = [np.concatenate([wave1[4][:16],
                             rng.integers(0, 256, (n,)).astype(np.int32)])
             for n in (2, 5)]
    return wave1, wave2


def _serve(srv, prefix=None, n_new=6, seeds=None):
    """Both waves; ``prefix`` registered (twice) between them."""
    toks = []
    for i, wave in enumerate(_waves()):
        if i == 1 and prefix is not None:
            assert srv.register_prefix(prefix) == len(prefix)
            assert srv.register_prefix(prefix) == len(prefix)
        rids = [srv.submit(p, max_new_tokens=n_new,
                           seed=None if seeds is None else seeds[j])
                for j, p in enumerate(wave)]
        out = srv.run()
        toks += [out[r] for r in rids]
    return toks


def _pair(**kw):
    jm, tm = _models()
    return (JaxServer(jm, max_slots=2, max_cache_len=MCL, **kw),
            ContinuousBatchingServer(tm, max_slots=2, max_cache_len=MCL,
                                     **kw))


def _balance(srv):
    b = srv.pool_balance()
    return None if b is None else tuple(b)


def _check(js, ts, want, got, dispatches=True):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    keys = STATS + (("prefill_dispatches",) if dispatches else ())
    assert {k: ts.stats[k] for k in keys} == {k: js.stats[k] for k in keys}
    assert _balance(ts) == _balance(js)
    assert ts.stats["nonfinite_logit_rows"] == 0
    # CPU tensors take the plain versions: no kernel launch
    assert tpa.paged_attention.launches == 0
    assert trp.ragged_prefill_attention.launches == 0
    assert tsr.sample_rows.launches == 0


MODES = {
    "dense": dict(cache_backend="dense"),
    "dense-chunked": dict(cache_backend="dense", prefill_chunk=4),
    "paged-dense": dict(cache_backend="paged", page_size=PG,
                        prefill_mode="dense"),
    "paged-dense-chunked": dict(cache_backend="paged", page_size=PG,
                                prefill_mode="dense", prefill_chunk=4),
    # no automatic cache: a registered hit seeds from the stored rows
    # (with one, the tree's longer run wins over the 12-token prefix)
    "paged-dense-rows": dict(cache_backend="paged", page_size=PG,
                             prefill_mode="dense", auto_prefix_cache=False),
    "paged-ragged": dict(cache_backend="paged", page_size=PG,
                         prefill_tokens_per_tick=5),
}
CASES = [("dense", False, False), ("dense", True, True),
         ("dense-chunked", False, True), ("paged-dense", False, False),
         ("paged-dense", True, True), ("paged-dense-rows", False, True),
         ("paged-dense-chunked", True, True), ("paged-ragged", False, True),
         ("paged-ragged", True, True)]


@pytest.mark.parametrize(
    "mode,sample,register", CASES,
    ids=[f"{m}-{'sampled' if s else 'greedy'}{'-prefix' if r else ''}"
         for m, s, r in CASES])
def test_dense_serving_tokens_stats_and_pool_equal_jax(mode, sample,
                                                       register):
    kw = dict(MODES[mode], **(SAMPLE if sample else {}))
    js, ts = _pair(**kw)
    # a 12-token prefix: one full page and a sub-page tail on the pool
    prefix = _waves()[0][4][:12] if register else None
    want, got = _serve(js, prefix), _serve(ts, prefix)
    # the ragged greedy path pushes no keys, the reference pushes them
    # anyway: its dispatch count is the reference's only when sampling
    _check(js, ts, want, got,
           dispatches=not (mode == "paged-ragged" and not sample))
    if register and ts.pool_balance() is not None:
        pinned = ts.pool_balance()[2]
        assert pinned == 1 and ts.pool_balance()[1] == 0
    if register:
        assert ts.stats["prefix_hit_tokens"] > 0
    if sample:
        assert ts.stats["sample_launches"] > 0


BLOCK_CASES = [(backend, n, sample) for backend in ("dense", "paged")
               for n in (2, 4) for sample in (False, True)]


@pytest.mark.parametrize(
    "backend,n,sample", BLOCK_CASES,
    ids=[f"{b}-block{n}-{'sampled' if s else 'greedy'}"
         for b, n, s in BLOCK_CASES])
def test_tick_block_equals_jax_with_slots_ending_at_the_cache_end(
        backend, n, sample):
    kw = dict(cache_backend=backend, tick_block=n,
              **(SAMPLE if sample else {}))
    if backend == "paged":
        kw.update(page_size=PG, prefill_tokens_per_tick=5)
    js, ts = _pair(**kw)
    # budgets filling max_cache_len exactly (prompt + budget = 64): the
    # 56 and 51 tokens end mid-block, and at n = 4 the 13-token prompt's
    # last block writes rows 63 and 64, one past the cache (the dense
    # backend's idle slots write past it at every n)
    wave = [w for w in _waves()[0] if len(w) in (8, 13)]

    def serve(srv):
        rids = [srv.submit(p, max_new_tokens=MCL - len(p)) for p in wave]
        rids.append(srv.submit(wave[0][:5], max_new_tokens=7))
        out = srv.run()
        return [out[r] for r in rids]

    want, got = serve(js), serve(ts)
    _check(js, ts, want, got, dispatches=backend == "dense" or sample)
    assert [len(t) for t in got] == [56, 51, 7]
    waste = ts.stats["block_waste_tokens"]
    assert waste > 0 and ts.stats["decode_steps"] \
        == n * ts.stats["decode_ticks"]


def test_register_prefix_refusals_match_jax():
    """Dense prefill with a chunk: a prefix whose remainder pad would
    overflow a queued request's rows. Paged: a prefix whose pinned pages
    would strand a queued request. Both servers raise ValueError and
    register nothing; the queue then serves as before."""
    rng = np.random.default_rng(5)
    # remainder pad: the queued 60-token request (+ 2 new) was checked
    # against its whole-prompt pad (60 % 8 = 4 -> 64 fits); after a
    # 3-token prefix its 57-token remainder pads 7 rows: 67 > 64
    queued = rng.integers(0, 256, (60,)).astype(np.int32)
    outs = []
    for srv in _pair(cache_backend="dense", prefill_chunk=8):
        srv.submit(queued, max_new_tokens=2)
        with pytest.raises(ValueError, match="pad the queued"):
            srv.register_prefix(queued[:3])
        assert not srv._prefixes
        outs.append(srv.run())
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    # stranding: 6 usable pages; a queued 40-token extent needs 5; a
    # 16-token prefix of other tokens would pin 2
    prompt = rng.integers(0, 256, (30,)).astype(np.int32)
    outs = []
    for srv in _pair(cache_backend="paged", page_size=PG, num_pages=7,
                     prefill_mode="dense"):
        srv.submit(prompt, max_new_tokens=10)
        with pytest.raises(ValueError, match="strand"):
            srv.register_prefix(np.arange(16, dtype=np.int32))
        assert not srv._prefixes and srv.pool_balance()[2] == 0
        outs.append((srv.run(), tuple(srv.pool_balance())))
    np.testing.assert_array_equal(outs[0][0][0], outs[1][0][0])
    assert outs[0][1] == outs[1][1]


def test_register_prefix_adopts_cached_pages_and_pins_them():
    """Ragged: the first wave donates its pages; registering a prefix
    those pages cover adopts the cached nodes (no new page) and pins
    them, and an eviction sweep then leaves them alone."""
    kw = dict(cache_backend="paged", page_size=PG, prefill_tokens_per_tick=5)
    js, ts = _pair(**kw)
    wave1, wave2 = _waves()
    for srv in (js, ts):
        for p in wave1:
            srv.submit(p, max_new_tokens=4)
        srv.run()
    cached = ts.pool_balance()[3]
    for srv in (js, ts):
        srv.register_prefix(wave1[4][:16])
    assert _balance(ts) == _balance(js)
    assert ts.pool_balance()[2] == 2 and ts.pool_balance()[3] == cached - 2
    free = ts.pool_balance()[0]
    assert ts._prefix.evict(100) == cached - 2
    assert ts.pool_balance()[2] == 2 and ts.pool_balance()[0] \
        == free + cached - 2
    js._prefix.evict(100)
    want, got = _serve(js), _serve(ts)
    _check(js, ts, want, got, dispatches=False)


@pytest.mark.parametrize("mode", ["dense", "paged-dense-rows"])
def test_a_prompt_that_is_a_registered_prefix_takes_its_stored_logits(
        mode):
    """Dense prefill: a prompt equal to a registered prefix prefills
    nothing; its first token comes from the prefix's stored last
    logits, then it decodes from the seeded rows."""
    prefix = _waves()[0][4][:12]
    js, ts = _pair(**MODES[mode])
    out = []
    for srv in (js, ts):
        srv.register_prefix(prefix)
        before = srv.stats["prefill_tokens"]
        rid = srv.submit(prefix, max_new_tokens=5)
        out.append(srv.run()[rid])
        assert srv.stats["prefill_tokens"] == before
        assert srv.stats["prefix_hit_tokens"] == 12
    np.testing.assert_array_equal(out[1], out[0])
    assert _balance(ts) == _balance(js)


def test_fused_tick_keeps_refusing_block_decode():
    _, tm = _models()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingServer(tm, max_slots=2, max_cache_len=MCL,
                                 cache_backend="paged", page_size=PG,
                                 serving_mode="fused", tick_block=2)
    with pytest.raises(ValueError, match="ragged"):
        ContinuousBatchingServer(tm, max_slots=2, max_cache_len=MCL,
                                 cache_backend="dense",
                                 prefill_mode="ragged")
