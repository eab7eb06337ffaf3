"""The port's dense decode bundle and ``generate()`` against the JAX
package's, on the CPU.

Weights are made once on the JAX side (``llama_tiny``: 2 layers, 4
query heads over 2 kv heads, head_dim 16, f32) and copied into the port
with ``models.bridge.load_jax_params``; the same numpy inputs go through
both packages.

- ``_write_cache`` equal to the JAX function for a shared offset and for
  per-row offsets, the positions past the cache dropped as the
  reference's scatter drops them (s = 1 and s > 1); a shared offset past
  the cache raises where ``dynamic_update_slice`` would clamp;
- ``_cached_attend`` within 1e-6 of the JAX function (GQA-repeated
  caches, per-row and shared offsets);
- the dense bundle: prefill and decode-step logits within atol 1e-4 of
  the JAX dense bundle (the paged bundle test's tolerance);
- ``generate`` tokens EQUAL to the JAX package's, greedy and sampled, at
  B = 1 and B = 3, chunked and not, with eos, and with ``seed=None``
  drawing the seed from numpy's global stream;
- the batch ``categorical`` under ONE key over ``[B, V]``: equal to
  ``jax.random.categorical``, and not R1's per-row chain at B = 3 (what
  an R1 port of ``generate(do_sample=True)`` would give);
- the same ``ValueError``s as the reference, and ``NotImplementedError``
  naming the ROADMAP for the options not ported (``mesh``; beam search
  and ``fsm`` run since item 12 closed);
- the bundle cache: keyed by its arguments, least recently used first
  out past 4, cleared by ``reset_generate_cache``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import generation as jgen
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.random import categorical
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.ops.kernels import sample_rows as tsr
from paddle_tpu_torch.ops.kernels import threefry_fill as ttf

V = 256


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


# ------------------------------------------------------ cache functions


@pytest.mark.parametrize("case", ["shared", "rows", "rows-seq"])
def test_write_cache_matches_jax_and_drops_past_the_cache(case):
    rng = np.random.RandomState(0)
    B, T, h, hd = 4, 10, 2, 8
    s = 1 if case == "rows" else 3
    cache = rng.randn(B, T, h, hd).astype(np.float32)
    kv = rng.randn(B, s, h, hd).astype(np.float32)
    # per-row offsets: in range, ending at the cache's last row, one
    # row past it (the wasted block step of a slot that ended at T) and
    # far past it (an idle slot whose offset kept growing)
    t = np.int32(4) if case == "shared" else \
        np.array([2, T - s, T - s + 1, T + 7], np.int32)
    want = np.asarray(jgen._write_cache(jnp.asarray(cache), jnp.asarray(kv),
                                        jnp.asarray(t)))
    got = tgen._write_cache(torch.from_numpy(cache.copy()),
                            torch.from_numpy(kv),
                            int(t) if case == "shared"
                            else torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got, want)
    if case != "shared":
        np.testing.assert_array_equal(got[3], cache[3])   # all dropped


def test_write_cache_refuses_a_shared_offset_past_the_cache():
    cache = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError, match="outside the cache"):
        tgen._write_cache(cache, torch.ones(1, 3, 1, 4), 6)


@pytest.mark.parametrize("per_row", [False, True])
def test_cached_attend_matches_jax(per_row):
    rng = np.random.RandomState(1)
    B, s, T, nh, hd = 3, 4, 12, 4, 8
    q = rng.randn(B, s, nh, hd).astype(np.float32)
    k = rng.randn(B, T, nh, hd).astype(np.float32)
    v = rng.randn(B, T, nh, hd).astype(np.float32)
    t = np.array([0, 5, 8], np.int32) if per_row else 3
    jt = jnp.asarray(t) if per_row else jnp.int32(t)
    tt = torch.from_numpy(t) if per_row else t
    want = np.asarray(jgen._cached_attend(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jt, s, 0.25))
    got = tgen._cached_attend(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), tt, s, 0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dense_bundle_logits_match_jax_with_bridged_weights():
    jm, tm = _models()
    mcl, B = 32, 2
    jb = jm._decode_bundle(mcl)
    tb = tm._decode_bundle(mcl)
    assert len(tb) == 5 and tb[4] is tb[2]
    ids = np.random.default_rng(0).integers(0, V, (B, 9)).astype(np.int32)
    jl, jc = jm._run_prefill(jb, ids)
    tl, tc = tm._run_prefill(tb, ids)
    assert tc["k"].shape == (2, B, mcl, 2, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=0, atol=1e-4)
    # a decode step at per-row offsets, one of them past the cache
    tok = np.array([7, 9], np.int32)
    t = np.array([9, mcl + 3], np.int32)
    jo, jc = jb[2](jb[1](jnp.asarray(tok), jnp.asarray(t)), jc,
                   jnp.asarray(t))
    to, tc = tb[2](tb[1](torch.from_numpy(tok), torch.from_numpy(t)), tc,
                   torch.from_numpy(t))
    np.testing.assert_allclose(tb[3](to)[:1, -1].numpy(),
                               np.asarray(jb[3](jo))[:1, -1], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               rtol=0, atol=1e-4)


# ------------------------------------------------------------ generate


def _ids(B, T=11, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(
        np.int32)


def _both(ids, **kw):
    jm, tm = _models()
    want = np.asarray(jm.generate(jnp.asarray(ids), **kw).numpy())
    got = tm.generate(ids, **kw)
    assert got.dtype == torch.int32
    return got.numpy(), want


GEN_CASES = [(B, sample, chunk) for B in (1, 3) for sample in (False, True)
             for chunk in (None, 4)]


@pytest.mark.parametrize(
    "B,sample,chunk", GEN_CASES,
    ids=[f"B{b}-{'sampled' if s else 'greedy'}-{'chunk4' if c else 'whole'}"
         for b, s, c in GEN_CASES])
def test_generate_tokens_equal_jax(B, sample, chunk):
    kw = dict(max_new_tokens=9, prefill_chunk=chunk)
    if sample:
        kw.update(do_sample=True, seed=2**31 - 1 if chunk else 5,
                  temperature=0.8, top_k=20, top_p=0.9)
    got, want = _both(_ids(B, seed=B), **kw)
    assert got.shape == (B, 11 + 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sample", [False, True])
def test_generate_pads_after_eos_like_jax(sample):
    ids = _ids(3, seed=7)
    kw = dict(max_new_tokens=10, do_sample=sample, seed=3)
    free, _ = _both(ids, **kw)
    # an eos the rows emit mid-way: row r stops at its first one, and
    # the first token itself counts
    eos = int(free[0, 11 + 3])
    got, want = _both(ids, eos_token_id=eos, **kw)
    np.testing.assert_array_equal(got, want)
    row = got[0, 11:]
    first = int(np.argmax(row == eos))
    assert (row[first:] == eos).all() and first <= 3


def test_generate_seed_none_draws_from_numpys_global_stream():
    ids = _ids(3, seed=9)
    jm, tm = _models()
    kw = dict(max_new_tokens=6, do_sample=True)
    np.random.seed(1234)
    want = np.asarray(jm.generate(jnp.asarray(ids), **kw).numpy())
    after_jax = np.random.random()
    np.random.seed(1234)
    got = tm.generate(ids, **kw).numpy()
    assert np.random.random() == after_jax       # one draw each
    np.testing.assert_array_equal(got, want)
    np.random.seed(1234)
    seeded = tm.generate(ids, seed=int(np.random.randint(0, 2**31)),
                         **kw).numpy()
    np.testing.assert_array_equal(seeded, got)


def test_generate_draws_r2_noise_once_a_draw_and_no_r1_on_the_cpu():
    """On the CPU both kernels take their plain versions (no launch);
    the one-key draw is R2's noise, whose plain version is what each
    generate draw adds (checked against jax.random.categorical below)."""
    _, tm = _models()
    tm.generate(_ids(2), max_new_tokens=4, do_sample=True, seed=1)
    assert ttf.fill.launches == 0 and tsr.sample_rows.launches == 0


def test_categorical_is_one_key_over_the_batch_not_r1_per_row():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, V)) * 2).astype(np.float32)
    key = prng.PRNGKey(17)
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(17),
                                             jnp.asarray(logits), axis=-1))
    got = categorical(key, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    # R1 splits each row's key and draws the row under the sub-key
    # alone, counters 0 .. V-1 a row: under the same sub-key its row 0
    # is the batch draw's row 0, its rows 1 and 2 are not
    sub = prng.split(key)[1]
    batch = categorical(sub, torch.from_numpy(logits)).numpy()
    keys = key[None].repeat(3, 1)
    zeros = torch.zeros(3, dtype=torch.int32)
    ones = torch.ones(3, dtype=torch.int32)
    per_row, _, _ = tsr._ref_sample_rows(torch.from_numpy(logits), keys,
                                         zeros, zeros, ones)
    per_row = per_row.numpy()
    assert per_row[0] == batch[0]
    assert not np.array_equal(per_row, batch)


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("kw,match", [
    (dict(max_new_tokens=10, max_cache_len=20), "exceeds max_cache_len"),
    (dict(max_new_tokens=3, max_cache_len=14, prefill_chunk=8),
     "chunk headroom"),
], ids=["budget", "chunk-headroom"])
def test_generate_value_errors_match_jax(kw, match):
    jm, tm = _models()
    ids = _ids(1)
    with pytest.raises(ValueError, match=match):
        jm.generate(jnp.asarray(ids), **kw)
    with pytest.raises(ValueError, match=match):
        tm.generate(ids, **kw)


_ONLY_5 = (np.eye(V, dtype=bool)[5:6], np.zeros((1, V), np.int32))


@pytest.mark.parametrize("kw,item", [
    ({"num_beams": 2}, 12), ({"fsm": _ONLY_5}, 12),
    ({"mesh": object()}, 9),
], ids=lambda v: next(iter(v)) if isinstance(v, dict) else str(v))
def test_generate_refuses_unported_options_naming_the_roadmap(kw, item):
    """``mesh`` (item 9) raises naming its ROADMAP item; beam search and
    ``fsm`` (item 12, closed) run: the prompt and two new tokens (the
    automaton allows token 5 only)."""
    _, tm = _models()
    if item == 12:
        out = tm.generate(_ids(1), max_new_tokens=2, max_cache_len=16, **kw)
        assert out.shape == (1, _ids(1).shape[1] + 2)
        if "fsm" in kw:
            assert (out[0, -2:] == 5).all()
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP, Queue 1 item {item}"):
        tm.generate(_ids(1), max_new_tokens=2, **kw)


def test_decode_bundles_are_cached_lru_capped_at_four():
    _, tm = _models()
    tm.reset_generate_cache()
    first = tm._decode_bundle(16)
    assert tm._decode_bundle(16) is first
    for mcl in (24, 32, 40):
        tm._decode_bundle(mcl)
    assert tm._decode_bundle(16) is first     # touched: now the newest
    tm._decode_bundle(48)                     # evicts 24, the oldest
    assert set(k[0] for k in tm._pt_decode_cache) == {16, 32, 40, 48}
    tm.reset_generate_cache()
    assert tm._decode_bundle(16) is not first
