"""The port's beam search, constrained (FSM) decoding and ``scan_decode``
against the JAX package's, on the CPU.

Weights are made on the JAX side (``llama_tiny``, ``gpt2_tiny``,
``mixtral_tiny`` and a 6-token Llama, f32) and copied into the port with
``models.bridge.load_jax_params``; the decode loops run over each
package's own dense bundle (prefill by ``_run_prefill``), the JAX side
as its own tests run it (jitted scans on the CPU).

- ``phrases_to_fsm``: the tables equal the reference's, and the same
  ``ValueError``s;
- the beams' top K (``decode_loop._top_k``) orders exact ties as
  ``jax.lax.top_k`` does (the lower index first), ``-inf`` included;
- ``beam_generate``: tokens EQUAL and scores within 1e-5 (f32) of the
  reference's at K = 1, exhaustive beams (K = 36 over a 6-token
  vocabulary, 3 new tokens), eos freezing, K above the vocabulary, and
  on a synthetic step whose logits tie exactly (beams and frozen beams
  meeting equal scores);
- ``fsm_generate``: tokens and final automaton states EQUAL, greedy and
  seeded sampled, on a phrase trie (every family), the parity automaton
  and two single-token grammars swapped between calls;
- ``scan_decode`` over the dense Llama step: output and every cache
  within 1e-5;
- ``generate(num_beams=, fsm=)`` on the three families: tokens equal to
  the JAX package's, and its two ``ValueError``s.

The reference's jit-cache test (``tests/test_decode_loop.py``, a second
call must not retrace) has no counterpart: the port's loops are eager
and compile nothing (ROADMAP Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference import decode_loop as jdl
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral
from paddle_tpu.models.mixtral import mixtral_tiny as jax_mixtral_tiny
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.inference import decode_loop as tdl
from paddle_tpu_torch.models import (GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, MixtralForCausalLM,
                                     gpt2_tiny, llama_tiny, load_jax_params,
                                     mixtral_tiny)

V = 256
EOS = 7
PHRASES = [[10, 20, 30], [10, 25], [40, 41, 42, 43]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one torch thread each keeps the
    test workers (several a machine) from oversubscribing its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_vocab(jax_side):
    kw = dict(vocab_size=6, hidden_size=32, num_layers=1, num_heads=2,
              num_kv_heads=2, intermediate_size=64, max_seq_len=32)
    return JaxLlamaConfig(**kw) if jax_side else LlamaConfig(**kw)


_FAMILIES = {
    "llama": (JaxLlama, jax_llama_tiny, LlamaForCausalLM, llama_tiny, 41),
    "gpt": (JaxGPT, jax_gpt2_tiny, GPTForCausalLM, gpt2_tiny, 42),
    "mixtral": (JaxMixtral, jax_mixtral_tiny, MixtralForCausalLM,
                mixtral_tiny, 43),
    "v6": (JaxLlama, lambda: _small_vocab(True), LlamaForCausalLM,
           lambda: _small_vocab(False), 97),
}


@functools.lru_cache(maxsize=None)
def _models(family):
    jcls, jcfg, tcls, tcfg, seed = _FAMILIES[family]
    pt.seed(seed)
    jm = jcls(jcfg())
    jm.eval()
    tm = tcls(tcfg(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


def _ids(B, T, seed, vocab=V):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _prefilled(family, ids, mcl):
    """Both packages' dense bundles and their prefill of ``ids``:
    ((bundle, last logits, caches) JAX, the same for the port)."""
    jm, tm = _models(family)
    jb, tb = jm._decode_bundle(mcl), tm._decode_bundle(mcl)
    jl, jc = jm._run_prefill(jb, ids)
    tl, tc = tm._run_prefill(tb, ids)
    return (jb, jl, jc), (tb, tl, tc)


# ------------------------------------------------------------- automata


@pytest.mark.parametrize("phrases,vocab,eos", [
    (PHRASES, V, EOS), ([[3], [3, 4], [5, 4, 3]], 8, 0),
    ([[1, 2, 3, 4, 5, 6]], 16, 15)])
def test_phrases_to_fsm_tables_equal_jax(phrases, vocab, eos):
    jm, jn = jdl.phrases_to_fsm(phrases, vocab, eos)
    tm, tn = tdl.phrases_to_fsm(phrases, vocab, eos)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tn, jn)
    assert tm.dtype == jm.dtype and tn.dtype == jn.dtype


@pytest.mark.parametrize("phrases,match", [
    ([], "non-empty"), ([[1, EOS, 2]], "contains eos_token_id")])
def test_phrases_to_fsm_refusals_equal_jax(phrases, match):
    for mod in (jdl, tdl):
        with pytest.raises(ValueError, match=match):
            mod.phrases_to_fsm(phrases, V, EOS)


# ------------------------------------------------------------- beam search


def test_top_k_orders_ties_as_jax_top_k():
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, (4, 40)).astype(np.float32)
    x[0, ::3] = -np.inf
    x[1] = 0.0
    for k in (1, 5, 17, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tdl._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("family,K,B,new,eos", [
    ("llama", 1, 2, 5, None),
    ("v6", 36, 1, 3, None),          # exhaustive: K >= V ** 2
    ("v6", 4, 1, 6, "greedy[1]"),    # eos freezes beams
    ("v6", 8, 2, 4, None),           # K > V: -inf pads the first step
    ("gpt", 3, 2, 4, None),
    ("mixtral", 3, 1, 4, None),
], ids=["llama-K1", "v6-exhaustive", "v6-eos", "v6-K-over-V", "gpt-K3",
        "mixtral-K3"])
def test_beam_generate_equals_jax(family, K, B, new, eos):
    vocab = 6 if family == "v6" else V
    ids = _ids(B, 3, seed=K + new, vocab=vocab)
    mcl = 16
    if eos is not None:      # an eos the beams meet: greedy's 2nd token
        _, tm = _models(family)
        eos = int(tm.generate(ids, max_new_tokens=3,
                              max_cache_len=mcl).numpy()[0, 4])
    (jb, jl, jc), (tb, tl, tc) = _prefilled(family, ids, mcl)
    T = ids.shape[1]
    jids, jsc = jdl.beam_generate(jb[1], jb[2], jb[3], jc, jl, T, new, K,
                                  eos_token_id=eos)
    tids, tsc = tdl.beam_generate(tb[1], tb[2], tb[3], tc, tl, T, new, K,
                                  eos_token_id=eos)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0,
                               atol=1e-5)
    assert tids.dtype == torch.int32 and tsc.shape == (B, K)
    if eos is not None:
        out = tids.numpy()[0]
        hit = np.where(out == eos)[0]
        assert len(hit) and (out[hit[0]:] == eos).all()


# integer logits a token at a time: rows with exact ties, so beams meet
# equal scores, and token 2 (the eos below) ties the best of several rows
_TIE_TABLE = np.array([[1, 1, 0, 1, -2],
                       [0, 2, 2, 0, 2],
                       [1, 1, 1, 1, 1],
                       [3, 0, 3, 0, 0],
                       [0, 0, 0, 0, 0]], np.float32)


def _tie_fns(xp):
    """(embed, step, head) of a synthetic model over ``_TIE_TABLE``: the
    next logits are the table's row of the current token; the cache is a
    row counter, so a wrong ancestry reorder shows in it."""
    table = xp(_TIE_TABLE)

    def embed(tok, t):
        return tok

    def step(x, caches, t):
        return x, {"c": caches["c"] + 1}

    def head(tok):
        return table[tok]

    return embed, step, head


@pytest.mark.parametrize("eos", [None, 2])
@pytest.mark.parametrize("K", [3, 7])
def test_beam_generate_ties_equal_jax(K, eos):
    B, new = 2, 5
    first = np.array([[1, 1, 1, 0, 1], [0, 0, 0, 0, 0]], np.float32)
    jc = {"c": jnp.zeros((1, B, 1), jnp.float32)}
    tc = {"c": torch.zeros((1, B, 1))}
    je, js, jh = _tie_fns(jnp.asarray)
    te, ts, th = _tie_fns(torch.from_numpy)
    jids, jsc = jdl.beam_generate(je, js, jh, jc, jnp.asarray(first), 0,
                                  new, K, eos_token_id=eos)
    tids, tsc = tdl.beam_generate(te, ts, th, tc, torch.from_numpy(first),
                                  0, new, K, eos_token_id=eos)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------- constrained


def _parity():
    tokens = np.arange(V)
    mask = np.zeros((2, V), bool)
    mask[0, tokens % 2 == 0] = True
    mask[1, tokens % 2 == 1] = True
    nxt = np.zeros((2, V), np.int32)
    nxt[0] = 1
    return mask, nxt


def _only(tok):
    mask = np.zeros((1, V), bool)
    mask[0, tok] = True
    return mask, np.zeros((1, V), np.int32)


def _fsm_pair(family, fsm, sample, seed, eos=None, new=6, B=2):
    ids = _ids(B, 4, seed=seed)
    (jb, jl, jc), (tb, tl, tc) = _prefilled(family, ids, 32)
    kw = dict(do_sample=sample, temperature=1.5, top_k=0, top_p=1.0,
              eos_token_id=eos)
    jids, jst = jdl.fsm_generate(jb[1], jb[2], jb[3], jc, jl, 4, new,
                                 fsm[0], fsm[1], key=jax.random.PRNGKey(seed),
                                 **kw)
    tids, tst = tdl.fsm_generate(tb[1], tb[2], tb[3], tc, tl, 4, new,
                                 fsm[0], fsm[1], key=prng.PRNGKey(seed),
                                 **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    return tids.numpy(), tst.numpy()


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("family", ["llama", "gpt", "mixtral"])
def test_fsm_phrases_equal_jax(family, sample):
    fsm = tdl.phrases_to_fsm(PHRASES, V, EOS)
    out, _ = _fsm_pair(family, fsm, sample, seed=5, eos=EOS)
    for row in out.tolist():
        assert any(row == ph + [EOS] * (6 - len(ph)) for ph in PHRASES), row


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_fsm_parity_equal_jax(sample):
    out, states = _fsm_pair("llama", _parity(), sample, seed=6, new=7)
    assert (out % 2 == np.arange(7) % 2).all(), out
    np.testing.assert_array_equal(states, [0, 0])    # 8 picks: even


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_fsm_swapped_grammars_equal_jax(sample):
    a, _ = _fsm_pair("llama", _only(5), sample, seed=8, new=3)
    b, _ = _fsm_pair("llama", _only(9), sample, seed=8, new=3)
    assert (a == 5).all() and (b == 9).all(), (a, b)


# ------------------------------------------------------------- scan_decode


def test_scan_decode_over_the_dense_llama_step_equals_jax():
    ids = _ids(2, 5, seed=9)
    (jb, _, jc), (tb, _, tc) = _prefilled("llama", ids, 16)
    tok = np.array([3, 11], np.int32)
    jx = jb[1](jnp.asarray(tok), 5)
    tx = tb[1](torch.from_numpy(tok), 5)
    jo, jcs = jdl.scan_decode(jb[2], jx, jc, 5, 6, donate=False)
    to, tcs = tdl.scan_decode(tb[2], tx, tc, 5, 6, donate=False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=1e-5)
    assert set(tcs) == set(jcs)
    for name in jcs:           # every row the 6 steps write, 5..10
        np.testing.assert_allclose(tcs[name].numpy(), np.asarray(jcs[name]),
                                   rtol=0, atol=1e-5)
    assert np.abs(tcs["k"].numpy()[:, :, 10]).max() > 0


# --------------------------------------------------------------- generate


@pytest.mark.parametrize("family", ["llama", "gpt", "mixtral"])
def test_generate_beam_and_fsm_equal_jax(family):
    jm, tm = _models(family)
    ids = _ids(2, 5, seed=10)
    fsm = jdl.phrases_to_fsm(PHRASES, V, EOS)
    for kw in (dict(num_beams=3), dict(num_beams=2, eos_token_id=EOS),
               dict(fsm=fsm, eos_token_id=EOS),
               dict(fsm=fsm + (0,), do_sample=True, seed=3,
                    eos_token_id=EOS)):
        want = jm.generate(jnp.asarray(ids), max_new_tokens=5,
                           max_cache_len=16, **kw).numpy()
        got = tm.generate(ids, max_new_tokens=5, max_cache_len=16, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))


@pytest.mark.parametrize("kw,match", [
    (dict(num_beams=2, fsm=(np.ones((1, V), bool),
                            np.zeros((1, V), np.int32))), "not beam search"),
    (dict(num_beams=2, do_sample=True), "mutually exclusive")],
    ids=["beam-fsm", "beam-sample"])
def test_generate_refusals_equal_jax(kw, match):
    jm, tm = _models("llama")
    ids = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError, match=match):
        jm.generate(jnp.asarray(ids), max_new_tokens=2, **kw)
    with pytest.raises(ValueError, match=match):
        tm.generate(ids, max_new_tokens=2, **kw)
