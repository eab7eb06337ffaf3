"""The port's seeded sampling against the JAX package's, on the CPU.

- ``process_logits`` (temperature, top-k, top-p, each alone and
  together) equal to ``paddle_tpu.inference.decode_loop.process_logits``
  bit for bit, both as the reference runs it eagerly (a true division by
  the temperature) and jitted (XLA multiplies by the reciprocal:
  ``reciprocal=True``);
- R1's plain version (``ops.kernels.sample_rows``) fed the reference's
  logits, keys and seeds (fresh and carried keys, emitting and not):
  tokens and keys out equal to the reference's ``vmap`` of
  ``split`` + ``categorical``, at V = 256 and V = 32000; the flag of a
  non-finite row; the CUDA contract checked before any launch;
- the paged server on ``llama_tiny`` f32 (weights bridged from the JAX
  model) with ``do_sample=True``: tokens EQUAL to the JAX paged server's
  on split and on fused ticks, with explicit seeds (0, 2**31 - 1, 2**31,
  -1, 2**32 - 1) and with the default-seed rule (``seed + rid``, a server
  seed past 2**31 included), top-k / top-p on and off, a request
  admitted mid-wave; pool drained, no launch on the CPU;
- greedy serving does not touch the keys;
- R1's many-block plan covers each element of a row once, and a CPU
  model of its chunked walk plus the merge gives the plain version's
  tokens (ties across chunk boundaries, NaNs in several chunks, an all
  -inf row, V = 1).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.inference.decode_loop import process_logits as jax_process
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.inference.decode_loop import process_logits
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.ops.kernels import sample_rows as tsr

MCL, PG = 64, 8
FILTERS = {"plain": (1.0, 0, 1.0), "temperature": (0.8, 0, 1.0),
           "top_k": (1.0, 40, 1.0), "top_p": (1.0, 0, 0.9),
           "all": (0.7, 20, 0.95), "tight": (1.3, 5, 0.5)}


def test_jax_runs_the_threefry_stream_the_port_copies():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("name", list(FILTERS))
def test_process_logits_matches_the_reference_eager_and_jitted(name):
    t, k, p = FILTERS[name]
    x = (np.random.default_rng(0).standard_normal((5, 700)) * 3).astype(
        np.float32)
    eager = np.asarray(jax_process(jnp.asarray(x), t, k, p))
    jitted = np.asarray(jax.jit(lambda v: jax_process(v, t, k, p))(x))
    np.testing.assert_array_equal(
        process_logits(torch.from_numpy(x), t, k, p).numpy(), eager)
    np.testing.assert_array_equal(
        process_logits(torch.from_numpy(x), t, k, p,
                       reciprocal=True).numpy(), jitted)


def _jax_draw(keys, seeds, fresh, emit, logits):
    """The reference's fused-tick epilogue (``continuous_batching.py:
    2555-2568``) on host arrays."""
    def samp(k, row):
        k2, sub = jax.random.split(k)
        return k2, jax.random.categorical(sub, row[None], axis=-1)[0]
    fresh_keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    keys_in = jnp.where(jnp.asarray(fresh > 0)[:, None], fresh_keys,
                        jnp.asarray(keys))
    new, tok = jax.vmap(samp)(keys_in, jnp.asarray(logits))
    out = jnp.where(jnp.asarray(emit > 0)[:, None], new, keys_in)
    return np.asarray(tok), np.asarray(out)


@pytest.mark.parametrize("V", [256, 32000])
def test_plain_r1_matches_the_reference_draw(V):
    rng = np.random.default_rng(V)
    S = 8
    logits = (rng.standard_normal((S, V)) * 2).astype(np.float32)
    logits[3, ::3] = -1e30                     # a filtered row
    seeds = np.array([0, 1, 2**31 - 1, -1, -2**31, 7, 123456, 42],
                     np.int32)
    keys = rng.integers(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
    fresh = np.array([1, 0, 1, 0, 1, 0, 1, 0], np.int32)
    emit = np.array([1, 1, 0, 0, 1, 1, 0, 1], np.int32)
    want_tok, want_keys = _jax_draw(keys, seeds, fresh, emit, logits)
    tok, kout, bad = tsr.sample_rows(
        torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64))
        .to(torch.uint32), torch.from_numpy(seeds), torch.from_numpy(fresh),
        torch.from_numpy(emit))
    assert tok.dtype == torch.int32 and kout.dtype == torch.uint32
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_array_equal(kout.numpy(), want_keys)
    np.testing.assert_array_equal(bad.numpy(), np.zeros(S, np.int32))
    assert tsr.sample_rows.launches == 0


def test_plain_r1_flags_non_finite_rows_and_takes_the_first_nan():
    logits = torch.zeros((3, 16))
    logits[0, 5] = float("nan")
    logits[0, 9] = float("nan")
    logits[2, 1] = float("inf")
    z = torch.zeros((3,), dtype=torch.int32)
    tok, _, bad = tsr.sample_rows(logits, torch.zeros((3, 2),
                                                      dtype=torch.uint32),
                                  z, z, z)
    assert bad.tolist() == [1, 0, 1]
    assert int(tok[0]) == 5 and int(tok[2]) == 1


def test_plain_r1_flags_the_raw_rows_the_filters_erased():
    """top-p fills a row holding a NaN with -1e30: the flag reads the
    raw row (here bf16), the draw the filtered one."""
    raw = torch.zeros((2, 16), dtype=torch.bfloat16)
    raw[1, 3] = float("nan")
    rows = process_logits(raw, top_p=0.9)
    assert torch.isfinite(rows).all()
    z = torch.zeros((2,), dtype=torch.int32)
    keys = torch.zeros((2, 2), dtype=torch.uint32)
    tok, _, bad = tsr.sample_rows(rows, keys, z, z, z, raw=raw)
    assert bad.tolist() == [0, 1]
    assert tsr.sample_rows(rows, keys, z, z, z)[2].tolist() == [0, 0]
    np.testing.assert_array_equal(
        tok.numpy(), tsr.sample_rows(rows, keys, z, z, z)[0].numpy())


@pytest.mark.parametrize("bad", ["dtype", "keys", "seeds", "device", "raw"])
def test_r1_contract_is_checked_before_launch(bad):
    S, V = 2, 8
    args = dict(logits=torch.zeros((S, V)),
                keys=torch.zeros((S, 2), dtype=torch.uint32),
                seeds=torch.zeros((S,), dtype=torch.int32),
                fresh=torch.zeros((S,), dtype=torch.int32),
                emit=torch.zeros((S,), dtype=torch.int32),
                raw=torch.zeros((S, V), dtype=torch.bfloat16))
    tsr._check(**args)                  # a good set passes
    if bad == "dtype":
        args["logits"] = args["logits"].to(torch.bfloat16)
    elif bad == "keys":
        args["keys"] = torch.zeros((S, 2), dtype=torch.int64)
    elif bad == "seeds":
        args["seeds"] = torch.zeros((S + 1,), dtype=torch.int32)
    elif bad == "raw":
        args["raw"] = torch.zeros((S, V + 1), dtype=torch.bfloat16)
    else:
        args["emit"] = torch.zeros((S,), dtype=torch.int32, device="meta")
    with pytest.raises((TypeError, ValueError)):
        tsr._check(**args)


# ------------------------------------------------------------ the server


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
    return cls(model, max_slots=2, max_cache_len=MCL, cache_backend="paged",
               page_size=PG, do_sample=True, **kw)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (n,)).astype(np.int32)
            for n in (1, PG - 1, 13, 17)]


def _serve(srv, prompts, seeds, n_new=6):
    """The first request alone for a tick, the rest admitted mid-wave
    (queued behind two slots under a 4-token budget)."""
    rids = [srv.submit(prompts[0], max_new_tokens=n_new, seed=seeds[0])]
    srv.step()
    rids += [srv.submit(p, max_new_tokens=n_new, seed=s)
             for p, s in zip(prompts[1:], seeds[1:])]
    out = srv.run()
    return [out[r] for r in rids]


SEEDS = {"explicit": (0, 2**31 - 1, 2**31, -1),
         "explicit-wrap": (2**32 - 1, 5, -2**31, 2**40 + 3),
         "default": (None, None, None, None)}
CASES = [(mode, name, filt, seed_rule)
         for mode in ("split", "fused")
         for name, filt, seed_rule in (
             ("plain", "plain", "explicit"),
             ("top_k_p", "all", "explicit-wrap"),
             ("default_seed", "temperature", "default"),
             ("default_seed_past_2_31", "tight", "default"))]


@pytest.mark.parametrize("mode,name,filt,seed_rule", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_sampled_server_tokens_equal_the_jax_paged_server(mode, name, filt,
                                                          seed_rule):
    jm, tm = _models()
    t, k, p = FILTERS[filt]
    kw = dict(temperature=t, top_k=k, top_p=p, serving_mode=mode)
    if name == "default_seed_past_2_31":
        kw["seed"] = 2**31 - 2          # seed + rid crosses 2**31
    prompts, seeds = _prompts(), SEEDS[seed_rule]
    want = _serve(_server(JaxServer, jm, **kw), prompts, seeds)
    srv = _server(ContinuousBatchingServer, tm, **kw)
    got = _serve(srv, prompts, seeds)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert srv.pool_balance()[1] == 0
    assert srv.stats["sample_launches"] > 0
    assert srv.stats["nonfinite_logit_rows"] == 0
    assert tsr.sample_rows.launches == 0          # the CPU takes the plain


@pytest.mark.parametrize("mode", ["split", "fused"])
def test_sampled_server_counts_non_finite_rows_under_top_p(mode):
    """A NaN logit row of a live slot is counted when sampling under
    top-k and top-p too, though the filters turn it into the -1e30 fill:
    once per token the slot emits (fused: the first token and two decode
    tokens; split: the two decode tokens, its first came from prefill)."""
    _, tm = _models()
    srv = _server(ContinuousBatchingServer, tm, top_k=5, top_p=0.9,
                  serving_mode=mode)
    attr = "_fused_fn" if mode == "fused" else "_head_fn"
    inner = getattr(srv, attr)

    def poisoned(*args):
        out = inner(*args)
        logits = (out[0] if mode == "fused" else out).clone()
        logits[0] = float("nan")
        return (logits, out[1]) if mode == "fused" else logits

    setattr(srv, attr, poisoned)
    srv.submit(np.arange(3, dtype=np.int32), max_new_tokens=3, seed=7)
    srv.run()
    assert srv.stats["nonfinite_logit_rows"] == (3 if mode == "fused"
                                                 else 2)
    assert srv.pool_balance()[1] == 0


def test_sampling_differs_from_greedy_and_greedy_leaves_the_keys():
    _, tm = _models()
    prompts = _prompts()
    greedy = ContinuousBatchingServer(tm, max_slots=2, max_cache_len=MCL,
                                      cache_backend="paged", page_size=PG,
                                      prefill_tokens_per_tick=4)
    sampled = _server(ContinuousBatchingServer, tm)
    g = _serve(greedy, prompts, (None,) * 4)
    s = _serve(sampled, prompts, (None,) * 4)
    assert any(not np.array_equal(a, b) for a, b in zip(g, s))
    assert greedy.stats["sample_launches"] == 0
    assert not greedy._keys.to(torch.int64).any()


# ------------------------------------------------- R1's plan and its merge


@pytest.mark.parametrize("V", [1, 7, 32000, 128256])
@pytest.mark.parametrize("S", [1, 8, 64, 1024])
def test_r1_plan_covers_every_element_once(S, V):
    p = tsr.plan(S, V, 132)
    assert (tsr.plan_cover(p, V) == 1).all()
    assert p.chunk % tsr.STEP == 0 and (p.blocks - 1) * p.chunk < V
    assert 32 <= p.threads <= tsr.MAX_THREADS and p.threads % 32 == 0
    steps = p.chunk // tsr.STEP               # at most half a warp idle
    assert p.threads <= max(32, 2 * steps - 1)
    if S == 8 and V >= 32000:
        assert S * p.blocks >= 2 * 132            # two blocks an SM
    if S == 1024:
        assert p.blocks == 1                      # one block a row


def _first_max(vals, idx):
    """(value, index) first in argmax order (a NaN above every number, the
    lower index winning ties) of f32 ``vals`` at ``idx``: the kernel's
    ``ahead``."""
    best, bi = -np.inf, np.iinfo(np.int32).max
    for v, i in zip(vals.tolist(), idx.tolist()):
        if np.isnan(best) or np.isnan(v):
            if np.isnan(v) and (not np.isnan(best) or i < bi):
                best, bi = v, i
        elif v > best or (v == best and i < bi):
            best, bi = v, i
    return best, bi


def _walk_and_merge(rows, p):
    """The kernel's chunked walk and merge on the CPU: each block's first
    maximum over its chunk's strided thread walk, then the blocks' pairs
    merged in the same order."""
    tokens = []
    V = rows.shape[1]
    for row in rows:
        pairs = []
        for part in range(p.blocks):
            lo, hi = part * p.chunk, min(V, (part + 1) * p.chunk)
            thread_best = []
            for t in range(p.threads):
                idx = np.concatenate([np.arange(v0, min(v0 + tsr.STEP, hi))
                                      for v0 in range(lo + t * tsr.STEP, hi,
                                                      p.threads * tsr.STEP)]
                                     or [np.zeros(0, np.int64)])
                thread_best.append(_first_max(row[idx], idx))
            vals, idx = zip(*thread_best)
            pairs.append(_first_max(np.array(vals, np.float32),
                                    np.array(idx)))
        vals, idx = zip(*pairs)
        tokens.append(_first_max(np.array(vals, np.float32), np.array(idx))[1])
    return np.array(tokens, np.int32)


@pytest.mark.parametrize("V", [1, 77, 3000])
def test_r1_chunked_walk_and_merge_give_the_plain_tokens(V):
    """Ties across chunk boundaries, NaNs in several chunks, an all -inf
    row and V = 1: the plan's walk plus the merge picks the plain
    version's token."""
    rng = np.random.default_rng(V)
    S = 6
    p = tsr.plan(S, V, 4)
    logits = (rng.standard_normal((S, V)) * 3).astype(np.float32)
    c = p.chunk
    if V > 2 * c:
        logits[0, [c - 1, c, 2 * c]] = np.inf              # a tie
        logits[1, [2 * c + 1, c + 3]] = np.nan               # NaNs
        logits[4, V - 1] = 1e9                               # the last chunk
    logits[2] = -np.inf
    keys = rng.integers(0, 2**32, (S, 2), dtype=np.uint64).astype(np.uint32)
    args = (torch.from_numpy(keys.astype(np.int64)).to(torch.uint32),
            torch.zeros((S,), dtype=torch.int32),
            torch.zeros((S,), dtype=torch.int32),
            torch.ones((S,), dtype=torch.int32))
    want, _, _ = tsr.sample_rows(torch.from_numpy(logits), *args)
    # the kernel's values: logits + the Gumbel noise of each row's sub key
    from paddle_tpu_torch.core import prng
    k0, k1 = prng.key_data(args[0])
    sub = prng.split(prng.make_key(k0, k1)).unbind(-2)[1]
    g = prng.gumbel_from_bits(prng.random_bits(sub, (V,))).numpy()
    vals = (g + logits).astype(np.float32)
    np.testing.assert_array_equal(_walk_and_merge(vals, p), want.numpy())
    if V > 2 * c:
        assert want[0] == c - 1 and want[1] == c + 3 and want[4] == V - 1
    assert want[2] == 0
