"""The port's ``speculative_generate`` against the JAX package's, on the
CPU.

Weights are made on the JAX side (``llama_tiny`` targets and drafts, a
one-layer GPT draft, f32) and copied into the port with
``models.bridge.load_jax_params``. For each draft:

- the tokens equal the JAX package's ``speculative_generate`` and the
  port's own ``generate()`` (speculation changes latency, not results;
  torch's CPU matmuls round by their row count, so a near-tie between
  the verify block and a decode step could flip a token: these inputs
  have none, ROADMAP Queue 3);
- ``accepted_per_round`` equals the JAX package's round for round. A
  perfect draft (the target itself) accepts ``gamma`` every round, which
  holds only if the draft's cache row ``t + gamma``, written by its last
  drafting step, is there when the next round reads it;
- eos pads the tail as ``generate()`` does, and the headroom guard
  refuses a cache without room for the verify block.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.inference.speculative import \
    speculative_generate as jax_speculative
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.inference import speculative_generate
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     LlamaForCausalLM, llama_tiny,
                                     load_jax_params)

V = 256
MCL = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's steps here are tiny: one torch thread each keeps the
    test workers (several a machine) from oversubscribing its cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bridge(jm, tm):
    jm.eval()
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


@functools.lru_cache(maxsize=None)
def _llama(seed):
    pt.seed(seed)
    return _bridge(JaxLlama(jax_llama_tiny()),
                   LlamaForCausalLM(llama_tiny(), device="cpu"))


@functools.lru_cache(maxsize=1)
def _gpt_draft():
    kw = dict(vocab_size=V, hidden_size=32, num_layers=1, num_heads=2,
              max_seq_len=MCL)
    pt.seed(55)
    return _bridge(JaxGPT(JaxGPTConfig(**kw)),
                   GPTForCausalLM(GPTConfig(**kw), device="cpu"))


def _ids(T, seed):
    return np.random.default_rng(seed).integers(0, V, (1, T)).astype(
        np.int32)


def _both(target, draft, ids, **kw):
    """(JAX tokens, JAX stats, port tokens, port stats)."""
    jt, jstats = jax_speculative(target[0], draft[0], jnp.asarray(ids),
                                 max_cache_len=MCL, return_stats=True, **kw)
    tt, tstats = speculative_generate(target[1], draft[1], ids,
                                      max_cache_len=MCL, return_stats=True,
                                      **kw)
    return jt.numpy(), jstats, tt, tstats


@pytest.mark.parametrize("draft,gamma,new", [
    ("perfect", 3, 12), ("weak", 4, 10), ("gpt", 2, 8), ("perfect", 1, 7)])
def test_tokens_and_acceptance_equal_jax_and_generate(draft, gamma, new):
    target = _llama(51)
    d = {"perfect": target, "weak": _llama(53), "gpt": _gpt_draft()}[draft]
    ids = _ids(5, seed=gamma + new)
    jt, jstats, tt, tstats = _both(target, d, ids, max_new_tokens=new,
                                   gamma=gamma)
    want = target[1].generate(ids, max_new_tokens=new, max_cache_len=MCL)
    assert tt.dtype == torch.int32 and tt.shape == (1, 5 + new)
    np.testing.assert_array_equal(tt.numpy(), want.numpy())
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert tstats == jstats
    if draft == "perfect":
        assert tstats["accepted_per_round"] == \
            [gamma] * tstats["rounds"], tstats
    elif draft == "weak":
        assert tstats["mean_accepted"] < gamma


def test_eos_pads_the_tail_as_generate():
    target = _llama(56)
    ids = _ids(4, seed=10)
    ref = target[1].generate(ids, max_new_tokens=10,
                             max_cache_len=MCL).numpy()[0, 4:]
    eos = int(ref[3])
    want = target[1].generate(ids, max_new_tokens=10, eos_token_id=eos,
                              max_cache_len=MCL).numpy()
    jt, jstats, tt, tstats = _both(target, target, ids, max_new_tokens=10,
                                   gamma=2, eos_token_id=eos)
    np.testing.assert_array_equal(tt.numpy(), want)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert tstats == jstats
    assert (tt.numpy()[0, 4 + 3:] == eos).all()


def test_headroom_guard_and_single_sequence():
    target = _llama(57)
    for fn, m in ((jax_speculative, target[0]),
                  (speculative_generate, target[1])):
        with pytest.raises(ValueError, match="headroom"):
            fn(m, m, np.zeros((1, 50), np.int32), max_new_tokens=10,
               gamma=4, max_cache_len=64)
        with pytest.raises(ValueError, match="single-sequence"):
            fn(m, m, np.zeros((2, 5), np.int32), max_new_tokens=4)
