"""The port's threefry stream (``core.prng``, ``core.random``) against
``jax.random`` and ``paddle_tpu.core.random``, on the CPU.

- jax runs the stream the port copies: ``jax_threefry_partitionable`` is
  True and the default PRNG is ``threefry2x32`` (if a later jax flips
  either, this fails loudly rather than letting the port drift);
- ``PRNGKey`` (seeds 0, 1, 2**31 - 1, 2**31, 2**32 - 1, -1, -2**31,
  2**40 + 5 and an int32 tensor of seeds), ``split`` (2, 5, (2, 3), and
  of a batch of keys), ``fold_in``, ``random_bits`` (of one key and of a
  batch), f32 ``uniform`` over four ranges and ``bernoulli`` (R2's keep
  mask on a CPU device): bit for bit;
- ``gumbel`` (R2's Gumbel draw on a CPU device, its plain version):
  within 2 ulps of ``max(|g|, 1)`` (each log is f64 rounded to f32;
  XLA's f32 log is within one ulp of that: ROADMAP Queue 3), and
  ``categorical``'s tokens (the first maximum of the logits plus that
  noise) equal, along the last axis and the first;
- ``fma_f32`` (XLA's fused scale and shift in ``uniform``) against
  XLA's jitted ``a * b + c``, which it fuses;
- ``seed``, ``get_rng_state``, ``set_rng_state``, ``rng_scope`` (nested)
  and ``next_key`` against ``paddle_tpu.core.random`` over one sequence
  of draws; the top-level exports.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.ops.kernels import threefry_fill as ttf

SEEDS = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, -1, -2**31, 2**40 + 5]
RANGES = [(0.0, 1.0), (-3.7, 2.9), (0.3, 0.31), (1e-10, 1.0)]
GUMBEL_ULPS = 2


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def test_jax_runs_the_stream_the_port_copies():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax_for_every_seed(seed):
    jk, tk = _key(seed)
    assert tk.dtype == torch.uint32 and tk.shape == (2,)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_prng_key_of_a_seed_tensor_is_vmapped_prng_key():
    seeds = np.array([0, 5, -1, 2**31 - 1, -2**31], np.int32)
    want = np.asarray(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)))
    np.testing.assert_array_equal(
        prng.PRNGKey(torch.from_numpy(seeds)).numpy(), want)


@pytest.mark.parametrize("num", [2, 5, (2, 3)])
def test_split_matches_jax(num):
    jk, tk = _key(1234)
    np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                  np.asarray(jax.random.split(jk, num)))


def test_split_and_bits_of_a_batch_of_keys_are_vmapped():
    """R1's plain version splits one key a row and draws a row's bits
    under each: a batch of keys is jax's vmap over them."""
    seeds = np.array([3, -1, 2**31 - 1], np.int32)
    jkeys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    tkeys = prng.PRNGKey(torch.from_numpy(seeds))
    np.testing.assert_array_equal(
        prng.split(tkeys).numpy(), np.asarray(jax.vmap(jax.random.split)(
            jkeys)))
    want = jax.vmap(lambda k: jax.random.bits(k, (2, 50), jnp.uint32))(
        jkeys)
    np.testing.assert_array_equal(prng.random_bits(tkeys, (2, 50)).numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("data", [0, 1, 77, 2**31, 2**32 - 1])
def test_fold_in_matches_jax_and_split(data):
    jk, tk = _key(99)
    want = np.asarray(jax.random.fold_in(jk, data))
    np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(), want)
    if data < 5:
        np.testing.assert_array_equal(prng.split(tk, 5)[data].numpy(), want)


def _gumbel_ulps(got, want):
    ulp = np.float32(2.0 ** -23) * np.maximum(np.abs(want), 1)
    return (np.abs(got.astype(np.float64) - want) / ulp).max()


@pytest.mark.parametrize("what", ["gumbel", "gumbel_softmax_noise", "keep"])
def test_r2_draws_on_the_cpu_are_jax_random(what):
    """R2's entry points on a CPU device: its plain version, held to
    jax.random (the card holds the kernel to it, chip_smoke.py rng)."""
    jk, tk = _key(4321)
    shape = (6, 500)
    if what == "keep":
        got = ttf.keep_mask(tk, shape, 0.3, "cpu").numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.bernoulli(jk, 0.3, shape)))
    elif what == "gumbel":
        got = ttf.gumbel(tk, shape, "cpu").numpy()
        assert _gumbel_ulps(got, np.asarray(jax.random.gumbel(
            jk, shape))) <= GUMBEL_ULPS
    else:
        # gumbel_softmax's noise: -log(-log(uniform(1e-10, 1)))
        u = jax.random.uniform(jk, shape, jnp.float32, 1e-10, 1.0)
        got = ttf.gumbel(tk, shape, "cpu", 1e-10).numpy()
        assert _gumbel_ulps(got, np.asarray(-jnp.log(-jnp.log(u)))) \
            <= GUMBEL_ULPS
    assert ttf.fill.launches == 0


@pytest.mark.parametrize("shape", [(), (7,), (3, 1000), (2, 3, 5)])
def test_random_bits_match_jax(shape):
    jk, tk = _key(7)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.random_bits(tk, shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("lo,hi", RANGES)
def test_uniform_matches_jax_bit_for_bit(lo, hi):
    jk, tk = _key(1234)
    want = np.asarray(jax.random.uniform(jk, (7, 1000), jnp.float32, lo,
                                         hi))
    got = prng.uniform_from_bits(prng.random_bits(tk, (7, 1000)), lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.7, 1.0])
def test_bernoulli_matches_jax(p):
    jk, tk = _key(31)
    np.testing.assert_array_equal(
        ttf.keep_mask(tk, (5, 300), p, "cpu").numpy(),
        np.asarray(jax.random.bernoulli(jk, p, (5, 300))))


def test_fma_f32_is_xlas_fused_multiply_add():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(20000).astype(np.float32) * s
               for s in (1, 1, 1e-3))
    want = np.asarray(jax.jit(lambda x, y, z: x * y + z)(a, b, c))
    got = prng.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (a * b + c != got).any()            # the test has teeth


@pytest.mark.parametrize("seed", [1234, 5, 99])
def test_gumbel_within_two_ulps_and_categorical_tokens_equal(seed):
    jk, tk = _key(seed)
    shape = (4, 32000)
    want = np.asarray(jax.random.gumbel(jk, shape))
    g = ttf.gumbel(tk, shape, "cpu")
    err = _gumbel_ulps(g.numpy(), want)
    assert err <= GUMBEL_ULPS, err
    logits = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    for axis in (-1, 0):
        np.testing.assert_array_equal(
            torch.argmax(g + torch.from_numpy(logits), axis).numpy(),
            np.asarray(jax.random.categorical(jk, logits, axis=axis)))


def _jkey(k):
    return np.asarray(k)


def test_global_state_and_scopes_follow_the_reference():
    jrandom.seed(2024)
    trandom.seed(2024)
    seq_j, seq_t = [], []
    for _ in range(3):
        seq_j.append(_jkey(jrandom.next_key()))
        seq_t.append(trandom.next_key().numpy())
    jstate, tstate = jrandom.get_rng_state(), trandom.get_rng_state()
    np.testing.assert_array_equal(tstate[0].numpy(), _jkey(jstate[0]))
    assert tstate[1] == jstate[1] == 3
    outer = jax.random.PRNGKey(5)
    with jrandom.rng_scope(outer):
        seq_j.append(_jkey(jrandom.next_key()))
        with jrandom.rng_scope(jax.random.PRNGKey(2**31 + 9)):
            seq_j += [_jkey(jrandom.next_key()) for _ in range(2)]
        seq_j.append(_jkey(jrandom.next_key()))
        assert jrandom.in_rng_scope()
    with trandom.rng_scope(prng.PRNGKey(5)):
        seq_t.append(trandom.next_key().numpy())
        with trandom.rng_scope(prng.PRNGKey(2**31 + 9)):
            seq_t += [trandom.next_key().numpy() for _ in range(2)]
        seq_t.append(trandom.next_key().numpy())
        assert trandom.in_rng_scope()
    assert not trandom.in_rng_scope()
    # the scope left the global counter alone
    seq_j.append(_jkey(jrandom.next_key()))
    seq_t.append(trandom.next_key().numpy())
    # restore the state saved after three draws: the draws repeat
    jrandom.set_rng_state(jstate)
    trandom.set_rng_state(tstate)
    seq_j.append(_jkey(jrandom.next_key()))
    seq_t.append(trandom.next_key().numpy())
    for a, b in zip(seq_t, seq_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seq_t[-1], seq_t[-2])
    # a state taken from the reference crosses over
    trandom.set_rng_state((np.asarray(jstate[0]), jstate[1]))
    np.testing.assert_array_equal(trandom.next_key().numpy(), seq_j[-1])


def test_seed_returns_the_root_key_and_the_package_exports_it():
    assert ptt.seed is trandom.seed
    assert ptt.get_rng_state is trandom.get_rng_state
    assert ptt.set_rng_state is trandom.set_rng_state
    np.testing.assert_array_equal(ptt.seed(-3).numpy(),
                                  np.asarray(jax.random.PRNGKey(-3)))
    assert ptt.get_rng_state()[1] == 0
