"""The port's random ops (``paddle_tpu_torch/ops/random_ops.py``) and the
draws under them (``core.prng``, R2's plain ``fill``) against the JAX
package's ``jax.random``, on the CPU.

- Every op, ``Tensor.uniform_`` and ``Tensor.exponential_`` under the
  same ``seed()``, f32 and bf16, shapes from 0-d to odd sizes: the
  uniform family, ``randint``, ``randperm``, ``shuffle``, ``bernoulli``,
  ``multinomial`` and ``poisson`` bit for bit (the Gumbel noise and the
  logs are within 2 ulps, which moves no draw here); the normal family
  within 3 ulps of f32 (``NORMAL_ULPS``); ``exponential_`` within 2 ulps
  of XLA's log1p.
- ``erf_inv`` over all 2**23 f32 uniform values that
  ``normal_from_bits`` takes, against ``sqrt(2) * jax.lax.erf_inv``: how
  many differ and by how many ulps (ROADMAP Queue 3), and bf16's 128
  uniform values bit for bit.
- Key consumption: the draw after each op is the reference's.
- ``rng_scope``, and ``test_random_reproducible`` ported from
  ``tests/test_tensor_autograd.py:156``.
- The kernel's parameters (``threefry_fill._fill_params``) reproduce the
  plain version through the kernel's formulas.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jt
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.ops.kernels import threefry_fill as tfill

NORMAL_ULPS = 3      # the normal family's bound, in f32 ulps
LOG_ULPS = 2         # exponential_'s (XLA's log1p)


@pytest.fixture(autouse=True, scope="module")
def _cpu_one_thread():
    before, place = torch.get_num_threads(), tdevice._default[0]
    torch.set_num_threads(1)
    pt.set_device("cpu")
    yield
    tdevice._default[0] = place
    torch.set_num_threads(before)


def _np(t):
    return np.asarray(t.numpy()).astype(np.float64) if hasattr(
        t, "numpy") else np.asarray(t, np.float64)


def _ulps(a, b):
    """Distance in f32 ulps, element by element."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _run(script, s=5):
    """(port result, reference result, port's next draw, reference's
    next draw) of ``script(m)`` under ``seed(s)``."""
    jt.seed(s)
    pt.seed(s)
    want = script(jt)
    got = script(pt)
    return got, want, pt.ops.rand([3]).numpy(), np.asarray(
        jt.ops.rand([3]).numpy())


SHAPES = [[], [1], [7], [3, 5], [2, 3, 17]]
FLOATS = ["float32", "bfloat16"]
X = np.arange(24, dtype=np.float32).reshape(4, 6)
P = np.random.default_rng(0).uniform(0, 1, (4, 10)).astype(np.float32)

BITWISE = {
    "rand": lambda m, d, s: m.ops.rand(s, d),
    "uniform": lambda m, d, s: m.ops.uniform(s, d, -0.3, 2.0),
    "uniform_seed": lambda m, d, s: m.ops.uniform(s, d, seed=4),
    "rand_like": lambda m, d, s: m.ops.rand_like(m.to_tensor(
        np.zeros(s, np.float32), dtype=d)),
    "uniform_": lambda m, d, s: m.to_tensor(np.zeros(s, np.float32),
                                            dtype=d).uniform_(-2.0, 3.0),
    "bernoulli": lambda m, d, s: m.ops.bernoulli(m.to_tensor(
        np.full(s, 0.3, np.float32), dtype=d)),
}
NORMAL = {
    "randn": lambda m, d, s: m.ops.randn(s, d),
    "standard_normal": lambda m, d, s: m.ops.standard_normal(s, d),
    "gaussian": lambda m, d, s: m.ops.gaussian(s, 1.0, 2.0, d),
    "randn_like": lambda m, d, s: m.ops.randn_like(m.to_tensor(
        np.zeros(s, np.float32), dtype=d)),
}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("name", sorted(BITWISE))
def test_uniform_family_is_bitwise(name, dtype, shape):
    got, want, gn, wn = _run(lambda m: BITWISE[name](m, dtype, shape))
    assert list(got.shape) == list(want.shape)
    assert got.dtype == pt.ops.ones([1], dtype).dtype
    assert np.array_equal(_np(got), _np(want))
    assert np.array_equal(gn, wn)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("name", sorted(NORMAL))
def test_normal_family_is_within_its_bound(name, dtype, shape):
    got, want, gn, wn = _run(lambda m: NORMAL[name](m, dtype, shape))
    assert list(got.shape) == list(want.shape)
    if dtype == "bfloat16":       # bf16's 128 uniform values all agree
        assert np.array_equal(_np(got), _np(want))
    else:
        assert _ulps(_np(got), _np(want)).max(initial=0) <= NORMAL_ULPS
    assert np.array_equal(gn, wn)


INTEGER = {
    "randint": lambda m: m.ops.randint(-5, 17, [50]),
    "randint_high": lambda m: m.ops.randint(0, 2 ** 31 - 1, [33]),
    "randint_one_bound": lambda m: m.ops.randint(9, shape=[4, 4]),
    "randint_like": lambda m: m.ops.randint_like(
        m.to_tensor(np.zeros(9, np.int32)), 100),
    "randperm": lambda m: m.ops.randperm(37),
    "randperm_two_rounds": lambda m: m.ops.randperm(3000),
    "shuffle": lambda m: m.ops.shuffle(m.to_tensor(X)),
    "shuffle_axis1": lambda m: m.ops.shuffle(m.to_tensor(X), 1),
    "shuffle_1d": lambda m: m.ops.shuffle(m.to_tensor(X[0])),
    "multinomial": lambda m: m.ops.multinomial(m.to_tensor(P), 3),
    "multinomial_replace": lambda m: m.ops.multinomial(
        m.to_tensor(P[0]), 5, True),
    "poisson": lambda m: m.ops.poisson(m.to_tensor(np.array(
        [0, 0.5, 3, 9.9, 10, 25, 100, 1000] * 8, np.float32))),
    "poisson_knuth_only": lambda m: m.ops.poisson(m.to_tensor(np.array(
        [0.1, 2.0, 5.0], np.float32))),
    "normal_scalars": lambda m: m.ops.normal(0.5, 2.0, [20]),
    "normal_tensor_mean": lambda m: m.ops.normal(
        m.to_tensor(np.linspace(-1, 1, 12).astype(np.float32)), 2.0),
}


@pytest.mark.parametrize("name", sorted(INTEGER))
def test_integer_and_composite_ops_match(name):
    got, want, gn, wn = _run(INTEGER[name])
    assert list(got.shape) == list(want.shape)
    if name.startswith("normal"):
        assert _ulps(_np(got), _np(want)).max() <= NORMAL_ULPS
    else:
        assert got.dtype == {"int32": torch.int32, "float32": torch.float32}[
            str(np.asarray(want.numpy()).dtype)]
        assert np.array_equal(_np(got), _np(want))
    assert np.array_equal(gn, wn)


def test_exponential_is_within_the_log_bound():
    got, want, gn, wn = _run(
        lambda m: m.to_tensor(X).exponential_(2.0))
    assert _ulps(_np(got), _np(want)).max() <= LOG_ULPS
    assert np.array_equal(gn, wn)


def test_what_the_reference_refuses_the_port_refuses():
    pt.seed(0)
    with pytest.raises(ValueError):          # shapes jax cannot broadcast
        pt.ops.multinomial(pt.to_tensor(P), 1, True)
    with pytest.raises(TypeError):           # randint of a float tensor
        pt.ops.randint_like(pt.to_tensor(X), 3)
    with pytest.raises(TypeError):
        pt.ops.rand([2], "int32")


def test_erf_inv_over_every_f32_uniform_value():
    """All 2**23 values ``uniform(nextafter(-1, 0), 1)`` can take: the
    port's ``sqrt(2) * erf_inv`` against XLA's. XLA's f32 log1p is its
    own polynomial (within 2 ulps of the correctly rounded one the port
    takes), so 78960 values (0.94%) differ, by at most 3 ulps."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    diff, worst = 0, 0
    f = jax.jit(lambda v: jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(v))
    for part in range(4):
        m = torch.arange(part << 21, (part + 1) << 21, dtype=torch.int64)
        u = prng.uniform_from_bits(m << 9, lo, 1.0)
        got = (prng.SQRT2_F32 * prng.erf_inv_f32(u)).numpy()
        want = np.asarray(f(u.numpy()))
        d = _ulps(got, want)
        diff += int((d != 0).sum())
        worst = max(worst, int(d.max()))
    assert worst <= NORMAL_ULPS
    assert diff == 78960, diff


def test_bf16_normal_over_every_uniform_value():
    bits = torch.arange(256, dtype=torch.int64)
    got = prng.normal_from_bits(bits, torch.bfloat16).float().numpy()
    lo = float(prng._nextafter(-1.0, 0.0, torch.bfloat16))
    u = prng.uniform_from_bits(bits, lo, 1.0, torch.bfloat16)
    want = np.asarray((jnp.asarray(np.sqrt(2), jnp.bfloat16) * jax.lax.erf_inv(
        jnp.asarray(u.float().numpy()).astype(jnp.bfloat16))).astype(
            jnp.float32))
    assert np.array_equal(got, want)


def test_truncated_normal_matches_jax():
    key = prng.PRNGKey(9)
    for dt, jd in ((torch.float32, jnp.float32),
                   (torch.bfloat16, jnp.bfloat16)):
        got = tfill.truncated_normal(key, (1000,), "cpu", -2.0, 2.0, dt)
        want = np.asarray(jax.random.truncated_normal(
            jax.random.PRNGKey(9), -2.0, 2.0, (1000,), jd).astype(
                jnp.float32))
        g = got.float().numpy()
        assert np.all(np.abs(g) < 2.0)
        if dt == torch.bfloat16:
            assert np.array_equal(g, want)
        else:
            assert _ulps(g, want).max() <= NORMAL_ULPS


def test_rng_scope_routes_the_ops_to_subkeys():
    def s(m):
        m.seed(1)
        with m.core.random.rng_scope(np.array([0, 42], np.uint32)):
            a = m.ops.rand([5])
            b = m.ops.randint(0, 10, [5])
        return [a, b, m.ops.rand([2])]
    got, want = s(pt), s(jt)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), _np(w))


def test_random_reproducible():
    pt.seed(7)
    a = pt.ops.randn([4])
    pt.seed(7)
    b = pt.ops.randn([4])
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _kernel_formula(what, dtype, bits, q):
    """The kernel's ``draw_of`` written out on the host from its
    parameters (``_fill_params``), for the plain version to equal."""
    lo, scale, clo, chi, sqrt2 = (torch.tensor(v) for v in q[:5])
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        u = torch.maximum(lo, prng.fma_f32(f, scale, lo))
    else:
        f = ((((bits & 0xFF) >> 1) | 0x3F80) << 16).to(torch.int32).view(
            torch.float32) - 1.0
        u = torch.maximum(lo, ((f * scale).bfloat16().float() + lo)
                          .bfloat16().float())
    if what == tfill._UNIFORM:
        return u
    e = prng.erf_inv_f32(u)
    n = sqrt2 * e if dtype == torch.float32 else \
        (sqrt2 * e.bfloat16().float()).bfloat16().float()
    return n if what == tfill._NORMAL else torch.minimum(torch.maximum(n, clo),
                                                         chi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("what", [tfill._UNIFORM, tfill._NORMAL,
                                  tfill._TRUNCATED])
def test_the_kernels_parameters_reproduce_the_plain_draws(what, dtype):
    key = prng.PRNGKey(21)
    bits = prng.random_bits(key, (4099,))
    lo, hi = (-2.0, 2.0) if what == tfill._TRUNCATED else (-0.7, 1.3)
    q = tfill._fill_params(what, dtype, lo, hi)
    want = tfill._ref_fill(key, (4099,), what, "cpu", dtype, lo, hi).float()
    got = _kernel_formula(what, dtype, bits, q)
    assert torch.equal(got, want)


def test_f16_draws_are_refused_where_the_reference_draws():
    """Pinned (ROADMAP Queue 3): the port draws f32 and bf16 only; an f16
    draw raises TypeError, on the CPU as on the card (R2 has no f16
    mode), where jax draws 16 bits."""
    jt.seed(0)
    assert str(np.asarray(jt.ops.rand([2], "float16").numpy()).dtype) == \
        "float16"
    pt.seed(0)
    with pytest.raises(TypeError):
        pt.ops.rand([2], "float16")
    with pytest.raises(TypeError):
        pt.nn.initializer.Normal()((2, 2), "float16")
