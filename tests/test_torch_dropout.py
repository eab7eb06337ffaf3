"""The port's dropout family, ``gumbel_softmax`` and attention dropout
against the JAX package's, on the CPU, after the same ``seed()``.

The port draws each op's key from ``core.random.next_key`` where the
reference does, so the same seed gives the same masks op for op:

- ``dropout``: both modes, no axis, one axis, two axes, p = 0.3 and the
  edges p = 0 (identity), p = 1 (all dropped; the reference's gradient
  is ``0 / 0 = NaN`` there and the port's too), outside training
  (``downscale_in_infer`` scales by ``1 - p`` in x's type); f32, bf16
  and f16. Values and gradients (of ``sum``) bit for bit;
- ``dropout2d`` / ``dropout3d`` (NCHW / NHWC and NCDHW / NDHWC) and
  ``alpha_dropout``: values and gradients bit for bit;
- ``gumbel_softmax``, soft and hard: values and gradients within 1e-6
  (the Gumbel noise's logs are f64 logs rounded to f32, within an ulp
  of XLA's, and softmax's exp is torch's: a few f32 ulps of values <= 1;
  hard's one-hot at the same places);
- ``scaled_dot_product_attention(dropout_p=0.2)`` while training: the
  dropped elements bit for bit, values and gradients within 1e-5 (the
  composition's products are summed by another BLAS), and the counter
  advanced as the reference's: the next key drawn after it is equal;
- the CPU takes the plain versions: no R2 launch;
- the kernel's plans, by their CPU models: the integer keep test
  ``(bits >> 9) < keep_threshold(p)`` equals the float test for all 2**23
  mantissas; the magic divisors divide; the collapsed-axis plan's walk
  writes each value once with ``_mask_strides``' mask index on every
  route; the saved mask's bit packing; and ``_Dropout``'s backward from
  the saved bits equal to ``jax.vjp`` of the reference's dropout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core import random as jrandom
from paddle_tpu_torch.core import random as trandom
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import threefry_fill as ttf

DTYPES = {"float32": (None, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
SOFT_ATOL = 1e-6
SDPA_ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jfn, tfn, x, dname="float32", seed=5):
    """(values, gradients of sum) of the reference and the port on the
    same input after the same seed, as f32 numpy arrays."""
    jd, td = DTYPES[dname]
    pt.seed(seed)
    ptt.seed(seed)
    jx = pt.to_tensor(jnp.asarray(x) if jd is None else jnp.asarray(x, jd))
    jx.stop_gradient = False
    jy = jfn(jx)
    jy.sum().backward()
    tx = torch.tensor(x).to(td).requires_grad_(True)
    ty = tfn(tx)
    ty.sum().backward()
    assert ty.dtype == td
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa
    return ((f32(jy._value), ty.detach().float().numpy()),
            (f32(jx.grad._value), tx.grad.float().numpy()))


def _equal(pair):
    np.testing.assert_array_equal(pair[1], pair[0])


DROPOUT = {"p0.3": dict(p=0.3), "axis1": dict(p=0.3, axis=1),
           "axes02": dict(p=0.4, axis=[0, 2]),
           "downscale": dict(p=0.3, mode="downscale_in_infer"),
           "p0": dict(p=0.0), "p1": dict(p=1.0),
           "p1-axis": dict(p=1.0, axis=0),
           "infer": dict(p=0.3, training=False),
           "infer-downscale": dict(p=0.3, training=False,
                                   mode="downscale_in_infer")}


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", list(DROPOUT))
def test_dropout_matches_the_reference_values_and_gradients(case, dname):
    kw = DROPOUT[case]
    ys, gs = _both(lambda v: pt.nn.functional.dropout(v, **kw),
                   lambda v: F.dropout(v, **kw), _x((4, 6, 5)), dname)
    _equal(ys)
    _equal(gs)
    if case.startswith("p1"):
        assert (ys[1] == 0).all() and np.isnan(gs[1]).all()
    if case == "p0.3":
        assert 0 < (ys[1] == 0).mean() < 0.6
    assert ttf.dropout.launches == ttf.fill.launches == 0


@pytest.mark.parametrize("fn,shape,fmt", [
    ("dropout2d", (2, 3, 4, 5), "NCHW"), ("dropout2d", (2, 4, 5, 3), "NHWC"),
    ("dropout3d", (2, 3, 2, 3, 4), "NCDHW"),
    ("dropout3d", (2, 2, 3, 4, 3), "NDHWC")])
def test_channel_dropout_matches_the_reference(fn, shape, fmt):
    ys, gs = _both(
        lambda v: getattr(pt.nn.functional, fn)(v, p=0.5, data_format=fmt),
        lambda v: getattr(F, fn)(v, p=0.5, data_format=fmt), _x(shape))
    _equal(ys)
    _equal(gs)
    # whole channels drop together
    ch = 1 if fmt.startswith("NC") else len(shape) - 1
    dropped = np.moveaxis(ys[1] == 0, ch, 1).reshape(shape[0],
                                                     shape[ch], -1)
    assert (dropped.all(-1) == dropped.any(-1)).all()


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.2, 0.0])
def test_alpha_dropout_matches_the_reference(p, dname):
    ys, gs = _both(lambda v: pt.nn.functional.alpha_dropout(v, p=p),
                   lambda v: F.alpha_dropout(v, p=p), _x((5, 7)), dname)
    _equal(ys)
    _equal(gs)


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_gumbel_softmax_matches_the_reference(hard, axis):
    kw = dict(temperature=0.7, hard=hard, axis=axis)
    ys, gs = _both(lambda v: pt.nn.functional.gumbel_softmax(v, **kw),
                   lambda v: F.gumbel_softmax(v, **kw), _x((6, 9)))
    np.testing.assert_allclose(ys[1], ys[0], rtol=0, atol=SOFT_ATOL)
    np.testing.assert_allclose(gs[1], gs[0], rtol=0, atol=SOFT_ATOL)
    if hard:
        # y_hard - y + y: the one-hot within rounding of 1 and 0
        np.testing.assert_allclose(ys[1], np.round(ys[1]), rtol=0,
                                   atol=SOFT_ATOL)
        _equal((np.round(ys[0]), np.round(ys[1])))


def test_sdpa_dropout_while_training_matches_the_reference():
    q, k, v = (_x((2, 8, 3, 16), s) for s in (1, 2, 3))
    jt = [pt.to_tensor(jnp.asarray(a)) for a in (q, k, v)]
    tt = [torch.tensor(a).requires_grad_(True) for a in (q, k, v)]
    for t in jt:
        t.stop_gradient = False
    pt.seed(9)
    ptt.seed(9)
    jo = pt.nn.functional.scaled_dot_product_attention(
        *jt, dropout_p=0.2, is_causal=True)
    to = F.scaled_dot_product_attention(*tt, dropout_p=0.2, is_causal=True)
    jo.square().sum().backward()
    to.square().sum().backward()
    want = np.asarray(jo._value)
    got = to.detach().numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want == 0).mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=SDPA_ATOL)
    for jx, tx in zip(jt, tt):
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(
            jx.grad._value), rtol=0, atol=SDPA_ATOL)
    # one key each, drawn at the same place
    np.testing.assert_array_equal(trandom.next_key().numpy(),
                                  np.asarray(jrandom.next_key()))


def test_dropout_inside_an_rng_scope_follows_the_scope():
    x = _x((3, 8))
    scope = np.asarray([7, 11], np.uint32)
    pt.seed(1)
    ptt.seed(1)
    with jrandom.rng_scope(jnp.asarray(scope)):
        want = np.asarray(pt.nn.functional.dropout(
            pt.to_tensor(jnp.asarray(x)), p=0.5)._value)
    with trandom.rng_scope(scope):
        got = F.dropout(torch.tensor(x), p=0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert trandom.get_rng_state()[1] == 0     # the global counter untouched


@pytest.mark.parametrize("bad", ["shape", "rank"])
def test_dropout_mask_shape_is_checked(bad):
    x = torch.zeros((2, 3))
    mask = (2, 2) if bad == "shape" else (2, 3, 1)
    with pytest.raises(ValueError, match="broadcast"):
        ttf.dropout(x, trandom.next_key(), mask, 0.5, True)


def test_mask_strides_recompose_the_mask_index():
    shape, mask = (4, 3, 5, 2), (4, 1, 5, 1)
    st = ttf._mask_strides(shape, mask)
    idx = np.indices(shape).reshape(4, -1).T
    flat = (idx * np.asarray(st)).sum(1)
    want = np.ravel_multi_index(
        tuple(np.where(np.asarray(mask) == 1, 0, idx).T), mask)
    np.testing.assert_array_equal(flat, want)


# ------------------------------------------- R2's keep test, plan and bits


KEEP_PS = [0.0, 2.0 ** -23, 1e-10, 0.1, 0.5, 0.9,
           float(np.nextafter(np.float32(1), np.float32(0))), 1.0]


@pytest.mark.parametrize("p", KEEP_PS)
def test_integer_keep_threshold_equals_the_float_test(p):
    """``(bits >> 9) < keep_threshold(p)`` equals ``unit_f32(bits) <
    f32(p)`` for every one of the 2**23 mantissas ``bits >> 9`` (the low 9
    bits do not reach either test)."""
    m = np.arange(1 << 23, dtype=np.uint32)
    unit = (m | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    np.testing.assert_array_equal(m < ttf.keep_threshold(p),
                                  unit < np.float32(p))


def test_magic_division_matches_integer_division():
    rng = np.random.default_rng(3)
    divisors = [1, 2, 3, 7, 8, 1000, 1024, 32000, 128256, 2**31 - 1,
                2**31 + 5, 2**32 - 1, *rng.integers(1, 2**32, 20).tolist()]
    n = np.concatenate([rng.integers(0, 2**32, 4000, dtype=np.int64),
                        [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]])
    for d in divisors:
        mg = ttf.magic(int(d))
        assert 0 < mg[0] < 2**32
        got = [ttf._udiv(int(v), mg) for v in n]
        np.testing.assert_array_equal(got, n // int(d))


@pytest.mark.parametrize("seed", range(12))
def test_dropout_plan_reproduces_the_mask_index(seed):
    """The collapsed-axis plan, walked with its magic divisors on each
    route, writes every value element once with ``_mask_strides``' mask
    index, for seeded shapes up to rank 8 with broadcast axes anywhere."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        rank = int(rng.integers(1, 9))
        shape = [int(s) for s in rng.integers(1, 5, rank)]
        if rng.random() < 0.5:
            shape[-1] = 8 * int(rng.integers(1, 3))
        shape = tuple(shape)
        mask = tuple(s if rng.random() < 0.5 else 1 for s in shape)
        idx = np.indices(shape).reshape(rank, -1).T
        want = (idx * np.asarray(ttf._mask_strides(shape, mask))).sum(1)
        for force in (None, "scalar", "wide"):
            p = ttf.dropout_plan(shape, mask, True, int(rng.integers(1, 6)),
                                 force)
            got, count = ttf.plan_walk(p, idx.shape[0])
            assert (count == 1).all(), (shape, mask, p.route)
            np.testing.assert_array_equal(got, want)


def test_dropout_routes():
    assert ttf.route((8, 1024, 16, 64), (8, 1024, 16, 64), True) == "vector"
    assert ttf.route((7, 1001), (7, 1001), True) == "vector"   # a tail
    assert ttf.route((8, 64, 32, 32), (8, 64, 1, 1), True) == "vector"
    assert ttf.route((8, 1024, 1024), (8, 1, 1024), True) == "vector"
    assert ttf.route((8, 1024, 16, 64), (8, 1024, 16, 64), False) == \
        "scalar"
    assert ttf.route((4, 6, 5), (4, 1, 5), True) == "scalar"   # odd runs
    assert ttf.route((2**16, 2**16), (1, 2**16), True) == "wide"


@pytest.mark.parametrize("mask", [(5, 3, 7), (5, 1, 7), (1, 3, 1), (1, 1, 1)])
def test_saved_mask_bits_pack_the_keep_flags(mask):
    keep = torch.from_numpy(np.random.default_rng(1).random(mask) < 0.5)
    bits = ttf._ref_pack(keep)
    assert bits.dtype == torch.uint8 and bits.numel() == -(-keep.numel() // 8)
    np.testing.assert_array_equal(
        bits.numpy(), np.packbits(keep.numpy().reshape(-1),
                                  bitorder="little"))
    assert torch.equal(ttf._ref_unpack(bits, mask), keep)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["p0.3", "axis1", "downscale", "p1"])
def test_dropout_backward_from_the_saved_bits_equals_jax_vjp(case, dname):
    """``_Dropout``'s backward (the saved bits, no hash) against
    ``jax.vjp`` of the reference's dropout at a random cotangent."""
    kw = DROPOUT[case]
    jd, td = DTYPES[dname]
    x, ct = _x((4, 6, 5)), _x((4, 6, 5), seed=1)
    pt.seed(5)
    y, vjp = jax.vjp(lambda v: pt.nn.functional.dropout(
        pt.to_tensor(v), **kw)._value, jnp.asarray(x, jd))
    (want,) = vjp(jnp.asarray(ct, jd))
    ptt.seed(5)
    tx = torch.tensor(x).to(td).requires_grad_(True)
    ty = F.dropout(tx, **kw)
    ty.backward(torch.tensor(ct).to(td))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa
    np.testing.assert_array_equal(ty.detach().float().numpy(), f32(y))
    np.testing.assert_array_equal(tx.grad.float().numpy(), f32(want))
    assert ttf.dropout.launches == 0


def test_dropout_vjp_checks_the_saved_mask():
    g = torch.zeros((2, 8))
    _, bits = ttf.dropout(g, trandom.next_key(), (2, 8), 0.5, True,
                          save_mask=True)
    assert bits.numel() == 2
    np.testing.assert_array_equal(
        ttf.dropout_vjp(g, bits, (2, 8), 0.5, True).numpy(), 0)
