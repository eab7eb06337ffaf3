"""The port's fused GEMM epilogue (K7) against the JAX package's, on the
CPU.

The same numpy inputs (seeded) go through the JAX functions and the
port's plain version, which the CUDA kernel is held to on the card
(``chip_smoke.py`` phase ``k7``):

- ``gemm_epilogue`` vs ``_gemm_epilogue_pallas(interpret=True)``, every
  activation with and without a bias, f32 within 1e-5 (products summed
  in another order), bf16 within one bf16 rounding of the output (both
  accumulate in f32 and round once: one bf16 ulp);
- against the JAX public ``fused_gemm_epilogue`` (its ``_ref`` off the
  TPU) in f32 within 1e-5; in bf16 ``_ref`` rounds ``x @ w`` to bf16
  before the bias and the kernel does not, so there they differ by up
  to two bf16 roundings (ROADMAP, Queue 3);
- gradients of the autograd Function vs ``jax.grad`` through the custom
  VJP, f32 within 1e-5 and bf16 within a bf16 rounding;
- ``incubate.nn.functional.fused_linear_activation`` (batched x,
  ``trans_x``/``trans_y``), ``fused_matmul_bias`` (both of its routes)
  and ``fused_linear`` vs the JAX incubate functions, f32 within 1e-5;
- the contract refuses an unknown activation; the incubate functions
  once unported run (since item 15.6a), ``fused_multi_transformer``
  refusing a missing ``num_heads`` as the reference does;
- the kernel's route (wgmma, mma.sync or simt) is a pure function of the
  shape, the dtype and the operands' alignment, every branch; on the CPU
  no route counts a launch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as jif
from paddle_tpu.ops.pallas import gemm_epilogue as jge
from paddle_tpu_torch import incubate
from paddle_tpu_torch.incubate.nn import functional as tif
from paddle_tpu_torch.ops.kernels import gemm_epilogue as tge

ACTS = ["none", "relu", "gelu"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _data(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.5 * rng.standard_normal(n)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, b, g


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype, atol=1e-5):
    """f32: ``atol``; bf16: one rounding of the output apart (two f32
    sums a few ulps apart may round to neighbouring bf16 values), one
    bf16 ulp, at most 2^-7 of |want|, and 1e-6 near zero."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_less(np.abs(got - want),
                                     2.0 ** -7 * np.abs(want) + 1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_plain_version_matches_the_pallas_kernel(act, bias, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, _ = _data(64, 96, 48, 0)
    jb = jnp.asarray(b).astype(jdt) if bias else None
    want = _f32(jge._gemm_epilogue_pallas(jnp.asarray(x).astype(jdt),
                                          jnp.asarray(w).astype(jdt), jb,
                                          act, interpret=True))
    got = tge.gemm_epilogue(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(w).to(tdt),
                            torch.from_numpy(b).to(tdt) if bias else None,
                            act)
    assert got.dtype == tdt and got.shape == (64, 48)
    _close(got.float().numpy(), want, dtype)
    assert tge.gemm_epilogue.launches == 0     # CPU: the plain version


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_against_the_public_jax_function(act, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, _ = _data(3 * 10, 40, 24, 1)
    x3 = x.reshape(3, 10, 40)                   # leading dims flattened
    want = _f32(jge.fused_gemm_epilogue(jnp.asarray(x3).astype(jdt),
                                        jnp.asarray(w).astype(jdt),
                                        jnp.asarray(b).astype(jdt), act))
    got = tge.fused_gemm_epilogue(torch.from_numpy(x3).to(tdt),
                                  torch.from_numpy(w).to(tdt),
                                  torch.from_numpy(b).to(tdt), act)
    assert got.shape == (3, 10, 24)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        # _ref rounds x @ w to bf16 before the bias: two roundings apart
        np.testing.assert_array_less(
            np.abs(got - want), 2.0 ** -7 * (np.abs(want) + np.abs(
                _f32(jnp.asarray(x3).astype(jdt) @ jnp.asarray(w)
                     .astype(jdt)))) + 1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_gradients_match_jax_grad_through_the_custom_vjp(act, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, g = _data(24, 32, 20, 2)

    def loss(xv, wv, bv):
        out = jge.fused_gemm_epilogue(xv, wv, bv, act)
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (x, w, b)))
    xt, wt, bt = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (x, w, b))
    out = tge.fused_gemm_epilogue(xt, wt, bt, act)
    out.backward(torch.from_numpy(g).to(tdt))
    for t, j in zip((xt, wt, bt), want):
        assert t.grad.dtype == tdt
        _close(t.grad.float().numpy(), _f32(j), dtype)


def _jt(a):
    return pt.to_tensor(a)


def test_fused_linear_activation_matches_the_jax_incubate_function():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    y = rng.standard_normal((12, 16)).astype(np.float32) / 4
    b = rng.standard_normal(12).astype(np.float32)
    for act in ACTS:
        want = jif.fused_linear_activation(_jt(x), _jt(y), _jt(b),
                                           trans_y=True, activation=act)
        got = tif.fused_linear_activation(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(b),
            trans_y=True, activation=act)
        assert got.shape == (2, 7, 12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=0, atol=1e-5)
    xt = rng.standard_normal((16, 9)).astype(np.float32)   # trans_x, 2-D
    want = jif.fused_linear_activation(_jt(xt), _jt(y.T.copy()), _jt(b),
                                       trans_x=True, activation="relu")
    got = tif.fused_linear_activation(
        torch.from_numpy(xt), torch.from_numpy(y.T.copy()),
        torch.from_numpy(b), trans_x=True, activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=0, atol=1e-5)
    assert incubate.nn.functional is tif


@pytest.mark.parametrize("case", ["2d_y", "2d_y_transposed", "no_bias",
                                  "batched_y", "transpose_x"])
def test_fused_matmul_bias_matches_the_jax_incubate_function(case):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    y = rng.standard_normal((8, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    kw = {}
    if case == "2d_y_transposed":
        y, kw = y.T.copy(), {"transpose_y": True}
    elif case == "batched_y":
        y = rng.standard_normal((3, 8, 6)).astype(np.float32)
    elif case == "transpose_x":
        x, kw = x.transpose(0, 2, 1).copy(), {"transpose_x": True}
    bias = None if case == "no_bias" else b
    want = jif.fused_matmul_bias(_jt(x), _jt(y),
                                 None if bias is None else _jt(bias), **kw)
    got = tif.fused_matmul_bias(torch.from_numpy(x), torch.from_numpy(y),
                                None if bias is None
                                else torch.from_numpy(bias), **kw)
    assert got.shape == (3, 5, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=0, atol=1e-5)


def test_fused_linear_matches_the_jax_incubate_function():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = rng.standard_normal((6, 8)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    want = jif.fused_linear(_jt(x), _jt(w), _jt(b), transpose_weight=True)
    got = tif.fused_linear(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), transpose_weight=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=0, atol=1e-5)


def test_unknown_activation_and_unported_functions_raise():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="activation"):
        tge.gemm_epilogue(x, torch.zeros(3, 4), None, "swish")
    with pytest.raises(ValueError, match="num_heads"):
        tif.fused_multi_transformer(x, *([[]] * 12))
    assert tif.swiglu(torch.ones(2, 4)).shape == (2, 2)
    assert callable(incubate.nn.FusedMultiTransformer)


# (m, n, k, dtype, aligned, route): every branch of ``route``
ROUTE_CASES = [
    (4096, 4096, 1024, torch.bfloat16, True, "wgmma"),    # GPT-2 FFN1
    (4096, 11008, 4096, torch.bfloat16, True, "wgmma"),   # 7B gate
    (4096, 1000, 1024, torch.bfloat16, True, "wgmma"),    # N tail of 8s
    (1000, 1000, 1000, torch.bfloat16, True, "wgmma"),    # ragged M, K
    (1, 8, 8, torch.bfloat16, True, "wgmma"),             # the least K, N
    (999, 333, 777, torch.bfloat16, True, "mma_sync"),    # K and N odd
    (64, 48, 100, torch.bfloat16, True, "mma_sync"),      # K % 8 != 0
    (64, 44, 96, torch.bfloat16, True, "mma_sync"),       # N % 8 != 0
    (64, 48, 0, torch.bfloat16, True, "mma_sync"),        # K == 0
    (4096, 4096, 1024, torch.bfloat16, False, "mma_sync"),  # misaligned
    (4096, 4096, 1024, torch.float32, True, "simt"),
    (999, 333, 777, torch.float32, False, "simt"),
]


@pytest.mark.parametrize("m,n,k,dtype,aligned,want", ROUTE_CASES)
def test_route_is_chosen_by_shape_dtype_and_alignment(m, n, k, dtype,
                                                      aligned, want):
    assert tge.route(m, n, k, dtype, aligned) == want
    assert tge.route(m + 1, n, k, dtype, aligned) == want   # M takes no part


def test_cpu_tensors_count_no_route_launch():
    before = dict(tge.gemm_epilogue.route_launches)
    assert set(before) == set(tge.ROUTES)
    x, w, b, _ = _data(16, 16, 8, 6)
    tge.gemm_epilogue(torch.from_numpy(x).bfloat16(),
                      torch.from_numpy(w).bfloat16(),
                      torch.from_numpy(b).bfloat16(), "gelu")
    assert tge.gemm_epilogue.route_launches == before
