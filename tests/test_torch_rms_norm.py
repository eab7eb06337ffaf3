"""The port's RMSNorm (K5) against the JAX package's, on the CPU.

The same numpy inputs (seeded) go through the JAX Pallas kernels in
interpret mode and through the port's plain versions, which the CUDA
kernels are held to on the card (``chip_smoke.py`` phase ``k5``):

- forward: ``_ref_fwd`` vs ``_pallas_fwd`` (which takes no ``interpret``
  argument: the test wraps ``pallas_call`` with ``interpret=True``
  through monkeypatch, nothing in the JAX package changes) and vs the
  JAX ``_ref_fwd``; f32 within 1e-6 (one rsqrt and two products per
  element, summed in another order);
- backward: ``_ref_bwd`` vs ``_pallas_bwd(interpret=True)`` and the JAX
  ``_ref_bwd``; f32 dx within 1e-5, dw (a sum over 96 rows) within 1e-4;
- the autograd Function's gradients vs torch autograd through the plain
  forward (1e-5), 3-D inputs;
- bf16: dx in bf16, dw in w's dtype, both within a bf16 rounding of the
  JAX reference;
- the kernels' contract refuses bad inputs before any launch.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from paddle_tpu.ops.pallas import rms_norm as jrn
from paddle_tpu_torch.ops.kernels import rms_norm as trn

EPS = 1e-5


def _inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, w, g


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def test_forward_matches_the_pallas_kernel_and_the_reference(
        interpret_pallas):
    x, w, _ = _inputs((3, 32, 64), 0)
    want = np.asarray(jrn._pallas_fwd(jnp.asarray(x), jnp.asarray(w), EPS))
    ref = np.asarray(jrn._ref_fwd(jnp.asarray(x), jnp.asarray(w), EPS))
    got = trn.rms_norm_fwd(torch.from_numpy(x), torch.from_numpy(w),
                           EPS).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert trn.rms_norm_fwd.launches == 0      # CPU: the plain version


def test_backward_matches_the_pallas_kernel_and_the_reference():
    x, w, g = _inputs((3, 32, 64), 1)
    jx, jw, jg = jnp.asarray(x), jnp.asarray(w), jnp.asarray(g)
    pdx, pdw = jrn._pallas_bwd(jx, jw, jg, EPS, block_rows=32,
                               interpret=True)
    rdx, rdw = jrn._ref_bwd(jx, jw, jg, EPS)
    dx, dw = trn.rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(g), EPS)
    for want_dx, want_dw in ((pdx, pdw), (rdx, rdw)):
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=0,
                                   atol=1e-4)
    assert trn.rms_norm_bwd.launches == 0


def test_autograd_function_matches_autograd_through_the_plain_forward():
    x, w, g = _inputs((2, 5, 64), 2)
    xa = torch.from_numpy(x).requires_grad_()
    wa = torch.from_numpy(w).requires_grad_()
    out = trn.rms_norm(xa, wa, EPS)
    out.backward(torch.from_numpy(g))
    xb = torch.from_numpy(x).requires_grad_()
    wb = torch.from_numpy(w).requires_grad_()
    ref = trn._ref_fwd(xb, wb, EPS)
    ref.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(wa.grad.numpy(), wb.grad.numpy(), rtol=0,
                               atol=1e-5)


def test_bf16_types_and_values_against_the_jax_reference():
    x, w, g = _inputs((4, 16, 64), 3)
    to_bf = functools.partial(torch.tensor, dtype=torch.bfloat16)
    tx, tw, tg = to_bf(x), to_bf(w), to_bf(g)
    # the JAX side on the very same bf16 values
    jx, jw, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tx, tw, tg))
    out = trn.rms_norm_fwd(tx, tw, EPS)
    dx, dw = trn.rms_norm_bwd(tx, tw, tg, EPS)
    assert out.dtype == dx.dtype == dw.dtype == torch.bfloat16
    want = np.asarray(jrn._ref_fwd(jx, jw, EPS).astype(jnp.float32))
    wdx, wdw = (np.asarray(a.astype(jnp.float32))
                for a in jrn._ref_bwd(jx, jw, jg, EPS))
    # both round the same f32 value once to bf16 (8 significant bits):
    # at most one bf16 step apart, 2^-7 of the magnitude
    for got, ref in ((out, want), (dx, wdx), (dw, wdw)):
        got = got.float().numpy()
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("case", ["dtype", "w_shape", "d", "g_shape",
                                  "contiguous"])
def test_contract_refuses_bad_inputs_before_a_launch(case):
    x = torch.zeros(4, 64)
    w = torch.ones(64)
    g = torch.zeros(4, 64)
    if case == "dtype":
        x, w = x.half(), w.half()
    elif case == "w_shape":
        w = torch.ones(32)
    elif case == "d":
        x, w, g = torch.zeros(4, 60), torch.ones(60), torch.zeros(4, 60)
    elif case == "g_shape":
        g = torch.zeros(2, 64)
    else:
        x = torch.zeros(64, 4).t()
    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        trn._check(x, w, g)
