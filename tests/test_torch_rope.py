"""The port's rope (K6) against the JAX package's, on the CPU.

The same numpy inputs and cos/sin tables (seeded; the tables made with
numpy, since the two frameworks' ``cos`` and ``sin`` differ in the last
bit) go through the JAX functions and the port's plain versions, which
the CUDA kernel is held to on the card (``chip_smoke.py`` phase ``k6``):

- forward: ``rope_fwd`` vs ``apply_rotary_pallas(interpret=True)``: bf16
  bit for bit; f32 within one f32 ulp of the output (XLA contracts the
  interpreted kernel's product and difference into a fused multiply-add,
  torch rounds each) and bit for bit against ``_apply_rotary_jnp``;
- backward: the autograd Function vs ``jax.vjp`` of
  ``_apply_rotary_jnp``, bit for bit in f32 and bf16 (each product
  rounded to x's dtype before the sum, as that VJP rounds);
- bf16 tables: forward against the interpreted Pallas kernel and
  backward against ``jax.vjp``, and the kernel's contract takes them;
- a sequence past the table raises, as ``test_rope_kernel.py`` asks of
  the reference;
- ``PT_ROPE_PALLAS=1`` routes a 4-D call without ``position_ids`` on a
  card tensor to the kernel and nothing else; on CPU tensors it changes
  nothing;
- ``incubate.nn.functional.fused_rotary_position_embedding`` vs the JAX
  incubate function, with and without ``position_ids``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.incubate.nn import functional as jif
from paddle_tpu.ops.pallas import rope as jrope
from paddle_tpu_torch.incubate.nn import functional as tif
from paddle_tpu_torch.ops import rope as trope
from paddle_tpu_torch.ops.kernels import rope as trk

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tables(d, s_max):
    ang = np.outer(np.arange(s_max, dtype=np.float64),
                   10000.0 ** (-np.arange(0, d, 2) / d))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_matches_the_pallas_kernel_and_the_composition(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x((2, 64, 3, 32), 0)
    c, s = _tables(32, 96)
    jx = jnp.asarray(x).astype(jdt)
    kern = _np(jrope.apply_rotary_pallas(jx, jnp.asarray(c), jnp.asarray(s),
                                         block_s=32, interpret=True))
    comp = _np(jrope._apply_rotary_jnp(jx, jnp.asarray(c), jnp.asarray(s)))
    got = trk.rope_fwd(torch.from_numpy(x).to(tdt), torch.from_numpy(c),
                       torch.from_numpy(s))
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    np.testing.assert_array_equal(got, comp)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, kern)
    else:
        np.testing.assert_allclose(got, kern, rtol=0,
                                   atol=np.spacing(np.abs(kern)).max())
    assert trk.rope_fwd.launches == 0          # CPU: the plain version


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_backward_is_the_vjp_of_the_composition_bit_for_bit(dtype):
    jdt, tdt = DTYPES[dtype]
    x, g = _x((2, 40, 2, 16), 1), _x((2, 40, 2, 16), 2)
    c, s = _tables(16, 64)
    jx = jnp.asarray(x).astype(jdt)
    _, vjp = jax.vjp(lambda a: jrope._apply_rotary_jnp(
        a, jnp.asarray(c), jnp.asarray(s)), jx)
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = trk.apply_rotary_kernel(xt, torch.from_numpy(c),
                                  torch.from_numpy(s))
    out.backward(torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == tdt
    np.testing.assert_array_equal(xt.grad.float().numpy(), _np(want))
    # and torch autograd through the port's plain composition agrees
    xc = torch.from_numpy(x).to(tdt).requires_grad_()
    trope.apply_rotary(xc, torch.from_numpy(c), torch.from_numpy(s)) \
        .backward(torch.from_numpy(g).to(tdt))
    assert torch.equal(xc.grad, xt.grad)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bf16_tables_match_the_pallas_kernel_and_the_vjp(dtype):
    """bf16 cos/sin tables, as the reference's kernel takes them: the
    forward against ``apply_rotary_pallas(interpret=True)`` (bf16 x bit
    for bit, each product rounded to bf16 as bf16 * bf16 is in both
    frameworks; f32 x within one f32 ulp, the kernel's fused
    multiply-add), the backward against ``jax.vjp`` of the composition
    bit for bit."""
    jdt, tdt = DTYPES[dtype]
    x, g = _x((2, 64, 3, 32), 10), _x((2, 64, 3, 32), 11)
    c, s = (jnp.asarray(t).astype(jnp.bfloat16) for t in _tables(32, 96))
    tc, ts = (torch.from_numpy(np.array(t.astype(jnp.float32)))
              .to(torch.bfloat16) for t in (c, s))
    jx = jnp.asarray(x).astype(jdt)
    kern = _np(jrope.apply_rotary_pallas(jx, c, s, block_s=32,
                                         interpret=True))
    got = trk.rope_fwd(torch.from_numpy(x).to(tdt), tc, ts)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, kern)
    else:
        np.testing.assert_allclose(got, kern, rtol=0,
                                   atol=np.spacing(np.abs(kern)).max())
    _, vjp = jax.vjp(lambda a: jrope._apply_rotary_jnp(a, c, s), jx)
    (want,) = vjp(jnp.asarray(g).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    trk.apply_rotary_kernel(xt, tc, ts).backward(
        torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(xt.grad.float().numpy(), _np(want))
    assert trk.rope_fwd.launches == 0          # CPU: the plain version


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_the_kernel_contract_takes_bf16_tables(x_dtype):
    """The kernel reads f32 or bf16 tables (the card launches it for
    both); cos and sin must share one of those types."""
    x = torch.zeros((1, 8, 2, 16), dtype=x_dtype)
    c = torch.zeros((8, 8), dtype=torch.bfloat16)
    trk._check(x, c, c.clone())
    trk._check(x, c.float(), c.float())
    with pytest.raises(TypeError):
        trk._check(x, c, c.float())
    with pytest.raises(TypeError):
        trk._check(x, c.half(), c.half())


def test_a_sequence_past_the_table_raises():
    x = torch.from_numpy(_x((1, 64, 2, 16), 3))
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    with pytest.raises(ValueError, match="past the rope table"):
        trk.rope_fwd(x, c, s)
    with pytest.raises(ValueError, match="past the rope table"):
        trk.apply_rotary_kernel(x.requires_grad_(), c, s)


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports itself on the card: it lets the test see
    which route ``apply_rotary`` takes without a card."""

    @property
    def is_cuda(self):
        return True


def test_the_opt_in_route_follows_the_reference_condition(monkeypatch):
    calls = []
    monkeypatch.setattr(trope, "apply_rotary_kernel",
                        lambda x, c, s: calls.append(x.shape) or x)
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    card = torch.from_numpy(_x((1, 8, 2, 16), 4)).as_subclass(_CardTensor)
    pos = torch.arange(8)[None]
    monkeypatch.delenv("PT_ROPE_PALLAS", raising=False)
    trope.apply_rotary(card, c, s)
    monkeypatch.setenv("PT_ROPE_PALLAS", "0")
    trope.apply_rotary(card, c, s)
    assert calls == []                          # not opted in
    monkeypatch.setenv("PT_ROPE_PALLAS", "1")   # read at call time
    trope.apply_rotary(card, c, s, position_ids=pos)      # serving
    trope.apply_rotary(torch.from_numpy(_x((1, 8, 2, 16), 4)), c, s)
    assert calls == []
    trope.apply_rotary(card, c, s)
    assert calls == [(1, 8, 2, 16)]


def test_the_opt_in_on_cpu_tensors_changes_nothing(monkeypatch):
    x = torch.from_numpy(_x((2, 24, 4, 16), 5)).requires_grad_()
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    monkeypatch.delenv("PT_ROPE_PALLAS", raising=False)
    want = trope.apply_rotary(x, c, s)
    monkeypatch.setenv("PT_ROPE_PALLAS", "1")
    got = trope.apply_rotary(x, c, s)
    assert torch.equal(got, want)
    assert trk.rope_fwd.launches == 0


@pytest.mark.parametrize("with_positions", [False, True])
def test_fused_rotary_position_embedding_matches_jax(with_positions):
    q, k, v = _x((2, 12, 4, 16), 6), _x((2, 12, 2, 16), 7), \
        _x((2, 12, 2, 16), 8)
    c, s = _tables(16, 32)
    pos = (np.random.default_rng(9).integers(0, 32, (2, 12))
           if with_positions else None)
    want = jif.fused_rotary_position_embedding(
        pt.to_tensor(q), pt.to_tensor(k), pt.to_tensor(v),
        sin=pt.to_tensor(s), cos=pt.to_tensor(c),
        position_ids=None if pos is None else jnp.asarray(pos))
    got = tif.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        sin=torch.from_numpy(s), cos=torch.from_numpy(c),
        position_ids=None if pos is None else torch.from_numpy(pos))
    for w, t in zip(want[:2], got[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(w.numpy()), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), v)
    # k and v may be left out
    only_q = tif.fused_rotary_position_embedding(
        torch.from_numpy(q), sin=torch.from_numpy(s),
        cos=torch.from_numpy(c))
    assert only_q[1] is None and only_q[2] is None
    assert torch.equal(only_q[0], trope.apply_rotary(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(s)))
