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
- the pair entry (q and k at the same positions, one launch on the
  card): its plain version against the reference's ``apply_rotary`` on q
  and k, MHA and GQA, forward and backward against ``jax.vjp``, bit for
  bit; ``RopeQKFunction`` with one cotangent None takes a single-tensor
  launch for the other;
- the route (vector or scalar body) by D, dtype and alignment, and the
  static plan: its walk (``plan_cover``) rotates every element once;
- routing: a 4-D call without ``position_ids`` on a card tensor takes
  the kernel by default (``apply_rotary``, ``apply_rotary_qk``); CPU
  tensors, ``position_ids`` and the module-private composition switch
  take the composition; a card tensor whose kernel fails to build
  raises, it does not fall back;
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


def _route_spy(monkeypatch):
    """Record which of the kernel entries ``ops.rope`` calls; each
    returns its input(s) unchanged."""
    calls = []
    monkeypatch.setattr(trope, "apply_rotary_kernel",
                        lambda x, c, s: calls.append(("x", x.shape)) or x)
    monkeypatch.setattr(trope, "apply_rotary_qk_kernel",
                        lambda q, k, c, s: calls.append(
                            ("qk", q.shape, k.shape)) or (q, k))
    return calls


def test_the_opt_in_route_follows_the_reference_condition(monkeypatch):
    """The reference's kernel condition (no ``position_ids``, a 4-D x on
    the device) routes to K6 by default now, with no environment switch:
    ``PT_ROPE_PALLAS`` is not read."""
    calls = _route_spy(monkeypatch)
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    card = torch.from_numpy(_x((1, 8, 2, 16), 4)).as_subclass(_CardTensor)
    pos = torch.arange(8)[None]
    monkeypatch.delenv("PT_ROPE_PALLAS", raising=False)
    trope.apply_rotary(card, c, s)
    monkeypatch.setenv("PT_ROPE_PALLAS", "0")
    trope.apply_rotary(card, c, s)
    assert calls == [("x", (1, 8, 2, 16))] * 2      # the default
    calls.clear()
    trope.apply_rotary(card, c, s, position_ids=pos)      # serving
    trope.apply_rotary(torch.from_numpy(_x((1, 8, 2, 16), 4)), c, s)
    assert calls == []
    monkeypatch.setattr(trope, "_COMPOSITION_ONLY", True)
    trope.apply_rotary(card, c, s)
    assert calls == []


def test_the_opt_in_on_cpu_tensors_changes_nothing(monkeypatch):
    """CPU tensors take the composition, whatever the environment says,
    and launch nothing."""
    x = torch.from_numpy(_x((2, 24, 4, 16), 5)).requires_grad_()
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    monkeypatch.delenv("PT_ROPE_PALLAS", raising=False)
    want = trope.apply_rotary(x, c, s)
    monkeypatch.setenv("PT_ROPE_PALLAS", "1")
    got = trope.apply_rotary(x, c, s)
    assert torch.equal(got, want)
    q2, k2 = trope.apply_rotary_qk(x, x[:, :, :2], c, s)
    assert torch.equal(q2, want)
    assert torch.equal(k2, want[:, :, :2])
    assert got.grad_fn.name() == "CatBackward0"     # no kernel Function
    assert trk.rope_fwd.launches == 0 and trk.rope_qk_fwd.launches == 0


def test_apply_rotary_qk_routes_card_tensors_to_one_kernel_call(
        monkeypatch):
    calls = _route_spy(monkeypatch)
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    q = torch.from_numpy(_x((1, 8, 4, 16), 12)).as_subclass(_CardTensor)
    k = torch.from_numpy(_x((1, 8, 2, 16), 13)).as_subclass(_CardTensor)
    trope.apply_rotary_qk(q, k, c, s)
    assert calls == [("qk", (1, 8, 4, 16), (1, 8, 2, 16))]
    calls.clear()
    trope.apply_rotary_qk(q, k, c, s, position_ids=torch.arange(8)[None])
    trope.apply_rotary_qk(q, torch.from_numpy(_x((1, 8, 2, 16), 13)), c, s)
    monkeypatch.setattr(trope, "_COMPOSITION_ONLY", True)
    trope.apply_rotary_qk(q, k, c, s)
    assert calls == []
    # the incubate entry sends q and k through the pair, a lone q alone
    monkeypatch.setattr(trope, "_COMPOSITION_ONLY", False)
    tif.fused_rotary_position_embedding(q, k, sin=s, cos=c)
    tif.fused_rotary_position_embedding(q, sin=s, cos=c)
    assert calls == [("qk", (1, 8, 4, 16), (1, 8, 2, 16)),
                     ("x", (1, 8, 4, 16))]


@pytest.mark.parametrize("entry", ["single", "pair"])
def test_a_card_tensor_raises_when_the_kernel_cannot_build(monkeypatch,
                                                          entry):
    """No fallback: a card tensor whose kernel does not build raises, and
    nothing is counted as launched."""
    def no_build(stem, name, argtypes):
        raise RuntimeError(f"nvcc failed on {stem}.cu")

    monkeypatch.setattr(trk._build, "function", no_build)
    monkeypatch.setattr(trk, "sm_count", lambda index: 132)
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    q = torch.from_numpy(_x((1, 8, 4, 16), 14)).as_subclass(_CardTensor)
    k = torch.from_numpy(_x((1, 8, 2, 16), 15)).as_subclass(_CardTensor)
    with pytest.raises(RuntimeError, match="nvcc failed on rope.cu"):
        if entry == "single":
            trope.apply_rotary(q, c, s)
        else:
            trope.apply_rotary_qk(q, k, c, s)
    assert trk.rope_fwd.launches == 0 and trk.rope_qk_fwd.launches == 0


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_pair_matches_the_reference_on_q_and_k(dtype, heads):
    """The pair's plain version (``rope_qk_fwd`` on the CPU) against the
    reference's ``apply_rotary`` of q and of k, and its backward (the
    autograd Function, one call for both cotangents) against ``jax.vjp``
    of ``_apply_rotary_jnp`` over (q, k): bit for bit."""
    jdt, tdt = DTYPES[dtype]
    hq, hk = heads
    q, k = _x((2, 40, hq, 32), 20), _x((2, 40, hk, 32), 21)
    gq, gk = _x((2, 40, hq, 32), 22), _x((2, 40, hk, 32), 23)
    c, s = _tables(32, 64)
    jc, js = jnp.asarray(c), jnp.asarray(s)
    jq, jk = (jnp.asarray(a).astype(jdt) for a in (q, k))
    tc, ts = torch.from_numpy(c), torch.from_numpy(s)
    tq, tk = (torch.from_numpy(a).to(tdt) for a in (q, k))
    oq, ok = trk.rope_qk_fwd(tq, tk, tc, ts)
    for got, want in ((oq, jrope.apply_rotary(jq, jc, js)),
                      (ok, jrope.apply_rotary(jk, jc, js))):
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    _, vjp = jax.vjp(lambda a, b: (jrope._apply_rotary_jnp(a, jc, js),
                                   jrope._apply_rotary_jnp(b, jc, js)),
                     jq, jk)
    wq, wk = vjp((jnp.asarray(gq).astype(jdt), jnp.asarray(gk).astype(jdt)))
    tq.requires_grad_()
    tk.requires_grad_()
    oq, ok = trk.apply_rotary_qk_kernel(tq, tk, tc, ts)
    torch.autograd.backward((oq, ok), (torch.from_numpy(gq).to(tdt),
                                       torch.from_numpy(gk).to(tdt)))
    np.testing.assert_array_equal(tq.grad.float().numpy(), _np(wq))
    np.testing.assert_array_equal(tk.grad.float().numpy(), _np(wk))
    assert trk.rope_qk_fwd.launches == 0        # CPU: the plain version


@pytest.mark.parametrize("used", ["q", "k"])
def test_one_cotangent_none_takes_a_single_tensor_launch(monkeypatch,
                                                         used):
    calls = []
    single, pair = trk.rope_fwd, trk.rope_qk_fwd
    monkeypatch.setattr(trk, "rope_fwd", lambda *a: calls.append("single")
                        or single(*a))
    monkeypatch.setattr(trk, "rope_qk_fwd", lambda *a: calls.append("pair")
                        or pair(*a))
    c, s = (torch.from_numpy(t) for t in _tables(16, 32))
    q = torch.from_numpy(_x((2, 12, 4, 16), 24)).requires_grad_()
    k = torch.from_numpy(_x((2, 12, 2, 16), 25)).requires_grad_()
    g = torch.from_numpy(_x((2, 12, 4 if used == "q" else 2, 16), 26))
    out = trk.apply_rotary_qk_kernel(q, k, c, s)[0 if used == "q" else 1]
    out.backward(g)
    assert calls == ["pair", "single"]
    grad, unused = (q.grad, k.grad) if used == "q" else (k.grad, q.grad)
    assert unused is None
    assert torch.equal(grad, trk._ref_rope(g, c, s, -1))


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (64, torch.bfloat16, True, "vector"),        # D/2 = 32: 4 chunks of 8
    (128, torch.float32, True, "vector"),
    (16, torch.bfloat16, True, "vector"),        # one chunk
    (72, torch.bfloat16, True, "scalar"),        # D/2 = 36, not 8k
    (72, torch.float32, True, "vector"),         # 36 = 9 chunks of 4
    (68, torch.float32, True, "scalar"),
    (64, torch.bfloat16, False, "scalar"),       # an offset view
    (128, torch.float32, False, "scalar")])
def test_the_route_follows_width_dtype_and_alignment(d, dtype, aligned,
                                                     want):
    assert trk.route(d, dtype, aligned) == want
    p = trk.plan(64, d, 8, dtype, aligned, 132, 4)
    assert p.route == want
    assert p.vec * p.chunks == d // 2
    assert p.vec == (16 // torch.empty((), dtype=dtype).element_size()
                     if want == "vector" else 1)


@pytest.mark.parametrize("positions,d,heads,dtype,sms,bps", [
    (8 * 1024, 64, 32, torch.bfloat16, 132, 4),   # llama_350m q + k
    (4096, 128, 64, torch.bfloat16, 132, 4),      # Llama-2-7B q + k
    (2048, 128, 72, torch.bfloat16, 132, 4),      # 70B heads, 64 + 8
    (8 * 1024, 64, 16, torch.float32, 132, 8),
    (1000, 72, 6, torch.bfloat16, 2, 1)])         # scalar, grid-stride
def test_the_plan_fills_the_card_once_and_keeps_table_reuse(
        positions, d, heads, dtype, sms, bps):
    p = trk.plan(positions, d, heads, dtype, True, sms, bps)
    items = positions * p.chunks * p.groups
    room = sms * bps * trk.THREADS
    assert p.groups == -(-heads // p.group_heads)
    assert p.blocks == min(sms * bps, -(-items // trk.THREADS))
    # one pass when the groups split at all; halving once more would
    # overflow the card or leave a group under MIN_GROUP_HEADS heads
    if p.groups > 1:
        assert items <= room and p.group_heads >= trk.MIN_GROUP_HEADS
    assert (positions * p.chunks * p.groups * 2 > room
            or -(-heads // (p.groups * 2)) < trk.MIN_GROUP_HEADS)


@pytest.mark.parametrize("positions,d,heads,dtype,aligned,sms,bps", [
    (40, 64, 8, torch.bfloat16, True, 1, 1),      # groups, one pass
    (300, 64, 5, torch.bfloat16, True, 1, 1),     # grid-stride, ragged group
    (24, 72, 9, torch.bfloat16, True, 2, 1),      # scalar body
    (16, 128, 72, torch.float32, False, 132, 8),  # many groups, scalar
    (50, 16, 6, torch.float32, True, 3, 2)])
def test_the_plan_walk_rotates_every_element_once(positions, d, heads,
                                                  dtype, aligned, sms, bps):
    p = trk.plan(positions, d, heads, dtype, aligned, sms, bps)
    cover = trk.plan_cover(p, positions, heads)
    assert cover.shape == (positions, heads, d // 2)
    assert (cover == 1).all()


def test_the_pair_contract_holds_q_and_k_to_one_frame():
    c = torch.zeros((8, 8))
    q = torch.zeros((1, 8, 4, 16))
    trk._check_qk(q, torch.zeros((1, 8, 2, 16)), c, c.clone())
    for bad in (torch.zeros((1, 7, 2, 16)), torch.zeros((2, 8, 2, 16)),
                torch.zeros((1, 8, 2, 8)), torch.zeros((1, 8, 2, 16),
                                                       dtype=torch.bfloat16)):
        with pytest.raises((ValueError, TypeError)):
            trk._check_qk(q, bad, c, c.clone())
    with pytest.raises(ValueError, match="past the rope table"):
        trk.rope_qk_fwd(torch.zeros((1, 9, 4, 16)), torch.zeros((1, 9, 2, 16)),
                        c, c.clone())


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
