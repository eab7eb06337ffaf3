"""The port's flash attention (K4) against the JAX package's, on the CPU.

The same numpy inputs (seeded, scaled by 0.3 as
``tests/test_flash_attention.py`` does) go through the JAX Pallas
kernels in interpret mode and through the port's plain versions, which
the CUDA kernels are held to on the card (``chip_smoke.py`` phase
``k4``). f32 throughout; tolerances 2e-5 absolute (sums of 64-256
products in another order):

- forward o and lse vs ``_flash_fwd_pallas``, causal and not, and with
  rectangular K/V;
- the card tiles' edges (S = 100, S_q = 64 under S_k = 192, head_dim
  16), forward and backward;
- backward dq, dk, dv vs ``_flash_bwd_pallas``, causal and not,
  rectangular K/V, and with an lse cotangent (``dlse``);
- the explicit ``_ref_bwd`` (FlashAttention-2's formulas) vs autograd
  through ``_ref_with_lse``, with and without ``dlse``;
- the autograd Functions (``flash_attention`` on ``[B, S, H, D]``,
  ``flash_attention_with_lse``) vs the same autograd;
- causal alignment at ``S_q != S_k``: the port follows the Pallas kernel
  (top-left) and so differs from the JAX package's ``_ref_with_lse``
  (bottom-right) — the divergence recorded in ROADMAP Queue 3;
- the kernels' contract refuses bad inputs before any launch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 2e-5


def _rand(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 0.3).astype(np.float32)


def _qkv(bh, sq, sk, d, seed):
    return (_rand((bh, sq, d), seed), _rand((bh, sk, d), seed + 1),
            _rand((bh, sk, d), seed + 2))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("causal,sq,sk", [(False, 256, 256),
                                          (True, 256, 256),
                                          (False, 128, 256)])
def test_forward_matches_the_pallas_kernel(causal, sq, sk):
    q, k, v = _qkv(2, sq, sk, 64, 0)
    sm = 1.0 / np.sqrt(64)
    jo, jlse = jfa._flash_fwd_pallas(*map(jnp.asarray, (q, k, v)), sm,
                                     causal, interpret=True)
    o, lse = tfa.flash_fwd(*_t(q, k, v), sm, causal)
    assert o.shape == q.shape and lse.shape == (2, sq)
    assert lse.dtype == torch.float32
    _close(o.numpy(), jo)
    _close(lse.numpy(), jlse)
    assert tfa.flash_fwd.launches == 0       # CPU: the plain version


def test_the_plain_forward_does_not_depend_on_the_thread_count():
    """The 2e-5 tolerance above holds the plain forward to the Pallas
    kernel with ~20x room (measured: 7.8e-8 on o, 9.5e-7 on lse at
    S = 256, at 1 to 8 threads alike), and its bits do not move with
    torch's thread count: summation order under BLAS threads is not what
    a worker of a parallel test run could see differently."""
    q, k, v = _t(*_qkv(2, 256, 256, 64, 0))
    sm = 1.0 / np.sqrt(64)
    before = torch.get_num_threads()
    try:
        outs = []
        for n in (1, 2, 4):
            torch.set_num_threads(n)
            outs.append(tfa.flash_fwd(q, k, v, sm, False))
    finally:
        torch.set_num_threads(before)
    for o, lse in outs[1:]:
        assert torch.equal(o, outs[0][0]) and torch.equal(lse, outs[0][1])


@pytest.mark.parametrize("causal,sq,sk,with_dlse", [
    (False, 256, 256, False), (True, 256, 256, False),
    (False, 128, 256, False), (True, 256, 256, True),
    (False, 256, 256, True)])
def test_backward_matches_the_pallas_kernel(causal, sq, sk, with_dlse):
    q, k, v = _qkv(2, sq, sk, 64, 10)
    do = _rand((2, sq, 64), 99)
    dlse = np.random.RandomState(5).randn(2, sq).astype(np.float32) \
        if with_dlse else None
    sm = 1.0 / np.sqrt(64)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_fwd_pallas(jq, jk, jv, sm, causal, interpret=True)
    want = jfa._flash_bwd_pallas(
        jq, jk, jv, jo, jlse, jdo, sm, causal, interpret=True,
        dlse=None if dlse is None else jnp.asarray(dlse))
    o, lse = tfa.flash_fwd(*_t(q, k, v), sm, causal)
    got = tfa.flash_bwd(*_t(q, k, v), o, lse, torch.from_numpy(do), sm,
                        causal,
                        dlse=None if dlse is None else torch.from_numpy(dlse))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w)
    assert tfa.flash_bwd.dq_launches == tfa.flash_bwd.dkv_launches == 0


@pytest.mark.parametrize("causal,sq,sk,hd", [(True, 100, 100, 64),
                                             (False, 64, 192, 64),
                                             (True, 96, 96, 16)])
def test_tile_edges_match_the_pallas_kernels(causal, sq, sk, hd):
    """The edges of the card kernels' 64-row tiles, in the plain
    versions they are held to: S = 100 (a tail tile), S_q = 64 under
    S_k = 192 non-causal (key tiles past the row tile), head_dim 16
    (``llama_tiny``'s, a single k-step); forward and backward against
    the Pallas kernels in interpret mode."""
    q, k, v = _qkv(2, sq, sk, hd, 50)
    do = _rand((2, sq, hd), 51)
    sm = 1.0 / np.sqrt(hd)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jfa._flash_fwd_pallas(jq, jk, jv, sm, causal, interpret=True)
    want = jfa._flash_bwd_pallas(jq, jk, jv, jo, jlse, jdo, sm, causal,
                                 interpret=True)
    o, lse = tfa.flash_fwd(*_t(q, k, v), sm, causal)
    _close(o.numpy(), jo)
    _close(lse.numpy(), jlse)
    got = tfa.flash_bwd(*_t(q, k, v), o, lse, torch.from_numpy(do), sm,
                        causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_dlse", [False, True])
def test_explicit_backward_matches_autograd_of_the_forward(causal,
                                                           with_dlse):
    q, k, v = _qkv(3, 40, 40, 16, 20)
    do = torch.from_numpy(_rand((3, 40, 16), 21))
    dlse = torch.from_numpy(_rand((3, 40), 22)) if with_dlse else None
    sm = 0.25
    qa, ka, va = (t.requires_grad_() for t in _t(q, k, v))
    o, lse = tfa._ref_with_lse(qa, ka, va, sm, causal)
    loss = (o * do).sum() + ((lse * dlse).sum() if with_dlse else 0.0)
    loss.backward()
    got = tfa._ref_bwd(*_t(q, k, v), o.detach(), lse.detach(), do, sm,
                       causal, dlse)
    for g, a in zip(got, (qa.grad, ka.grad, va.grad)):
        _close(g.numpy(), a.numpy())


def test_autograd_functions_match_autograd_of_the_plain_version():
    rng = np.random.RandomState(30)
    b, s, h, d = 2, 24, 3, 16
    q, k, v = ((rng.randn(b, s, h, d) * 0.3).astype(np.float32)
               for _ in range(3))
    do = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
    dlse = torch.from_numpy(rng.randn(b, h, s).astype(np.float32))
    sm = 1.0 / np.sqrt(d)

    # flash_attention: [B, S, H, D], causal
    qa, ka, va = (t.requires_grad_() for t in _t(q, k, v))
    (tfa.flash_attention(qa, ka, va, causal=True) * do).sum().backward()
    qb, kb, vb = (t.requires_grad_() for t in _t(q, k, v))
    ref = tfa._ref_with_lse(qb.transpose(1, 2), kb.transpose(1, 2),
                            vb.transpose(1, 2), sm, True)[0]
    (ref.transpose(1, 2) * do).sum().backward()
    for a, r in ((qa, qb), (ka, kb), (va, vb)):
        _close(a.grad.numpy(), r.grad.numpy())

    # flash_attention_with_lse: [B, H, S, D], both outputs in the loss
    dot = do.transpose(1, 2)
    qa, ka, va = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in _t(q, k, v))
    o, lse = tfa.flash_attention_with_lse(qa, ka, va, sm, False)
    ((o * dot).sum() + (lse * dlse).sum()).backward()
    qb, kb, vb = (t.detach().clone().requires_grad_() for t in (qa, ka, va))
    ro, rl = tfa._ref_with_lse(qb, kb, vb, sm, False)
    ((ro * dot).sum() + (rl * dlse).sum()).backward()
    _close(o.detach().numpy(), ro.detach().numpy())
    _close(lse.detach().numpy(), rl.detach().numpy())
    for a, r in ((qa, qb), (ka, kb), (va, vb)):
        _close(a.grad.numpy(), r.grad.numpy())


def test_causal_alignment_at_unequal_lengths_follows_the_tpu_kernel():
    """S_q = 128 < S_k = 256, causal: the port's plain version equals the
    Pallas kernel (top-left diagonal) and differs from the JAX package's
    XLA reference ``_ref_with_lse`` (bottom-right) by O(1)."""
    q, k, v = _qkv(2, 128, 256, 64, 40)
    sm = 1.0 / np.sqrt(64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    po, plse = jfa._flash_fwd_pallas(jq, jk, jv, sm, True, interpret=True)
    ro, _ = jfa._ref_with_lse(jq[None], jk[None], jv[None], sm, True)
    o, lse = tfa.flash_fwd(*_t(q, k, v), sm, True)
    _close(o.numpy(), po)
    _close(lse.numpy(), plse)
    gap = np.abs(o.numpy() - np.asarray(ro)[0]).max()
    assert gap > 0.1, gap            # the recorded divergence
    # with S_q == S_k the two alignments are one
    q2 = q[:, :128]
    k2, v2 = k[:, :128], v[:, :128]
    ro2, _ = jfa._ref_with_lse(*(jnp.asarray(a)[None] for a in (q2, k2, v2)),
                               sm, True)
    _close(tfa.flash_fwd(*_t(q2, k2, v2), sm, True)[0].numpy(),
           np.asarray(ro2)[0])


@pytest.mark.parametrize("case", ["head_dim", "dtype", "kv_shape",
                                  "lse_dtype", "contiguous"])
def test_contract_refuses_bad_inputs_before_a_launch(case):
    q = torch.zeros(2, 8, 64)
    k = torch.zeros(2, 8, 64)
    v = torch.zeros(2, 8, 64)
    lse = torch.zeros(2, 8)
    if case == "head_dim":
        q, k, v = (torch.zeros(2, 8, 32) for _ in range(3))
    elif case == "dtype":
        k = k.to(torch.bfloat16)
    elif case == "kv_shape":
        v = torch.zeros(2, 9, 64)
    elif case == "lse_dtype":
        lse = lse.double()
    else:
        q = torch.zeros(2, 64, 8).transpose(1, 2)
    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        tfa._check(q, k, v, lse=lse)
