"""The port's ``cross_entropy`` options, ``scaled_dot_product_attention``
with a mask, ``softmax`` and activation recompute, on the CPU.

- ``cross_entropy`` against ``paddle_tpu.nn.functional.cross_entropy``
  in f32 within 1e-5: hard labels with ``ignore_index``, ``reduction``
  mean / sum / none, ``label_smoothing``, ``axis`` 1 of a [N, C, L]
  input, labels with a trailing axis of 1, soft labels under each
  reduction; ``weight`` and ``use_softmax`` are accepted and not used,
  as in the reference (ROADMAP, Queue 3);
- ``scaled_dot_product_attention`` with ``attn_mask`` (a [S, S] additive
  mask, a [B, H, S, S] one, causal and not) against the reference's
  composition within 1e-5, gradients through it finite; without a mask
  it takes K4's plain version; dropout outside training is the plain
  composition, inside training it drops the output as the reference
  does after the same ``seed()`` (``tests/test_torch_dropout.py`` holds
  the rest);
- ``softmax`` against the reference's;
- ``parallel.recompute`` and ``recompute_sequential``: outputs and
  gradients (of the inputs and of the parameters the layers hold) equal
  to the plain run's bit for bit, keyword arguments passed through.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.parallel import recompute, recompute_sequential

ATOL = 1e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(a):
    return pt.to_tensor(jnp.asarray(a)), torch.from_numpy(np.asarray(a))


def _labels(shape, n, seed, ignore=True):
    lab = np.random.default_rng(seed).integers(0, n, shape).astype(np.int64)
    if ignore:
        lab.reshape(-1)[::5] = -100
    return lab


CE_CASES = {
    "mean": ({}, (6, 11), (6,)),
    "sum": ({"reduction": "sum"}, (6, 11), (6,)),
    "none": ({"reduction": "none"}, (2, 5, 11), (2, 5)),
    "smoothing": ({"label_smoothing": 0.1}, (6, 11), (6,)),
    "smoothing-sum": ({"label_smoothing": 0.2, "reduction": "sum"},
                      (2, 5, 11), (2, 5)),
    "ignore_index": ({"ignore_index": 3}, (6, 11), (6,)),
    "axis": ({"axis": 1}, (3, 11, 4), (3, 4)),
    "axis-none": ({"axis": 1, "reduction": "none"}, (3, 11, 4), (3, 4)),
    "trailing-1": ({}, (6, 11), (6, 1)),
    "weight": ({"weight": "w"}, (6, 11), (6,)),
    "use_softmax": ({"use_softmax": False}, (6, 11), (6,)),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_hard_labels_match_the_reference(case):
    kw, xs, ls = CE_CASES[case]
    jx, tx = _pair(_x(xs, 1))
    jl, tl = _pair(_labels(ls, 11, 2))
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("weight") == "w":
        jkw["weight"], tkw["weight"] = _pair(np.linspace(0.5, 2, 11)
                                             .astype(np.float32))
    want = np.asarray(pt.nn.functional.cross_entropy(jx, jl, **jkw)._value)
    got = F.cross_entropy(tx, tl, **tkw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_soft_labels_match_the_reference(reduction):
    jx, tx = _pair(_x((2, 5, 11), 3))
    soft = np.random.default_rng(4).dirichlet(np.ones(11), (2, 5)).astype(
        np.float32)
    jl, tl = _pair(soft)
    want = np.asarray(pt.nn.functional.cross_entropy(
        jx, jl, soft_label=True, reduction=reduction)._value)
    got = F.cross_entropy(tx, tl, soft_label=True, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


MASKS = {"2d-causal": ((8, 8), True), "2d": ((8, 8), False),
         "4d": ((2, 3, 8, 8), False), "4d-causal": ((2, 3, 8, 8), True)}


@pytest.mark.parametrize("case", list(MASKS))
def test_sdpa_with_a_mask_matches_the_reference_composition(case):
    mshape, causal = MASKS[case]
    q, k, v = (_x((2, 8, 3, 16), s) for s in (5, 6, 7))
    mask = _x(mshape, 8)
    (jq, tq), (jk, tk), (jv, tv), (jm, tm) = map(_pair, (q, k, v, mask))
    want = np.asarray(pt.nn.functional.scaled_dot_product_attention(
        jq, jk, jv, attn_mask=jm, is_causal=causal)._value)
    tq.requires_grad_(True)
    got = F.scaled_dot_product_attention(tq, tk, tv, attn_mask=tm,
                                         is_causal=causal)
    assert got.shape == (2, 8, 3, 16)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    got.square().sum().backward()
    assert torch.isfinite(tq.grad).all()


def test_sdpa_without_a_mask_and_dropout_outside_training():
    q, k, v = (_x((1, 6, 2, 16), s) for s in (1, 2, 3))
    (jq, tq), (jk, tk), (jv, tv) = map(_pair, (q, k, v))
    want = np.asarray(pt.nn.functional.scaled_dot_product_attention(
        jq, jk, jv, is_causal=True)._value)
    np.testing.assert_allclose(
        F.scaled_dot_product_attention(tq, tk, tv, is_causal=True).numpy(),
        want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        F.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.3,
                                       is_causal=True,
                                       training=False).numpy(),
        want, rtol=0, atol=ATOL)
    pt.seed(4)
    ptt.seed(4)
    want = np.asarray(pt.nn.functional.scaled_dot_product_attention(
        jq, jk, jv, dropout_p=0.3)._value)
    got = F.scaled_dot_product_attention(tq, tk, tv, dropout_p=0.3).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("axis", [-1, 0])
def test_softmax_matches_the_reference(axis):
    jx, tx = _pair(_x((4, 9), 11))
    want = np.asarray(pt.nn.functional.softmax(jx, axis=axis)._value)
    np.testing.assert_allclose(F.softmax(tx, axis=axis).numpy(), want,
                               rtol=0, atol=1e-7)


class _Block(torch.nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = torch.nn.Parameter(torch.randn(8, 8, generator=g) * 0.3)

    def forward(self, x, shift=0.0):
        return torch.tanh(x @ self.w + shift)


def _grads(blocks, x, run):
    x = x.clone().requires_grad_(True)
    out = run(x)
    out.square().sum().backward()
    grads = [x.grad.clone()] + [b.w.grad.clone() for b in blocks]
    for b in blocks:
        b.w.grad = None
    return out.detach(), grads


def test_recompute_gives_the_plain_gradients():
    blocks = [_Block(s) for s in range(4)]
    x = torch.from_numpy(_x((5, 8), 12))

    def plain(t):
        for b in blocks:
            t = b(t, shift=0.1)
        return t

    def rec(t):
        for b in blocks:
            t = recompute(b, t, shift=0.1)
        return t

    want = _grads(blocks, x, plain)
    got = _grads(blocks, x, rec)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    seq = _grads(blocks, x, lambda t: recompute_sequential(
        {"segments": 2}, blocks, t))
    plain0 = _grads(blocks, x, lambda t: blocks[3](blocks[2](blocks[1](
        blocks[0](t)))))
    assert torch.equal(seq[0], plain0[0])
    assert all(torch.equal(a, b) for a, b in zip(seq[1], plain0[1]))
    # no input needs grad: the parameters still get theirs
    out = recompute(blocks[0], x)
    out.sum().backward()
    assert blocks[0].w.grad is not None
