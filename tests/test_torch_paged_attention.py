"""The port's paged decode attention (K1) against the JAX package's.

The same numpy inputs go through ``paddle_tpu``'s Pallas kernel (in
interpret mode) and its gather reference, and through the port's plain
version ``_ref_paged_attention`` — the one a CPU tensor takes, and the
one ``chip_smoke.py`` holds the CUDA kernel against on the card.
Tolerance: float32, atol 1e-5 — both sides compute the same f32 softmax
over the same products; only summation order differs (~1e-7 here).

One deliberate divergence: a slot of length 0 reads as zeros in the
port, as both kernels (Pallas and CUDA) give it; the JAX gather
reference averages the whole masked frame there instead. The server
never decodes a length-0 slot (lengths are ``t + 1``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa

ATOL = 1e-5


def _case(S, nh, kvh, hd, pg, maxp, seed):
    rng = np.random.RandomState(seed)
    P = S * maxp + 1
    q = (rng.randn(S, nh, hd) * 0.5).astype(np.float32)
    kp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    vp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    bt = (rng.permutation(P - 1)[:S * maxp] + 1).reshape(S, maxp)
    return q, kp, vp, bt.astype(np.int32)


def _port(q, kp, vp, bt, lengths, scale):
    return tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(bt),
                               torch.from_numpy(lengths), scale).numpy()


@pytest.mark.parametrize("nh,kvh,hd", [(4, 4, 16), (4, 2, 16), (8, 1, 32),
                                       (16, 2, 64)])
def test_plain_version_matches_jax_kernel_and_reference(nh, kvh, hd):
    """MHA and GQA up to 8x; lengths 0, 1, page-unaligned, the full
    table, and the parked ``T + 1`` (clamped to the table)."""
    S, pg, maxp = 6, 8, 4
    T = pg * maxp
    q, kp, vp, bt = _case(S, nh, kvh, hd, pg, maxp, seed=nh + kvh)
    lengths = np.array([0, 1, 5, 13, T, T + 1], np.int32)
    scale = hd ** -0.5
    got = _port(q, kp, vp, bt, lengths, scale)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lengths), scale)
    kern = np.asarray(jpa._paged_attention_pallas(*args, interpret=True))
    ref = np.asarray(jpa._ref_paged_attention(*args))
    np.testing.assert_allclose(got, kern, rtol=0, atol=ATOL)
    live = lengths > 0
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=ATOL)
    assert not got[~live].any()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, kp, vp, bt = _case(2, 2, 2, 16, 4, 2, seed=3)
    lengths = np.array([3, 8], np.int32)
    before = tpa.paged_attention.launches
    out = _port(q, kp, vp, bt, lengths, None)        # default 1/sqrt(hd)
    ref = tpa._ref_paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(lengths), 16 ** -0.5)
    np.testing.assert_array_equal(out, ref.numpy())
    assert tpa.paged_attention.launches == before


@pytest.mark.parametrize("bad", ["gqa_ratio", "head_dim", "dtype",
                                 "bt_dtype", "lengths_shape",
                                 "contiguity"])
def test_kernel_contract_is_checked_before_launch(bad):
    """What the CUDA kernel does not take raises in the wrapper, before
    any pointer leaves Python."""
    S, nh, kvh, hd, P, pg, maxp = 2, 4, 2, 16, 5, 4, 2
    q = torch.zeros(S, nh, hd)
    kp = torch.zeros(P, pg, kvh, hd)
    bt = torch.zeros(S, maxp, dtype=torch.int32)
    lengths = torch.ones(S, dtype=torch.int32)
    if bad == "gqa_ratio":
        q = torch.zeros(S, 18, hd)
        kp = torch.zeros(P, pg, 1, hd)
    elif bad == "head_dim":
        q, kp = torch.zeros(S, nh, 24), torch.zeros(P, pg, kvh, 24)
    elif bad == "dtype":
        q = q.half()
    elif bad == "bt_dtype":
        bt = bt.long()
    elif bad == "lengths_shape":
        lengths = torch.ones(S + 1, dtype=torch.int32)
    else:
        q = torch.zeros(S, hd, nh).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        tpa._check(q, kp, kp.clone(), bt, lengths)
