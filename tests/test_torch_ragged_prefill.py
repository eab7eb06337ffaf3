"""The port's ragged prefill attention (K2) against the JAX package's.

The same numpy inputs go through ``paddle_tpu``'s Pallas kernel (in
interpret mode), its public fallback (gather reference plus the idle-
slot zeroing) and through the port's plain version
``_ref_ragged_prefill`` — the one a CPU tensor takes, and the one
``chip_smoke.py`` holds the CUDA kernel against on the card.
Tolerance: float32, atol 1e-5 — same f32 softmax over the same
products, only summation order differs.

The edge shapes of the CUDA kernel's bf16 tiling (64 query vectors a
block: 64 / rep rows x the rep heads of a GQA group) are held on the CPU
too: a chunk that is not a multiple of the row tile, rep 4, prefix
resumes at a page boundary and mid-page, and a slot that ends at the
table's last column.

Rows past a slot's ``last`` (chunk padding) are garbage callers
discard: the kernels stop their keys at ``last``, the gather versions
do not, so kernel comparisons cover live rows and idle slots only.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import ragged_prefill as jrp
from paddle_tpu_torch.ops.kernels import ragged_prefill as trp

ATOL = 1e-5


def _case(S, C, nh, kvh, hd, pg, maxp, seed):
    rng = np.random.RandomState(seed)
    P = S * maxp + 1
    q = (rng.randn(S, C, nh, hd) * 0.5).astype(np.float32)
    kp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    vp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    bt = (rng.permutation(P - 1)[:S * maxp] + 1).reshape(S, maxp)
    return q, kp, vp, bt.astype(np.int32)


@pytest.mark.parametrize("nh,kvh,hd", [(2, 2, 16), (4, 2, 16), (8, 1, 32),
                                       (8, 4, 64)])
def test_plain_version_matches_jax_kernel_and_fallback(nh, kvh, hd):
    """A cold chunk, a page-aligned and a mid-page prefix resume
    (t0 > 0), a chunk ending mid-page, and an idle slot (the
    scheduler's ``t0 = T`` sentinel with ``last = -1``)."""
    S, C, pg, maxp = 5, 8, 4, 8
    T = pg * maxp
    q, kp, vp, bt = _case(S, C, nh, kvh, hd, pg, maxp, seed=nh * kvh)
    t0 = np.array([0, 8, 13, T, 2], np.int32)
    takes = np.array([8, 5, 6, 0, 3], np.int32)
    last = np.where(takes > 0, t0 + takes - 1, -1).astype(np.int32)
    scale = hd ** -0.5
    got = trp.ragged_prefill_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, t0, last)),
        sm_scale=scale).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, t0)]
    fallback = np.asarray(jrp.ragged_prefill_attention(
        *jargs, last=jnp.asarray(last), sm_scale=scale))
    np.testing.assert_allclose(got, fallback, rtol=0, atol=ATOL)
    kern = np.asarray(jrp._ragged_prefill_pallas(
        *jargs, jnp.asarray(last), scale, interpret=True))
    ref = np.asarray(jrp._ref_ragged_prefill(*jargs, scale))
    for s in range(S):
        n = takes[s]
        np.testing.assert_allclose(got[s, :n], kern[s, :n], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got[s, :n], ref[s, :n], rtol=0,
                                   atol=ATOL)
    assert not got[3].any() and not kern[3].any()     # idle slot: zeros


# (nh, kvh, hd, C, t0 per slot, take per slot): C = 20 against the
# bf16 tile's 16 rows at rep 4 (and its 64 rows at rep 1, 32 at rep 2);
# resumes at a page boundary (t0 = 8, 4) and mid-page (13, 6, 1); slot 1
# of the first case ends at the table's last column (t0 + take = 32).
EDGE_CASES = [
    (8, 2, 16, 20, [0, 12, 13, 32, 8], [20, 20, 7, 0, 19]),
    (8, 2, 64, 20, [4, 6, 0, 32, 1], [20, 17, 20, 0, 3]),
    (4, 4, 16, 20, [8, 1, 0, 32, 13], [20, 20, 20, 0, 19]),
    (4, 2, 32, 20, [0, 8, 6, 32, 12], [20, 20, 11, 0, 20]),
]


@pytest.mark.parametrize("nh,kvh,hd,C,t0s,takes", EDGE_CASES)
def test_plain_version_matches_jax_kernel_at_the_tile_edges(nh, kvh, hd, C,
                                                            t0s, takes):
    S, pg, maxp = 5, 4, 8
    q, kp, vp, bt = _case(S, C, nh, kvh, hd, pg, maxp, seed=nh + hd + C)
    t0 = np.array(t0s, np.int32)
    takes = np.array(takes, np.int32)
    last = np.where(takes > 0, t0 + takes - 1, -1).astype(np.int32)
    assert last.max() <= pg * maxp - 1
    scale = hd ** -0.5
    got = trp.ragged_prefill_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, t0, last)),
        sm_scale=scale).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, t0)]
    kern = np.asarray(jrp._ragged_prefill_pallas(
        *jargs, jnp.asarray(last), scale, interpret=True))
    for s in range(S):
        n = takes[s]
        np.testing.assert_allclose(got[s, :n], kern[s, :n], rtol=0,
                                   atol=ATOL)
    assert not got[3].any() and not kern[3].any()     # idle slot: zeros


def test_bf16_gqa_ratio_is_checked_before_launch():
    S, C, hd, P, pg, maxp = 1, 2, 16, 3, 4, 2
    bt = torch.zeros(S, maxp, dtype=torch.int32)
    t0 = torch.zeros(S, dtype=torch.int32)
    kp = torch.zeros(P, pg, 1, hd, dtype=torch.bfloat16)
    trp._check(torch.zeros(S, C, 64, hd, dtype=torch.bfloat16), kp, kp, bt,
               t0, t0)
    with pytest.raises(ValueError, match="kv head"):
        trp._check(torch.zeros(S, C, 128, hd, dtype=torch.bfloat16), kp, kp,
                   bt, t0, t0)
    trp._check(torch.zeros(S, C, 128, hd), kp.float(), kp.float(), bt, t0,
               t0)                                  # f32: any ratio


def test_default_last_covers_every_row():
    q, kp, vp, bt = _case(2, 4, 2, 2, 16, 4, 4, seed=9)
    t0 = torch.tensor([0, 5], dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt)]
    before = trp.ragged_prefill_attention.launches
    got = trp.ragged_prefill_attention(*args, t0)
    want = trp._ref_ragged_prefill(*args, t0, t0 + 3, 16 ** -0.5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert trp.ragged_prefill_attention.launches == before


@pytest.mark.parametrize("bad", ["rank", "kv_heads", "t0_dtype",
                                 "last_shape", "device_mix"])
def test_kernel_contract_is_checked_before_launch(bad):
    S, C, nh, kvh, hd, P, pg, maxp = 2, 4, 4, 2, 16, 5, 4, 2
    q = torch.zeros(S, C, nh, hd)
    kp = torch.zeros(P, pg, kvh, hd)
    bt = torch.zeros(S, maxp, dtype=torch.int32)
    t0 = torch.zeros(S, dtype=torch.int32)
    last = torch.zeros(S, dtype=torch.int32)
    if bad == "rank":
        q = q[:, 0]
    elif bad == "kv_heads":
        kp = torch.zeros(P, pg, 3, hd)
    elif bad == "t0_dtype":
        t0 = t0.long()
    elif bad == "last_shape":
        last = last[:1]
    else:
        t0 = torch.zeros(S, dtype=torch.int32, device="meta")
    with pytest.raises((TypeError, ValueError)):
        trp._check(q, kp, kp.clone(), bt, t0, last)
