"""The port's paged decode attention (K1) against the JAX package's.

The same numpy inputs go through ``paddle_tpu``'s Pallas kernel (in
interpret mode) and its gather reference, and through the port's plain
version ``_ref_paged_attention`` — the one a CPU tensor takes, and the
one ``chip_smoke.py`` holds the CUDA kernel against on the card.
Tolerance: float32, atol 1e-5 — both sides compute the same f32 softmax
over the same products; only summation order differs (~1e-7 here).

The bf16 kernel's split plan (``decode_split_plan``) covers every
visible key exactly once from static shapes alone, and its split and
merge (``_ref_split_decode``, the kernel's order of operations) equals
the Pallas kernel at split sizes down to one page, with splits that see
no key.

One deliberate divergence: a slot of length 0 reads as zeros in the
port, as both kernels (Pallas and CUDA) give it; the JAX gather
reference averages the whole masked frame there instead. The server
never decodes a length-0 slot (lengths are ``t + 1``).
"""
import inspect

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


# ------------------------------------------------ the bf16 split and merge


@pytest.mark.parametrize("S,nh,kvh,hd,pg,pages,sm", [
    (8, 32, 32, 128, 16, 128, 132),     # Llama-2-7B serve: 8 splits of 16
    (8, 64, 8, 128, 16, 128, 132),      # Llama-2-70B's GQA: 16 splits of 8
    (3, 4, 2, 16, 8, 8, 132),           # llama_tiny-sized: one split
    (2, 4, 4, 64, 4, 48, 132),
    (8, 32, 32, 128, 16, 5, 132),       # a narrow live slice (K3's W)
    (1, 8, 1, 64, 1, 300, 4),
    (4, 8, 8, 128, 300, 3, 132)])       # pages longer than a split's keys
def test_split_plan_covers_every_key_once(S, nh, kvh, hd, pg, pages, sm):
    """Split z walks keys z * pps * pg .. of the visible prefix: for
    lengths 0, 1, pg - 1, pg, the span and the span + 1, the splits cover
    each visible key exactly once and nothing else; no split lies wholly
    past the table; the workspace holds (acc, m, l) per split."""
    plan = tpa.decode_split_plan(S, nh, kvh, hd, pg, pages, sm)
    pps, splits = plan.pages_per_split, plan.splits
    assert 1 <= pps <= tpa.MAX_SPLIT_PAGES
    assert (splits - 1) * pps < pages <= splits * pps
    assert plan.workspace == ((S, nh, splits, hd + 2) if splits > 1
                              else None)
    span = pages * pg
    for length in (0, 1, pg - 1, pg, span, span + 1):
        visible = min(length, span)
        seen = []
        for z in range(splits):
            lo = z * pps * pg
            seen.extend(range(lo, min(lo + pps * pg, visible)))
        assert seen == list(range(visible)), length


def test_split_plan_depends_on_static_shapes_only():
    """The plan takes shapes and the SM count, never the lengths (they
    live on the card), and fills the card at least four times over
    unless a split is already down to one 64-key tile."""
    assert list(inspect.signature(tpa.decode_split_plan).parameters) == [
        "S", "nh", "kvh", "hd", "pg", "pages", "sm_count"]
    for S, kvh, pg, pages in ((8, 32, 16, 128), (8, 8, 16, 128),
                              (1, 1, 16, 128), (8, 32, 16, 64)):
        plan = tpa.decode_split_plan(S, 8 * kvh, kvh, 128, pg, pages, 132)
        assert plan == tpa.decode_split_plan(S, 8 * kvh, kvh, 128, pg,
                                             pages, 132)
        assert (S * kvh * plan.splits >= 4 * 132
                or plan.pages_per_split // 2 * pg < tpa.KEY_TILE)
    assert tpa.decode_split_plan(8, 32, 32, 128, 16, 128, 132)[:2] == (16, 8)
    assert tpa.decode_split_plan(8, 64, 8, 128, 16, 128, 132)[:2] == (8, 16)


@pytest.mark.parametrize("pps", [1, 2, 3, 16])
@pytest.mark.parametrize("nh,kvh,hd", [(4, 4, 16), (8, 1, 32), (16, 2, 64)])
def test_split_and_merge_match_jax_kernel_and_reference(pps, nh, kvh, hd):
    """The split kernels' arithmetic, split by split and merged in index
    order (``_ref_split_decode``), at split sizes of 1 to 16 pages over a
    16-page table (splits with no visible key among them): equal to the
    Pallas kernel in interpret mode and to the port's plain version
    within ATOL; zeros at length 0."""
    S, pg, maxp = 7, 4, 16
    T = pg * maxp
    q, kp, vp, bt = _case(S, nh, kvh, hd, pg, maxp, seed=pps + nh)
    lengths = np.array([0, 1, pg - 1, pg, 13, T, T + 1], np.int32)
    scale = hd ** -0.5
    bases = np.broadcast_to(np.arange(maxp) * pg, bt.shape)
    lim = np.minimum(lengths, T) - 1
    got = tpa._ref_split_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(bases.copy()),
        torch.from_numpy(lim), scale, pps).numpy()
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(bt), jnp.asarray(lengths), scale)
    kern = np.asarray(jpa._paged_attention_pallas(*args, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, _port(q, kp, vp, bt, lengths, scale),
                               rtol=0, atol=ATOL)
    assert not got[0].any()
