"""The port's fused prefill/decode tick (K3 and ``serving_mode="fused"``)
against the JAX package's, on CPU.

- Schedule: ``build_schedule`` and ``_ladder`` equal the JAX ones on the
  reference's cases and on seeded random ``last`` vectors.
- Kernel: the plain version ``_ref_fused_tick`` — the one a CPU tensor
  takes and the one ``chip_smoke.py`` holds the CUDA kernel against —
  matches the Pallas kernel (interpret mode) and the JAX gather
  reference on mixed phases (a cold chunk, a chunk at a prefix offset, a
  decode row, an idle slot), MHA and GQA; float32, atol 2e-5 as the JAX
  tests use (same f32 softmax, another summation order). Idle slots are
  exact zeros. Pages past every slot's frontier, poisoned with large
  finite values, move no bit of a live row. The contract is checked
  before any launch. A decode-only tick split and merged as the bf16
  kernel does it over each slot's schedule run (``_ref_split_decode``,
  split sizes of 1, 2 and 5 entries) equals the Pallas kernel at C = 1.
- Bundle: the fused-tick entry's logits equal the JAX fused entry's
  within 1e-4 at one mixed tick, with bridged weights. On torch's CPU
  the fused decode row is bitwise equal to the split decode step when
  the live slice spans at least 32 positions, at every chunk width; at a
  16-position slice it differs by ~6e-7 (a measured property of this
  torch build, recorded in ROADMAP Queue 3), so there it is held to 1e-5.
  A mixed tick runs its decode rows as a pass of their own at C = 1:
  their logits and K/V equal a decode-only tick's bit for bit.
- Server: ``serving_mode="fused"`` emits greedy tokens equal to the JAX
  fused server and to the port's split server (prompt lengths 1, pg-1,
  pg and multi-page, a chunk-straddling budget, an automatic prefix hit),
  every tick dispatches once (``{"fused": 1}``), a cancel and a deadline
  mid-prefill leak no page, only emitting slots count non-finite logits,
  the tick's inputs reach the device as views of one buffer, the serve
  thread works on fused ticks, and the JAX server's ``serving_mode``
  refusals hold.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.inference.continuous_batching import \
    ContinuousBatchingServer as JaxServer
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu.ops.pallas import fused_tick as jft
from paddle_tpu_torch.inference import ContinuousBatchingServer
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny,
                                     load_jax_params)
from paddle_tpu_torch.ops.kernels import fused_tick as tft
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.ops.kernels import ragged_prefill as trp
from paddle_tpu_torch.telemetry.clock import FakeClock

ATOL = 2e-5
MCL, PG = 64, 8


@functools.lru_cache(maxsize=1)
def _models():
    pt.seed(21)
    jm = JaxLlama(jax_llama_tiny())
    jm.eval()
    tm = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_params(tm, {n: p.numpy() for n, p in jm.named_parameters()})
    return jm, tm


# ------------------------------------------------------------- schedule


@pytest.mark.parametrize("last,pg,n_slots", [
    ([7, -1, 0, 8], 4, 4), ([-1, -1], 4, None), ([4 * 9 - 1], 4, None),
    ([0], 16, 3), ([2047, 100, -1, 511, 16, 15, 2047, 0], 16, 8)])
def test_build_schedule_matches_jax(last, pg, n_slots):
    want = jft.build_schedule(last, pg, n_slots=n_slots)
    got = tft.build_schedule(last, pg, n_slots=n_slots)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


@pytest.mark.parametrize("seed", range(4))
def test_build_schedule_and_ladder_match_jax_on_random_slots(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 12))
    pg = int(rng.choice([4, 8, 16]))
    last = np.where(rng.random(S) < 0.3, -1,
                    rng.integers(0, 2048, S)).astype(np.int32)
    want = jft.build_schedule(last, pg, n_slots=S)
    got = tft.build_schedule(last, pg, n_slots=S)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    for n in rng.integers(0, 5000, 20):
        assert tft._ladder(n, 8) == jft._ladder(n, 8)


# --------------------------------------------------------------- kernel


def _mixed(nh, kvh, hd, seed, S=4, C=4, P=24, pg=4, W=5):
    """Slot 0: a cold chunk of 4 rows. Slot 1: one decode row at t=9.
    Slot 2: idle. Slot 3: a 3-row chunk at the prefix offset 13 (ending
    mid-page)."""
    rng = np.random.RandomState(seed)
    q = (rng.randn(S, C, nh, hd) * 0.5).astype(np.float32)
    kp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    vp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    bt = (rng.permutation(P - 1)[:S * W] + 1).reshape(S, W).astype(np.int32)
    t0 = np.array([0, 9, W * pg, 13], np.int32)
    last = np.array([3, 9, -1, 15], np.int32)
    dec = np.array([0, 1, 0, 0], np.int32)
    ss, sp, _ = tft.build_schedule(last, pg, n_slots=S)
    return q, kp, vp, bt, t0, last, dec, ss, sp


def _live_rows(t0, last, dec):
    """{slot: rows compared}: all of a prefill slot's take, row 0 of a
    decode slot."""
    return {s: (1 if dec[s] else int(last[s] - t0[s] + 1))
            for s in range(len(last)) if last[s] >= 0}


@pytest.mark.parametrize("nh,kvh,hd", [(2, 2, 16), (4, 2, 16), (8, 1, 32),
                                       (8, 4, 64)])
def test_plain_version_matches_jax_kernel_and_reference(nh, kvh, hd):
    q, kp, vp, bt, t0, last, dec, ss, sp = _mixed(nh, kvh, hd, seed=nh + hd)
    scale = hd ** -0.5
    got = tft.fused_tick_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, t0, last, dec, ss,
                                        sp)), sm_scale=scale).numpy()
    j = [jnp.asarray(a) for a in (q, kp, vp, bt, t0, last, dec, ss, sp)]
    kern = np.asarray(jft.fused_tick_attention(*j, sm_scale=scale,
                                               interpret=True))
    ref = np.asarray(jft._ref_fused_tick(j[0], j[1], j[2], j[3], j[4], j[6],
                                         scale))
    for s, n in _live_rows(t0, last, dec).items():
        np.testing.assert_allclose(got[s, :n], kern[s, :n], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got[s, :n], ref[s, :n], rtol=0,
                                   atol=ATOL)
    # the idle slot reads as exact zeros on both packages
    assert not got[2].any() and not kern[2].any()
    # the plain version zeroes a decode slot's rows past row 0, as the
    # JAX gather reference does
    assert not got[1, 1:].any() and not ref[1, 1:].any()


def test_pages_past_the_frontier_are_never_seen():
    """Poison every pool row no live row may attend to — all pages of
    the idle slot, the pages past each slot's frontier, and the rows
    past ``last`` inside a slot's last page — with large finite values:
    no bit of a live row moves, in the port's plain version or in the
    JAX kernel."""
    q, kp, vp, bt, t0, last, dec, ss, sp = _mixed(4, 2, 16, seed=7)
    pg = kp.shape[1]
    scale = 0.3

    def run(kp_, vp_):
        port = tft.fused_tick_attention(
            *(torch.from_numpy(a) for a in (q, kp_, vp_, bt, t0, last, dec,
                                            ss, sp)), sm_scale=scale).numpy()
        j = [jnp.asarray(a) for a in (q, kp_, vp_, bt, t0, last, dec, ss,
                                      sp)]
        return port, np.asarray(jft.fused_tick_attention(
            *j, sm_scale=scale, interpret=True))

    clean = run(kp, vp)
    kp2, vp2 = kp.copy(), vp.copy()
    live = {}                      # page id -> first row past the frontier
    for s in range(len(last)):
        if last[s] < 0:
            continue
        for p in range(last[s] // pg + 1):
            live[int(bt[s, p])] = pg if p < last[s] // pg \
                else int(last[s] % pg) + 1
    for pid in range(kp.shape[0]):
        cut = live.get(pid, 0)
        kp2[pid, cut:] = 1e3
        vp2[pid, cut:] = -1e3
    poisoned = run(kp2, vp2)
    for a, b in zip(clean, poisoned):
        for s, n in _live_rows(t0, last, dec).items():
            np.testing.assert_array_equal(a[s, :n], b[s, :n])


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, kp, vp, bt, t0, last, dec, ss, sp = _mixed(4, 2, 16, seed=3)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, t0, last, dec, ss,
                                          sp)]
    before = tft.fused_tick_attention.launches
    got = tft.fused_tick_attention(*args)
    want = tft._ref_fused_tick(*args[:7], 16 ** -0.5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tft.fused_tick_attention.launches == before


@pytest.mark.parametrize("bad", [
    "rank", "kv_heads", "rep", "head_dim", "dtype", "bt_dtype", "bt_rows",
    "t0_dtype", "last_shape", "dec_shape", "sched_dtype", "sched_len",
    "sched_rank", "sched_empty", "contiguity", "device_mix"])
def test_kernel_contract_is_checked_before_launch(bad):
    S, C, nh, kvh, hd, P, pg, W = 2, 4, 4, 2, 16, 5, 4, 2
    t = {"q": torch.zeros(S, C, nh, hd), "kp": torch.zeros(P, pg, kvh, hd),
         "bt": torch.zeros(S, W, dtype=torch.int32),
         "t0": torch.zeros(S, dtype=torch.int32),
         "last": torch.zeros(S, dtype=torch.int32),
         "dec": torch.zeros(S, dtype=torch.int32),
         "ss": torch.zeros(8, dtype=torch.int32),
         "sp": torch.zeros(8, dtype=torch.int32)}
    if bad == "rank":
        t["q"] = t["q"][:, 0]
    elif bad == "kv_heads":
        t["kp"] = torch.zeros(P, pg, 3, hd)
    elif bad == "rep":
        t["q"] = torch.zeros(S, C, 18, hd)
        t["kp"] = torch.zeros(P, pg, 1, hd)
    elif bad == "head_dim":
        t["q"] = torch.zeros(S, C, nh, 32)
        t["kp"] = torch.zeros(P, pg, kvh, 32)
    elif bad == "dtype":
        t["q"] = t["q"].double()
    elif bad == "bt_dtype":
        t["bt"] = t["bt"].long()
    elif bad == "bt_rows":
        t["bt"] = t["bt"][:1]
    elif bad == "t0_dtype":
        t["t0"] = t["t0"].long()
    elif bad == "last_shape":
        t["last"] = t["last"][:1]
    elif bad == "dec_shape":
        t["dec"] = torch.zeros(S, 1, dtype=torch.int32)
    elif bad == "sched_dtype":
        t["sp"] = t["sp"].long()
    elif bad == "sched_len":
        t["sp"] = t["sp"][:4]
    elif bad == "sched_rank":
        t["ss"], t["sp"] = t["ss"].reshape(2, 4), t["sp"].reshape(2, 4)
    elif bad == "sched_empty":
        t["ss"], t["sp"] = t["ss"][:0], t["sp"][:0]
    elif bad == "contiguity":
        t["q"] = torch.zeros(S, nh, C, hd).transpose(1, 2)
    else:
        t["ss"] = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises((TypeError, ValueError)):
        tft._check(t["q"], t["kp"], t["kp"].clone(), t["bt"], t["t0"],
                   t["last"], t["dec"], t["ss"], t["sp"])


@pytest.mark.parametrize("pps", [1, 2, 5])
@pytest.mark.parametrize("nh,kvh,hd", [(4, 4, 16), (8, 1, 32), (8, 4, 64)])
def test_split_and_merge_over_the_schedule_match_the_pallas_kernel(
        pps, nh, kvh, hd):
    """A decode-only tick (C = 1) as the bf16 kernel splits it: slot s
    walks its run of the schedule, entry e being the live table's column
    sp[lo + e] at positions sp[lo + e] * pg .., visible up to min(t0,
    last); split every ``pps`` entries and merged in index order
    (``_ref_split_decode``), it equals the JAX kernel in interpret mode
    and the port's plain version within ATOL; an idle slot is zeros."""
    rng = np.random.RandomState(pps + nh + hd)
    S, pg, W, P = 5, 4, 6, 40
    q = (rng.randn(S, 1, nh, hd) * 0.5).astype(np.float32)
    kp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    vp = (rng.randn(P, pg, kvh, hd) * 0.5).astype(np.float32)
    bt = (rng.permutation(P - 1)[:S * W] + 1).reshape(S, W).astype(np.int32)
    last = np.array([0, 3, 4, W * pg - 1, -1], np.int32)
    t0 = np.where(last >= 0, last, W * pg).astype(np.int32)
    dec = (last >= 0).astype(np.int32)
    ss, sp, _ = tft.build_schedule(last, pg, n_slots=S)
    pages = np.full((S, W), -1, np.int32)
    bases = np.zeros((S, W), np.int32)
    for s in range(S):
        run = sp[ss == s]
        pages[s, :len(run)] = bt[s, run]
        bases[s, :len(run)] = run * pg
    lim = np.minimum(t0, last)
    scale = hd ** -0.5
    got = tpa._ref_split_decode(
        torch.from_numpy(q[:, 0]), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pages), torch.from_numpy(bases),
        torch.from_numpy(lim), scale, pps).numpy()
    kern = np.asarray(jft._fused_tick_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, t0, ss, sp)), scale,
        interpret=True))[:, 0]
    port = tft.fused_tick_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, t0, last, dec, ss,
                                        sp)), sm_scale=scale).numpy()[:, 0]
    live = last >= 0
    np.testing.assert_allclose(got[live], kern[live], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, port, rtol=0, atol=ATOL)
    assert not got[~live].any()


# ------------------------------------------------------------ the bundle


def _copy(c):
    return {"pool": {"k": c["pool"]["k"].clone(),
                     "v": c["pool"]["v"].clone()}, "bt": c["bt"].clone()}


def test_fused_entry_logits_match_jax_with_bridged_weights():
    """One mixed tick after a prefill: slot 0 a cold 12-token chunk
    (C=16), slot 1 a decode row at t=9, slot 2 idle, over the live
    slice of the block tables (W=2 pages of 8)."""
    jm, tm = _models()
    NP, S = 17, 3
    jb = jm._decode_bundle(MCL, cache_backend="paged", page_size=PG,
                           num_pages=NP)
    tb = tm._decode_bundle(MCL, cache_backend="paged", page_size=PG,
                           num_pages=NP)
    assert len(tb) == len(jb) == 7
    rng = np.random.default_rng(0)
    bt = np.zeros((S, MCL // PG), np.int32)
    bt[0, :2], bt[1, :2] = [1, 2], [3, 4]
    C = 16
    toks = np.zeros((S, C), np.int32)
    toks[1, :9] = rng.integers(0, 256, 9)
    t0 = np.array([MCL, 0, MCL], np.int32)
    out_idx = np.array([0, 8, 0], np.int32)
    jc = dict(jb[0](S), bt=jnp.asarray(bt))
    jl, jc = jb[5](jnp.asarray(toks), jnp.asarray(t0), jc,
                   jnp.asarray(out_idx))
    tc = tb[0](S)
    tc["bt"].copy_(torch.from_numpy(bt))
    tl, tc = tb[5](torch.from_numpy(toks), torch.from_numpy(t0), tc,
                   torch.from_numpy(out_idx))
    nxt = int(np.argmax(np.asarray(jl)[1]))
    assert nxt == int(tl[1].argmax())

    toks = np.zeros((S, C), np.int32)
    toks[0, :12] = rng.integers(0, 256, 12)
    toks[1, 0] = nxt
    t0 = np.array([0, 9, MCL], np.int32)
    last = np.array([11, 9, -1], np.int32)
    dec = np.array([0, 1, 0], np.int32)
    out_idx = np.array([11, 0, 0], np.int32)
    bt_live = np.ascontiguousarray(bt[:, :2])
    ss, sp, _ = tft.build_schedule(last, PG, n_slots=S)
    host = (toks, t0, last, dec, out_idx, bt_live, ss, sp)
    ja = [jnp.asarray(a) for a in host]
    jl2, jc = jb[6](*ja[:4], jc, *ja[4:])
    ta = [torch.from_numpy(a) for a in host]
    tl2, tc = tb[6](*ta[:4], tc, *ta[4:])
    np.testing.assert_allclose(tl2[:2].numpy(), np.asarray(jl2)[:2], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tc["pool"]["k"][:, 1:].numpy(),
                               np.asarray(jc["pool"]["k"])[:, 1:], rtol=0,
                               atol=1e-4)
    assert np.isfinite(tl2.numpy()).all()
    assert tft.fused_tick_attention.launches == 0     # CPU: plain version


def test_fused_decode_row_against_the_split_step_across_widths():
    """The fused entry's decode-row logits against the split decode step
    on the same cache, at chunk widths 1/2/4 and live widths 2/4/8
    pages: bitwise from 32 live positions up, within 1e-5 at 16."""
    _, tm = _models()
    S = 2
    init, embed, step, head, _, ragged, fused = tm._decode_bundle(
        MCL, cache_backend="paged", page_size=PG, num_pages=33)
    rng = np.random.default_rng(0)
    caches = init(S)
    bt = np.zeros((S, MCL // PG), np.int32)
    bt[0, :3], bt[1, :3] = [1, 2, 3], [4, 5, 6]
    caches["bt"].copy_(torch.from_numpy(bt))
    toks = np.zeros((S, 16), np.int32)
    toks[0, :12] = rng.integers(0, 256, 12)
    lg, caches = ragged(torch.from_numpy(toks),
                        torch.tensor([0, MCL], dtype=torch.int32), caches,
                        torch.tensor([11, 0], dtype=torch.int32))
    nxt = int(lg[0].argmax())
    t = torch.tensor([12, MCL], dtype=torch.int32)
    out, _ = step(embed(torch.tensor([nxt, 0], dtype=torch.int32), t),
                  _copy(caches), t)
    split = head(out)[:, -1][0]
    last = np.array([12, -1], np.int32)
    ss, sp, _ = tft.build_schedule(last, PG, n_slots=S)
    for C in (1, 2, 4):
        tf = np.zeros((S, C), np.int32)
        tf[0, 0] = nxt
        for W in (2, 4, 8):
            lf, _ = fused(torch.from_numpy(tf), t, torch.from_numpy(last),
                          torch.tensor([1, 0], dtype=torch.int32),
                          _copy(caches), torch.zeros(S, dtype=torch.int32),
                          torch.from_numpy(np.ascontiguousarray(bt[:, :W])),
                          torch.from_numpy(ss), torch.from_numpy(sp))
            if W * PG >= 32:
                assert torch.equal(lf[0], split), (C, W)
            else:
                np.testing.assert_allclose(lf[0].numpy(), split.numpy(),
                                           rtol=0, atol=1e-5)
            assert int(lf[0].argmax()) == int(split.argmax())


def test_fused_decode_row_takes_a_pass_at_decode_shapes(monkeypatch):
    """A mixed tick (slot 0 a cold 12-token chunk, C=16; slot 1 a decode
    row at t=9; slot 2 idle) runs its decode rows as a pass of their own
    at C = 1 and its chunks as another at C = 16, one fused-tick call a
    layer each. The decode row's logits and the K/V it writes are
    bitwise those of a decode-only tick (C = 1) on the same cache: what
    else a tick packs moves no bit of a decode row."""
    from paddle_tpu_torch.models import generation
    _, tm = _models()
    S = 3
    init, _, _, _, _, ragged, fused = tm._decode_bundle(
        MCL, cache_backend="paged", page_size=PG, num_pages=17)
    rng = np.random.default_rng(0)
    caches = init(S)
    bt = np.zeros((S, MCL // PG), np.int32)
    bt[0, :2], bt[1, :2] = [1, 2], [3, 4]
    caches["bt"].copy_(torch.from_numpy(bt))
    toks = np.zeros((S, 16), np.int32)
    toks[1, :9] = rng.integers(0, 256, 9)
    lg, caches = ragged(torch.from_numpy(toks),
                        torch.tensor([MCL, 0, MCL], dtype=torch.int32),
                        caches, torch.tensor([0, 8, 0], dtype=torch.int32))
    nxt = int(lg[1].argmax())
    widths = []
    inner = generation._fused_attend

    def attend(q, *args):
        widths.append(q.shape[1])
        return inner(q, *args)

    monkeypatch.setattr(generation, "_fused_attend", attend)
    full = torch.from_numpy(bt)

    def tick(C, last, dec, out_idx, prompt=()):
        tf = np.zeros((S, C), np.int32)
        tf[0, :len(prompt)] = prompt
        tf[1, 0] = nxt
        t0 = np.array([0 if len(prompt) else MCL, 9, MCL], np.int32)
        ss, sp, _ = tft.build_schedule(last, PG, n_slots=S)
        return fused(torch.from_numpy(tf), torch.from_numpy(t0),
                     torch.from_numpy(np.asarray(last, np.int32)),
                     torch.from_numpy(np.asarray(dec, np.int32)),
                     _copy(caches), torch.from_numpy(
                         np.asarray(out_idx, np.int32)), full,
                     torch.from_numpy(ss), torch.from_numpy(sp))

    L = tm.cfg.num_layers
    mixed, mc = tick(16, [11, 9, -1], [0, 1, 0], [11, 0, 0],
                     rng.integers(0, 256, 12))
    assert widths == [1] * L + [16] * L
    widths.clear()
    alone, ac = tick(1, [-1, 9, -1], [0, 1, 0], [0, 0, 0])
    assert widths == [1] * L
    assert torch.equal(mixed[1], alone[1])
    for name in ("k", "v"):
        assert torch.equal(mc["pool"][name][:, 4, 1],
                           ac["pool"][name][:, 4, 1])
    assert torch.isfinite(mixed[:2]).all()


# ------------------------------------------------------------ the server


def _server(cls, model, **kw):
    kw.setdefault("prefill_tokens_per_tick", 4)
    return cls(model, max_slots=2, max_cache_len=MCL, cache_backend="paged",
               page_size=PG, **kw)


def _waves(n_vocab=256):
    rng = np.random.default_rng(5)
    wave1 = [rng.integers(0, n_vocab, (n,)).astype(np.int32)
             for n in (1, PG - 1, PG, 13, 17)]
    wave2 = [np.concatenate([wave1[4][:16],
                             rng.integers(0, n_vocab, (n,))
                             .astype(np.int32)]) for n in (2, 5)]
    return wave1, wave2


def _serve(srv, waves, n_new=6):
    toks = []
    for wave in waves:
        rids = [srv.submit(p, max_new_tokens=n_new) for p in wave]
        out = srv.run()
        toks += [out[r] for r in rids]
    return toks


def test_fused_server_tokens_equal_jax_fused_and_port_split():
    """Prompt lengths 1 / pg-1 / pg / multi-page through 2 slots under a
    4-token budget (chunks straddle ticks), then a second wave that
    resumes from an automatic prefix hit."""
    jm, tm = _models()
    waves = _waves()
    jf = _server(JaxServer, jm, serving_mode="fused")
    tf = _server(ContinuousBatchingServer, tm, serving_mode="fused")
    ts = _server(ContinuousBatchingServer, tm)
    want, got, split = _serve(jf, waves), _serve(tf, waves), _serve(ts, waves)
    for a, b, c in zip(got, want, split):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert tf.serving_mode == "fused" and ts.serving_mode == "split"
    assert tf.stats["prefix_auto_hits"] == jf.stats["prefix_auto_hits"] >= 1
    for k in ("admissions", "prefill_tokens", "prefix_auto_hit_tokens",
              "prefill_dispatches", "tick_dispatches"):
        assert tf.stats[k] == jf.stats[k], k
    assert tf.stats["fused_launches"] == tf.stats["tick_dispatches"] > 0
    assert tf.stats["prefill_launches"] == tf.stats["decode_ticks"] == 0
    assert ts.stats["fused_launches"] == 0
    assert tf.stats["nonfinite_logit_rows"] == 0
    assert tuple(tf.pool_balance()) == tuple(jf.pool_balance())
    assert tf.pool_balance()[1] == 0
    assert tft.fused_tick_attention.launches == 0
    assert tpa.paged_attention.launches == 0
    assert trp.ragged_prefill_attention.launches == 0


def _tick_profiles(srv, prompts, budgets):
    rids = [srv.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    profiles = []
    while srv.queue_depth() or srv.in_flight():
        srv.step()
        if srv._tick_disp:
            profiles.append(dict(srv._tick_disp))
    out = srv.run()
    return profiles, [out[r] for r in rids]


def test_every_fused_tick_dispatches_once():
    """Steady-state AND admission ticks, slot refills mid-run included,
    show the dispatch profile ``{"fused": 1}``; the split server's
    admission ticks add prefill, state-push and block-table dispatches
    on the same work (so the comparison is not vacuous)."""
    _, tm = _models()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 11, 3, 9, 2)]
    budgets = (6, 3, 9, 4, 2)
    kw = {"max_slots": 3, "prefill_tokens_per_tick": 6}
    fused, tf = _tick_profiles(
        ContinuousBatchingServer(tm, max_cache_len=48, cache_backend="paged",
                                 page_size=4, serving_mode="fused", **kw),
        prompts, budgets)
    split, ts = _tick_profiles(
        ContinuousBatchingServer(tm, max_cache_len=48, cache_backend="paged",
                                 page_size=4, **kw), prompts, budgets)
    assert fused and all(d == {"fused": 1} for d in fused), fused
    assert max(sum(d.values()) for d in split) > 1
    for a, b in zip(tf, ts):
        np.testing.assert_array_equal(a, b)


def test_fused_cancel_and_deadline_mid_prefill_leak_free():
    _, tm = _models()
    clock = FakeClock()
    srv = ContinuousBatchingServer(tm, max_slots=1, max_cache_len=32,
                                   cache_backend="paged", page_size=4,
                                   serving_mode="fused",
                                   prefill_tokens_per_tick=2, clock=clock)
    usable = srv._kv.num_pages - 1
    long_p = (np.arange(20, dtype=np.int32) * 5) % 256
    ra = srv.submit(long_p, max_new_tokens=4)
    srv.step()                                   # mid-prefill
    assert srv.in_flight() == 1 and not srv._active.any()
    assert srv.cancel(ra) is True
    assert srv._results[ra].size == 0
    free, live, _, cached = srv.pool_balance()
    assert live == 0 and free + cached == usable

    rb = srv.submit(long_p, max_new_tokens=4, deadline_s=5.0)
    srv.step()
    clock.advance(10.0)                          # expires mid-prefill
    srv.step()
    free, live, _, cached = srv.pool_balance()
    assert live == 0 and free + cached == usable
    assert srv._results[rb].size == 0
    short = np.arange(4, dtype=np.int32)
    rc = srv.submit(short, max_new_tokens=3)
    want = _serve(_server(ContinuousBatchingServer, tm), [[short]], 3)[0]
    np.testing.assert_array_equal(srv.run()[rc], want)
    assert srv.pool_balance()[1] == 0


def test_fused_counts_nonfinite_logits_of_emitting_slots_only():
    """A NaN row of a slot that emits nothing this tick (idle, or mid-
    prefill short of its last chunk) is not counted; one of a slot that
    emits is."""
    _, tm = _models()
    srv = _server(ContinuousBatchingServer, tm, serving_mode="fused")
    inner = srv._fused_fn
    poison = {"rows": []}

    def fused_fn(*args):
        logits, caches = inner(*args)
        logits = logits.clone()
        logits[poison["rows"]] = float("nan")
        return logits, caches

    srv._fused_fn = fused_fn
    long_p = np.arange(10, dtype=np.int32)
    srv.submit(long_p, max_new_tokens=3)   # slot 0: 10 rows, 4 per tick
    poison["rows"] = [0, 1]                # slot 0 mid-prefill, slot 1 idle
    srv.step()
    assert srv.stats["nonfinite_logit_rows"] == 0
    srv.step()
    srv.step()                             # slot 0's last chunk: it emits
    assert srv.stats["nonfinite_logit_rows"] == 1
    poison["rows"] = []
    srv.run()
    assert srv.pool_balance()[1] == 0


def test_fused_serving_mode_validation_as_in_jax():
    _, tm = _models()
    kw = {"max_slots": 2, "max_cache_len": MCL, "page_size": PG}
    with pytest.raises(ValueError, match="serving_mode"):
        ContinuousBatchingServer(tm, cache_backend="paged",
                                 serving_mode="bogus", **kw)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingServer(tm, serving_mode="fused", **kw)
    with pytest.raises(ValueError, match="ragged"):
        ContinuousBatchingServer(tm, cache_backend="paged",
                                 prefill_mode="dense", serving_mode="fused",
                                 **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingServer(tm, cache_backend="paged",
                                 serving_mode="fused", mesh=object(), **kw)
    srv = ContinuousBatchingServer(tm, cache_backend="paged", **kw)
    assert srv.serving_mode == "split" and not srv._fused


def test_fused_tick_block_gt_1_raises_as_in_jax():
    jm, tm = _models()
    kw = {"max_slots": 2, "max_cache_len": MCL, "cache_backend": "paged",
          "page_size": PG, "serving_mode": "fused", "tick_block": 4}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        JaxServer(jm, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ContinuousBatchingServer(tm, **kw)


def test_fused_tick_inputs_ride_one_buffer():
    """The tick's eight small host arrays reach the device as views of
    ONE int32 buffer (one host-to-device copy), in argument order, with
    their shapes and values."""
    _, tm = _models()
    srv = _server(ContinuousBatchingServer, tm, serving_mode="fused")
    rng = np.random.default_rng(4)
    host = [rng.integers(-1, 50, shape).astype(np.int32)
            for shape in ((2, 4), (2,), (2,), (2,), (2,), (2, 3), (8,),
                          (8,))]
    views = srv._fused_inputs(*host)
    base = views[0].untyped_storage().data_ptr()
    for v, h in zip(views, host):
        assert v.untyped_storage().data_ptr() == base
        assert v.dtype == torch.int32 and v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), h)


def test_fused_serve_thread_matches_run():
    """``start``/``wait``/``stop(drain=True)`` on fused ticks: the serve
    thread gives the tokens a ``run()`` gives, and no page leaks."""
    _, tm = _models()
    wave1, _ = _waves()
    want = _serve(_server(ContinuousBatchingServer, tm), [wave1[2:4]])
    srv = _server(ContinuousBatchingServer, tm, serving_mode="fused").start()
    try:
        rids = [srv.submit(p, max_new_tokens=6) for p in wave1[2:4]]
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(srv.wait(rid, timeout=60), w)
    finally:
        srv.stop(drain=True)
    assert srv.pool_balance()[1] == 0 and srv.stats["fused_launches"] > 0
