#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only build,k1,k2,k3
    python3 chip_smoke.py --only build,k4,k5,train_parity,train

Phases, in order; any failure exits non-zero:

1. card: name and power limit (nvidia-smi), TF32 switched off for
   float32 products and convolutions;
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc for
   sm_90a (one process per source, all at once), with ptxas's report;
3. k1: the paged-decode kernel against its plain version at Llama-2-7B
   decode shapes (and at Llama-2-70B's GQA head layout), bf16 and f32,
   within TOL and VEC_RTOL (below), with its time beside the plain version's, one SDPA call over the
   gathered frame (a yardstick the port never calls) and its bound;
4. k2: the ragged-prefill kernel likewise, on 512-row chunks with
   prefix offsets, an idle slot and a chunk ending mid-page;
5. k3: the fused-tick kernel likewise, on an admission tick (512-row
   chunks at prefix offsets, two decode rows, an idle slot, a chunk
   ending mid-page) and a decode-only tick (C = 1, K1's lengths, timed
   beside K1), plus a poison check: every page the schedule does not
   list filled with NaN must leave the live rows bit for bit unchanged;
6. k4: the flash-attention forward (K4a) and backward (K4b: dq, then
   dk + dv) against their plain versions, bf16 and f32, at llama_350m's
   training shape (B = 8, S = 1024, 16 heads of 64, causal), at
   Llama-2-7B's (B = 1, S = 4096, 32 heads of 128, causal), non-causal,
   and at S = 1000 (a tail tile): o, lse, dq, dk, dv within TOL and
   VEC_RTOL; two backward runs bitwise equal; times beside the plain
   version, one SDPA call (a yardstick the port never calls) and the
   bound;
7. k5: RMSNorm forward (K5a) and backward (K5b) likewise, at 8192 x 1024
   (llama_350m) and 4096 x 4096 (Llama-2-7B) rows x d, beside
   torch.nn.functional.rms_norm;
8. parity: a llama_tiny-shaped float32 model served on the card (the
   kernels) and on the CPU (the plain versions) from the same weights,
   on split ticks and on fused ticks, must emit equal greedy tokens:
   card == CPU on each, and fused == split; split runs launch K1 and K2
   only, fused runs K3 only;
9. train_parity: llama_tiny in float32 trained 3 steps (``train_step_fn``
   + ``AdamW``) on the card and on the CPU from one set of weights:
   per-step losses, step-1 gradients and the trained weights agree, and
   every step launches K4 forward, dq and dk + dv once per layer and K5
   forward and backward 2 x layers + 1 times;
10. serve: Llama-2-7B in bf16 (random weights from a seed, full width
   and depth) serves 8 requests through ``ContinuousBatchingServer``,
   on split and on fused ticks in the order split, fused, fused, split
   (a new server over the same model each time, the last one freed
   first); the launch counters are zeroed just before each wave and
   read just after, and must equal decode ticks x layers (K1) and
   prefill launches x layers (K2) on a split wave, fused launches x
   layers (K3) on a fused wave;
11. train: llama_350m in bf16 at full width and depth, AdamW(1e-4) with
   f32 moments, one fixed 8 x 1024 batch from seed 0: 2 warm-up steps,
   then 10 timed with the counters zeroed just before and read just
   after (K4: 10 x layers each, K5: 10 x (2 x layers + 1) each); the
   loss must fall and stay finite, gradients finite; step time,
   tokens/s, peak memory and a profile of one step.

The last two lines of standard output are the per-kernel JSON record
and ``{"ok": true, "device": {...}}``. Without a CUDA card, or without
the ``paddle_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "k1", "k2", "k3", "k4", "k5", "parity", "train_parity",
          "serve", "train")

# NVIDIA data sheets, dense rates: (bytes/s, bf16 FLOP/s, fp32 FLOP/s
# outside the tensor cores). The SXM part is the default.
CARD_PEAKS = {
    "H100 SXM": (3.35e12, 989e12, 67e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
}

# bf16 holds 8 significant bits: the kernels accumulate in f32 and round
# once at the output, so against the plain version evaluated in f32 on
# the same bf16 inputs the error is the output's rounding, <= 2^-8 of
# |out| (outputs here are below ~3), with room for summation order.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# An absolute bound sized for outputs of ~3 is loose for long-context
# rows, whose outputs average over ~1000 keys and shrink to ~0.05–0.1:
# a kernel that dropped some of their keys could pass it. So each output
# vector (one row under one query head) is also held to its own scale:
# its largest error over the head dims over its largest |value|. The
# kernels' own share is ~2^-8 in bf16 (output rounding, and K3's bf16
# probabilities in P V) and ~1e-5 in f32.
VEC_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def log(*a):
    print(*a, flush=True)


def agreement(pairs, dname, floor=0.0):
    """Largest absolute error and largest vector-relative error (see
    VEC_RTOL) of kernel outputs against their plain versions, over
    (out, ref) pairs of rows [..., hd] the caller reads; and whether
    both are within tolerance. A vector whose plain value is all zero
    must come out all zero — unless ``floor`` > 0: then each vector's
    scale is at least ``floor`` times the largest |value| of its tensor.
    Gradients need that: a vector that is zero in exact arithmetic (dq
    of causal row 0, which sees one key) is rounding noise on both
    sides."""
    abs_err = rel_err = 0.0
    for out, ref in pairs:
        d = (out.float() - ref).abs().amax(-1)
        abs_err = max(abs_err, d.max().item())
        scale = ref.abs().amax(-1).clamp_min(
            max(1e-30, floor * ref.abs().max().item()))
        rel_err = max(rel_err, (d / scale).max().item())
    return abs_err, rel_err, (abs_err <= TOL[dname]
                              and rel_err <= VEC_RTOL[dname])


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def peaks(name):
    key = "H100 PCIe" if "PCIe" in name else \
        "H100 NVL" if "NVL" in name else "H100 SXM"
    return key, CARD_PEAKS[key]


def cuda_ms(fn, torch, iters=20, warmup=3, flush=None):
    """Median milliseconds of ``fn`` over CUDA events, the L2 cache
    flushed before every timed launch (the main path finds it cold)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and bf16 tensor-core operations over their peak."""
    bw, pk_bf16, _ = peak
    b_bytes, b_ops = nbytes / bw * 1e3, flops / pk_bf16 * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def paged_case(torch, S, nh, kvh, hd, pg, maxp, dtype, gen):
    """Pool, block tables (distinct random pages per slot) and q."""
    P = S * maxp + 1
    dev = "cuda"
    kp = torch.randn((P, pg, kvh, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, pg, kvh, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:S * maxp].reshape(S, maxp).to(torch.int32).contiguous()
    return kp, vp, bt


def gathered(torch, kp, vp, bt, rep):
    """K/V gathered through the block table into the contiguous
    [S, heads, T, hd] frame SDPA takes (heads repeated for GQA)."""
    S, maxp = bt.shape
    _, pg, kvh, hd = kp.shape
    k = kp[bt.long()].reshape(S, maxp * pg, kvh, hd)
    v = vp[bt.long()].reshape(S, maxp * pg, kvh, hd)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
    return k, v


def phase_k1(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    S, pg, maxp, hd = 8, 16, 128, 128
    T = maxp * pg
    # empty slot, 1 token, page-unaligned, full table, parked (T + 1),
    # and three mid-length slots
    lens = [0, 1, 17, T, T + 1, 700, 1500, 333]
    gen = torch.Generator(device="cuda").manual_seed(1)
    for nh, kvh, tag in ((32, 32, "7b"), (64, 8, "70b-gqa")):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp, dtype,
                                    gen)
            q = torch.randn((S, nh, hd), generator=gen,
                            device="cuda").to(dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            scale = hd ** -0.5
            out = pa.paged_attention(q, kp, vp, bt, lengths, scale)
            torch.cuda.synchronize()
            ref = pa._ref_paged_attention(q.float(), kp.float(), vp.float(),
                                          bt, lengths, scale)
            err, rel, close = agreement([(out, ref)], dname)
            ok = close and torch.isfinite(out).all().item()
            log(f"k1 {tag} {dname}: max_abs_err {err:.3e} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k1 {tag} {dname} disagrees with its "
                                 f"plain version")
            if tag != "7b" or dtype != torch.bfloat16:
                continue
            # the main path's shape and type: time it
            ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, lengths,
                                                    scale), torch,
                         flush=flush)
            plain_ms = cuda_ms(lambda: pa._ref_paged_attention(
                q, kp, vp, bt, lengths, scale), torch, iters=5,
                flush=flush)
            k, v = gathered(torch, kp, vp, bt, nh // kvh)
            mask = (torch.arange(T, device="cuda")[None]
                    < lengths[:, None])[:, None, None, :]
            qq = q[:, :, None, :]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qq, k, v, attn_mask=mask, scale=scale), torch, flush=flush)
            elt = q.element_size()
            toks = sum(min(n, T) for n in lens)
            nbytes = (2 * q.numel() * elt + 2 * toks * kvh * hd * elt
                      + sum(-(-min(n, T) // pg) for n in lens) * 4 + 4 * S)
            flops = 4 * toks * nh * hd
            bound_ms, by = bound(nbytes, flops, peak)
            record["paged_attention"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by)
            log(f"k1 7b bf16 timing: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({nbytes} bytes, {flops} flops)")


def phase_k2(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import ragged_prefill as rp
    S, C, pg, maxp, hd = 8, 512, 16, 128, 128
    T = maxp * pg
    # cold, prefix hits (page-aligned and mid-page), an idle slot (the
    # scheduler's t0 = T sentinel, last = -1), chunks ending mid-page
    t0s = [0, 256, 1000, T, 37, 512, 1200, 1536]
    takes = [512, 512, 300, 0, 512, 200, 512, 500]
    lasts = [t + n - 1 if n else -1 for t, n in zip(t0s, takes)]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for nh, kvh, tag in ((32, 32, "7b"), (64, 8, "70b-gqa")):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp, dtype,
                                    gen)
            q = torch.randn((S, C, nh, hd), generator=gen,
                            device="cuda").to(dtype)
            t0 = torch.tensor(t0s, dtype=torch.int32, device="cuda")
            last = torch.tensor(lasts, dtype=torch.int32, device="cuda")
            scale = hd ** -0.5
            out = rp.ragged_prefill_attention(q, kp, vp, bt, t0, last, scale)
            torch.cuda.synchronize()
            ref = rp._ref_ragged_prefill(q.float(), kp.float(), vp.float(),
                                         bt, t0, last, scale)
            err, rel, close = agreement(     # live rows only
                [(out[s, :n], ref[s, :n]) for s, n in enumerate(takes)
                 if n], dname)
            idle_zero = out[3].abs().max().item() == 0.0
            ok = close and idle_zero and torch.isfinite(out).all().item()
            log(f"k2 {tag} {dname}: max_abs_err {err:.3e} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}), idle slot zero {idle_zero} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k2 {tag} {dname} disagrees with its "
                                 f"plain version")
            del ref
            if tag != "7b" or dtype != torch.bfloat16:
                continue
            ms = cuda_ms(lambda: rp.ragged_prefill_attention(
                q, kp, vp, bt, t0, last, scale), torch, flush=flush)
            plain_ms = cuda_ms(lambda: rp._ref_ragged_prefill(
                q, kp, vp, bt, t0, last, scale), torch, iters=5,
                flush=flush)
            k, v = gathered(torch, kp, vp, bt, nh // kvh)
            pos = torch.arange(T, device="cuda")
            row = t0.long()[:, None] + torch.arange(C, device="cuda")[None]
            mask = (pos[None, None] <= row[:, :, None])[:, None]
            qq = q.transpose(1, 2)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qq, k, v, attn_mask=mask, scale=scale), torch, flush=flush)
            elt = q.element_size()
            vis = sum(sum(t + c + 1 for c in range(n))
                      for t, n in zip(t0s, takes))
            flops = 4 * vis * nh * hd
            kv_toks = sum(t + n for t, n in zip(t0s, takes) if n)
            nbytes = (sum(takes) * nh * hd * elt + q.numel() * elt
                      + 2 * kv_toks * kvh * hd * elt + 12 * S
                      + sum(-(-(t + n) // pg) for t, n in zip(t0s, takes)
                            if n) * 4)
            bound_ms, by = bound(nbytes, flops, peak)
            record["ragged_prefill"].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by)
            log(f"k2 7b bf16 timing: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({nbytes} bytes, {flops} flops)")


def k3_ticks(T):
    """(name, C, [(t0, take, dec) per slot]) of the two ticks K3 is held
    at: an admission tick (cold and prefix-offset chunks, two decode
    rows, an idle slot at the scheduler's t0 = T sentinel, chunks ending
    mid-page) and a decode-only tick at K1's lengths (clamped to
    [1, T]: a decode row has at least itself to attend to)."""
    admit = [(0, 512, 0), (256, 512, 0), (1000, 300, 0), (T, 0, 0),
             (700, 1, 1), (512, 200, 0), (1500, 1, 1), (1536, 500, 0)]
    decode = [(max(1, min(n, T)) - 1, 1, 1)
              for n in (0, 1, 17, T, T + 1, 700, 1500, 333)]
    return (("admit", 512, admit), ("decode", 1, decode))


def phase_k3(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_tick as ft
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    S, pg, maxp, hd = 8, 16, 128, 128
    T = maxp * pg
    gen = torch.Generator(device="cuda").manual_seed(3)
    for tick, C, slots in k3_ticks(T):
        t0_l = [t for t, _, _ in slots]
        last_l = [t + n - 1 if n else -1 for t, n, _ in slots]
        dec_l = [d for _, _, d in slots]
        rows = [1 if d else n for _, n, d in slots]    # live rows compared
        live_pages = max(x // pg + 1 for x in last_l if x >= 0)
        W = min(maxp, 1 << (live_pages - 1).bit_length())
        ss_np, sp_np, n_live = ft.build_schedule(last_l, pg, n_slots=S)
        dev = "cuda"
        t0 = torch.tensor(t0_l, dtype=torch.int32, device=dev)
        last = torch.tensor(last_l, dtype=torch.int32, device=dev)
        dec = torch.tensor(dec_l, dtype=torch.int32, device=dev)
        ss = torch.from_numpy(ss_np).to(dev)
        sp = torch.from_numpy(sp_np).to(dev)
        for nh, kvh, tag in ((32, 32, "7b"), (64, 8, "70b-gqa")):
            for dtype in (torch.bfloat16, torch.float32):
                dname = str(dtype).split(".")[1]
                kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp,
                                        dtype, gen)
                bt_live = bt[:, :W].contiguous()
                q = torch.randn((S, C, nh, hd), generator=gen,
                                device=dev).to(dtype)
                scale = hd ** -0.5
                args = (bt_live, t0, last, dec, ss, sp, scale)
                out = ft.fused_tick_attention(q, kp, vp, *args)
                torch.cuda.synchronize()
                ref = ft._ref_fused_tick(q.float(), kp.float(), vp.float(),
                                         bt_live, t0, last, dec, scale)
                err, rel, close = agreement(
                    [(out[s, :n], ref[s, :n]) for s, n in enumerate(rows)
                     if n], dname)
                del ref
                idle_zero = all(out[s].abs().max().item() == 0.0
                                for s, n in enumerate(rows) if not n)
                # poison: every page the schedule does not list -> NaN
                listed = torch.zeros(kp.shape[0], dtype=torch.bool,
                                     device=dev)
                live = ss < S
                listed[bt_live[ss[live].long(), sp[live].long()].long()] = \
                    True
                kpn, vpn = kp.clone(), vp.clone()
                kpn[~listed] = float("nan")
                vpn[~listed] = float("nan")
                out2 = ft.fused_tick_attention(q, kpn, vpn, *args)
                torch.cuda.synchronize()
                same = all(torch.equal(out[s, :n], out2[s, :n])
                           for s, n in enumerate(rows) if n)
                del kpn, vpn, out2
                ok = close and idle_zero and same \
                    and torch.isfinite(out).all().item()
                log(f"k3 {tick} {tag} {dname}: C={C} W={W} G={len(ss_np)} "
                    f"({n_live} live pages), max_abs_err {err:.3e} (tol "
                    f"{TOL[dname]:.0e}), max vector-relative error "
                    f"{rel:.3e} (tol {VEC_RTOL[dname]:.0e}), idle slot "
                    f"zero {idle_zero}, "
                    f"unlisted pages NaN-poisoned: live rows bitwise "
                    f"equal {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"k3 {tick} {tag} {dname} disagrees "
                                     f"with its plain version")
                if tag == "7b" and dtype == torch.bfloat16:
                    k3_time(torch, F, ft, pa, tick, q, kp, vp, bt, args,
                            slots, n_live, peak, flush, record, err)


def k3_time(torch, F, ft, pa, tick, q, kp, vp, bt, args, slots, n_live,
            peak, flush, record, err):
    """K3's time at the main path's shape beside its plain version, one
    SDPA call over the gathered masked frame (a yardstick the port never
    calls) and its bound; on the decode-only tick, K1 at the same
    lengths too."""
    bt_live, t0, last, dec, ss, sp, scale = args
    S, C, nh, hd = q.shape
    _, pg, kvh, _ = kp.shape
    ms = cuda_ms(lambda: ft.fused_tick_attention(q, kp, vp, *args), torch,
                 flush=flush)
    plain_ms = cuda_ms(lambda: ft._ref_fused_tick(
        q, kp, vp, bt_live, t0, last, dec, scale), torch, iters=5,
        flush=flush)
    k, v = gathered(torch, kp, vp, bt_live, nh // kvh)
    Tl = k.shape[2]
    pos = torch.arange(Tl, device="cuda")
    row = t0.long()[:, None] + torch.arange(C, device="cuda")[None]
    mask = (pos[None, None] <= row[:, :, None])[:, None]
    qq = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale), torch, flush=flush)
    del k, v, mask
    elt = q.element_size()
    vis = sum(t + 1 if d else sum(t + c + 1 for c in range(n))
              for t, n, d in slots if n)
    flops = 4 * vis * nh * hd
    # q: the live rows only (rows past a take, and rows 1.. of a decode
    # slot, need not be read); out: every row, as the contract writes
    # them (finite values past a take, zeros for an idle slot); K/V: the
    # scheduled pages; int32: their block-table and schedule entries, t0
    # and last
    live_rows = sum(1 if d else n for _, n, d in slots)
    nbytes = (live_rows * nh * hd * elt + q.numel() * elt
              + 2 * n_live * pg * kvh * hd * elt + 4 * (3 * n_live + 2 * S))
    bound_ms, by = bound(nbytes, flops, peak)
    extra = ""
    if tick == "admit":
        record["fused_tick"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by)
    else:
        lengths = (t0 + 1).to(torch.int32)
        qd = q[:, 0].contiguous()
        k1_ms = cuda_ms(lambda: pa.paged_attention(qd, kp, vp, bt, lengths,
                                                   scale), torch,
                        flush=flush)
        extra = f", K1 at the same lengths {k1_ms:.4f} ms"
    log(f"k3 {tick} 7b bf16 timing: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by}; {nbytes} bytes, {flops} flops){extra}")


# (tag, B, S, heads, head_dim, causal): llama_350m's training shape (the
# main path), Llama-2-7B's, a non-causal case and a tail tile (S = 1000)
K4_CASES = (("350m", 8, 1024, 16, 64, True), ("7b", 1, 4096, 32, 128, True),
            ("noncausal", 4, 512, 16, 64, False),
            ("tail", 2, 1000, 8, 128, True))


def phase_k4(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(4)
    for tag, B, S, H, D, causal in K4_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            # v and do at half scale: o and the gradients stay below ~3,
            # the size TOL is set for (bf16 output rounding <= 2^-9 |x|)
            q, k = (torch.randn((B * H, S, D), generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            v, do = (torch.randn((B * H, S, D), generator=gen, device="cuda")
                     .mul(0.5).to(dtype) for _ in range(2))
            scale = D ** -0.5
            o, lse = fa.flash_fwd(q, k, v, scale, causal)
            dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, do, scale, causal)
            dq2, dk2, dv2 = fa.flash_bwd(q, k, v, o, lse, do, scale, causal)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       ((dq, dq2), (dk, dk2), (dv, dv2)))
            del dq2, dk2, dv2
            f32 = [t.float() for t in (q, k, v, do)]
            ro, rlse = fa._ref_with_lse(f32[0], f32[1], f32[2], scale, causal)
            # the backward's plain version on the very inputs the kernel
            # got: the kernel's own o and lse
            ref_g = fa._ref_bwd(f32[0], f32[1], f32[2], o.float(), lse,
                                f32[3], scale, causal)
            del f32
            pairs = [(o, ro), (lse, rlse)] + list(zip((dq, dk, dv), ref_g))
            errs = [agreement([pr], dname, floor=1e-2) for pr in pairs]
            del ro, rlse, ref_g, pairs
            rel = max(e[1] for e in errs)
            ok = all(e[2] for e in errs) and same and all(
                torch.isfinite(t).all().item() for t in (o, lse, dq, dk, dv))
            log(f"k4 {tag} {dname}: B={B} S={S} H={H} hd={D} causal={causal}"
                f", max_abs_err o/lse/dq/dk/dv "
                f"{'/'.join(f'{e[0]:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}), backward bitwise repeatable "
                f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k4 {tag} {dname} disagrees with its plain "
                                 f"version")
            if tag == "350m" and dtype == torch.bfloat16:
                k4_time(torch, F, fa, (q, k, v, o, lse, do), (B, S, H, D),
                        scale, peak, flush, record, errs)
            del q, k, v, do, o, lse, dq, dk, dv
            torch.cuda.empty_cache()


def k4_time(torch, F, fa, tensors, shape, scale, peak, flush, record,
            errs):
    """K4a and K4b at the main path's shape and type beside their plain
    versions and one SDPA call (forward; its backward through autograd
    on a kept graph), and their bounds; also forward + backward."""
    q, k, v, o, lse, do = tensors
    B, S, H, D = shape
    ms_f = cuda_ms(lambda: fa.flash_fwd(q, k, v, scale, True), torch,
                   flush=flush)
    ms_b = cuda_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, scale, True),
                   torch, flush=flush)
    ms_fb = cuda_ms(lambda: fa.flash_bwd(
        q, k, v, *fa.flash_fwd(q, k, v, scale, True), do, scale, True),
        torch, flush=flush)
    plain_f = cuda_ms(lambda: fa._ref_with_lse(q, k, v, scale, True), torch,
                      iters=5, flush=flush)
    plain_b = cuda_ms(lambda: fa._ref_bwd(q, k, v, o, lse, do, scale, True),
                      torch, iters=5, flush=flush)
    plain_fb = cuda_ms(lambda: fa._ref_bwd(
        q, k, v, *fa._ref_with_lse(q, k, v, scale, True), do, scale, True),
        torch, iters=5, flush=flush)
    qs, ks, vs = (t.reshape(B, H, S, D).detach().requires_grad_()
                  for t in (q, k, v))
    dos = do.reshape(B, H, S, D)
    lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, scale=scale), torch, flush=flush)
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         scale=scale)
    lib_b = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                                retain_graph=True), torch,
                    flush=flush)

    def sdpa_fb():
        o_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                            scale=scale)
        return torch.autograd.grad(o_, (qs, ks, vs), dos)

    lib_fb = cuda_ms(sdpa_fb, torch, flush=flush)
    del out
    elt = q.element_size()
    n = B * H * S * D * elt
    flops_f = 2 * B * H * S * S * D          # causal: half of 4 B H S^2 D
    bound_f, by_f = bound(4 * n + 4 * B * H * S, flops_f, peak)
    bound_b, by_b = bound(8 * n + 4 * B * H * S, 2.5 * flops_f, peak)
    bound_fb, _ = bound(9 * n + 4 * B * H * S, 3.5 * flops_f, peak)
    record["flash_attention_fwd"].update(
        max_abs_err=max(errs[0][0], errs[1][0]), ms=ms_f, plain_ms=plain_f,
        library_ms=lib_f, bound_ms=bound_f, bound_by=by_f)
    record["flash_attention_bwd"].update(
        max_abs_err=max(e[0] for e in errs[2:]), ms=ms_b, plain_ms=plain_b,
        library_ms=lib_b, bound_ms=bound_b, bound_by=by_b)
    for what, ms, plain, lib, bnd in (
            ("forward", ms_f, plain_f, lib_f, bound_f),
            ("backward", ms_b, plain_b, lib_b, bound_b),
            ("forward+backward", ms_fb, plain_fb, lib_fb, bound_fb)):
        log(f"k4 350m bf16 {what} timing: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms")


def phase_k5(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps = 1e-5
    for tag, rows, d in (("350m", 8192, 1024), ("7b", 4096, 4096)):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            # the output is x / rms(x) * w whatever the scale of x: w ~
            # 0.5 keeps it below ~3, the size TOL is set for; g at
            # rows^-1/2 keeps dw, a sum over every row, near 1
            w = (0.5 + 0.05 * torch.randn((d,), generator=gen, device="cuda")
                 ).to(dtype)
            g = (torch.randn((rows, d), generator=gen, device="cuda")
                 * rows ** -0.5).to(dtype)
            out = rn.rms_norm_fwd(x, w, eps)
            dx, dw = rn.rms_norm_bwd(x, w, g, eps)
            dx2, dw2 = rn.rms_norm_bwd(x, w, g, eps)
            torch.cuda.synchronize()
            same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
            ro = rn._ref_fwd(x.float(), w.float(), eps)
            rdx, rdw = rn._ref_bwd(x.float(), w.float(), g.float(), eps)
            errs = [agreement([pr], dname, floor=1e-2) for pr in
                    ((out, ro), (dx, rdx), (dw[None], rdw[None]))]
            rel = max(e[1] for e in errs)
            ok = all(e[2] for e in errs) and same and all(
                torch.isfinite(t).all().item() for t in (out, dx, dw))
            log(f"k5 {tag} {dname}: {rows} x {d}, max_abs_err out/dx/dw "
                f"{'/'.join(f'{e[0]:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}), backward bitwise repeatable "
                f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k5 {tag} {dname} disagrees with its plain "
                                 f"version")
            if tag != "350m" or dtype != torch.bfloat16:
                continue
            ms_f = cuda_ms(lambda: rn.rms_norm_fwd(x, w, eps), torch,
                           flush=flush)
            ms_b = cuda_ms(lambda: rn.rms_norm_bwd(x, w, g, eps), torch,
                           flush=flush)
            plain_f = cuda_ms(lambda: rn._ref_fwd(x, w, eps), torch,
                              flush=flush)
            plain_b = cuda_ms(lambda: rn._ref_bwd(x, w, g, eps), torch,
                              flush=flush)
            xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
            lib_f = cuda_ms(lambda: F.rms_norm(xs, (d,), ws, eps), torch,
                            flush=flush)
            y = F.rms_norm(xs, (d,), ws, eps)
            lib_b = cuda_ms(lambda: torch.autograd.grad(
                y, (xs, ws), g, retain_graph=True), torch, flush=flush)
            elt = x.element_size()
            bound_f, by_f = bound((2 * rows * d + d) * elt, 0, peak)
            bound_b, by_b = bound((3 * rows * d + 2 * d) * elt, 0, peak)
            record["rms_norm_fwd"].update(
                max_abs_err=errs[0][0], ms=ms_f, plain_ms=plain_f,
                library_ms=lib_f, bound_ms=bound_f, bound_by=by_f)
            record["rms_norm_bwd"].update(
                max_abs_err=max(errs[1][0], errs[2][0]), ms=ms_b,
                plain_ms=plain_b, library_ms=lib_b, bound_ms=bound_b,
                bound_by=by_b)
            for what, ms, plain, lib, bnd in (
                    ("forward", ms_f, plain_f, lib_f, bound_f),
                    ("backward", ms_b, plain_b, lib_b, bound_b)):
                log(f"k5 350m bf16 {what} timing: kernel {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, F.rms_norm {lib:.4f} ms, bound "
                    f"{bnd:.4f} ms")


def serve_wave(srv, prompts, n_new):
    rids = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    out = srv.run()
    return [out[r] for r in rids]


def counters():
    """The kernels' launch counters: {name: (wrapper, attribute)}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels.fused_tick import fused_tick_attention
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention
    from paddle_tpu_torch.ops.kernels.ragged_prefill import \
        ragged_prefill_attention
    return {"k1": (paged_attention, "launches"),
            "k2": (ragged_prefill_attention, "launches"),
            "k3": (fused_tick_attention, "launches"),
            "k4_fwd": (fa.flash_fwd, "launches"),
            "k4_dq": (fa.flash_bwd, "dq_launches"),
            "k4_dkv": (fa.flash_bwd, "dkv_launches"),
            "k5_fwd": (rn.rms_norm_fwd, "launches"),
            "k5_bwd": (rn.rms_norm_bwd, "launches")}


def zero_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def phase_parity(torch, np):
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    cfg = llama_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    rng = np.random.default_rng(5)
    wave1 = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in (1, 7, 8, 13, 17, 30)]
    wave2 = [np.concatenate([wave1[5][:16],
                             rng.integers(0, cfg.vocab_size, (n,))
                             .astype(np.int32)]) for n in (3, 9)]
    outs = {}
    for mode in ("split", "fused"):
        for name, model in (("cpu", cpu), ("cuda", gpu)):
            zero_counts()
            srv = ContinuousBatchingServer(model, max_slots=3,
                                           max_cache_len=64,
                                           cache_backend="paged",
                                           page_size=8,
                                           prefill_tokens_per_tick=5,
                                           serving_mode=mode)
            toks = serve_wave(srv, wave1, 7) + serve_wave(srv, wave2, 7)
            outs[mode, name] = (toks, srv.pool_balance()[1],
                                srv.stats["prefix_auto_hits"], read_counts())
    ref = outs["split", "cpu"][0]
    good = True
    for (mode, name), (toks, live, hits, n) in outs.items():
        same = all(np.array_equal(a, b) for a, b in zip(toks, ref))
        want = {"split": ("k1", "k2"), "fused": ("k3",)}[mode]
        launched = all(n[k] > 0 for k in want) if name == "cuda" \
            else not any(n.values())
        others = not any(v for k, v in n.items() if k not in want)
        log(f"parity {mode} {name}: tokens equal to the CPU split run "
            f"{same}, prefix hits {hits}, live pages {live}, launches {n}")
        good &= same and launched and others and hits > 0 and live == 0
    if not good:
        raise SystemExit("parity: the card and the CPU, or the fused and "
                         "split ticks, disagree")


def serve_timed(torch, np, srv, prompts, n_new, warm):
    """One wave through ``srv`` tick by tick: a warm-up request first
    (cuBLAS handles, the allocator; its prompt shares no page with the
    wave), then the launch counters zeroed, the wave driven, the counters
    read. Returns the tokens, the counts and the end-to-end metrics."""
    srv.submit(warm, max_new_tokens=2)
    srv.run()
    first_at = {}

    def on_token(rid, toks):
        first_at.setdefault(rid, time.perf_counter())

    zero_counts()
    s0 = dict(srv.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    submitted = {srv.submit(p, max_new_tokens=n_new, on_token=on_token):
                 time.perf_counter() for p in prompts}
    ticks, decode_only_ms = 0, []
    while srv.queue_depth() or srv.in_flight():
        before = srv.stats["prefill_tokens"]
        ts = time.perf_counter()
        srv.step()
        dt = (time.perf_counter() - ts) * 1e3
        ticks += 1
        if srv.stats["prefill_tokens"] == before:
            decode_only_ms.append(dt)
    out = srv.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    d = {k: srv.stats[k] - s0[k] for k in ("decode_ticks",
                                            "prefill_launches",
                                            "fused_launches")}
    ttft = sorted((first_at[r] - submitted[r]) * 1e3 for r in submitted)
    decode_only_ms.sort()
    return {"tokens": [out[r] for r in submitted], "counts": counts,
            "ticks": ticks, "wall": wall,
            "tok_s": len(prompts) * n_new / wall,
            "decode_ms": decode_only_ms[len(decode_only_ms) // 2]
            if decode_only_ms else float("nan"),
            "ttft_med": ttft[len(ttft) // 2], "ttft_max": ttft[-1],
            "bad": srv.stats["nonfinite_logit_rows"],
            "pool": tuple(srv.pool_balance()), **d}


def phase_serve(torch, np, card, record):
    import gc
    from paddle_tpu_torch.inference import ContinuousBatchingServer
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    cfg = llama2_7b()
    t_init = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    torch.cuda.synchronize()
    log(f"serve: Llama-2-7B bf16 weights from seed 0 in "
        f"{time.perf_counter() - t_init:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)).astype(np.int32)
               for n in lens]
    warm = rng.integers(0, cfg.vocab_size, (40,)).astype(np.int32)
    n_new = 32
    L = cfg.num_layers
    log(f"serve: prompts {lens.tolist()}, {n_new} new tokens each")

    def server(mode):
        # prefill_tokens_per_tick=512: long prompts stream in as 512-row
        # chunks between (split) or beside (fused) decode rows
        return ContinuousBatchingServer(model, max_slots=8,
                                        max_cache_len=2048, page_size=16,
                                        cache_backend="paged",
                                        prefill_tokens_per_tick=512,
                                        serving_mode=mode)

    def release():
        # the last server went out of scope: return its pool to the card
        gc.collect()
        torch.cuda.empty_cache()

    # split, fused, fused, split: the tick is host-bound and drifts from
    # wave to wave, so each mode's two waves bracket the other's. The
    # profiled ticks come after every timed wave and cannot disturb it.
    res = {"split": [], "fused": []}
    for mode in ("split", "fused", "fused", "split"):
        r = serve_timed(torch, np, server(mode), prompts, n_new, warm)
        release()
        res[mode].append(r)
        c = r["counts"]
        log(f"serve {mode}: {r['ticks']} ticks ({r['decode_ticks']} "
            f"decode, {r['prefill_launches']} prefill launches, "
            f"{r['fused_launches']} fused launches), launches {c}, "
            f"non-finite live logit rows {r['bad']}, pool {r['pool']}")
        log(f"serve metrics {mode} [{card}]: wall {r['wall']:.3f} s, "
            f"{r['tok_s']:.1f} tok/s, median decode-only tick "
            f"{r['decode_ms']:.2f} ms, TTFT median {r['ttft_med']:.1f} ms "
            f"max {r['ttft_max']:.1f} ms")
        if mode == "split":
            launch_checks = {
                "k1 == decode ticks x layers":
                    c["k1"] == r["decode_ticks"] * L > 0,
                "k2 == prefill launches x layers":
                    c["k2"] == r["prefill_launches"] * L > 0,
                "no k3 launch": c["k3"] == 0}
        else:
            launch_checks = {
                "k3 == fused launches x layers":
                    c["k3"] == r["fused_launches"] * L > 0,
                "no k1 or k2 launch": c["k1"] == c["k2"] == 0}
        checks = {"32 in-vocabulary tokens each":
                      all(len(t) == n_new and t.min() >= 0
                          and t.max() < cfg.vocab_size for t in r["tokens"]),
                  "no non-finite live logits": r["bad"] == 0,
                  "pool drained (live == 0)": r["pool"][1] == 0,
                  **launch_checks}
        for name, good in checks.items():
            if not good:
                raise SystemExit(f"serve {mode}: check failed: {name}")
    for mode, runs in res.items():
        log(f"serve summary {mode} [{card}]: tok/s "
            f"{[round(r['tok_s'], 1) for r in runs]}, median decode-only "
            f"tick {[round(r['decode_ms'], 2) for r in runs]} ms, TTFT "
            f"median {[round(r['ttft_med'], 1) for r in runs]} ms")
    record["paged_attention"]["launches"] = res["split"][0]["counts"]["k1"]
    record["ragged_prefill"]["launches"] = res["split"][0]["counts"]["k2"]
    record["fused_tick"]["launches"] = res["fused"][0]["counts"]["k3"]
    agree = sum(int((a == b).sum()) for a, b in
                zip(res["split"][0]["tokens"], res["fused"][0]["tokens"]))
    log(f"serve: split and fused agree on {agree} of {8 * n_new} tokens "
        f"(informational: bf16 near-ties on random weights may flip)")
    for mode in ("split", "fused"):
        profile_decode(torch, np, server(mode), cfg, card, mode)
        release()


def profile_decode(torch, np, srv, cfg, card, mode):
    """Where a steady decode tick's time goes: 8 live slots, 5 ticks
    under torch.profiler, device time by kernel and the device's busy
    share of the wall time. Informational: it checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(7)
    admitted = srv.stats["admissions"] + 8
    for _ in range(8):
        srv.submit(rng.integers(0, cfg.vocab_size, (128,)).astype(np.int32),
                   max_new_tokens=24)
    while srv.stats["admissions"] < admitted:
        srv.step()
    srv.step()                           # first all-decode tick: warm
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log("profile: the profiler recorded no device time (not measured)")
    else:
        log(f"profile {mode} [{card}]: decode tick {wall_ms:.2f} ms wall, "
            f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
            f"{sum(k[2] for k in kernels)} kernel launches per tick")
        for name, ms, count in kernels[:10]:
            log(f"  {ms:8.3f} ms/tick  {count:5d}x  {name[:90]}")
    srv.run()


def per_step_counts(L, steps=1):
    """The launches a train step of an L-layer Llama makes: K4's three
    kernels once per layer, K5 forward and backward at both norms of
    every layer and the final norm."""
    return {"k4_fwd": steps * L, "k4_dq": steps * L, "k4_dkv": steps * L,
            "k5_fwd": steps * (2 * L + 1), "k5_bwd": steps * (2 * L + 1)}


def phase_train_parity(torch, np):
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_tiny()
    lr = 1e-3
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=4)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 64))
    want = per_step_counts(cfg.num_layers)
    res = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = torch.as_tensor(ids, device=model.device)
        batch = {"inputs": (t,), "labels": (t,)}
        opt = AdamW(learning_rate=lr, parameters=model.named_parameters())
        step = train_step_fn(model, model.loss, opt)
        # step 1 by hand, to read its gradients; steps 2 and 3 through
        # train_step_fn; the counters zeroed before and read after each
        zero_counts()
        loss = model.loss(model(t), t)
        loss.backward()
        grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses, counts = [loss.item()], [read_counts()]
        for _ in range(2):
            zero_counts()
            losses.append(step(batch).item())
            counts.append(read_counts())
        res[name] = (losses, grads, export_params(model), counts)
    (l_cpu, g_cpu, p_cpu, c_cpu), (l_gpu, g_gpu, p_gpu, c_gpu) = \
        res["cpu"], res["cuda"]
    # f32 on both sides (TF32 off): another summation order in cuBLAS
    # and the kernels; Adam's first steps move a weight by ~lr * sign(g),
    # so trained weights are held to a fiftieth of lr
    loss_err = max(abs(a - b) for a, b in zip(l_cpu, l_gpu))
    grad_ok = all(torch.allclose(g_gpu[n], g_cpu[n], rtol=1e-4, atol=1e-5)
                  for n in g_cpu)
    grad_err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    w_err = max(np.abs(p_gpu[n] - p_cpu[n]).max() for n in p_cpu)
    counted = all({k: c[k] for k in want} == want for c in c_gpu)
    quiet = not any(v for c in c_cpu for v in c.values()) and \
        not any(c[k] for c in c_gpu for k in ("k1", "k2", "k3"))
    log(f"train_parity llama_tiny f32: losses cpu "
        f"{[round(x, 6) for x in l_cpu]} card {[round(x, 6) for x in l_gpu]}"
        f" (max diff {loss_err:.2e}, tol 1e-5), step-1 gradients max diff "
        f"{grad_err:.2e} (atol 1e-5, rtol 1e-4) {grad_ok}, trained weights "
        f"max diff {w_err:.2e} (tol {0.02 * lr:.0e}), launches per step "
        f"{c_gpu}")
    if not (loss_err <= 1e-5 and grad_ok and w_err <= 0.02 * lr and counted
            and quiet and l_gpu[2] < l_gpu[0]):
        raise SystemExit("train_parity: the card and the CPU disagree, or "
                         "a step did not launch each kernel as counted")


def phase_train(torch, np, card, peak, record):
    import gc
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    from paddle_tpu_torch.optimizer import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_350m()
    L = cfg.num_layers
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    B, S = 8, 1024
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    batch = {"inputs": (ids,), "labels": (ids,)}
    step = train_step_fn(model, model.loss, opt)
    log(f"train: llama_350m bf16, {L} layers, {n_params} parameters, "
        f"AdamW(1e-4) f32 moments, batch {B} x {S} from seed 0")

    # two warm-up steps by hand: every gradient must be finite
    losses, grads_finite = [], True
    for _ in range(2):
        loss = model.loss(model(ids), ids)
        loss.backward()
        grads_finite &= all(torch.isfinite(p.grad).all().item()
                            for p in model.parameters())
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [x.item() for x in losses]
    finite = all(np.isfinite(losses)) and all(
        torch.isfinite(p).all().item() for p in model.parameters())
    want = per_step_counts(L, n)
    step_ms = wall / n * 1e3
    tok_s = B * S * n / wall
    flops = 6 * n_params * B * S + 3 * 2 * B * cfg.num_heads * S * S \
        * cfg.head_dim * L
    log(f"train losses: {[round(x, 4) for x in losses]}")
    log(f"train metrics [{card}]: {step_ms:.1f} ms per step, {tok_s:.0f} "
        f"tokens/s, peak memory {peak_gb:.2f} GiB, "
        f"{flops / (wall / n) / 1e12:.1f} model TFLOP/s "
        f"({100 * flops / (wall / n) / peak[1]:.1f}% of the bf16 peak)")
    log(f"train launches over {n} steps: {counts}")
    checks = {"loss falls": losses[-1] < losses[0],
              "losses and weights finite": finite,
              "warm-up gradients finite": grads_finite,
              "launches == steps x per-step counts":
                  {k: counts[k] for k in want} == want,
              "no serving kernel": counts["k1"] == counts["k2"]
                  == counts["k3"] == 0}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"train: check failed: {name}")
    record["flash_attention_fwd"]["launches"] = counts["k4_fwd"]
    record["flash_attention_bwd"]["launches"] = counts["k4_dq"]
    record["rms_norm_fwd"]["launches"] = counts["k5_fwd"]
    record["rms_norm_bwd"]["launches"] = counts["k5_bwd"]
    profile_train(torch, step, batch, card)


def profile_train(torch, step, batch, card):
    """Where a train step's time goes: one step under torch.profiler,
    device time by kernel and the device's busy share of the wall time.
    Informational: it checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log("profile train: the profiler recorded no device time (not "
            "measured)")
        return
    log(f"profile train [{card}]: one step {wall_ms:.1f} ms wall (under the "
        f"profiler), device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%),"
        f" {sum(k[2] for k in kernels)} kernel launches")
    for name, ms, count in kernels[:12]:
        log(f"  {ms:8.3f} ms/step  {count:5d}x  {name[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args()
    phases = [p for p in args.only.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke.py: the paddle_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available",
              file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    key, peak = peaks(name)
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; bounds use "
        f"the {key} data-sheet figures ({peak[0] / 1e12} TB/s, "
        f"{peak[1] / 1e12:.0f} TFLOP/s bf16)")

    from paddle_tpu_torch.ops.kernels import _build
    t_build = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {time.perf_counter() - t_build:.1f} s wall, per source "
        f"{ {k: round(v, 1) for k, v in secs.items()} }")
    for stem, info in _build.build_log().items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {stem}: {line.strip()}")

    record = {
        "paged_attention": {
            "name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:124",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None},
        "ragged_prefill": {
            "name": "ragged_prefill", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_prefill.cu",
            "replaces": "paddle_tpu/ops/pallas/ragged_prefill.py:144",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None},
        "fused_tick": {
            "name": "fused_tick", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_tick.cu",
            "replaces": "paddle_tpu/ops/pallas/fused_tick.py:215",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None},
    }
    for kname, src, tpu in (
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:98"),
            ("flash_attention_bwd", "flash_attention.cu",
             "flash_attention.py:248"),
            ("rms_norm_fwd", "rms_norm.cu", "rms_norm.py:42"),
            ("rms_norm_bwd", "rms_norm.cu", "rms_norm.py:91")):
        record[kname] = {
            "name": kname, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{src}",
            "replaces": f"paddle_tpu/ops/pallas/{tpu}",
            "launches": None, "max_abs_err": None, "ms": None,
            "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None}
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
    if "k1" in phases:
        phase_k1(torch, peak, flush, record)
    if "k2" in phases:
        phase_k2(torch, peak, flush, record)
    if "k3" in phases:
        phase_k3(torch, peak, flush, record)
    if "k4" in phases:
        phase_k4(torch, peak, flush, record)
    if "k5" in phases:
        phase_k5(torch, peak, flush, record)
    del flush
    if "parity" in phases:
        phase_parity(torch, np)
    if "train_parity" in phases:
        phase_train_parity(torch, np)
    if "serve" in phases:
        torch.cuda.empty_cache()
        phase_serve(torch, np, card, record)
    if "train" in phases:
        phase_train(torch, np, card, peak, record)
    log(json.dumps({"kernels": list(record.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
