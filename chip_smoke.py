#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --only build,k1,k2,k3
    python3 chip_smoke.py --only build,k2,k7
    python3 chip_smoke.py --only build,k4,k5,train_parity,train
    python3 chip_smoke.py --only build,k4,k6,train_parity,train
    python3 chip_smoke.py --only build,k6,k7,k8,int8_parity

Phases, in order; any failure exits non-zero:

1. card: name and power limit (nvidia-smi), TF32 switched off for
   float32 products and convolutions;
2. build: every ``paddle_tpu_torch/csrc/*.cu`` compiled by nvcc for
   sm_90a (one process per source, all at once), with ptxas's report;
   every time below is the card's own (``cuda_ms``: the wrapper's host
   work is hidden behind a spin kernel, and a sample it was not hidden
   from is dropped), each kernel's also on the clock it replaced, for
   one PR;
3. k1: the paged-decode kernel against its plain version at Llama-2-7B
   decode shapes (and at Llama-2-70B's GQA head layout), bf16 and f32,
   within TOL and VEC_RTOL (below), with its time beside the plain version's, one SDPA call over the
   gathered frame (a yardstick the port never calls) and its bound;
4. k2: the ragged-prefill kernel likewise, on 512-row chunks with
   prefix offsets, an idle slot and a chunk ending mid-page, at 7B's and
   70B's heads (both timed in bf16), then bf16 edge cases at full widths
   (C = 100, rep 4, head_dim 64 and 16, a slot ending at the table's last
   column), each with a poison check: every page past each slot's
   frontier and every unused column's page filled with NaN must leave the
   live rows bit for bit unchanged;
5. k3: the fused-tick kernel likewise, on an admission tick (512-row
   chunks at prefix offsets, two decode rows, an idle slot, a chunk
   ending mid-page) and a decode-only tick (C = 1, K1's lengths, timed
   beside K1), plus a poison check: every page the schedule does not
   list filled with NaN must leave the live rows bit for bit unchanged;
6. k4: the flash-attention forward (K4a) and backward (K4b: dq, then
   dk + dv) against their plain versions, bf16 and f32, at llama_350m's
   training shape (B = 8, S = 1024, 16 heads of 64, causal), at
   Llama-2-7B's (B = 1, S = 4096, 32 heads of 128, causal), non-causal,
   and at S = 1000 (a tail tile); then bf16 at S = 100, at S_q != S_k
   (non-causal and causal) and at head_dim 16: o, lse, dq, dk, dv within
   TOL and VEC_RTOL; two backward runs bitwise equal; ptxas's registers
   and spills of the three bf16 kernels at each head_dim; at the 350m and
   7B shapes, forward, backward and both timed beside the plain
   version, one SDPA call (a yardstick the port never calls) and the
   bound, the kernels' time also read from torch.profiler;
7. k5: RMSNorm forward (K5a) and backward (K5b) likewise, at 8192 x 1024
   (llama_350m) and 4096 x 4096 (Llama-2-7B) rows x d, beside
   torch.nn.functional.rms_norm;
8. k6: the rope kernel, forward (sign +1) and backward (sign -1), bf16
   and f32, at llama_350m's q (8 x 1024 x 16 x 64), Llama-2-7B's q
   (1 x 4096 x 32 x 128) and a tail (S = 1000) against its plain
   version, the reference's composition (bit for bit expected, held to
   TOL and VEC_RTOL), timed beside it: the A/B the reference's opt-in
   waits for; then bf16 tables under bf16 and f32 x through
   ``apply_rotary_kernel``, forward and backward: two K6 launches (the
   kernel's route) and the plain version's values;
9. k7: the fused GEMM epilogue forward, and its backward through
   autograd, against the plain version at GPT-2 345M's FFN (4096 rows:
   1024 -> 4096 + bias, gelu; 4096 -> 1024 + bias), Llama-2-7B's gate
   projection (4096 x 4096 @ 4096 x 11008), relu, an N tail (N = 1000)
   and ragged shapes, bf16 and f32, each on its stated route (wgmma,
   mma.sync for K and N odd, simt for f32), timed beside torch.addmm +
   the activation (a yardstick the port never calls); then the GPT-2 FFN
   forward and backward through
   ``incubate.nn.functional.fused_linear_activation`` and
   ``fused_matmul_bias``, counters zeroed just before and read after,
   both launches on the wgmma route;
10. k8: the int8 matmul against its plain version, bit for bit, at
   Llama-2-7B's projection shapes with 4096 rows (K x N 4096 x 4096,
   4096 x 11008, 11008 x 4096, 4096 x 32000), a decode batch (M = 8) and
   ragged shapes, timed beside torch._int_mm + the same epilogue (a
   yardstick);
11. parity: a llama_tiny-shaped float32 model served on the card (the
   kernels) and on the CPU (the plain versions) from the same weights,
   on split ticks and on fused ticks, must emit equal greedy tokens:
   card == CPU on each, and fused == split; split runs launch K1 and K2
   only, fused runs K3 only;
12. train_parity: llama_tiny in float32 trained 3 steps (``train_step_fn``
   + ``AdamW``) on the card and on the CPU from one set of weights:
   per-step losses, step-1 gradients and the trained weights agree, and
   every step launches K4 forward, dq and dk + dv once per layer and K5
   forward and backward 2 x layers + 1 times; then again with
   ``PT_ROPE_PALLAS=1``, where every step also launches K6 4 x layers
   times (q and k, forward and backward);
13. int8_parity: a llama_tiny-shaped float32 model converted by
   ``to_int8_inference`` on the card (K8) and on the CPU (the plain
   version) from the same weights: equal int8 codes, logits within one
   quantisation step of the head, equal greedy argmax, and 7 x layers + 1
   K8 launches per forward;
14. serve: Llama-2-7B in bf16 (random weights from a seed, full width
   and depth) serves 8 requests through ``ContinuousBatchingServer``,
   on split and on fused ticks in the order split, fused, fused, split
   (a new server over the same model each time, the last one freed
   first); the launch counters are zeroed just before each wave and
   read just after, and must equal decode ticks x layers (K1) and
   prefill launches x layers (K2) on a split wave, fused launches x
   layers (K3) on a fused wave; then one split and one fused admission
   tick, and five decode ticks of each, under torch.profiler;
15. int8_infer: the serve phase's Llama-2-7B (full width and depth):
   one bf16 forward of 8 x 512 ids from seed 0, then
   ``to_int8_inference(model, inplace=True)`` and the same forward with
   the counters zeroed just before and read just after: 7 x layers + 1
   K8 launches, the forward's K4 and K5 launches as in bf16, no other
   kernel, finite logits; top-1 agreement and the largest relative logit
   error against bf16, ms per forward and tokens/s for both, peak memory,
   a profile of one forward of each;
16. train: llama_350m in bf16 at full width and depth, AdamW(1e-4) with
   f32 moments, one fixed 8 x 1024 batch from seed 0: 2 warm-up steps,
   then 10 timed with the counters zeroed just before and read just
   after (K4: 10 x layers each, K5: 10 x (2 x layers + 1) each, no K6);
   the loss must fall and stay finite, gradients finite; step time,
   tokens/s, peak memory and a profile of one step;
17. train_rope: the same model, weights, batch and optimizer with
   ``PT_ROPE_PALLAS=1`` (K6 rope): 2 warm-up steps and 5 timed, the
   counters zeroed before the first and read after the last (K6: 7 x 4 x
   layers); the 7 losses within 1e-3 relative of the train phase's first
   7; step time beside train's.

The last two lines of standard output are the per-kernel JSON record
and ``{"ok": true, "device": {...}}``. Without a CUDA card, or without
the ``paddle_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "parity",
          "train_parity", "int8_parity", "serve", "int8_infer", "train",
          "train_rope")

# NVIDIA data sheets, dense rates: (bytes/s, bf16 FLOP/s, fp32 FLOP/s
# outside the tensor cores, int8 tensor-core operations/s). The SXM part
# is the default.
CARD_PEAKS = {
    "H100 SXM": (3.35e12, 989e12, 67e12, 1979e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
    "H100 NVL": (3.9e12, 835e12, 60e12, 1670e12),
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


_SPIN = {}     # cycles of torch.cuda._sleep per millisecond, measured once


def spin_cycles_per_ms(torch):
    if "per_ms" not in _SPIN:
        torch.cuda._sleep(100_000)                   # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = 2_000_000 / start.elapsed_time(end)
    return _SPIN["per_ms"]


def cuda_ms(fn, torch, iters=20, warmup=3, flush=None):
    """Median milliseconds of the card's work in one call of ``fn``, the
    L2 cache flushed before every timed call (the main path finds it
    cold). Only the card's time counts: before each timed call the
    stream gets a spin kernel (``torch.cuda._sleep``) that outlasts the
    host side of ``fn`` (contract checks, allocation, the ctypes call,
    PyTorch's dispatch), so the start event is reached after ``fn`` has
    queued all its work. A sample whose start event had already been
    reached when ``fn`` returned on the host (the spin was too short) is
    dropped and the spin doubled. Kernels, their plain versions and the
    library yardsticks are all timed so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int(max(0.05, 3 * host_ms) * spin_cycles_per_ms(torch))
    times, dropped = [], 0
    while len(times) < iters:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end))
            continue
        dropped += 1
        spin *= 2
        if dropped > 12:
            raise SystemExit("cuda_ms: the host side of a timed call "
                             "outlasted every spin")
    times.sort()
    return times[len(times) // 2]


def cuda_ms_host(fn, torch, iters=20, warmup=3, flush=None):
    """The clock ``cuda_ms`` replaced, kept for one PR beside it: the
    start event is recorded on an idle card before ``fn``, so its host
    work counts too. Median milliseconds, L2 flushed before each call."""
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


def kernel_ms(fn, torch, flush, what):
    """A kernel's time on the card's clock (``cuda_ms``), logged beside
    the old clock's (``cuda_ms_host``) reading of the same call."""
    ms = cuda_ms(fn, torch, flush=flush)
    old = cuda_ms_host(fn, torch, flush=flush)
    log(f"clock {what}: {ms:.4f} ms on the card's clock, {old:.4f} ms on "
        f"the old clock (host work included)")
    return ms


def bound(nbytes, flops, peak, ops_peak=None):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over ``ops_peak`` (by default the bf16 tensor-core
    peak; the f32 or int8 entry of ``peak`` for those types)."""
    bw = peak[0]
    ops_peak = peak[1] if ops_peak is None else ops_peak
    b_bytes, b_ops = nbytes / bw * 1e3, flops / ops_peak * 1e3
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
            ms = kernel_ms(lambda: pa.paged_attention(q, kp, vp, bt,
                                                      lengths, scale),
                           torch, flush, "k1 7b bf16")
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


def k2_cases(T):
    """(tag, C, nh, kvh, hd, [(t0, take) per slot], dtypes, timed) of
    the cases K2 is held at, S = 8 slots over 128 pages of 16: the serve
    phase's admission tick at Llama-2-7B's heads (the main path) and at
    Llama-2-70B's GQA layout, both dtypes, each timed in bf16 (cold and
    prefix-offset chunks, page-aligned and mid-page, an idle slot at the
    scheduler's t0 = T sentinel, chunks ending mid-page); then bf16 edge
    cases at full widths, each with a slot whose frontier ends at the
    table's last column: C = 100 (a row tile straddles C), 32 query heads
    over 8 kv heads (rep 4: 16 rows x 4 heads a tile), llama_350m's 16
    heads of 64 and llama_tiny's 4 heads of 16 over 2."""
    bf, f32 = ("bfloat16",), ("bfloat16", "float32")
    admit = [(0, 512), (256, 512), (1000, 300), (T, 0), (37, 512),
             (512, 200), (1200, 512), (1536, 500)]
    to_end = admit[:-1] + [(T - 512, 512)]
    c100 = [(0, 100), (T - 100, 100), (1000, 37), (T, 0), (5, 100),
            (16, 64), (700, 99), (1900, 65)]
    return (("7b", 512, 32, 32, 128, admit, f32, True),
            ("70b-gqa", 512, 64, 8, 128, admit, f32, True),
            ("c100", 100, 32, 32, 128, c100, bf, False),
            ("rep4", 512, 32, 8, 128, to_end, bf, False),
            ("hd64", 512, 16, 16, 64, to_end, bf, False),
            ("hd16", 512, 4, 2, 16, to_end, bf, False))


def phase_k2(torch, peak, flush, record):
    from paddle_tpu_torch.ops.kernels import ragged_prefill as rp
    S, pg, maxp = 8, 16, 128
    T = maxp * pg
    gen = torch.Generator(device="cuda").manual_seed(2)
    for tag, C, nh, kvh, hd, slots, dnames, timed in k2_cases(T):
        t0s = [t for t, _ in slots]
        takes = [n for _, n in slots]
        lasts = [t + n - 1 if n else -1 for t, n in slots]
        t0 = torch.tensor(t0s, dtype=torch.int32, device="cuda")
        last = torch.tensor(lasts, dtype=torch.int32, device="cuda")
        for dname in dnames:
            dtype = getattr(torch, dname)
            kp, vp, bt = paged_case(torch, S, nh, kvh, hd, pg, maxp, dtype,
                                    gen)
            q = torch.randn((S, C, nh, hd), generator=gen,
                            device="cuda").to(dtype)
            scale = hd ** -0.5
            out = rp.ragged_prefill_attention(q, kp, vp, bt, t0, last, scale)
            torch.cuda.synchronize()
            ref = rp._ref_ragged_prefill(q.float(), kp.float(), vp.float(),
                                         bt, t0, last, scale)
            err, rel, close = agreement(     # live rows only
                [(out[s, :n], ref[s, :n]) for s, n in enumerate(takes)
                 if n], dname)
            del ref
            idle_zero = all(out[s].abs().max().item() == 0.0
                            for s, n in enumerate(takes) if not n)
            # poison: every page past each slot's frontier (its last
            # position), every unused column's page and every page of an
            # idle slot -> NaN; the live rows must not move by a bit
            seen = torch.zeros(kp.shape[0], dtype=torch.bool, device="cuda")
            for s, x in enumerate(lasts):
                if x >= 0:
                    seen[bt[s, :x // pg + 1].long()] = True
            kpn, vpn = kp.clone(), vp.clone()
            kpn[~seen] = float("nan")
            vpn[~seen] = float("nan")
            out2 = rp.ragged_prefill_attention(q, kpn, vpn, bt, t0, last,
                                               scale)
            torch.cuda.synchronize()
            same = all(torch.equal(out[s, :n], out2[s, :n])
                       for s, n in enumerate(takes) if n)
            del kpn, vpn, out2
            ok = close and idle_zero and same \
                and torch.isfinite(out).all().item()
            log(f"k2 {tag} {dname}: C={C}, {nh} heads over {kvh} kv heads "
                f"of {hd}, max_abs_err {err:.3e} (tol {TOL[dname]:.0e}), "
                f"max vector-relative error {rel:.3e} (tol "
                f"{VEC_RTOL[dname]:.0e}), idle slot zero {idle_zero}, "
                f"pages past each frontier NaN-poisoned: live rows bitwise "
                f"equal {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k2 {tag} {dname} disagrees with its "
                                 f"plain version")
            if timed and dname == "bfloat16":
                k2_time(torch, rp, tag, q, kp, vp, bt, t0, last, slots,
                        scale, peak, flush, record, err)
            del q, kp, vp, bt, out
    torch.cuda.empty_cache()


def k2_time(torch, rp, tag, q, kp, vp, bt, t0, last, slots, scale, peak,
            flush, record, err):
    """K2 at the main path's shape beside its plain version, one SDPA call
    over the gathered masked frame (a yardstick the port never calls) and
    its bound; the 7B case goes into the record."""
    import torch.nn.functional as F
    S, C, nh, hd = q.shape
    _, pg, kvh, _ = kp.shape
    T = bt.shape[1] * pg
    ms = kernel_ms(lambda: rp.ragged_prefill_attention(
        q, kp, vp, bt, t0, last, scale), torch, flush, f"k2 {tag} bf16")
    plain_ms = cuda_ms(lambda: rp._ref_ragged_prefill(
        q, kp, vp, bt, t0, last, scale), torch, iters=5, flush=flush)
    k, v = gathered(torch, kp, vp, bt, nh // kvh)
    pos = torch.arange(T, device="cuda")
    row = t0.long()[:, None] + torch.arange(C, device="cuda")[None]
    mask = (pos[None, None] <= row[:, :, None])[:, None]
    qq = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, scale=scale), torch, flush=flush)
    del k, v, mask
    elt = q.element_size()
    vis = sum(sum(t + c + 1 for c in range(n)) for t, n in slots)
    flops = 4 * vis * nh * hd
    kv_toks = sum(t + n for t, n in slots if n)
    takes = sum(n for _, n in slots)
    nbytes = (takes * nh * hd * elt + q.numel() * elt
              + 2 * kv_toks * kvh * hd * elt + 12 * S
              + sum(-(-(t + n) // pg) for t, n in slots if n) * 4)
    bound_ms, by = bound(nbytes, flops, peak)
    if tag == "7b":
        record["ragged_prefill"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by)
    log(f"k2 {tag} bf16 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
        f"{nbytes} bytes, {flops} flops)")


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
    ms = kernel_ms(lambda: ft.fused_tick_attention(q, kp, vp, *args), torch,
                   flush, f"k3 {tick} 7b bf16")
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
        k1_ms = kernel_ms(lambda: pa.paged_attention(qd, kp, vp, bt,
                                                     lengths, scale),
                          torch, flush, "k1 at k3's decode lengths")
        extra = f", K1 at the same lengths {k1_ms:.4f} ms"
    log(f"k3 {tick} 7b bf16 timing: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({by}; {nbytes} bytes, {flops} flops){extra}")


# (tag, B, S_q, S_k, heads, head_dim, causal, types): llama_350m's
# training shape (the main path), Llama-2-7B's, a non-causal case and a
# tail tile (S = 1000), in both types; then bf16 cases at the edges of
# the kernels' 64-row tiles: S = 100 (one full tile and a tail), S_q !=
# S_k non-causal at head_dim 128 (key tiles past the row tiles, tails on
# both axes) and causal (the top-left diagonal at unequal lengths), and
# llama_tiny's head_dim 16 (one k-step)
BOTH, BF16 = ("bfloat16", "float32"), ("bfloat16",)
K4_CASES = (("350m", 8, 1024, 1024, 16, 64, True, BOTH),
            ("7b", 1, 4096, 4096, 32, 128, True, BOTH),
            ("noncausal", 4, 512, 512, 16, 64, False, BOTH),
            ("tail", 2, 1000, 1000, 8, 128, True, BOTH),
            ("s100", 4, 100, 100, 16, 64, True, BF16),
            ("rect", 2, 300, 1000, 16, 128, False, BF16),
            ("rect-causal", 2, 1000, 300, 8, 64, True, BF16),
            ("hd16", 4, 1024, 1024, 4, 16, True, BF16))
K4_KERNELS = ("fwd_mma_kernel", "dq_mma_kernel", "dkv_mma_kernel")


def ptxas_report(stem, names):
    """{(kernel, template arguments): (registers, spill stores, spill
    loads)} from ptxas's report of ``csrc/<stem>.cu`` in this process's
    build, for the kernels named in ``names``."""
    import re
    from paddle_tpu_torch.ops.kernels import _build
    info = _build.build_log().get(stem)
    if info is None:
        return {}
    out, cur = {}, None
    for line in info["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = None
            for n in names:
                t = re.search(n + r"I((?:Li\d+E)+)E", m.group(1))
                if t:
                    cur = (n, ",".join(re.findall(r"Li(\d+)E", t.group(1))))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, [None, 0, 0])[1:] = [int(m.group(1)),
                                                    int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, [None, 0, 0])[0] = int(m.group(1))
    return out


def phase_k4(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    report = ptxas_report("flash_attention", K4_KERNELS)
    if not report:
        log("k4 ptxas: the library was not built by this process (not "
            "reported)")
    for (kname, targs), (regs, st, ld) in sorted(report.items()):
        log(f"k4 ptxas {kname}<{targs}>: {regs} registers, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for tag, B, Sq, Sk, H, D, causal, dnames in K4_CASES:
        for dname in dnames:
            dtype = getattr(torch, dname)
            # v and do at half scale: o and the gradients stay below ~3,
            # the size TOL is set for (bf16 output rounding <= 2^-9 |x|)
            q, k = (torch.randn((B * H, n, D), generator=gen, device="cuda")
                    .to(dtype) for n in (Sq, Sk))
            v, do = (torch.randn((B * H, n, D), generator=gen, device="cuda")
                     .mul(0.5).to(dtype) for n in (Sk, Sq))
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
            log(f"k4 {tag} {dname}: B={B} Sq={Sq} Sk={Sk} H={H} hd={D} "
                f"causal={causal}, max_abs_err o/lse/dq/dk/dv "
                f"{'/'.join(f'{e[0]:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error {rel:.3e} "
                f"(tol {VEC_RTOL[dname]:.0e}), backward bitwise repeatable "
                f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k4 {tag} {dname} disagrees with its plain "
                                 f"version")
            if tag in ("350m", "7b") and dtype == torch.bfloat16:
                k4_time(torch, F, fa, tag, (q, k, v, o, lse, do),
                        (B, Sq, H, D), scale, peak, flush, record, errs)
            del q, k, v, do, o, lse, dq, dk, dv
            torch.cuda.empty_cache()


def profiled_ms(torch, fn, names, flush, iters=10):
    """Device time per call of the kernels whose names hold one of
    ``names``, summed from torch.profiler over ``iters`` calls (L2
    flushed before each): a second reading of the card's clock. None
    when the profiler saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and any(n in e.key for n in names))
    return us / 1e3 / iters if us else None


def k4_time(torch, F, fa, tag, tensors, shape, scale, peak, flush, record,
            errs):
    """K4a and K4b at a training shape in bf16 (llama_350m's, the main
    path, goes into the record; Llama-2-7B's) beside their plain versions
    and one SDPA call (forward; its backward through autograd on a kept
    graph), and their bounds; also forward + backward. The kernels' own
    times are read a second way from torch.profiler."""
    q, k, v, o, lse, do = tensors
    B, S, H, D = shape
    ms_f = kernel_ms(lambda: fa.flash_fwd(q, k, v, scale, True), torch,
                     flush, f"k4 {tag} bf16 forward")
    ms_b = kernel_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, scale, True),
                     torch, flush, f"k4 {tag} bf16 backward")
    ms_fb = kernel_ms(lambda: fa.flash_bwd(
        q, k, v, *fa.flash_fwd(q, k, v, scale, True), do, scale, True),
        torch, flush, f"k4 {tag} bf16 forward+backward")
    prof_f = profiled_ms(torch, lambda: fa.flash_fwd(q, k, v, scale, True),
                         K4_KERNELS[:1], flush)
    prof_b = profiled_ms(torch, lambda: fa.flash_bwd(q, k, v, o, lse, do,
                                                     scale, True),
                         K4_KERNELS[1:], flush)
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
    if tag == "350m":
        record["flash_attention_fwd"].update(
            max_abs_err=max(errs[0][0], errs[1][0]), ms=ms_f,
            plain_ms=plain_f, library_ms=lib_f, bound_ms=bound_f,
            bound_by=by_f)
        record["flash_attention_bwd"].update(
            max_abs_err=max(e[0] for e in errs[2:]), ms=ms_b,
            plain_ms=plain_b, library_ms=lib_b, bound_ms=bound_b,
            bound_by=by_b)
    def by_profiler(x):
        return ", profiler " + ("no device time (not measured)"
                                if x is None else f"{x:.4f} ms")

    for what, ms, plain, lib, bnd, seen in (
            ("forward", ms_f, plain_f, lib_f, bound_f, by_profiler(prof_f)),
            ("backward", ms_b, plain_b, lib_b, bound_b, by_profiler(prof_b)),
            ("forward+backward", ms_fb, plain_fb, lib_fb, bound_fb, "")):
        log(f"k4 {tag} bf16 {what} timing: kernel {ms:.4f} ms{seen}, plain "
            f"{plain:.4f} ms, sdpa {lib:.4f} ms ({ms / lib:.2f}x), bound "
            f"{bnd:.4f} ms")


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
            ms_f = kernel_ms(lambda: rn.rms_norm_fwd(x, w, eps), torch,
                             flush, "k5 350m bf16 forward")
            ms_b = kernel_ms(lambda: rn.rms_norm_bwd(x, w, g, eps), torch,
                             flush, "k5 350m bf16 backward")
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


# (tag, [B, S, H, D], table rows): llama_350m's q (the train_rope path),
# Llama-2-7B's q, and a tail (S = 1000, no power of two)
K6_CASES = (("350m", (8, 1024, 16, 64), 2048),
            ("7b", (1, 4096, 32, 128), 4096),
            ("tail", (2, 1000, 8, 128), 2048))


def phase_k6(torch, peak, flush, record):
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.ops.rope import precompute_freqs
    gen = torch.Generator(device="cuda").manual_seed(6)
    for tag, shape, rows in K6_CASES:
        cos, sin = precompute_freqs(shape[-1], rows, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            # half scale: a rotation keeps each pair's norm, so outputs
            # stay below ~3, the size TOL is set for
            x = (0.5 * torch.randn(shape, generator=gen, device="cuda")
                 ).to(dtype)
            errs, same, finite = [], True, True
            for sign in (1, -1):
                out = rk.rope_fwd(x, cos, sin, sign)
                torch.cuda.synchronize()
                ref = rk._ref_rope(x, cos, sin, sign)
                errs.append(agreement([(out, ref.float())], dname))
                same &= torch.equal(out, ref)
                finite &= bool(torch.isfinite(out).all().item())
            ok = all(e[2] for e in errs) and finite
            log(f"k6 {tag} {dname}: {list(shape)}, table {rows} rows, "
                f"max_abs_err fwd/bwd {errs[0][0]:.2e}/{errs[1][0]:.2e} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error "
                f"{max(e[1] for e in errs):.3e} (tol {VEC_RTOL[dname]:.0e}), "
                f"bitwise equal to the plain version {same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k6 {tag} {dname} disagrees with its plain "
                                 f"version")
            if tag != "350m" or dtype != torch.bfloat16:
                continue
            ms_f = kernel_ms(lambda: rk.rope_fwd(x, cos, sin, 1), torch,
                             flush, "k6 350m bf16 forward")
            ms_b = kernel_ms(lambda: rk.rope_fwd(x, cos, sin, -1), torch,
                             flush, "k6 350m bf16 backward")
            plain_f = cuda_ms(lambda: rk._ref_rope(x, cos, sin, 1), torch,
                              flush=flush)
            plain_b = cuda_ms(lambda: rk._ref_rope(x, cos, sin, -1), torch,
                              flush=flush)
            # x read and written once, the table's first S rows of cos and
            # sin read once; 6 operations a pair (no tensor-core work)
            nbytes = 2 * x.numel() * x.element_size() \
                + 2 * shape[1] * shape[-1] // 2 * 4
            bound_ms, by = bound(nbytes, 3 * x.numel(), peak, peak[2])
            record["rope"].update(
                max_abs_err=max(e[0] for e in errs), ms=ms_f,
                plain_ms=plain_f, library_ms=None, bound_ms=bound_ms,
                bound_by=by)
            log(f"k6 350m bf16 timing: kernel forward {ms_f:.4f} ms, "
                f"backward {ms_b:.4f} ms; plain composition forward "
                f"{plain_f:.4f} ms, backward {plain_b:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({by}; {nbytes} bytes)")
    k6_bf16_tables(torch, gen)


def k6_bf16_tables(torch, gen):
    """bf16 cos/sin tables, as the reference's kernel takes the tables'
    type, at llama_350m's q in bf16 and f32: ``apply_rotary_kernel``
    forward and backward must take the kernel route (two K6 launches)
    and agree with the plain composition (bit for bit expected)."""
    from paddle_tpu_torch.ops.kernels import rope as rk
    from paddle_tpu_torch.ops.rope import precompute_freqs
    shape = K6_CASES[0][1]
    cos, sin = precompute_freqs(shape[-1], K6_CASES[0][2],
                                dtype=torch.bfloat16, device="cuda")
    x0 = 0.5 * torch.randn(shape, generator=gen, device="cuda")
    g0 = 0.5 * torch.randn(shape, generator=gen, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        x = x0.to(dtype).requires_grad_()
        g = g0.to(dtype)
        before = rk.rope_fwd.launches
        out = rk.apply_rotary_kernel(x, cos, sin)
        (dx,) = torch.autograd.grad(out, x, g)
        torch.cuda.synchronize()
        launched = rk.rope_fwd.launches - before
        ref = rk._ref_rope(x.detach(), cos, sin, 1)
        ref_dx = rk._ref_rope(g, cos, sin, -1)
        errs = [agreement([(out.detach(), ref.float())], dname),
                agreement([(dx, ref_dx.float())], dname)]
        same = torch.equal(out, ref) and torch.equal(dx, ref_dx)
        ok = all(e[2] for e in errs) and launched == 2
        log(f"k6 bf16 tables, {dname} x {list(shape)}: route kernel "
            f"({launched} K6 launches for forward + backward, expected 2), "
            f"max_abs_err fwd/bwd {errs[0][0]:.2e}/{errs[1][0]:.2e} (tol "
            f"{TOL[dname]:.0e}), bitwise equal to the plain version {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"k6 bf16 tables {dname}: not on the kernel "
                             f"route, or disagrees with the plain version")


# (tag, M, K, N, bias, activation, bf16 route): GPT-2 345M's FFN at 4096
# rows (8 x 512; benchmarks/decode_bench.py:24-26), Llama-2-7B's gate
# projection, relu, an N tail that is a multiple of 8 but not of the 128
# tile, ragged M, N and K (multiples of 8: TMA zero-fills the edges), then
# K and N odd, which only the masked element loads take. f32 runs simt.
K7_CASES = (("gpt2-ffn1", 4096, 1024, 4096, True, "gelu", "wgmma"),
            ("gpt2-ffn2", 4096, 4096, 1024, True, "none", "wgmma"),
            ("7b-gate", 4096, 4096, 11008, False, "none", "wgmma"),
            ("relu", 4096, 1024, 4096, True, "relu", "wgmma"),
            ("n-tail", 4096, 1024, 1000, True, "gelu", "wgmma"),
            ("ragged", 1000, 1000, 1000, True, "gelu", "wgmma"),
            ("ragged-odd", 999, 777, 333, True, "relu", "mma_sync"))


def k7_inputs(torch, gen, M, K, N, has_bias, dtype):
    """x, w, bias and a cotangent: w at 0.5 / sqrt(K) keeps the
    pre-activation near N(0, 1/4), below ~3 (the size TOL is set for);
    the cotangent at 0.5 / sqrt(M) keeps dw and db, sums over M rows,
    near that size too."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((K, N), generator=gen, device="cuda")
         * (0.5 / K ** 0.5)).to(dtype)
    b = (0.1 * torch.randn((N,), generator=gen, device="cuda")).to(dtype) \
        if has_bias else None
    g = (torch.randn((M, N), generator=gen, device="cuda")
         * (0.5 / M ** 0.5)).to(dtype)
    return x, w, b, g


def phase_k7(torch, peak, flush, record):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import gemm_epilogue as ge
    gen = torch.Generator(device="cuda").manual_seed(7)
    for tag, M, K, N, has_bias, act, bf16_route in K7_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            want = bf16_route if dtype == torch.bfloat16 else "simt"
            x, w, b, g = k7_inputs(torch, gen, M, K, N, has_bias, dtype)
            leaves = [t.detach().requires_grad_() for t in (x, w)] + \
                ([b.detach().requires_grad_()] if has_bias else [])
            before = dict(ge.gemm_epilogue.route_launches)
            out = ge.fused_gemm_epilogue(*leaves[:2],
                                         leaves[2] if has_bias else None, act)
            took = [r for r, n in ge.gemm_epilogue.route_launches.items()
                    if n != before[r]]
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            # the plain version in f32, its backward through autograd
            ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
            ref = ge._ref_gemm_epilogue(
                *ref_leaves[:2], ref_leaves[2] if has_bias else None, act)
            ref_grads = torch.autograd.grad(ref, ref_leaves, g.float())
            pairs = [(out, ref.detach())] + [      # db as one row
                (gr.reshape(-1, gr.shape[-1]), rg.reshape(-1, rg.shape[-1]))
                for gr, rg in zip(grads, ref_grads)]
            errs = [agreement([pr], dname, floor=1e-2) for pr in pairs]
            del ref, ref_grads, ref_leaves, pairs
            ok = all(e[2] for e in errs) and torch.isfinite(out).all().item() \
                and all(torch.isfinite(t).all().item() for t in grads) \
                and took == [want]
            log(f"k7 {tag} {dname}: [{M}, {K}] @ [{K}, {N}]"
                f"{' + bias' if has_bias else ''}, {act}, route {took} "
                f"(expected {want}), max_abs_err out/"
                f"dx/dw{'/db' if has_bias else ''} "
                f"{'/'.join(f'{e[0]:.2e}' for e in errs)} (tol "
                f"{TOL[dname]:.0e}), max vector-relative error "
                f"{max(e[1] for e in errs):.3e} (tol {VEC_RTOL[dname]:.0e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"k7 {tag} {dname} disagrees with its plain "
                                 f"version")
            if dtype == torch.bfloat16 and tag in ("gpt2-ffn1", "7b-gate"):
                k7_time(torch, F, ge, tag, x, w, b, act, peak, flush, record,
                        errs[0][0])
            del x, w, b, g, leaves, out, grads
    record["gemm_epilogue"]["launches"] = k7_main_path(torch, gen)
    torch.cuda.empty_cache()


def k7_time(torch, F, ge, tag, x, w, b, act, peak, flush, record, err):
    """K7 forward beside its plain version and torch.addmm followed by
    the activation (a yardstick the port never calls), and its bound."""
    M, K = x.shape
    N = w.shape[1]
    ms = kernel_ms(lambda: ge.gemm_epilogue(x, w, b, act), torch, flush,
                   f"k7 {tag} bf16")
    plain_ms = cuda_ms(lambda: ge._ref_gemm_epilogue(x, w, b, act), torch,
                       flush=flush)
    zero = torch.zeros((N,), dtype=x.dtype, device="cuda")
    lib_act = {"gelu": lambda t: F.gelu(t, approximate="tanh"),
               "relu": F.relu, "none": lambda t: t}[act]
    lib_ms = cuda_ms(lambda: lib_act(torch.addmm(
        b if b is not None else zero, x, w)), torch, flush=flush)
    elt = x.element_size()
    nbytes = (M * K + K * N + M * N + (N if b is not None else 0)) * elt
    bound_ms, by = bound(nbytes, 2 * M * N * K, peak)
    if tag == "gpt2-ffn1":
        record["gemm_epilogue"].update(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound_ms, bound_by=by)
    log(f"k7 {tag} bf16 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"addmm + {act} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
        f"{nbytes} bytes, {2 * M * N * K} flops)")


def k7_main_path(torch, gen):
    """GPT-2 345M's FFN at 4096 rows in bf16 through the incubate entry
    points, forward and backward: ``fused_linear_activation`` (gelu)
    then ``fused_matmul_bias``. The counters are zeroed just before and
    read just after: K7 twice, both on the wgmma route (the backward is
    torch.matmul, as in the reference), no other kernel. Returns K7's
    count."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops.kernels import gemm_epilogue as ge
    x, w1, b1, _ = k7_inputs(torch, gen, 4096, 1024, 4096, True,
                             torch.bfloat16)
    _, w2, b2, gy = k7_inputs(torch, gen, 4096, 4096, 1024, True,
                              torch.bfloat16)
    leaves = [t.requires_grad_() for t in (x, w1, b1, w2, b2)]
    zero_counts()
    ge.gemm_epilogue.route_launches = dict.fromkeys(ge.ROUTES, 0)
    h = IF.fused_linear_activation(x, w1, b1, activation="gelu")
    y = IF.fused_matmul_bias(h, w2, b2)
    grads = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    counts = read_counts()
    routes = dict(ge.gemm_epilogue.route_launches)
    with torch.no_grad():
        ref = ge._ref_gemm_epilogue(
            ge._ref_gemm_epilogue(x, w1, b1, "gelu"), w2, b2, "none")
    err, rel, close = agreement([(y, ref.float())], "bfloat16")
    ok = close and counts["k7"] == 2 and routes["wgmma"] == 2 and not any(
        v for k, v in counts.items() if k != "k7") and all(
        torch.isfinite(t).all().item() for t in (y, *grads))
    log(f"k7 main path: GPT-2 345M FFN [4096, 1024] bf16 through "
        f"fused_linear_activation + fused_matmul_bias, forward and backward:"
        f" launches {counts}, by route {routes}, max_abs_err against the "
        f"plain chain {err:.2e}"
        f" (tol {TOL['bfloat16']:.0e}), max vector-relative error {rel:.3e}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("k7 main path: the incubate entry points did not "
                         "run K7 as counted (twice, on the wgmma route), or "
                         "disagree with the plain chain")
    return counts["k7"]


# (tag, M, K, N): Llama-2-7B's projections at 4096 rows (8 x 512 tokens):
# q/k/v/o, gate/up, down and the head; a decode batch; ragged M; then K
# and N off the wide loads' multiples
K8_CASES = (("7b-qkvo", 4096, 4096, 4096), ("7b-gate-up", 4096, 4096, 11008),
            ("7b-down", 4096, 11008, 4096), ("7b-head", 4096, 4096, 32000),
            ("decode", 8, 4096, 11008), ("ragged-m", 1000, 4096, 4096),
            ("ragged-all", 77, 1000, 1002))


def phase_k8(torch, peak, flush, record):
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    gen = torch.Generator(device="cuda").manual_seed(8)
    for tag, M, K, N in K8_CASES:
        x = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        sx = torch.tensor(0.0123, device="cuda")
        sw = 1e-3 + 1e-2 * torch.rand((N,), generator=gen, device="cuda")
        out = qm.quantized_matmul(x, w, sx, sw)
        out_bf = qm.quantized_matmul(x, w, sx, sw, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ref = qm._ref(x, w, sx, sw)
        same = torch.equal(out, ref) and torch.equal(
            out_bf, ref.to(torch.bfloat16))
        err = (out - ref).abs().max().item()
        log(f"k8 {tag}: [{M}, {K}] @ [{K}, {N}] int8, f32 and bf16 out "
            f"bitwise equal to the plain version {same} (max_abs_err "
            f"{err:.2e}) {'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit(f"k8 {tag} disagrees with its plain version")
        del out_bf, ref
        if tag == "7b-gate-up":
            k8_time(torch, qm, x, w, sx, sw, peak, flush, record, err)
        del x, w, out
    torch.cuda.empty_cache()


def k8_time(torch, qm, x, w, sx, sw, peak, flush, record, err):
    """K8 beside its plain version (an f64 product) and torch._int_mm
    with the same epilogue (a yardstick the port never calls), and its
    bound at the int8 tensor-core peak."""
    M, K = x.shape
    N = w.shape[1]
    ms = kernel_ms(lambda: qm.quantized_matmul(x, w, sx, sw), torch, flush,
                   "k8 7b-gate-up")
    plain_ms = cuda_ms(lambda: qm._ref(x, w, sx, sw), torch, iters=5,
                       flush=flush)
    try:
        lib_ms = cuda_ms(lambda: torch._int_mm(x, w).float() * sx
                         * sw[None, :], torch, flush=flush)
    except RuntimeError as e:        # the yardstick only; nothing depends
        lib_ms = None
        log(f"k8: torch._int_mm refused these operands ({e}); library_ms "
            f"not measured")
    nbytes = M * K + K * N + 4 + 4 * N + 4 * M * N
    bound_ms, by = bound(nbytes, 2 * M * N * K, peak, peak[3])
    record["quant_matmul"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound_ms, bound_by=by)
    log(f"k8 7b-gate-up timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" _int_mm + epilogue "
        f"{'not measured' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{bound_ms:.4f} ms ({by}; {nbytes} bytes, {2 * M * N * K} int8 "
        f"operations)")


def serve_wave(srv, prompts, n_new):
    rids = [srv.submit(p, max_new_tokens=n_new) for p in prompts]
    out = srv.run()
    return [out[r] for r in rids]


def counters():
    """The kernels' launch counters: {name: (wrapper, attribute)}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.ops.kernels.fused_tick import fused_tick_attention
    from paddle_tpu_torch.ops.kernels.gemm_epilogue import gemm_epilogue
    from paddle_tpu_torch.ops.kernels.paged_attention import \
        paged_attention
    from paddle_tpu_torch.ops.kernels.quant_matmul import quantized_matmul
    from paddle_tpu_torch.ops.kernels.ragged_prefill import \
        ragged_prefill_attention
    from paddle_tpu_torch.ops.kernels.rope import rope_fwd
    return {"k1": (paged_attention, "launches"),
            "k2": (ragged_prefill_attention, "launches"),
            "k3": (fused_tick_attention, "launches"),
            "k4_fwd": (fa.flash_fwd, "launches"),
            "k4_dq": (fa.flash_bwd, "dq_launches"),
            "k4_dkv": (fa.flash_bwd, "dkv_launches"),
            "k5_fwd": (rn.rms_norm_fwd, "launches"),
            "k5_bwd": (rn.rms_norm_bwd, "launches"),
            "k6": (rope_fwd, "launches"),
            "k7": (gemm_epilogue, "launches"),
            "k8": (quantized_matmul, "launches")}


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
        profile_admit(torch, np, server(mode), prompts, warm, card, mode)
        release()
    for mode in ("split", "fused"):
        profile_decode(torch, np, server(mode), cfg, card, mode)
        release()
    return model


def profile_admit(torch, np, srv, prompts, warm, card, mode):
    """Where an admission tick's time goes, the tick TTFT waits on: a
    warm-up request served first, then the serve wave's 8 prompts
    submitted and the first tick (admission, a 512-token prefill chunk,
    K2 per layer on a split tick, K3 on a fused one) run under
    torch.profiler: device time by kernel and the attention kernel's
    share. Informational: it checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    srv.submit(warm, max_new_tokens=2)
    srv.run()
    for p in prompts:
        srv.submit(p, max_new_tokens=2)
    before = srv.stats["prefill_tokens"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    chunk = srv.stats["prefill_tokens"] - before
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log("profile admit: the profiler recorded no device time (not "
            "measured)")
    else:
        attn = sum(ms for name, ms, _ in kernels if any(
            k in name for k in ("ragged_prefill", "fused_rows",
                                "fused_decode")))
        log(f"profile admit {mode} [{card}]: admission tick ({chunk} "
            f"prompt tokens) {wall_ms:.2f} ms wall under the profiler, "
            f"device busy {busy:.2f} ms ({100 * busy / wall_ms:.1f}%), "
            f"attention kernel {attn:.3f} ms ({100 * attn / busy:.1f}% of "
            f"device time), {sum(k[2] for k in kernels)} kernel launches")
        for name, ms, count in kernels[:10]:
            log(f"  {ms:8.3f} ms/tick  {count:5d}x  {name[:90]}")
    srv.run()


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


@contextlib.contextmanager
def rope_kernel_opt_in():
    """``PT_ROPE_PALLAS=1`` inside the block (K6 rope in the train step,
    as the reference's opt-in), the environment restored after it."""
    old = os.environ.get("PT_ROPE_PALLAS")
    os.environ["PT_ROPE_PALLAS"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PT_ROPE_PALLAS", None)
        else:
            os.environ["PT_ROPE_PALLAS"] = old


def phase_train_parity(torch, np):
    for rope in (False, True):
        train_parity_run(torch, np, rope)


def train_parity_run(torch, np, rope):
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
    want["k6"] = 4 * cfg.num_layers if rope else 0
    res = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = torch.as_tensor(ids, device=model.device)
        batch = {"inputs": (t,), "labels": (t,)}
        opt = AdamW(learning_rate=lr, parameters=model.named_parameters())
        step = train_step_fn(model, model.loss, opt)
        with rope_kernel_opt_in() if rope else contextlib.nullcontext():
            # step 1 by hand, to read its gradients; steps 2 and 3
            # through train_step_fn; the counters zeroed before and read
            # after each
            zero_counts()
            loss = model.loss(model(t), t)
            loss.backward()
            grads = {n: p.grad.float().cpu()
                     for n, p in model.named_parameters()}
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
        not any(c[k] for c in c_gpu for k in ("k1", "k2", "k3", "k7", "k8"))
    tag = "with K6 rope (PT_ROPE_PALLAS=1)" if rope else "composition rope"
    log(f"train_parity llama_tiny f32, {tag}: losses cpu "
        f"{[round(x, 6) for x in l_cpu]} card {[round(x, 6) for x in l_gpu]}"
        f" (max diff {loss_err:.2e}, tol 1e-5), step-1 gradients max diff "
        f"{grad_err:.2e} (atol 1e-5, rtol 1e-4) {grad_ok}, trained weights "
        f"max diff {w_err:.2e} (tol {0.02 * lr:.0e}), launches per step "
        f"{c_gpu}")
    if not (loss_err <= 1e-5 and grad_ok and w_err <= 0.02 * lr and counted
            and quiet and l_gpu[2] < l_gpu[0]):
        raise SystemExit(f"train_parity ({tag}): the card and the CPU "
                         f"disagree, or a step did not launch each kernel "
                         f"as counted")


def phase_int8_parity(torch, np):
    from paddle_tpu_torch.models import (LlamaForCausalLM, export_params,
                                         llama_tiny, load_jax_params)
    from paddle_tpu_torch.ops.kernels.quant_matmul import quantize_tensor
    from paddle_tpu_torch.quantization import to_int8_inference
    cfg = llama_tiny()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=8)
    gpu = LlamaForCausalLM(cfg, device="cuda")
    load_jax_params(gpu, export_params(cpu))
    qc, qg = to_int8_inference(cpu), to_int8_inference(gpu)
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 24))
    zero_counts()
    with torch.no_grad():
        lg = qg(torch.as_tensor(ids, device="cuda"))
        torch.cuda.synchronize()
        counts = read_counts()
        lc = qc(torch.as_tensor(ids))
        h = qc(torch.as_tensor(ids), return_hidden=True)
    # one quantisation step of the head: its input scale x its largest
    # weight scale x 127, what one flipped input code moves a logit by
    _, sx = quantize_tensor(h.reshape(-1, h.shape[-1]))
    step = (sx * qc.lm_head.w_scale.max() * 127).item()
    err = (lg.cpu() - lc).abs().max().item()
    argmax = torch.equal(lg.cpu().argmax(-1), lc.argmax(-1))
    cb = dict(qc.named_buffers())
    codes = all(torch.equal(b.cpu(), cb[n]) for n, b in qg.named_buffers()
                if n.endswith(("qweight", "w_scale")))
    L = cfg.num_layers
    launched = counts["k8"] == 7 * L + 1 and not any(
        counts[k] for k in ("k1", "k2", "k3", "k6", "k7", "k4_dq", "k4_dkv",
                            "k5_bwd"))
    log(f"int8_parity llama_tiny f32: int8 codes and scales of every layer "
        f"equal card/CPU {codes}, logits max diff {err:.3e} (tol one quantisation "
        f"step of the head, {step:.3e}), greedy argmax equal {argmax}, "
        f"launches per forward {counts}")
    if not (codes and err <= step and argmax and launched
            and torch.isfinite(lg).all().item()):
        raise SystemExit("int8_parity: the card and the CPU disagree, or a "
                         "forward did not launch K8 7 x layers + 1 times")


def phase_int8_infer(torch, np, card, record, model):
    """Llama-2-7B bf16 (the serve phase's model, or a new one from seed
    0), then converted in place to int8: one forward each of 8 x 512 ids
    from seed 0."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b
    from paddle_tpu_torch.quantization import to_int8_inference
    cfg = llama2_7b()
    if model is None:
        model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                 seed=0)
    L = cfg.num_layers
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 512)), device="cuda")
    tokens = ids.numel()

    def timed(n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model(ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    with torch.no_grad():
        model(ids)                                # warm
        zero_counts()
        ref = model(ids)
        torch.cuda.synchronize()
        c_bf16 = read_counts()
        ms_bf16 = timed()
        profile_once(torch, lambda: model(ids), card, "bf16_infer", "forward")
        t0 = time.perf_counter()
        to_int8_inference(model, inplace=True)
        torch.cuda.synchronize()
        conv_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = model(ids)
        torch.cuda.synchronize()
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        ms_int8 = timed()
        profile_once(torch, lambda: model(ids), card, "int8_infer", "forward")
    int8_bytes = sum(b.numel() * b.element_size() for b in model.buffers()
                     if b.dtype == torch.int8)
    top1 = (out.argmax(-1) == ref.argmax(-1)).float().mean().item()
    rel = ((out.float() - ref.float()).abs().amax(-1)
           / ref.float().abs().amax(-1)).max().item()
    fwd = {"k4_fwd": L, "k5_fwd": 2 * L + 1}
    log(f"int8_infer: Llama-2-7B, {L} layers, 8 x 512 ids from seed 0; "
        f"to_int8_inference in place in {conv_s:.1f} s ({int8_bytes} bytes "
        f"of int8 weights); launches per forward bf16 {c_bf16}, int8 "
        f"{counts}")
    log(f"int8_infer metrics [{card}]: bf16 {ms_bf16:.1f} ms per forward "
        f"({tokens / ms_bf16 * 1e3:.0f} tokens/s), int8 {ms_int8:.1f} ms "
        f"({tokens / ms_int8 * 1e3:.0f} tokens/s), peak memory after the "
        f"conversion {peak_gb:.2f} GiB; int8 against bf16 (informational): "
        f"top-1 agreement {top1:.4f}, largest relative logit error "
        f"{rel:.4f}")
    checks = {"int8 logits finite": torch.isfinite(out).all().item(),
              "k8 == 7 x layers + 1": counts["k8"] == 7 * L + 1,
              "bf16 forward: K4 and K5 forward only, no K8":
                  {k: c_bf16[k] for k in fwd} == fwd and not any(
                      v for k, v in c_bf16.items() if k not in fwd),
              "int8 forward: K8, K4 and K5 forward only":
                  {k: counts[k] for k in fwd} == fwd and not any(
                      v for k, v in counts.items()
                      if k not in fwd and k != "k8")}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"int8_infer: check failed: {name}")
    record["quant_matmul"]["launches"] = counts["k8"]


def run_350m(torch, np, n, count_warmup=False):
    """llama_350m in bf16 from seed 0, AdamW(1e-4), the fixed 8 x 1024
    batch from seed 0: 2 warm-up steps by hand (their gradients checked
    finite), then ``n`` timed ``train_step_fn`` steps. The counters are
    zeroed before the timed steps, or before the warm-up with
    ``count_warmup``, and read after the last step."""
    import gc
    from paddle_tpu_torch.jit import train_step_fn
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_350m
    from paddle_tpu_torch.optimizer import AdamW
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama_350m()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters())
    B, S = 8, 1024
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    batch = {"inputs": (ids,), "labels": (ids,)}
    step = train_step_fn(model, model.loss, opt)
    losses, grads_finite = [], True
    if count_warmup:
        zero_counts()
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
    if not count_warmup:
        zero_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        losses.append(step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = [x.item() for x in losses]
    finite = all(np.isfinite(losses)) and all(
        torch.isfinite(p).all().item() for p in model.parameters())
    return {"cfg": cfg, "model": model, "step": step, "batch": batch,
            "losses": losses, "counts": counts, "wall": wall,
            "step_ms": wall / n * 1e3, "tok_s": B * S * n / wall,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "finite": finite and grads_finite,
            "n_params": sum(p.numel() for p in model.parameters())}


def phase_train(torch, np, card, peak, record):
    n = 10
    r = run_350m(torch, np, n)
    cfg, counts, losses = r["cfg"], r["counts"], r["losses"]
    L, B, S = cfg.num_layers, 8, 1024
    log(f"train: llama_350m bf16, {L} layers, {r['n_params']} parameters, "
        f"AdamW(1e-4) f32 moments, batch {B} x {S} from seed 0")
    want = per_step_counts(L, n)
    flops = 6 * r["n_params"] * B * S + 3 * 2 * B * cfg.num_heads * S * S \
        * cfg.head_dim * L
    per_step_s = r["wall"] / n
    log(f"train losses: {[round(x, 4) for x in losses]}")
    log(f"train metrics [{card}]: {r['step_ms']:.1f} ms per step, "
        f"{r['tok_s']:.0f} tokens/s, peak memory {r['peak_gb']:.2f} GiB, "
        f"{flops / per_step_s / 1e12:.1f} model TFLOP/s "
        f"({100 * flops / per_step_s / peak[1]:.1f}% of the bf16 peak)")
    log(f"train launches over {n} steps: {counts}")
    checks = {"loss falls": losses[-1] < losses[0],
              "losses, weights and warm-up gradients finite": r["finite"],
              "launches == steps x per-step counts":
                  {k: counts[k] for k in want} == want,
              "no serving, rope, epilogue or int8 kernel":
                  not any(counts[k] for k in ("k1", "k2", "k3", "k6", "k7",
                                              "k8"))}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"train: check failed: {name}")
    record["flash_attention_fwd"]["launches"] = counts["k4_fwd"]
    record["flash_attention_bwd"]["launches"] = counts["k4_dq"]
    record["rms_norm_fwd"]["launches"] = counts["k5_fwd"]
    record["rms_norm_bwd"]["launches"] = counts["k5_bwd"]
    profile_once(torch, lambda: r["step"](r["batch"]), card)
    return {"losses": losses, "step_ms": r["step_ms"]}


def phase_train_rope(torch, np, card, record, train):
    """The train phase's run with K6 rope: the same losses expected (K6 is
    the composition bit for bit, forward and backward)."""
    n = 5
    with rope_kernel_opt_in():
        r = run_350m(torch, np, n, count_warmup=True)
    counts, losses = r["counts"], r["losses"]
    L = r["cfg"].num_layers
    steps = n + 2
    want = {**per_step_counts(L, steps), "k6": steps * 4 * L}
    ref = train["losses"][:steps]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    log(f"train_rope losses: {[round(x, 4) for x in losses]}; the train "
        f"phase's first {steps}: {[round(x, 4) for x in ref]}; largest "
        f"relative difference {rel:.2e} (tol 1e-3), equal {losses == ref}")
    log(f"train_rope metrics [{card}]: {r['step_ms']:.1f} ms per step with "
        f"K6 rope, {train['step_ms']:.1f} ms with the composition (train "
        f"phase), {r['tok_s']:.0f} tokens/s, peak memory "
        f"{r['peak_gb']:.2f} GiB; launches over {steps} steps: {counts}")
    checks = {"losses within 1e-3 of train's": rel <= 1e-3,
              "losses, weights and warm-up gradients finite": r["finite"],
              "launches == steps x per-step counts (K6: 4 x layers)":
                  {k: counts[k] for k in want} == want,
              "no serving, epilogue or int8 kernel":
                  not any(counts[k] for k in ("k1", "k2", "k3", "k7",
                                              "k8"))}
    for name, good in checks.items():
        if not good:
            raise SystemExit(f"train_rope: check failed: {name}")
    record["rope"]["launches"] = counts["k6"]


def profile_once(torch, fn, card, what="train", unit="step"):
    """Where one call's time goes (a train step, an int8 forward): ``fn``
    once under torch.profiler, device time by kernel and the device's
    busy share of the wall time. Informational: it checks nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log(f"profile {what}: the profiler recorded no device time (not "
            f"measured)")
        return
    log(f"profile {what} [{card}]: one {unit} {wall_ms:.1f} ms wall (under "
        f"the profiler), device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), {sum(k[2] for k in kernels)} kernel "
        f"launches")
    for name, ms, count in kernels[:12]:
        log(f"  {ms:8.3f} ms/{unit}  {count:5d}x  {name[:90]}")
    # the port's own kernels (each library's anonymous namespace; PyTorch
    # has kernels there too, named with at:: or c10:: types), ranked or
    # not: K4's three and K5's in a train step
    ours = [(name.split("::")[1].split("(")[0], ms, count)
            for name, ms, count in kernels
            if name.startswith("void (anonymous namespace)::")
            and "at::" not in name and "c10::" not in name]
    log(f"profile {what}: the port's kernels, {sum(k[1] for k in ours):.3f} "
        f"ms/{unit}: " + ", ".join(f"{n} {ms:.3f} ms ({c}x)"
                                     for n, ms, c in ours))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args()
    phases = [p for p in args.only.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if "train_rope" in phases and "train" not in phases:
        ap.error("train_rope compares its losses with the train phase's: "
                 "run both")
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
    # the reference's default rope (the composition) everywhere but the
    # phases that opt in to K6 themselves
    os.environ.pop("PT_ROPE_PALLAS", None)
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
            ("rms_norm_bwd", "rms_norm.cu", "rms_norm.py:91"),
            ("rope", "rope.cu", "rope.py:89"),
            ("gemm_epilogue", "gemm_epilogue.cu", "gemm_epilogue.py:72"),
            ("quant_matmul", "quant_matmul.cu", "quant_matmul.py:51")):
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
    if "k6" in phases:
        phase_k6(torch, peak, flush, record)
    if "k7" in phases:
        phase_k7(torch, peak, flush, record)
    if "k8" in phases:
        phase_k8(torch, peak, flush, record)
    del flush
    if "parity" in phases:
        phase_parity(torch, np)
    if "train_parity" in phases:
        phase_train_parity(torch, np)
    if "int8_parity" in phases:
        phase_int8_parity(torch, np)
    model_7b = None
    if "serve" in phases:
        torch.cuda.empty_cache()
        model_7b = phase_serve(torch, np, card, record)
    if "int8_infer" in phases:
        phase_int8_infer(torch, np, card, record, model_7b)
    del model_7b
    if "train" in phases:
        train = phase_train(torch, np, card, peak, record)
    if "train_rope" in phases:
        phase_train_rope(torch, np, card, record, train)
    log(json.dumps({"kernels": list(record.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
