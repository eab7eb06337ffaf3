"""Fused mixed prefill/decode tick attention (K3): the CUDA kernel, its
plain version and the host-side page schedule.

Port of ``paddle_tpu/ops/pallas/fused_tick.py``. One serving tick's
attention — every slot's prompt chunk at its prefix offset, every live
slot's single decode row, nothing for idle slots — runs as ONE launch
over the global page pool. Row c of slot s attends to key positions
``<= t0[s] + c``, and only through the pages that the schedule
``(sched_slot, sched_page)`` lists for s: ``build_schedule`` lists, slot
by slot, exactly the pages a slot's live rows can see, so a page past a
slot's frontier is never read. A slot with ``last < 0`` is idle and
reads as zeros.

``fused_tick_attention`` launches the hand-written kernel
(``csrc/fused_tick.cu``) for CUDA tensors and the plain version
``_ref_fused_tick`` for CPU tensors; a CUDA tensor the kernel cannot
take raises. ``fused_tick_attention.launches`` counts kernel launches:
one per call, whatever the chunk width.
"""
import ctypes
import math

import numpy as np
import torch

from . import _build
from .paged_attention import _DTYPES, MAX_REP, _ref_paged_attention
from .ragged_prefill import _check as _check_ragged
from .ragged_prefill import _ref_ragged_prefill

__all__ = ["fused_tick_attention", "build_schedule"]


# ------------------------------------------------------------- schedule


def _ladder(n, min_entries):
    """Quarter-octave schedule-length ladder: round ``n`` up to the next
    multiple of ``2**floor(log2 n) / 4``, so the pad stays under ~25% of
    the live entries while the distinct lengths stay O(log pages)."""
    n = max(int(n), int(min_entries))
    step = max(1, (1 << (n.bit_length() - 1)) // 4)
    return -(-n // step) * step


def build_schedule(last, page_size, n_slots=None, min_entries=8):
    """Host-side page schedule for one fused launch.

    ``last`` ([S] ints): each slot's last written position this launch
    (prefill: ``t0 + take - 1``; decode: ``t``; idle: ``-1``). A live
    slot contributes entries ``(s, 0) .. (s, last // page_size)`` —
    exactly the pages any of its live rows may attend to — in slot-major
    page order. The schedule is padded up the quarter-octave ladder
    (floor ``min_entries``) with ``(n_slots, 0)`` sentinels the kernel
    skips.

    Returns ``(sched_slot, sched_page, n_live)``: two int32 arrays of
    equal ladder length and the number of real (unpadded) entries."""
    last = np.asarray(last, np.int64)
    if n_slots is None:
        n_slots = last.shape[0]
    npages = np.where(last >= 0, last // int(page_size) + 1, 0)
    n_live = int(npages.sum())
    total = _ladder(n_live, min_entries)
    ss = np.full(total, int(n_slots), np.int32)
    sp = np.zeros(total, np.int32)
    ss[:n_live] = np.repeat(np.arange(last.shape[0]), npages)
    sp[:n_live] = np.arange(n_live) - np.repeat(
        np.cumsum(npages) - npages, npages)
    return ss, sp, n_live


# ------------------------------------------------------- plain version


def _ref_fused_tick(q, k_pages, v_pages, block_tables, t0, last, dec,
                    sm_scale):
    """Plain version: gather through the live block-table slice. Prefill
    rows take the C-row causal path of ``_ref_ragged_prefill``; decode
    rows (``dec > 0``) take the s=1 path of ``_ref_paged_attention`` at
    lengths ``t0 + 1`` — the computation the split decode step runs on
    the CPU — with rows 1.. of a decode slot zeroed. Idle slots
    (``last < 0``) read as zeros."""
    pre = _ref_ragged_prefill(q, k_pages, v_pages, block_tables, t0, last,
                              sm_scale)
    lengths = (t0.to(q.device) + 1).to(torch.int32)
    dec_row = _ref_paged_attention(q[:, 0], k_pages, v_pages, block_tables,
                                   lengths, sm_scale)
    dec_full = torch.cat([dec_row[:, None], torch.zeros_like(q[:, 1:])], 1)
    out = torch.where((dec.to(q.device) > 0)[:, None, None, None],
                      dec_full, pre)
    return out.masked_fill((last.to(q.device) < 0)[:, None, None, None],
                           0.0)


# -------------------------------------------------------------- kernel


def _check(q, k_pages, v_pages, block_tables, t0, last, dec, sched_slot,
           sched_page):
    """The kernel's contract, checked before any pointer leaves Python:
    K2's (shapes, types, devices, contiguity of q, the pools, the table,
    ``t0`` and ``last``), a GQA ratio of at most ``MAX_REP``, ``dec``,
    the schedule, and 16-byte aligned q and pools."""
    _check_ragged(q, k_pages, v_pages, block_tables, t0, last)
    nh, kvh = q.shape[2], k_pages.shape[2]
    if nh // kvh > MAX_REP:
        raise ValueError(f"query heads ({nh}) over kv heads ({kvh}) is "
                         f"more than {MAX_REP}x")
    if dec.shape != t0.shape or dec.dtype != torch.int32:
        raise TypeError("dec must be [S] int32")
    if sched_slot.dim() != 1 or sched_slot.shape != sched_page.shape \
            or sched_slot.shape[0] < 1:
        raise ValueError("sched_slot and sched_page must be [G] with the "
                         "same G >= 1")
    if sched_slot.dtype != torch.int32 or sched_page.dtype != torch.int32:
        raise TypeError("sched_slot and sched_page must be int32")
    for name, t in (("dec", dec), ("sched_slot", sched_slot),
                    ("sched_page", sched_page)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernel reads it in 16-byte vectors)")


def _launch(q, k_pages, v_pages, block_tables, t0, last, dec, sched_slot,
            sched_page, sm_scale):
    _check(q, k_pages, v_pages, block_tables, t0, last, dec, sched_slot,
           sched_page)
    fn = _build.function("fused_tick", "fused_tick_launch",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                         + [ctypes.c_float, ctypes.c_void_p])
    S, C, nh, hd = q.shape
    _, pg, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), t0.data_ptr(), last.data_ptr(),
             sched_slot.data_ptr(), sched_page.data_ptr(), out.data_ptr(),
             S, C, nh, kvh, hd, pg, block_tables.shape[1],
             sched_slot.shape[0], _DTYPES[q.dtype], float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tick kernel launch failed: CUDA error "
                           f"{err}")
    fused_tick_attention.launches += 1
    return out


# --------------------------------------------------------------- public


def fused_tick_attention(q, k_pages, v_pages, block_tables, t0, last, dec,
                         sched_slot, sched_page, sm_scale=None):
    """Fused mixed prefill/decode tick attention over paged KV.

    q            [slots, chunk, num_heads, head_dim]  one packed row
                 group per slot: a prompt chunk (right-padded), a single
                 decode row in row 0, or garbage for idle slots
    k_pages      [num_pages, page_size, kv_heads, head_dim]  global pool
    v_pages      same shape as ``k_pages``
    block_tables [slots, live_width] int32  the LIVE slice of the block
                 tables (tail entries hold a valid id, the null page)
    t0           [slots] int32  absolute position of each slot's row 0
                 (decode: the write position ``t``)
    last         [slots] int32  last position each slot's rows write
                 (``t0 + take - 1``; decode: ``t0``); ``-1`` marks an
                 idle slot, which reads as zeros
    dec          [slots] int32  1 for decode slots: the plain version
                 routes them through the s=1 decode computation; the
                 kernel is phase-agnostic
    sched_slot / sched_page
                 [entries] int32 page schedule from ``build_schedule``

    Row c of slot s attends to key positions <= t0[s] + c. Returns
    [slots, chunk, num_heads, head_dim] in q's dtype: idle slots are
    zeros; rows of a live slot past its take (and rows 1.. of a decode
    slot) are garbage the caller discards. CUDA tensors run the kernel
    (f32 or bf16, head_dim 16/64/128, GQA up to 8x); CPU tensors run
    ``_ref_fused_tick``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, block_tables, t0, last, dec,
                       sched_slot, sched_page, sm_scale)
    return _ref_fused_tick(q, k_pages, v_pages, block_tables, t0, last, dec,
                           sm_scale)


fused_tick_attention.launches = 0
