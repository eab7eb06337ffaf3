"""Paged decode attention (K1): the CUDA kernel and its plain version.

Port of ``paddle_tpu/ops/pallas/paged_attention.py``. K/V live in a
global page pool ``[num_pages, page_size, kv_heads, head_dim]``; each
slot owns an ordered block table of page ids and a length. One query
row per slot attends over its first ``length`` positions (GQA: query
head h reads kv head h // rep).

``paged_attention`` launches the hand-written kernel
(``csrc/paged_attention.cu``) for CUDA tensors and the plain version
``_ref_paged_attention`` for CPU tensors — the choice follows where the
tensors lie, and a CUDA tensor the kernel cannot take raises instead of
falling back. ``paged_attention.launches`` counts kernel launches: one
per call, though bf16 runs two kernels (the splits, then their merge).

bf16 splits each slot's keys over blocks of ``pages_per_split`` pages
(``decode_split_plan``, from static shapes and the card's SM count
only, so a call never waits on the lengths), and merges the splits'
partial softmax states in index order through a float32 workspace the
wrapper allocates: the same function, bitwise repeatable.
"""
import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

__all__ = ["paged_attention", "decode_split_plan", "NEG_INF"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)     # llama_tiny, llama_350m, Llama-2-7B/70B
MAX_REP = 8

# the split-K decode body (csrc/paged_decode.cuh): keys a tile, pages a
# split at most (kMaxSplitPages), and the keys a split walks by choice
KEY_TILE = 64
MAX_SPLIT_PAGES = 64
SPLIT_KEYS = 256


class SplitPlan(NamedTuple):
    pages_per_split: int
    splits: int
    workspace: Optional[Tuple[int, int, int, int]]   # f32; None: 1 split


def decode_split_plan(S, nh, kvh, hd, pg, pages, sm_count):
    """The bf16 decode kernels' split of each slot's ``pages`` pages
    (K1: the table's width; K3 at C = 1: the live slice's width): split
    z walks pages ``z * pages_per_split ..``, at most ``SPLIT_KEYS``
    keys. While the grid (slots x kv heads x splits) would not fill the
    card four times over, splits halve, down to one 64-key tile. The
    workspace [S, nh, splits, hd + 2] holds each split's unnormalised
    f32 output, its running max (base 2) and its sum; one split needs
    none. Static shapes in, static plan out: nothing here depends on
    the lengths."""
    pps = max(1, min(pages, MAX_SPLIT_PAGES, SPLIT_KEYS // pg))
    while (S * kvh * -(-pages // pps) < 4 * sm_count
           and (pps // 2) * pg >= KEY_TILE):
        pps //= 2
    splits = -(-pages // pps)
    ws = (S, nh, splits, hd + 2) if splits > 1 else None
    return SplitPlan(pps, splits, ws)


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_args(q, k_pages, pages):
    """(workspace or None, pages_per_split, splits) of a decode launch
    over ``pages`` pages of the pool: bf16 splits by
    ``decode_split_plan``, f32 does not split ((None, 0, 0))."""
    if q.dtype != torch.bfloat16:
        return None, 0, 0
    S, nh, hd = q.shape[0], q.shape[-2], q.shape[-1]
    _, pg, kvh, _ = k_pages.shape
    plan = decode_split_plan(S, nh, kvh, hd, pg, pages,
                             sm_count(q.device.index))
    ws = None if plan.workspace is None else torch.empty(
        plan.workspace, dtype=torch.float32, device=q.device)
    return ws, plan.pages_per_split, plan.splits


def _ref_split_decode(q, k_pages, v_pages, pages, bases, lim, sm_scale,
                      pages_per_split):
    """Plain version of the bf16 decode kernels' split and merge (K1, and
    K3 at C = 1), in their order of operations: slot s walks pool pages
    ``pages[s]`` (-1: a page not read), page e holding positions
    ``bases[s, e] ..``; a key is visible at positions up to ``lim[s]``.
    Split z takes pages ``z * pages_per_split ..`` and keeps its own
    base-2 softmax state (max m, sum l, unnormalised acc, probabilities
    rounded to q's type for P V); the splits then merge in index order.
    A split with no visible key adds nothing; a slot with none is zeros.
    q [S, nh, hd]; returns [S, nh, hd] float32."""
    S, nh, hd = q.shape
    _, pg, kvh, _ = k_pages.shape
    rep = nh // kvh
    scale2 = sm_scale * 1.4426950408889634          # scale * log2(e)
    out = torch.zeros(S, nh, hd)
    for s in range(S):
        m_all, l_all, acc_all = [], [], []
        for z in range(0, pages.shape[1], pages_per_split):
            ids = pages[s, z:z + pages_per_split].long()
            pos = bases[s, z:z + pages_per_split, None].long() \
                + torch.arange(pg)
            ok = ((ids[:, None] >= 0) & (pos <= int(lim[s]))).reshape(-1)
            if not ok.any():
                continue
            k = k_pages[ids.clamp(min=0)].reshape(-1, kvh, hd)
            v = v_pages[ids.clamp(min=0)].reshape(-1, kvh, hd)
            k = k.repeat_interleave(rep, 1).float()
            v = v.repeat_interleave(rep, 1).float()
            sc = torch.einsum("nd,knd->nk", q[s].float(), k) * scale2
            sc = sc.masked_fill(~ok, NEG_INF)
            m = sc.max(-1).values
            p = torch.exp2(sc - m[:, None]).masked_fill(~ok, 0.0)
            m_all.append(m)
            l_all.append(p.sum(-1))
            acc_all.append(torch.einsum(
                "nk,knd->nd", p.to(q.dtype).float(), v))
        if not m_all:
            continue
        mx = torch.stack(m_all).max(0).values
        lsum = torch.zeros(nh)
        acc = torch.zeros(nh, hd)
        for m, l, a in zip(m_all, l_all, acc_all):     # in index order
            c = torch.exp2(m - mx)
            lsum = lsum + l * c
            acc = acc + a * c[:, None]
        out[s] = acc / lsum[:, None]
    return out


def _ref_paged_attention(q, k_pages, v_pages, block_tables, lengths,
                         sm_scale):
    """Plain version: gather the slot's pages into a contiguous
    ``[S, maxp * pg]`` frame and mirror the reference's composition op
    for op (same einsum specs, -1e30 mask, f32 softmax, probabilities
    cast to q's dtype before the value product). A slot of length 0
    reads as zeros, as the kernels (TPU and CUDA) give it; the JAX
    gather reference would average the whole frame there instead."""
    S, nh, hd = q.shape
    _, pg, kvh, _ = k_pages.shape
    maxp = block_tables.shape[1]
    T = maxp * pg
    bt = block_tables.long()
    k = k_pages[bt].reshape(S, T, kvh, hd)
    v = v_pages[bt].reshape(S, T, kvh, hd)
    rep = nh // kvh
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bsnd,btnd->bnst", q[:, None], k) * sm_scale
    lengths = lengths.to(q.device)
    pos = torch.arange(T, device=q.device)
    ok = pos[None, None] < lengths[:, None, None]             # [S, 1, T]
    logits = logits.float().masked_fill(~ok[:, None], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bnst,btnd->bsnd", p, v)[:, 0]
    return out.masked_fill((lengths <= 0)[:, None, None], 0.0)


def _check(q, k_pages, v_pages, block_tables, lengths):
    """The kernel's contract, checked before any pointer leaves Python."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be [S, nh, hd] and the pools "
                         "[P, pg, kvh, hd]")
    S, nh, hd = q.shape
    _, pg, kvh, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if nh % kvh or nh // kvh > MAX_REP:
        raise ValueError(f"query heads ({nh}) must be a multiple of kv "
                         f"heads ({kvh}), at most {MAX_REP}x")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or block_tables.dtype != torch.int32:
        raise TypeError("block_tables must be [S, maxp] int32")
    if lengths.shape != (S,) or lengths.dtype != torch.int32:
        raise TypeError("lengths must be [S] int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(q, k_pages, v_pages, block_tables, lengths, sm_scale):
    _check(q, k_pages, v_pages, block_tables, lengths)
    fn = _build.function("paged_attention", "paged_attention_launch",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                         + [ctypes.c_float, ctypes.c_void_p])
    S, nh, hd = q.shape
    _, pg, kvh, _ = k_pages.shape
    maxp = block_tables.shape[1]
    ws, pps, splits = split_args(q, k_pages, maxp)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), S, nh, kvh, hd, pg,
             maxp, pps, splits, _DTYPES[q.dtype], float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    sm_scale=None):
    """Ragged paged-attention decode step.

    q            [slots, num_heads, head_dim]   one query token per slot
    k_pages      [num_pages, page_size, kv_heads, head_dim]  global pool
    v_pages      same shape as ``k_pages``
    block_tables [slots, pages_per_slot] int32  page ids in position
                 order; entries past a slot's allocation must hold a
                 valid id (the allocator fills them with the null page)
    lengths      [slots] int32  valid KV tokens per slot; a length past
                 the table's span reads the whole table

    Returns [slots, num_heads, head_dim] in q's dtype. CUDA tensors run
    the kernel (f32 or bf16, head_dim 16/64/128, GQA up to 8x); CPU
    tensors run ``_ref_paged_attention``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, block_tables, lengths,
                       sm_scale)
    return _ref_paged_attention(q, k_pages, v_pages, block_tables,
                                lengths, sm_scale)


paged_attention.launches = 0
