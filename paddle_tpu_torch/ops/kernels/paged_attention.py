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
falling back. ``paged_attention.launches`` counts kernel launches.
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention", "NEG_INF"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)     # llama_tiny, llama_350m, Llama-2-7B/70B
MAX_REP = 8


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
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                         + [ctypes.c_float, ctypes.c_void_p])
    S, nh, hd = q.shape
    _, pg, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             S, nh, kvh, hd, pg, block_tables.shape[1], _DTYPES[q.dtype],
             float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
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
