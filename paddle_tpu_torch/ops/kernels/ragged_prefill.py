"""Ragged prefill attention over the paged pool (K2): the CUDA kernel
and its plain version.

Port of ``paddle_tpu/ops/pallas/ragged_prefill.py``. Several
variable-length prompt chunks — one per serving slot — are packed into
one ``[slots, chunk]`` launch and attend causally over the global page
pool through their slots' block tables, each at its own prefix offset
``t0`` (a prefix-cache hit resumes at the first uncached token). Row c
of slot s sees key positions ``<= t0[s] + c``; a slot with
``last < 0`` (the scheduler's idle sentinel) is skipped and reads as
zeros.

``ragged_prefill_attention`` launches the hand-written kernel
(``csrc/ragged_prefill.cu``) for CUDA tensors and the plain version
``_ref_ragged_prefill`` for CPU tensors; a CUDA tensor the kernel
cannot take raises. bf16 runs on the tensor cores (``mma.sync``, K/V
gathered with ``cp.async`` into a two-stage ring, one block per 64 query
vectors of a kv head's GQA group); f32 runs SIMT in full f32.
``ragged_prefill_attention.launches`` counts kernel launches.
"""
import ctypes
import math

import torch

from . import _build
from .paged_attention import _DTYPES, HEAD_DIMS, NEG_INF

__all__ = ["ragged_prefill_attention"]

# the bf16 kernel's block holds 64 query vectors: rows x the GQA group
MAX_REP_BF16 = 64


def _ref_ragged_prefill(q, k_pages, v_pages, block_tables, t0, last,
                        sm_scale):
    """Plain version: gather each slot's pages into the contiguous
    ``[S, maxp * pg]`` frame and mirror the reference's composition op
    for op (same einsum specs, -1e30 causal mask at ``t0 + row``, f32
    softmax, probabilities cast to q's dtype). Idle slots
    (``last < 0``) read as zeros. Rows past a slot's ``last`` (chunk
    padding) are causally self-contained garbage that callers discard;
    the kernel also stops their keys at ``last``, so only live rows
    agree between the two."""
    S, C, nh, hd = q.shape
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
    logits = torch.einsum("bsnd,btnd->bnst", q, k) * sm_scale
    pos = torch.arange(T, device=q.device)
    row = t0.to(q.device).long()[:, None] \
        + torch.arange(C, device=q.device)[None]                # [S, C]
    ok = pos[None, None] <= row[:, :, None]                     # [S, C, T]
    logits = logits.float().masked_fill(~ok[:, None], NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bnst,btnd->bsnd", p, v)
    return out.masked_fill((last.to(q.device) < 0)[:, None, None, None],
                           0.0)


def _check(q, k_pages, v_pages, block_tables, t0, last):
    """The kernel's contract, checked before any pointer leaves Python."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("q must be [S, C, nh, hd] and the pools "
                         "[P, pg, kvh, hd]")
    S, _, nh, hd = q.shape
    _, _, kvh, hd_k = k_pages.shape
    if v_pages.shape != k_pages.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if nh % kvh:
        raise ValueError(f"query heads ({nh}) must be a multiple of kv "
                         f"heads ({kvh})")
    if q.dtype == torch.bfloat16 and nh // kvh > MAX_REP_BF16:
        raise ValueError(f"bf16 takes at most {MAX_REP_BF16} query heads "
                         f"per kv head, got {nh // kvh}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or block_tables.dtype != torch.int32:
        raise TypeError("block_tables must be [S, maxp] int32")
    for name, t in (("t0", t0), ("last", last)):
        if t.shape != (S,) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be [S] int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("t0", t0),
                    ("last", last)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(q, k_pages, v_pages, block_tables, t0, last, sm_scale):
    _check(q, k_pages, v_pages, block_tables, t0, last)
    fn = _build.function("ragged_prefill", "ragged_prefill_launch",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_void_p])
    S, C, nh, hd = q.shape
    _, pg, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), t0.data_ptr(), last.data_ptr(),
             out.data_ptr(), S, C, nh, kvh, hd, pg, block_tables.shape[1],
             _DTYPES[q.dtype], float(sm_scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_prefill kernel launch failed: CUDA "
                           f"error {err}")
    ragged_prefill_attention.launches += 1
    return out


def ragged_prefill_attention(q, k_pages, v_pages, block_tables, t0,
                             last=None, sm_scale=None):
    """Ragged packed-prefill attention over paged KV.

    q            [slots, chunk, num_heads, head_dim]  packed prompt
                 chunks, one right-padded segment per slot
    k_pages      [num_pages, page_size, kv_heads, head_dim]  global pool
    v_pages      same shape as ``k_pages``
    block_tables [slots, pages_per_slot] int32  page ids in position
                 order; unused entries hold a valid id (the null page)
    t0           [slots] int32  absolute position of each chunk's row 0
    last         [slots] int32  last position each chunk writes
                 (t0 + take - 1); -1 skips the slot. Defaults to
                 ``t0 + chunk - 1``.

    Row c of slot s attends to key positions <= t0[s] + c. Returns
    [slots, chunk, num_heads, head_dim] in q's dtype. CUDA tensors run
    the kernel (f32 or bf16, head_dim 16/64/128, any GQA ratio in f32, up
    to 64 query heads per kv head in bf16); CPU tensors run
    ``_ref_ragged_prefill``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if last is None:
        last = (t0 + q.shape[1] - 1).to(torch.int32)
    if q.is_cuda:
        return _launch(q, k_pages, v_pages, block_tables, t0, last,
                       sm_scale)
    return _ref_ragged_prefill(q, k_pages, v_pages, block_tables, t0,
                               last, sm_scale)


ragged_prefill_attention.launches = 0
