"""Rotary position embedding (K6): the CUDA kernel, its plain versions and
the autograd Functions.

Port of ``paddle_tpu/ops/pallas/rope.py:73-113`` (``apply_rotary_pallas``
/ ``_rope_call``): the neox half rotation of x ``[B, S, H, D]`` at rows
0..S-1 of cos/sin tables ``[S_max, D/2]``::

    out1 = x1 * c - sign * x2 * s,  out2 = x2 * c + sign * x1 * s

in f32, rounded once to x's dtype. The tables are f32 or bf16, as the
reference's kernel takes them: with bf16 tables and bf16 x each product
is rounded to bf16 first (bf16 * bf16 is bf16 in both frameworks), and
the result is the reference's interpreted Pallas kernel bit for bit.
``sign = +1`` is the rotation;
``sign = -1`` is its transpose, which is the backward: the reference
kernel has no VJP of its own (ROADMAP, Queue 3), the port's backward is
the same kernel run the other way. The backward rounds each product to
x's dtype before the sum, as the VJP of the reference's composition
does (``jax.vjp`` of ``_apply_rotary_jnp`` and torch autograd alike), so
in bf16 too it is that VJP bit for bit, and a train step through K6 is
the train step through the composition.

``rope_fwd`` (one tensor) and ``rope_qk_fwd`` (q ``[B, S, Hq, D]`` and k
``[B, S, Hk, D]`` at the same positions, one launch: the reference
model's single rope dispatch over ``(q, k)``) launch the hand-written
kernel (``csrc/rope.cu``) for CUDA tensors and the plain versions
``_ref_rope`` / ``_ref_rope_qk`` for CPU tensors; a CUDA tensor the
kernel cannot take raises instead of falling back. Each counts its
launches in ``.launches`` (forward and backward alike) and each route's
in ``.route_launches``.

The kernel walks (head group, position, 16-byte chunk) items in a static
plan (``plan``, from the shape, the route, the SM count and the kernel's
blocks a SM only; ``plan_cover`` models its walk on the CPU). ``route``
picks the 16-byte body (``vector``) or the scalar one before the launch.
"""
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .paged_attention import sm_count

__all__ = ["rope_fwd", "rope_qk_fwd", "RopeFunction", "RopeQKFunction",
           "apply_rotary_kernel", "apply_rotary_qk_kernel", "route", "plan",
           "plan_cover"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}     # elements in 16 bytes
ROUTES = ("vector", "scalar")
THREADS = 256            # csrc/rope.cu: kThreads
# heads a thread walks, at least, once the groups split: 2 was no faster
# on an H100 and 8 slower at llama_350m's q (an in-call A/B, PERF.md §6)
MIN_GROUP_HEADS = 4
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


class Plan(NamedTuple):
    route: str          # "vector" (16-byte chunks) or "scalar"
    vec: int            # elements a chunk: 16 bytes' worth, or 1
    chunks: int         # chunks of a half row: D/2 // vec
    group_heads: int    # heads one thread walks at one position
    groups: int         # head groups: ceil(heads / group_heads)
    blocks: int         # the grid (a grid-stride loop past one pass)


def route(d, dtype, aligned):
    """``vector`` when D/2 holds whole 16-byte chunks of ``dtype`` and
    every pointer of the launch (tensors, outputs, tables) starts on 16
    bytes (``aligned``); else ``scalar``, the same kernel one element a
    chunk."""
    return "vector" if (d // 2) % _VEC[dtype] == 0 and aligned \
        else "scalar"


def plan(positions, d, heads, dtype, aligned, sms, blocks_per_sm):
    """The kernel's static plan for ``heads`` heads (q's and k's
    together) of width ``d`` at ``positions`` = B x S positions, on a
    card of ``sms`` SMs where ``blocks_per_sm`` blocks fit (the occupancy
    query's answer). Each thread loads its table chunk once and walks a
    group of heads; the groups split in halves while the items still fit
    on the card in one pass and a group keeps ``MIN_GROUP_HEADS`` heads,
    so wide groups reuse the table and enough items fill the card.
    Nothing here depends on the data."""
    r = route(d, dtype, aligned)
    vec = _VEC[dtype] if r == "vector" else 1
    chunks = d // 2 // vec
    room = sms * blocks_per_sm * THREADS
    groups = 1
    while (positions * chunks * groups * 2 <= room
           and -(-heads // (groups * 2)) >= MIN_GROUP_HEADS):
        groups *= 2
    gh = -(-heads // groups)
    groups = -(-heads // gh)
    items = positions * chunks * groups
    blocks = max(1, min(sms * blocks_per_sm, -(-items // THREADS)))
    return Plan(r, vec, chunks, gh, groups, blocks)


def plan_cover(p, positions, heads):
    """Plain model of the kernel's walk over plan ``p``: how many times
    each (position, head, element of a half row) is rotated, as an int
    array ``[positions, heads, chunks * vec]``. Every entry is 1 for a
    plan that is right."""
    items = positions * p.chunks * p.groups
    step = p.blocks * THREADS
    cover = np.zeros((positions, heads, p.chunks * p.vec), dtype=np.int64)
    for t in range(min(step, items)):
        for i in range(t, items, step):
            c, pg = i % p.chunks, i // p.chunks
            pos, h0 = pg % positions, (pg // positions) * p.group_heads
            j = c * p.vec
            cover[pos, h0:min(h0 + p.group_heads, heads), j:j + p.vec] += 1
    return cover


def _ref_rope(x, cos, sin, sign=1):
    """Plain version: the composition of ``rope.py:47-53`` at rows
    0..S-1: in f32 against f32 tables (bf16 x promotes), rounded once to
    x's dtype; bf16 x against bf16 tables rounds each product to bf16
    first. ``sign = -1`` is the backward (x the cotangent): the
    transpose, with each product rounded to x's dtype before the sum, as
    the VJP of the composition rounds each promoted copy's cotangent."""
    seq, d2 = x.shape[1], x.shape[-1] // 2
    c = cos[None, :seq, None, :]
    s = sin[None, :seq, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    if sign > 0:
        out1, out2 = x1 * c - x2 * s, x2 * c + x1 * s
    else:
        def r(t):
            return t.to(x.dtype).to(t.dtype)

        out1 = r(x1 * c) + r(x2 * s)
        out2 = r(x2 * c) - r(x1 * s)
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def _ref_rope_qk(q, k, cos, sin, sign=1):
    """Plain version of the pair: ``_ref_rope`` of q and of k."""
    return _ref_rope(q, cos, sin, sign), _ref_rope(k, cos, sin, sign)


def _check(x, cos, sin):
    """The kernel's contract, checked before any pointer leaves Python."""
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"x must be [B, S, H, D] with D even, got "
                         f"{tuple(x.shape)}")
    d2 = x.shape[-1] // 2
    if cos.dim() != 2 or cos.shape[1] != d2 or sin.shape != cos.shape:
        raise ValueError(f"cos/sin must be [S_max, {d2}], got "
                         f"{tuple(cos.shape)} / {tuple(sin.shape)}")
    if x.dtype not in _DTYPES or cos.dtype not in _DTYPES \
            or sin.dtype != cos.dtype:
        raise TypeError(f"x and the tables must each be one of "
                        f"{list(_DTYPES)}, cos and sin alike, got "
                        f"{x.dtype}/{cos.dtype}/{sin.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError("x must hold fewer than 2**31 elements")
    for name, t in (("x", x), ("cos", cos), ("sin", sin)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_qk(q, k, cos, sin):
    """The pair's contract: each tensor's, and q and k at the same
    positions, width and dtype."""
    _check(q, cos, sin)
    _check(k, cos, sin)
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.dtype != q.dtype or k.device != q.device:
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} and k "
                         f"{tuple(k.shape)} {k.dtype} must share B, S, D, "
                         f"dtype and device")


def _check_table(x, cos):
    if x.shape[1] > cos.shape[0]:
        raise ValueError(f"sequence length {x.shape[1]} is past the rope "
                         f"table's {cos.shape[0]} rows")


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(dtype, table_dtype, sign, vec, index):
    """Resident blocks of the kernel a SM (the occupancy query), per
    instantiation, on CUDA device ``index``."""
    fn = _build.function("rope", "rope_blocks_per_sm",
                         [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(_DTYPES[dtype], _DTYPES[table_dtype], sign, vec,
                 ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"rope occupancy query failed: CUDA error {err}")
    if out.value < 1:
        raise RuntimeError("rope: no block of the kernel fits on a SM")
    return out.value


def _launch(q, k, cos, sin, sign, out=None):
    """One launch over q (and k, or None) into ``out`` = (oq, ok) (new
    tensors when None): returns ((oq, ok), route)."""
    b, s, hq, d = q.shape
    hk = 0 if k is None else k.shape[2]
    if out is None:
        out = (torch.empty_like(q), None if k is None else torch.empty_like(k))
    oq, ok = out
    ptrs = [t.data_ptr() for t in (q, k, oq, ok, cos, sin) if t is not None]
    aligned = all(p % 16 == 0 for p in ptrs)
    sign = 1 if sign > 0 else -1
    vec = route(d, q.dtype, aligned) == "vector"
    index = q.device.index
    p = plan(b * s, d, hq + hk, q.dtype, aligned, sm_count(index),
             _blocks_per_sm(q.dtype, cos.dtype, sign, int(vec), index))
    fn = _build.function("rope", "rope_qk_launch", _ARGTYPES)
    err = fn(q.data_ptr(), None if k is None else k.data_ptr(),
             cos.data_ptr(), sin.data_ptr(), oq.data_ptr(),
             None if ok is None else ok.data_ptr(), b, s, hq, hk, d,
             cos.shape[0], sign, _DTYPES[q.dtype], _DTYPES[cos.dtype],
             int(vec), p.group_heads, p.blocks,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope kernel launch failed ({p.route} route): "
                           f"CUDA error {err}")
    return (oq, ok), p.route


def rope_fwd(x, cos, sin, sign=1):
    """K6 on x ``[B, S, H, D]`` at rows 0..S-1 of ``cos``/``sin``
    ``[S_max, D/2]`` (f32 or bf16); ``sign = -1`` applies the transpose
    (the backward). CUDA tensors run the kernel (f32 or bf16 x, any S up to
    the table, D even; the route ``route`` picks); CPU tensors run
    ``_ref_rope``. S past the table raises on both."""
    _check_table(x, cos)
    if not x.is_cuda:
        return _ref_rope(x, cos, sin, sign)
    _check(x, cos, sin)
    (out, _), path = _launch(x, None, cos, sin, sign)
    rope_fwd.launches += 1
    rope_fwd.route_launches[path] += 1
    return out


def rope_qk_fwd(q, k, cos, sin, sign=1):
    """K6 on q ``[B, S, Hq, D]`` and k ``[B, S, Hk, D]`` at the same rows
    0..S-1, in one launch that reads each table chunk once for all Hq +
    Hk heads; returns (q rotated, k rotated). CUDA tensors run the kernel;
    CPU tensors run ``_ref_rope_qk``. S past the table raises on both."""
    _check_table(q, cos)
    if not q.is_cuda:
        return _ref_rope_qk(q, k, cos, sin, sign)
    _check_qk(q, k, cos, sin)
    (oq, ok), path = _launch(q, k, cos, sin, sign)
    rope_qk_fwd.launches += 1
    rope_qk_fwd.route_launches[path] += 1
    return oq, ok


rope_fwd.launches = 0
rope_fwd.route_launches = dict.fromkeys(ROUTES, 0)
rope_qk_fwd.launches = 0
rope_qk_fwd.route_launches = dict.fromkeys(ROUTES, 0)


class RopeFunction(torch.autograd.Function):
    """Rope with the kernel as its own backward: the cotangent rotated by
    the transpose (``sign = -1``). The tables take no gradient."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope_fwd(x.contiguous(), cos, sin, 1)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope_fwd(g.contiguous(), cos, sin, -1), None, None


class RopeQKFunction(torch.autograd.Function):
    """Rope of q and k in one launch, forward and backward (the pair of
    cotangents rotated by the transpose in one launch too). A cotangent
    that is None (that output unused) takes a single-tensor launch for
    the other."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.set_materialize_grads(False)     # an unused output's g is None
        ctx.save_for_backward(cos, sin)
        return rope_qk_fwd(q.contiguous(), k.contiguous(), cos, sin, 1)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        if gq is None and gk is None:
            dq = dk = None
        elif gk is None:
            dq, dk = rope_fwd(gq.contiguous(), cos, sin, -1), None
        elif gq is None:
            dq, dk = None, rope_fwd(gk.contiguous(), cos, sin, -1)
        else:
            dq, dk = rope_qk_fwd(gq.contiguous(), gk.contiguous(), cos, sin,
                                 -1)
        return dq, dk, None, None


def apply_rotary_kernel(x, cos, sin):
    """Counterpart of ``apply_rotary_pallas``: differentiable rope of x
    ``[B, S, H, D]`` at rows 0..S-1, K6 forward and backward on the card.
    Any S up to the table (the reference's block-divisibility fallback is
    TPU tiling and does not carry over); S past the table raises."""
    return RopeFunction.apply(x, cos, sin)


def apply_rotary_qk_kernel(q, k, cos, sin):
    """Differentiable rope of q ``[B, S, Hq, D]`` and k ``[B, S, Hk, D]``
    at rows 0..S-1, one K6 launch forward and one backward on the card;
    returns (q rotated, k rotated)."""
    return RopeQKFunction.apply(q, k, cos, sin)
