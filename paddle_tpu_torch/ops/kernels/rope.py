"""Rotary position embedding (K6): the CUDA kernel, its plain version and
the autograd Function.

Port of ``paddle_tpu/ops/pallas/rope.py:73-113`` (``apply_rotary_pallas``
/ ``_rope_call``): the neox half rotation of x ``[B, S, H, D]`` at rows
0..S-1 of f32 cos/sin tables ``[S_max, D/2]``::

    out1 = x1 * c - sign * x2 * s,  out2 = x2 * c + sign * x1 * s

in f32, rounded once to x's dtype. ``sign = +1`` is the rotation;
``sign = -1`` is its transpose, which is the backward: the reference
kernel has no VJP of its own (ROADMAP, Queue 3), the port's backward is
the same kernel run the other way. The backward rounds each product to
x's dtype before the sum, as the VJP of the reference's composition
does (``jax.vjp`` of ``_apply_rotary_jnp`` and torch autograd alike), so
in bf16 too it is that VJP bit for bit, and a train step through K6 is
the train step through the composition.

``rope_fwd`` launches the hand-written kernel (``csrc/rope.cu``) for a
CUDA tensor and the plain version ``_ref_rope`` for a CPU tensor; a CUDA
tensor the kernel cannot take raises instead of falling back. It counts
its launches in ``rope_fwd.launches`` (forward and backward alike).
"""
import ctypes

import torch

from . import _build

__all__ = ["rope_fwd", "RopeFunction", "apply_rotary_kernel"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ref_rope(x, cos, sin, sign=1):
    """Plain version: the composition of ``rope.py:47-53`` at rows
    0..S-1, in f32 (bf16 x against the f32 tables promotes), rounded once
    to x's dtype. ``sign = -1`` is the backward (x the cotangent): the
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


def _check(x, cos, sin):
    """The kernel's contract, checked before any pointer leaves Python."""
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"x must be [B, S, H, D] with D even, got "
                         f"{tuple(x.shape)}")
    d2 = x.shape[-1] // 2
    if cos.dim() != 2 or cos.shape[1] != d2 or sin.shape != cos.shape:
        raise ValueError(f"cos/sin must be [S_max, {d2}], got "
                         f"{tuple(cos.shape)} / {tuple(sin.shape)}")
    if x.dtype not in _DTYPES or cos.dtype != torch.float32 \
            or sin.dtype != torch.float32:
        raise TypeError(f"x must be one of {list(_DTYPES)} and the tables "
                        f"float32, got {x.dtype}/{cos.dtype}/{sin.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError("x must hold fewer than 2**31 elements")
    for name, t in (("x", x), ("cos", cos), ("sin", sin)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_table(x, cos):
    if x.shape[1] > cos.shape[0]:
        raise ValueError(f"sequence length {x.shape[1]} is past the rope "
                         f"table's {cos.shape[0]} rows")


def rope_fwd(x, cos, sin, sign=1):
    """K6 on x ``[B, S, H, D]`` at rows 0..S-1 of ``cos``/``sin``
    ``[S_max, D/2]`` (f32); ``sign = -1`` applies the transpose (the
    backward). CUDA tensors run the kernel (f32 or bf16 x, any S up to
    the table, D even); CPU tensors run ``_ref_rope``. S past the table
    raises on both."""
    _check_table(x, cos)
    if not x.is_cuda:
        return _ref_rope(x, cos, sin, sign)
    _check(x, cos, sin)
    out = torch.empty_like(x)
    b, s, h, d = x.shape
    fn = _build.library("rope").rope_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
             b, s, h, d, cos.shape[0], 1 if sign > 0 else -1,
             _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope kernel launch failed: CUDA error {err}")
    rope_fwd.launches += 1
    return out


rope_fwd.launches = 0


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


def apply_rotary_kernel(x, cos, sin):
    """Counterpart of ``apply_rotary_pallas``: differentiable rope of x
    ``[B, S, H, D]`` at rows 0..S-1, K6 forward and backward on the card.
    Any S up to the table (the reference's block-divisibility fallback is
    TPU tiling and does not carry over); S past the table raises."""
    return RopeFunction.apply(x, cos, sin)
