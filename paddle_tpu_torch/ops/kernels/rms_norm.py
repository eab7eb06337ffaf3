"""RMSNorm forward and backward (K5a, K5b): CUDA kernels, plain versions
and the autograd Function.

Port of ``paddle_tpu/ops/pallas/rms_norm.py``: ``out = x * rsqrt(mean(x^2)
+ eps) * w`` per row in f32, in x's dtype; the backward recomputes rstd
from the saved (x, w), as the JAX custom VJP does, and returns dx in x's
dtype and dw (summed over every row in f32) in w's dtype.

``rms_norm_fwd`` and ``rms_norm_bwd`` launch the hand-written kernels
(``csrc/rms_norm.cu``) for CUDA tensors and the plain versions
``_ref_fwd``/``_ref_bwd`` for CPU tensors; a CUDA tensor the kernels
cannot take raises instead of falling back. Each counts its launches in
``.launches``. ``rms_norm`` is the differentiable entry point.
"""
import ctypes

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_fwd", "rms_norm_bwd", "RMSNormFunction"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = {torch.float32: 8192, torch.bfloat16: 16384}
DW_BLOCKS = 512      # row blocks of the backward, each one f32 dw partial


def _ref_fwd(x, w, eps):
    """Plain version of the forward (``rms_norm.py:21-25``)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return (xf * rstd * w.float()).to(x.dtype)


def _ref_bwd(x, w, g, eps):
    """Plain version of the backward (``rms_norm.py:141-152``)."""
    xf, gf, wf = x.float(), g.float(), w.float()
    var = xf.square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xf * rstd
    gw = gf * wf
    dx = rstd * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(x, w, g=None):
    """The kernels' contract, checked before any pointer leaves Python."""
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"x must be [..., d] and w [d], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or (g is not None and g.dtype != x.dtype):
        raise TypeError(f"x, w (and g) must share one of {list(_DTYPES)}, "
                        f"got {x.dtype}/{w.dtype}"
                        + ("" if g is None else f"/{g.dtype}"))
    d = x.shape[-1]
    if d % 8 or d > MAX_D[x.dtype]:
        raise ValueError(f"d = {d} must be a multiple of 8 and at most "
                         f"{MAX_D[x.dtype]} for {x.dtype}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("w", w), ("g", g)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _fn(name, n_ptr, n_int):
    return _build.function(
        "rms_norm", name, [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float, ctypes.c_void_p])


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def rms_norm_fwd(x, w, eps=1e-6):
    """K5a: RMSNorm of x's last dim, in x's dtype. CUDA tensors run the
    kernel (f32 or bf16, w of x's type, d a multiple of 8); CPU tensors
    run ``_ref_fwd``."""
    if not x.is_cuda:
        return _ref_fwd(x, w, eps)
    _check(x, w)
    out = torch.empty_like(x)
    d = x.shape[-1]
    err = _fn("rms_norm_fwd_launch", 3, 3)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // d, d,
        _DTYPES[x.dtype], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "rms_norm forward")
    rms_norm_fwd.launches += 1
    return out


def rms_norm_bwd(x, w, g, eps=1e-6):
    """K5b: (dx, dw) of RMSNorm for the output cotangent g; dx in x's
    dtype, dw summed over every row in f32 and cast to w's dtype. CUDA
    tensors run the kernel pair (rows and per-block dw partials, then the
    partials' sum in a fixed order: bitwise repeatable); CPU tensors run
    ``_ref_bwd``."""
    if not x.is_cuda:
        return _ref_bwd(x, w, g, eps)
    _check(x, w, g)
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    nb = min(rows, DW_BLOCKS)
    part = torch.empty((nb, d), dtype=torch.float32, device=x.device)
    err = _fn("rms_norm_bwd_launch", 6, 4)(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), rows, d, nb, _DTYPES[x.dtype],
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "rms_norm backward")
    rms_norm_bwd.launches += 1
    return dx, dw


rms_norm_fwd.launches = 0
rms_norm_bwd.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """``rms_norm``'s custom VJP: saves (x, w) and recomputes rstd in the
    backward (``rms_norm.py:130-162``)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, g.contiguous(), ctx.eps)
        return dx, dw, None


def rms_norm(x, w, eps=1e-6):
    """Differentiable RMSNorm over x's last dim with scale w: K5a forward,
    K5b backward on the card, the plain versions on the CPU."""
    return RMSNormFunction.apply(x, w, eps)
