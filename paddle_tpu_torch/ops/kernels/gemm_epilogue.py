"""Fused GEMM + bias + activation epilogue (K7): the CUDA kernel, its
plain version and the autograd Function.

Port of ``paddle_tpu/ops/pallas/gemm_epilogue.py:36-158``:
``act(x @ w + bias)`` for x ``[M, K]``, w ``[K, N]``, bias ``[N]`` or
None, activation ``none``, ``relu`` or ``gelu`` (the tanh form,
``jax.nn.gelu(approximate=True)``). The product accumulates in f32, the
bias is added in f32 and the activation applied in the epilogue, then the
result is rounded once to x's dtype — as the TPU kernel does it. (The
reference's own plain ``_ref``, which its public function runs off the
TPU, rounds ``x @ w`` to the input dtype before the bias; in bf16 the
port, which follows the kernel, differs from it by that rounding:
ROADMAP, Queue 3.)

``gemm_epilogue`` launches the hand-written kernel
(``csrc/gemm_epilogue.cu``) for CUDA tensors and the plain version
``_ref_gemm_epilogue`` for CPU tensors; a CUDA tensor the kernel cannot
take raises instead of falling back. The kernel has three routes, which
``route`` picks from the shape before the launch (never on failure):

- ``"wgmma"``: bf16 with K >= 8, K and N multiples of 8 and x, w and out
  16-byte aligned (TMA's stride and base rule): TMA loads into a ring of
  stages, ``wgmma`` with w read as it lies;
- ``"mma_sync"``: every other bf16 shape (K or N odd, a misaligned view):
  ``mma.sync`` tiles with loads masked element by element;
- ``"simt"``: float32, fused multiply-adds in full f32 (no TF32).

``gemm_epilogue.launches`` counts every launch and
``gemm_epilogue.route_launches`` each route's. The backward
(``_fge_bwd``) is plain ``torch.matmul``, as the reference computes it
outside any Pallas kernel.
"""
import ctypes
import math

import torch

from . import _build

__all__ = ["ACTIVATIONS", "ROUTES", "route", "gemm_epilogue",
           "fused_gemm_epilogue", "FusedGemmEpilogueFunction"]

ACTIVATIONS = {"none": 0, "relu": 1, "gelu": 2}
ROUTES = {"simt": 0, "mma_sync": 1, "wgmma": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _act(z, activation):
    """``gemm_epilogue.py:36-41``; gelu as ``jax.nn.gelu(approximate=
    True)`` writes it."""
    if activation == "relu":
        return torch.maximum(z, z.new_zeros(()))
    if activation == "gelu":
        return z * (0.5 * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (z + 0.044715 * (z * z * z)))))
    return z


def _ref_gemm_epilogue(x, w, bias, activation):
    """Plain version, the kernel's math: ``x @ w`` in f32 (f64 for f64
    inputs), plus the bias, the activation, one rounding to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    z = x.to(acc) @ w.to(acc)
    if bias is not None:
        z = z + bias.to(acc)
    return _act(z, activation).to(x.dtype)


def _check(x, w, bias):
    """The kernel's contract, checked before any pointer leaves Python."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias must be [{w.shape[1]}], got "
                         f"{tuple(bias.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or (bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"x, w (and bias) must share one of {list(_DTYPES)}"
                        f", got {x.dtype}/{w.dtype}"
                        + ("" if bias is None else f"/{bias.dtype}"))
    if max(x.shape[0], x.shape[1], w.shape[1]) >= 2 ** 31:
        raise ValueError("M, K and N must be below 2**31")
    for name, t in (("x", x), ("w", w), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def route(m, n, k, dtype, aligned):
    """The kernel route for an ``[m, k] @ [k, n]`` product in ``dtype``,
    ``aligned`` telling whether x, w and out all start on 16 bytes (see
    the module docstring). ``m`` takes no part: TMA zero-fills the rows
    past it and the stores are masked."""
    if dtype == torch.float32:
        return "simt"
    if k >= 8 and k % 8 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def gemm_epilogue(x, w, bias=None, activation="none"):
    """K7: ``act(x @ w + bias)`` in x's dtype for x ``[M, K]``, w ``[K,
    N]``, bias ``[N]`` or None. CUDA tensors run the kernel on the route
    ``route`` picks (f32 or bf16, every shape); CPU tensors run
    ``_ref_gemm_epilogue``."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {list(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if not x.is_cuda:
        return _ref_gemm_epilogue(x, w, bias, activation)
    _check(x, w, bias)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
    path = route(m, n, k, x.dtype, aligned)
    fn = _build.function("gemm_epilogue", "gemm_epilogue_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(),
             m, n, k, ACTIVATIONS[activation], ROUTES[path],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gemm_epilogue kernel launch failed ({path} "
                           f"route): CUDA error {err}")
    gemm_epilogue.launches += 1
    gemm_epilogue.route_launches[path] += 1
    return out


gemm_epilogue.launches = 0
gemm_epilogue.route_launches = dict.fromkeys(ROUTES, 0)


def _fge_bwd(x, w, bias, g, activation):
    """``gemm_epilogue.py:140-155`` in f32: recompute z, dz = act'(z) *
    g, then dx = dz w^T, dw = x^T dz, db = sum of dz over rows, each in
    its input's dtype."""
    xf, wf, gf = x.float(), w.float(), g.float()
    if activation != "none":
        z = xf @ wf
        if bias is not None:
            z = z + bias.float()
        with torch.enable_grad():
            zz = z.detach().requires_grad_()
            (gf,) = torch.autograd.grad(_act(zz, activation), zz, gf)
    dx = (gf @ wf.T).to(x.dtype)
    dw = (xf.T @ gf).to(w.dtype)
    db = gf.sum(0).to(bias.dtype) if bias is not None else None
    return dx, dw, db


class FusedGemmEpilogueFunction(torch.autograd.Function):
    """The custom VJP of ``fused_gemm_epilogue`` on 2-D x: K7 forward,
    ``_fge_bwd`` backward from the saved (x, w, bias)."""

    @staticmethod
    def forward(ctx, x, w, bias, activation):
        x, w = x.contiguous(), w.contiguous()
        bias = None if bias is None else bias.contiguous()
        ctx.save_for_backward(x, w, bias)
        ctx.activation = activation
        return gemm_epilogue(x, w, bias, activation)

    @staticmethod
    def backward(ctx, g):
        x, w, bias = ctx.saved_tensors
        dx, dw, db = _fge_bwd(x, w, bias, g, ctx.activation)
        return dx, dw, db, None


def fused_gemm_epilogue(x, w, bias=None, activation="none"):
    """``act(x @ w + bias)``, differentiable; x ``[..., K]`` flattened to
    2-D internally (``gemm_epilogue.py:124-133``). A program being
    exported records K7 as the custom op ``paddle_tpu_torch::
    gemm_epilogue`` (``custom_ops``)."""
    lead = x.shape[:-1]
    if torch.compiler.is_exporting():
        out = torch.ops.paddle_tpu_torch.gemm_epilogue(
            x.reshape(-1, x.shape[-1]).contiguous(), w.contiguous(),
            None if bias is None else bias.contiguous(), activation)
        return out.reshape(*lead, w.shape[1])
    out = FusedGemmEpilogueFunction.apply(x.reshape(-1, x.shape[-1]), w,
                                          bias, activation)
    return out.reshape(*lead, w.shape[1])
