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
``.launches``, and by the type it ran in (its f32 or bf16 route) in
``.dtype_launches``. ``rms_norm`` is the differentiable entry point.

The backward's kernel walks rows in a static plan (``bwd_plan``, from
the shape, the SM count and the kernel's blocks a SM only) and sums dw
in a fixed order; ``_ref_bwd_plan`` is the plain model of both.
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .paged_attention import sm_count

__all__ = ["rms_norm", "rms_norm_fwd", "rms_norm_bwd", "RMSNormFunction",
           "bwd_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
MAX_D = {torch.float32: 8192, torch.bfloat16: 16384}
# the backward's row kernel (csrc/rms_norm.cu, namespace bwd): warps a
# block, 16-byte chunks of a row a lane at most, and the reduction's warps
BWD_WARPS = 8
MAX_CHUNKS = 4
REDUCE_WARPS = 32


class BwdPlan(NamedTuple):
    warps_per_row: int      # W: warps that share one row
    chunks_per_lane: int    # 16-byte chunks of x (and of g) a lane, a row
    groups: int             # rows a block walks at once: BWD_WARPS // W
    blocks: int             # the grid; one f32 dw partial row each


def bwd_shape(d, dtype):
    """(warps a row, 16-byte chunks a lane) of the backward for rows of d
    elements: one warp while a lane holds at most ``MAX_CHUNKS`` chunks
    (2 KB of x a row: 1024 bf16, 512 f32), else the fewest warps, a power
    of two, that do, up to the block's ``BWD_WARPS`` (whose lanes then
    hold up to 8 chunks: the widest rows); chunks a lane rounded up to a
    power of two."""
    nch = d // (16 // (2 if dtype == torch.bfloat16 else 4))
    w = 1
    while -(-nch // (32 * w)) > MAX_CHUNKS and w < BWD_WARPS:
        w *= 2
    need = -(-nch // (32 * w))
    return w, next(c for c in (1, 2, 4, 8) if c >= need)


def bwd_plan(rows, d, dtype, sms, blocks_per_sm):
    """The backward's static plan for ``rows`` x ``d`` in ``dtype`` on a
    card of ``sms`` SMs where ``blocks_per_sm`` blocks of the row kernel
    fit (the occupancy query's answer): enough blocks to fill every SM,
    fewer when the rows are few. Row group q (block q // groups, group q %
    groups) walks rows q, q + blocks * groups, ... Nothing here depends on
    the data."""
    w, nv = bwd_shape(d, dtype)
    groups = BWD_WARPS // w
    blocks = max(1, min(sms * blocks_per_sm, -(-rows // groups)))
    return BwdPlan(w, nv, groups, blocks)


def plan_rows(plan, rows):
    """[block][group] -> the rows that group walks, in its order."""
    n = plan.blocks * plan.groups
    return [[list(range(b * plan.groups + q, rows, n))
             for q in range(plan.groups)] for b in range(plan.blocks)]


def _ref_bwd_plan(x, w, g, eps, plan):
    """Plain model of the backward kernel in its plan and order of
    operations: per row xhat's mean as rstd * sum(g w x) / d; dw summed in
    f32 over each group's rows in walk order, the block's groups added in
    group order, then the blocks' rows as the reduction adds them (warp k
    of ``REDUCE_WARPS`` takes blocks k, k + REDUCE_WARPS, ..., the warp
    sums added in order). x, g [rows, d]; returns (dx, dw) like
    ``_ref_bwd``."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    gf = g.float().reshape(-1, d)
    wf = w.float()
    rstd = torch.rsqrt(xf.square().sum(-1, keepdim=True) / d + eps)
    mean_gx = (gf * wf * xf).sum(-1, keepdim=True) * rstd / d
    xhat = xf * rstd
    dx = rstd * (gf * wf - xhat * mean_gx)
    contrib = gf * xhat
    part = []
    for groups in plan_rows(plan, xf.shape[0]):
        acc = []
        for walk in groups:
            a = torch.zeros(d)
            for r in walk:
                a = a + contrib[r]
            acc.append(a)
        blk = acc[0]
        for a in acc[1:]:
            blk = blk + a
        part.append(blk)
    lanes = []
    for k in range(min(REDUCE_WARPS, len(part))):
        a = torch.zeros(d)
        for blk in part[k::REDUCE_WARPS]:
            a = a + blk
        lanes.append(a)
    dw = lanes[0]
    for a in lanes[1:]:
        dw = dw + a
    return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype)


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
    rms_norm_fwd.dtype_launches[_NAMES[x.dtype]] += 1
    return out


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(dtype, chunks_per_lane, index):
    """Resident blocks of the backward's row kernel a SM (the occupancy
    query), per dtype and chunks a lane, on CUDA device ``index``."""
    fn = _build.function("rms_norm", "rms_norm_bwd_blocks_per_sm",
                         [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(fn(_DTYPES[dtype], chunks_per_lane, ctypes.byref(out)),
                  "rms_norm backward occupancy query")
    if out.value < 1:
        raise RuntimeError("rms_norm backward: no block of the row kernel "
                           "fits on a SM")
    return out.value


def rms_norm_bwd(x, w, g, eps=1e-6):
    """K5b: (dx, dw) of RMSNorm for the output cotangent g; dx in x's
    dtype, dw summed over every row in f32 and cast to w's dtype. CUDA
    tensors run the kernel pair (rows in ``bwd_plan``'s static plan with
    per-block dw partials, then the partials' sum in a fixed order:
    bitwise repeatable); CPU tensors run ``_ref_bwd``."""
    if not x.is_cuda:
        return _ref_bwd(x, w, g, eps)
    _check(x, w, g)
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    index = x.device.index
    _, nv = bwd_shape(d, x.dtype)
    plan = bwd_plan(rows, d, x.dtype, sm_count(index),
                    _blocks_per_sm(x.dtype, nv, index))
    part = torch.empty((plan.blocks, d), dtype=torch.float32,
                       device=x.device)
    err = _fn("rms_norm_bwd_launch", 6, 6)(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), rows, d, plan.blocks,
        plan.warps_per_row, plan.chunks_per_lane, _DTYPES[x.dtype],
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "rms_norm backward")
    rms_norm_bwd.launches += 1
    rms_norm_bwd.dtype_launches[_NAMES[x.dtype]] += 1
    return dx, dw


rms_norm_fwd.launches = 0
rms_norm_bwd.launches = 0
rms_norm_fwd.dtype_launches = dict.fromkeys(_NAMES.values(), 0)
rms_norm_bwd.dtype_launches = dict.fromkeys(_NAMES.values(), 0)


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
    K5b backward on the card, the plain versions on the CPU. A program
    being exported records K5a as the custom op
    ``paddle_tpu_torch::rms_norm_fwd`` (``custom_ops``)."""
    if torch.compiler.is_exporting():
        return torch.ops.paddle_tpu_torch.rms_norm_fwd(
            x.contiguous(), w.contiguous(), float(eps))
    return RMSNormFunction.apply(x, w, eps)
