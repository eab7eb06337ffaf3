"""Int8 x int8 -> int32 matmul with a fused dequantize (K8): the CUDA
kernel, its plain version and the quantizer.

Port of ``paddle_tpu/ops/pallas/quant_matmul.py``:
``quantized_matmul(x, w, scale_x, scale_w)`` is ``(x @ w)`` accumulated
exactly in int32, then ``acc.float() * sx * sw[None, :]`` in that order
(``quant_matmul.py:47-48``), for int8 x ``[M, K]`` and w ``[K, N]``, a
scalar x scale and a per-channel (or scalar) w scale, cast to
``out_dtype``. ``quantize_tensor`` is the reference's symmetric quantizer
(``:91-102``) in plain torch: the same codes and scales bit for bit, the
scale in x's dtype.

The kernel (``csrc/quant_matmul.cu``) reads the weight K-major, ``wt [N,
K]``: Hopper's ``wgmma`` takes 8-bit operands K-major only.
``quantized_matmul_kmajor(x, wt, ...)`` takes such a weight as it lies;
``Int8InferLinear`` keeps its codes so and calls it.
``quantized_matmul(x, w, ...)`` keeps the reference's ``[K, N]``
contract and, on the card, makes a K-major copy of ``w`` first. Both
launch the kernel for CUDA tensors and run the plain version ``_ref``
for CPU tensors; a CUDA tensor the kernel cannot take raises instead of
falling back. The kernel has two routes, which ``route`` picks from the
shape before the launch (never on failure):

- ``"wgmma"``: K a multiple of 16, N of 8, x, wt and out 16-byte aligned
  (TMA's rule for int8 rows, and the 16-byte output stores): TMA loads
  into a ring of stages, ``wgmma`` s8 x s8 -> s32;
- ``"mma_sync"``: every other shape: ``mma.sync`` tiles with masked
  loads.

Both entries count every launch in ``quantized_matmul.launches`` and each
route's in ``quantized_matmul.route_launches``.
"""
import ctypes

import torch

from . import _build

__all__ = ["ROUTES", "route", "quantized_matmul", "quantized_matmul_kmajor",
           "quantize_tensor"]

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"mma_sync": 0, "wgmma": 1}
MAX_K = 133000
MAX_MMA_ROWS = 65535 * 128      # the mma.sync grid's row tiles


def _scales(scale_x, scale_w, n, device):
    """(sx, sw) as f32: sx a 0-d tensor, sw ``[N]``. A per-row x scale
    raises: the reference reshapes ``scale_x`` to ``(1,)``
    (``quant_matmul.py:65``), which only a scalar survives (ROADMAP,
    Queue 3)."""
    sx = torch.as_tensor(scale_x, device=device).float()
    if sx.numel() != 1:
        raise ValueError(f"scale_x must be a scalar (per-tensor x scale), "
                         f"got shape {tuple(sx.shape)}")
    sw = torch.as_tensor(scale_w, device=device).float()
    if sw.numel() not in (1, n) or sw.dim() > 1:
        raise ValueError(f"scale_w must be a scalar or [{n}], got shape "
                         f"{tuple(sw.shape)}")
    return sx.reshape(()), sw.reshape(-1).expand(n).contiguous()


def _ref(x, w, scale_x, scale_w, out_dtype=torch.float32):
    """Plain version: the int32 accumulator computed exactly (f64 holds
    every partial sum of int8 products below 2**53 exactly, and torch has
    no int8 product on the CPU), converted to f32, times sx, times sw.
    ``w`` is ``[K, N]`` with any strides (``wt.t()`` of a K-major one)."""
    sx, sw = _scales(scale_x, scale_w, w.shape[1], x.device)
    acc = x.double() @ w.double()
    return (acc.float() * sx * sw[None, :]).to(out_dtype)


def route(m, n, k, aligned):
    """The kernel route for an ``[m, k] @ [k, n]`` int8 product, ``aligned``
    telling whether x, wt and out all start on 16 bytes (see the module
    docstring); a shape neither route takes raises ValueError."""
    if max(m, n) >= 2 ** 31 or not 0 <= k < MAX_K:
        raise ValueError(f"M and N must be below 2**31 and K below {MAX_K} "
                         f"(the int32 sum of K products of 127 x 127 stays "
                         f"exact), got M={m}, K={k}, N={n}")
    if k > 0 and k % 16 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    if m > MAX_MMA_ROWS:
        raise ValueError(f"M={m} exceeds the mma.sync route's {MAX_MMA_ROWS} "
                         f"rows, and K={k}, N={n} or the alignment keeps it "
                         f"off the wgmma route")
    return "mma_sync"


def _check(x, wt, out_dtype):
    """The kernel's contract on x ``[M, K]`` and a K-major wt ``[N, K]``,
    checked before any pointer leaves Python."""
    if x.dim() != 2 or wt.dim() != 2 or wt.shape[1] != x.shape[1]:
        raise ValueError(f"x must be [M, K] and wt [N, K], got "
                         f"{tuple(x.shape)} and {tuple(wt.shape)}")
    if x.dtype != torch.int8 or wt.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype}/{wt.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {list(_OUT_DTYPES)}")
    for name, t in (("x", x), ("w", wt)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(x, wt, sx, sw, out):
    """Launch K8 into ``out`` ``[M, N]`` on the route ``route`` picks; sx
    and sw as ``_scales`` gives them. Counts the launch."""
    m, k = x.shape
    n = wt.shape[0]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, wt, out))
    path = route(m, n, k, aligned)
    fn = _build.function("quant_matmul", "quant_matmul_launch",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
    err = fn(x.data_ptr(), wt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
             out.data_ptr(), m, n, k, _OUT_DTYPES[out.dtype], ROUTES[path],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed ({path} "
                           f"route): CUDA error {err}")
    quantized_matmul.launches += 1
    quantized_matmul.route_launches[path] += 1
    return out


def quantized_matmul_kmajor(x, wt, scale_x, scale_w,
                            out_dtype=torch.float32):
    """K8 over a K-major weight: int8 x ``[M, K]`` @ ``wt.t()`` for int8
    wt ``[N, K]``, accumulated exactly in int32, dequantized as ``acc *
    scale_x * scale_w[n]`` in f32 and cast to ``out_dtype`` (f32 or
    bf16). CUDA tensors run the kernel (every shape, on the route
    ``route`` picks); CPU tensors run ``_ref``."""
    if not x.is_cuda:
        return _ref(x, wt.t(), scale_x, scale_w, out_dtype)
    _check(x, wt, out_dtype)
    m, n = x.shape[0], wt.shape[0]
    sx, sw = _scales(scale_x, scale_w, n, x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    return _launch(x, wt, sx, sw, out)


def quantized_matmul(x, w, scale_x, scale_w, out_dtype=torch.float32):
    """K8: int8 x ``[M, K]`` @ int8 w ``[K, N]`` accumulated exactly in
    int32, dequantized as ``acc * scale_x * scale_w[n]`` in f32 and cast
    to ``out_dtype``. ``scale_x`` is a scalar, ``scale_w`` a scalar or
    ``[N]`` (either dtype; taken as f32). CUDA tensors run the kernel on a
    K-major copy of w made on the card; CPU tensors run ``_ref``."""
    if not x.is_cuda:
        return _ref(x, w, scale_x, scale_w, out_dtype)
    if w.dim() != 2:
        raise ValueError(f"w must be [K, N], got {tuple(w.shape)}")
    return quantized_matmul_kmajor(x, w.t().contiguous(), scale_x, scale_w,
                                   out_dtype)


quantized_matmul.launches = 0
quantized_matmul.route_launches = dict.fromkeys(ROUTES, 0)


def quantize_tensor(x, per_channel_axis=None):
    """Symmetric int8 quantization (``quant_matmul.py:91-102``): returns
    (q int8, scale). ``scale = amax(|x|) / 127 + 1e-12`` in x's dtype (a
    0-d tensor per tensor, ``[C]`` along ``per_channel_axis``); ``q =
    clip(round(x / scale), -127, 127)`` with round half to even, as
    ``jnp.round``. The divisor 127 is a tensor on x's device: torch's
    CUDA division by a Python number multiplies by its reciprocal, one
    rounding off the true quotient the CPU and JAX compute."""
    if per_channel_axis is None:
        amax = x.abs().amax()
    else:
        axes = tuple(i for i in range(x.dim()) if i != per_channel_axis)
        # amax over no dims would reduce over all of them in torch
        amax = x.abs().amax(dim=axes, keepdim=True) if axes else x.abs()
    scale = amax / torch.full((), 127.0, dtype=amax.dtype,
                              device=amax.device) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, (scale if per_channel_axis is None else scale.reshape(-1))
