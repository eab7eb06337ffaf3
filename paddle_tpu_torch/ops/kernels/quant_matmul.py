"""Int8 x int8 -> int32 matmul with a fused dequantize (K8): the CUDA
kernel, its plain version and the quantizer.

Port of ``paddle_tpu/ops/pallas/quant_matmul.py``:
``quantized_matmul(x, w, scale_x, scale_w)`` is ``(x @ w)`` accumulated
exactly in int32, then ``acc.float() * sx * sw[None, :]`` in that order
(``quant_matmul.py:47-48``), for int8 x ``[M, K]`` and w ``[K, N]``, a
scalar x scale and a per-channel (or scalar) w scale. ``quantize_tensor``
is the reference's symmetric quantizer (``:91-102``) in plain torch: the
same codes and scales bit for bit, the scale in x's dtype.

``quantized_matmul`` launches the hand-written kernel
(``csrc/quant_matmul.cu``) for CUDA tensors and the plain version
``_ref`` for CPU tensors; a CUDA tensor the kernel cannot take raises
instead of falling back. It counts its launches in
``quantized_matmul.launches``.
"""
import ctypes

import torch

from . import _build

__all__ = ["quantized_matmul", "quantize_tensor"]

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 133000


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
    no int8 product on the CPU), converted to f32, times sx, times sw."""
    sx, sw = _scales(scale_x, scale_w, w.shape[1], x.device)
    acc = x.double() @ w.double()
    return (acc.float() * sx * sw[None, :]).to(out_dtype)


def _check(x, w, out_dtype):
    """The kernel's contract, checked before any pointer leaves Python."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype}/{w.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {list(_OUT_DTYPES)}")
    if max(x.shape[0], w.shape[1]) >= 2 ** 31 or x.shape[1] >= MAX_K:
        raise ValueError(f"M and N must be below 2**31 and K below {MAX_K} "
                         f"(the int32 sum of K products of 127 x 127 stays "
                         f"exact), got {tuple(x.shape)} @ {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def quantized_matmul(x, w, scale_x, scale_w, out_dtype=torch.float32):
    """K8: int8 x ``[M, K]`` @ int8 w ``[K, N]`` accumulated exactly in
    int32, dequantized as ``acc * scale_x * scale_w[n]`` in f32 and cast
    to ``out_dtype``. ``scale_x`` is a scalar, ``scale_w`` a scalar or
    ``[N]`` (either dtype; taken as f32). CUDA tensors run the kernel
    (every shape: tails are masked); CPU tensors run ``_ref``."""
    if not x.is_cuda:
        return _ref(x, w, scale_x, scale_w, out_dtype)
    _check(x, w, out_dtype)
    m, k = x.shape
    n = w.shape[1]
    sx, sw = _scales(scale_x, scale_w, n, x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _build.function("quant_matmul", "quant_matmul_launch",
                         [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
    err = fn(x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
             out.data_ptr(), m, n, k, _OUT_DTYPES[out_dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0


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
