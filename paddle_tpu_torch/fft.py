"""paddle.fft over ``torch.fft``: port of ``paddle_tpu/fft.py``.

The norms are the reference's: ``"backward"`` (the default: no scaling
forward, 1/n inverse), ``"forward"`` and ``"ortho"``. Every transform
goes through ``dispatch``, so a paddle ``Tensor`` in gives a ``Tensor``
out and autograd records it; torch tensors in give torch tensors out.
An integer input is taken as float32, as the reference's 64-bit-off
``jnp`` takes it. The N-D Hermitian pair goes through the conjugate of
``irfftn`` / ``rfftn`` with the scale over the whole transform, as in
the reference (``fft.py:78-110``).
"""
import numpy as np
import torch

from .core.tensor import dispatch, to_tensor

__all__ = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fftn",
           "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn", "fft2", "ifft2",
           "rfft2", "irfft2", "hfft2", "ihfft2", "fftfreq", "rfftfreq",
           "fftshift", "ifftshift"]


def _norm(norm):
    if norm not in (None, "backward", "forward", "ortho"):
        raise ValueError(f"invalid norm {norm!r}; expected backward/"
                         f"forward/ortho")
    return None if norm == "backward" else norm


def _inexact(v):
    if v.dtype.is_floating_point or v.dtype.is_complex:
        return v
    return v.to(torch.float32)


def _wrap1(torch_fn, opname):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        nm = _norm(norm)
        return dispatch(lambda v: torch_fn(_inexact(v), n=n, dim=axis,
                                           norm=nm), x, name=opname)
    op.__name__ = opname
    return op


def _wrapn(torch_fn, opname):
    def op(x, s=None, axes=None, norm="backward", name=None):
        nm = _norm(norm)
        return dispatch(lambda v: torch_fn(_inexact(v), s=s, dim=axes,
                                           norm=nm), x, name=opname)
    op.__name__ = opname
    return op


def _wrap2(torch_fn, opname):
    def op(x, s=None, axes=(-2, -1), norm="backward", name=None):
        nm = _norm(norm)
        return dispatch(lambda v: torch_fn(_inexact(v), s=s, dim=axes,
                                           norm=nm), x, name=opname)
    op.__name__ = opname
    return op


fft = _wrap1(torch.fft.fft, "fft")
ifft = _wrap1(torch.fft.ifft, "ifft")
rfft = _wrap1(torch.fft.rfft, "rfft")
irfft = _wrap1(torch.fft.irfft, "irfft")
hfft = _wrap1(torch.fft.hfft, "hfft")
ihfft = _wrap1(torch.fft.ihfft, "ihfft")
fftn = _wrapn(torch.fft.fftn, "fftn")
ifftn = _wrapn(torch.fft.ifftn, "ifftn")
rfftn = _wrapn(torch.fft.rfftn, "rfftn")
irfftn = _wrapn(torch.fft.irfftn, "irfftn")
fft2 = _wrap2(torch.fft.fft2, "fft2")
ifft2 = _wrap2(torch.fft.ifft2, "ifft2")
rfft2 = _wrap2(torch.fft.rfft2, "rfft2")
irfft2 = _wrap2(torch.fft.irfft2, "irfft2")


def _f32_scalar(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """Hermitian-input N-D FFT -> real output: ``n_total *
    irfftn(conj(x))``, the scale over the whole transform size, as the
    reference's c2r kernel."""
    _norm(norm)

    def fn(xv):
        ax = tuple(range(xv.dim())) if axes is None else tuple(axes)
        out = torch.fft.irfftn(torch.conj(xv), s=s, dim=ax, norm="backward")
        n_total = 1
        for a in ax:
            n_total *= out.shape[a]
        if norm in (None, "backward"):
            scale = n_total
        elif norm == "forward":
            scale = 1.0
        else:  # ortho
            scale = torch.sqrt(_f32_scalar(float(n_total), out))
        return out * scale

    return dispatch(fn, x, name="hfftn")


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """The inverse of ``hfftn``: ``conj(rfftn(x)) / n_total``
    (backward)."""
    _norm(norm)

    def fn(xv):
        xv = _inexact(xv)
        ax = tuple(range(xv.dim())) if axes is None else tuple(axes)
        out = torch.conj(torch.fft.rfftn(xv, s=s, dim=ax, norm="backward"))
        n_total = 1
        for a in ax:
            n_total *= xv.shape[a] if s is None else \
                dict(zip(ax, s)).get(a, xv.shape[a])
        if norm in (None, "backward"):
            scale = 1.0 / n_total
        elif norm == "forward":
            scale = 1.0
        else:
            scale = 1.0 / torch.sqrt(_f32_scalar(float(n_total), xv))
        return out * scale

    return dispatch(fn, x, name="ihfftn")


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return hfftn(x, s, axes, norm)


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    return ihfftn(x, s, axes, norm)


def _freq(k, n, d, dtype):
    # k / (d * n) in float32, a true division as the reference's
    out = k.astype(np.float32) / np.float32(d * n)
    return to_tensor(out, dtype=dtype)


def fftfreq(n, d=1.0, dtype="float32", name=None):
    """The sample frequencies of an ``n``-point transform on the default
    place."""
    k = np.concatenate([np.arange(0, (n - 1) // 2 + 1),
                        np.arange(-(n // 2), 0)])
    return _freq(k, n, d, dtype)


def rfftfreq(n, d=1.0, dtype="float32", name=None):
    return _freq(np.arange(0, n // 2 + 1), n, d, dtype)


def fftshift(x, axes=None, name=None):
    return dispatch(lambda v: torch.fft.fftshift(v, dim=axes), x,
                    name="fftshift")


def ifftshift(x, axes=None, name=None):
    return dispatch(lambda v: torch.fft.ifftshift(v, dim=axes), x,
                    name="ifftshift")
