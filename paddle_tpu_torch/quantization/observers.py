"""Observers and fake quanters: port of
``paddle_tpu/quantization/observers.py``.

Fake quant is a function of torch tensors with a straight-through
gradient (``quant_dequant``: the value ``x + (q(x) - x)`` as the
reference computes it, the gradient the identity, as its
``x + stop_gradient(q(x) - x)`` gives). Types promote as ``jnp``'s do: a
bf16 ``x`` meeting an f32 scale tensor is quantized in f32 and comes out
f32 (torch would keep a 0-d f32 scale from widening a bf16 tensor), a
Python scale is weakly typed and takes x's type. Divisions by a constant
divide by a tensor on x's device: torch's CUDA division by a Python
number multiplies by its reciprocal.

``FakeQuanterWithAbsMaxObserverLayer`` keeps its moving scale as an f32
buffer updated in place on x's device while training (``r * scale + (1 -
r) * absmax`` in f32, the reference's order): a QAT step reads nothing
back to the host. The calibration observers read what the reference
reads: the abs-max observers one float a batch, the histogram observers
(Hist, KL, MSE) the whole batch into float64 numpy histograms on the
host.
"""
import numpy as np
import torch

from ..core.tensor import Tensor, wrap
from ..nn.layer import Layer

__all__ = ["fake_quant", "quant_dequant", "BaseQuanter", "BaseObserver",
           "QuanterFactory", "quanter", "AbsmaxObserver",
           "AbsmaxObserverLayer", "EMAObserver", "EMAObserverLayer",
           "AVGObserver", "AVGObserverLayer", "HistObserver",
           "HistObserverLayer", "KLObserver", "KLObserverLayer",
           "MSEObserver", "MSEObserverLayer", "FakeQuanterWithAbsMaxObserver",
           "FakeQuanterWithAbsMaxObserverLayer",
           "FakeQuanterChannelWiseAbsMax",
           "FakeQuanterChannelWiseAbsMaxLayer"]


def _v(x):
    """A torch tensor of ``x`` (a paddle ``Tensor``, a tensor or an
    array), detached."""
    if isinstance(x, Tensor):
        x = x._value
    return torch.as_tensor(x).detach()


def _const(value, like):
    """``value`` as a 0-d tensor of ``like``'s type on its device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def fake_quant(x, scale, bit_length=8):
    """Symmetric round-to-nearest: ``q = clip(round(x / scale * qmax),
    -qmax, qmax)`` dequantized as ``q * scale / qmax`` (``observers.py:
    26-32``), the scale at least 1e-9; round half to even, as
    ``jnp.round``. ``scale`` broadcasts (per tensor or per channel); a
    tensor scale widens x to their common type, a Python one takes
    x's."""
    qmax = float(2 ** (bit_length - 1) - 1)
    if torch.is_tensor(scale):
        dt = torch.promote_types(x.dtype, scale.dtype)
        x = x.to(dt)
        s = torch.clamp_min(scale.to(dt), 1e-9)
    else:
        s = _const(max(float(scale), 1e-9), x)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    return q * s / _const(qmax, q)


class _StraightThrough(torch.autograd.Function):
    """``x + stop_gradient(fake_quant(x) - x)``: that value forward, the
    identity backward (the cotangent in x's type); the scale takes no
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, bit_length):
        ctx.dtype = x.dtype
        return x + (fake_quant(x, scale, bit_length) - x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def quant_dequant(x, scale, bit_length=8):
    """``fake_quant`` with a straight-through gradient (QAT trains
    through it)."""
    if torch.is_tensor(scale):
        scale = scale.detach()
    return _StraightThrough.apply(x, scale, bit_length)


class BaseQuanter(Layer):
    """A layer that simulates quantization in its forward; subclasses
    give ``forward`` and ``scales``."""

    def scales(self):
        raise NotImplementedError

    def quant_axis(self):
        return None

    def bit_length(self):
        return 8


class BaseObserver(BaseQuanter):
    """A calibration quanter: observes ranges and passes its input
    through. ``convert`` freezes it, so serving traffic no longer moves
    the calibrated scales."""

    def __init__(self):
        super().__init__()
        self._frozen = False

    def observe(self, x):
        raise NotImplementedError

    def forward(self, x):
        if not self._frozen:
            self.observe(x)
        return x


class _WithArgs:
    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs


class QuanterFactory(_WithArgs):
    """Holds a quanter's constructor arguments; ``_instance(layer)``
    builds one for the layer it quantizes."""
    _layer_cls = None

    def _instance(self, layer):
        return self._layer_cls(layer, *self.args, **self.kwargs)


def quanter(name):
    """Class decorator: registers a ``QuanterFactory`` named ``name`` for
    the decorated quanter layer in this module."""
    def deco(layer_cls):
        factory = type(name, (QuanterFactory,), {"_layer_cls": layer_cls})
        globals()[name] = factory
        return layer_cls
    return deco


def _layer_device(layer, quanter):
    """The device a quanter's state lives on: its layer's weight's, else
    the default place."""
    w = getattr(layer, "weight", None)
    if torch.is_tensor(w):
        return w.device
    return quanter._param_device()


class _MaxObserver(BaseObserver):
    """The abs-max observers' common state: bits, and the device of the
    data observed (where ``scales()`` puts its 0-d f32 tensor)."""

    def __init__(self, quant_bits):
        super().__init__()
        self._quant_bits = quant_bits
        self._device = torch.device("cpu")

    def _batch_max(self, x):
        v = _v(x)
        self._device = v.device
        return float(v.abs().max())

    def _scale_tensor(self, value):
        return wrap(torch.tensor(value, dtype=torch.float32,
                                 device=self._device))

    def bit_length(self):
        return self._quant_bits

    def cal_thresholds(self):
        pass


class AbsmaxObserverLayer(_MaxObserver):
    """The running abs-max over every batch observed."""

    def __init__(self, layer=None, quant_bits=8):
        super().__init__(quant_bits)
        self._max = 0.0

    def observe(self, x):
        self._max = max(self._max, self._batch_max(x))

    def scales(self):
        return self._scale_tensor(self._max)


class AbsmaxObserver(QuanterFactory):
    _layer_cls = AbsmaxObserverLayer


class EMAObserverLayer(_MaxObserver):
    """An exponential moving average of each batch's abs-max."""

    def __init__(self, layer=None, quant_bits=8, moving_rate=0.9):
        super().__init__(quant_bits)
        self._rate = moving_rate
        self._ema = None

    def observe(self, x):
        v = self._batch_max(x)
        self._ema = v if self._ema is None else \
            self._rate * self._ema + (1.0 - self._rate) * v

    def scales(self):
        return self._scale_tensor(self._ema or 0.0)


class EMAObserver(QuanterFactory):
    _layer_cls = EMAObserverLayer


class AVGObserverLayer(_MaxObserver):
    """The mean of the batches' abs-max."""

    def __init__(self, layer=None, quant_bits=8):
        super().__init__(quant_bits)
        self._sum = 0.0
        self._n = 0

    def observe(self, x):
        self._sum += self._batch_max(x)
        self._n += 1

    def scales(self):
        return self._scale_tensor(self._sum / max(self._n, 1))


class AVGObserver(QuanterFactory):
    _layer_cls = AVGObserverLayer


class _HistogramObserverBase(BaseObserver):
    """A fixed-bin float64 histogram of |x| over [0, running max] on the
    host, re-binned when the range grows (``observers.py:181-215``)."""

    def __init__(self, layer=None, quant_bits=8, bins_count=2048):
        super().__init__()
        self._quant_bits = quant_bits
        self._bins = bins_count
        self._hist = np.zeros(bins_count, np.float64)
        self._max = 0.0
        self._scale = None
        self._device = torch.device("cpu")

    def observe(self, x):
        self._scale = None   # new data invalidates the cached threshold
        t = _v(x)
        self._device = t.device
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()                     # exact; numpy has no bf16
        v = np.abs(t.cpu().numpy().astype(np.float64)).reshape(-1)
        vmax = float(v.max()) if v.size else 0.0
        if vmax > self._max:
            if self._max > 0.0:
                # re-bin the old histogram onto the wider range
                old_edges = np.linspace(0, self._max, self._bins + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2
                self._hist = np.histogram(
                    centers, bins=self._bins, range=(0, vmax),
                    weights=self._hist)[0]
            self._max = vmax
        if self._max > 0.0:
            self._hist += np.histogram(v, bins=self._bins,
                                       range=(0, self._max))[0]

    def bit_length(self):
        return self._quant_bits

    def scales(self):
        if self._scale is None:
            self.cal_thresholds()
        return wrap(torch.tensor(self._scale or self._max,
                                 dtype=torch.float32, device=self._device))


class HistObserverLayer(_HistogramObserverBase):
    """The ``percent`` percentile of |x| as the threshold."""

    def __init__(self, layer=None, quant_bits=8, bins_count=2048,
                 percent=0.999):
        super().__init__(layer, quant_bits, bins_count)
        self._percent = percent

    def cal_thresholds(self):
        total = self._hist.sum()
        if total <= 0:
            self._scale = self._max
            return
        cum = np.cumsum(self._hist) / total
        idx = int(np.searchsorted(cum, self._percent))
        edges = np.linspace(0, self._max, self._bins + 1)
        self._scale = float(edges[min(idx + 1, self._bins)])


class HistObserver(QuanterFactory):
    _layer_cls = HistObserverLayer


class KLObserverLayer(_HistogramObserverBase):
    """The clip threshold whose quantized distribution has the least KL
    divergence from the observed one (the TensorRT-style search of
    ``observers.py:243-282``)."""

    def cal_thresholds(self):
        total = self._hist.sum()
        if total <= 0:
            self._scale = self._max
            return
        levels = 2 ** (self._quant_bits - 1)
        eps = 1e-10
        p_full = self._hist / total + eps
        p_full /= p_full.sum()
        best_kl, best_i = np.inf, self._bins
        start = max(levels, self._bins // 16)
        for i in range(start, self._bins + 1, max(1, self._bins // 128)):
            # the kept range in `levels` buckets; the bins past the clip
            # threshold get (near-)zero mass, so clipping real probability
            # costs KL
            chunks = np.array_split(self._hist[:i], levels)
            q = np.concatenate([
                np.full(len(c), c.sum() / max((c > 0).sum(), 1))
                * (c > 0) for c in chunks])
            q_full = np.concatenate(
                [q, np.zeros(self._bins - i)]) + eps
            q_full /= q_full.sum()
            kl = float(np.sum(p_full * np.log(p_full / q_full)))
            if kl < best_kl:
                best_kl, best_i = kl, i
        edges = np.linspace(0, self._max, self._bins + 1)
        self._scale = float(edges[best_i])


class KLObserver(QuanterFactory):
    _layer_cls = KLObserverLayer


class MSEObserverLayer(_HistogramObserverBase):
    """The scale with the least quantization MSE over the observed
    histogram, among 36 fractions of the range."""

    def cal_thresholds(self):
        total = self._hist.sum()
        if total <= 0:
            self._scale = self._max
            return
        qmax = float(2 ** (self._quant_bits - 1) - 1)
        edges = np.linspace(0, self._max, self._bins + 1)
        centers = (edges[:-1] + edges[1:]) / 2
        w = self._hist / total
        best_mse, best_s = np.inf, self._max
        for frac in np.linspace(0.3, 1.0, 36):
            s = self._max * frac
            q = np.clip(np.round(centers / s * qmax), -qmax, qmax) \
                * s / qmax
            mse = float(np.sum(w * (centers - q) ** 2))
            if mse < best_mse:
                best_mse, best_s = mse, s
        self._scale = float(best_s)


class MSEObserver(QuanterFactory):
    _layer_cls = MSEObserverLayer


class FakeQuanterWithAbsMaxObserverLayer(BaseQuanter):
    """Moving-average abs-max fake quanter (activations): while training
    the f32 buffer ``_scale`` (1 at first) becomes ``r * _scale + (1 - r)
    * max|x|`` in place and x is fake-quantized by the new value; in eval
    by the stored one."""

    def __init__(self, layer=None, moving_rate=0.9, bit_length=8):
        super().__init__()
        self._moving_rate = moving_rate
        self._bit_length = bit_length
        self.register_buffer("_scale", torch.ones(
            (), dtype=torch.float32, device=_layer_device(layer, self)))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                cur = x.detach().abs().amax().float()
                r = self._moving_rate
                self._scale.copy_(r * self._scale + (1 - r) * cur)
        return quant_dequant(x, self._scale, self._bit_length)

    def scales(self):
        return wrap(self._scale)

    def bit_length(self):
        return self._bit_length


class FakeQuanterWithAbsMaxObserver(QuanterFactory):
    _layer_cls = FakeQuanterWithAbsMaxObserverLayer


class FakeQuanterChannelWiseAbsMaxLayer(BaseQuanter):
    """Per-output-channel abs-max weight quanter: the scale is each
    channel's abs-max of the weight it is given (in the weight's type),
    recomputed every call. The channel axis is 0 for a convolution's
    ``[out, in / g, ...]``, 1 for a transposed one's ``[in, out / g,
    ...]`` and for a Linear's ``[in, out]``."""

    def __init__(self, layer=None, quant_axis=None, bit_length=8):
        super().__init__()
        if quant_axis is None:
            from ..nn.layers_basic import _ConvND
            if isinstance(layer, _ConvND):
                quant_axis = 1 if getattr(layer, "_transpose", False) else 0
            else:
                quant_axis = 1
        self._quant_axis = quant_axis
        self._bit_length = bit_length
        self._scale_val = None

    def forward(self, w):
        axes = tuple(i for i in range(w.dim()) if i != self._quant_axis)
        with torch.no_grad():
            a = w.detach().abs()
            # amax over no dims would reduce over all of them in torch
            scale = a.amax(dim=axes, keepdim=True) if axes else a
        self._scale_val = scale
        return quant_dequant(w, scale, self._bit_length)

    def scales(self):
        return wrap(self._scale_val)

    def quant_axis(self):
        return self._quant_axis

    def bit_length(self):
        return self._bit_length


class FakeQuanterChannelWiseAbsMax(QuanterFactory):
    _layer_cls = FakeQuanterChannelWiseAbsMaxLayer
