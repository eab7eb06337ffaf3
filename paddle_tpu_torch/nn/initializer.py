"""Weight initializers (paddle.nn.initializer): port of
``paddle_tpu/nn/initializer.py``.

An initializer is called as ``init(shape, dtype="float32", device=None)``
and returns a torch tensor on ``device`` (None: the default place, the
card unless ``set_device`` said otherwise). Each random one takes one key
from ``core.random.next_key`` where the reference takes it, so a layer
built under ``seed(s)`` starts from the reference's weights: the uniform
family bit for bit, the normal family within 3 ulps (XLA's ``erf_inv``,
ROADMAP Queue 3). On the card the draw is R2's fill (uniform, normal,
truncated normal, in f32 or in bf16 by jax's 16-bit rule); the CPU runs
its plain version. ``Orthogonal`` takes its QR on the tensor's device
(cuSOLVER through torch on the card, where the reference leaves it to
XLA). ``calculate_gain`` and the fan rule are copied.
"""
import math

import numpy as np
import torch

from ..core import random as rnd
from ..core.dtype import canonical, convert_dtype
from ..device import default_device
from ..ops.kernels import threefry_fill as _tf

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "calculate_gain", "Bilinear", "Dirac",
    "set_global_initializer", "get_global_initializer",
]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _fan(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


def _args(shape, dtype, device):
    dt = canonical(convert_dtype(dtype)) or torch.float32
    dev = default_device() if device is None else torch.device(device)
    return tuple(int(s) for s in shape), dt, dev


def _times(scale, x):
    """``scale * x`` rounded in x's type (a weakly typed Python number)."""
    return torch.tensor(scale, dtype=x.dtype, device=x.device) * x


class Initializer:
    def __call__(self, shape, dtype="float32", device=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        return torch.full(shape, self.value, dtype=dt, device=dev)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        n = _tf.normal(rnd.next_key(), shape, dev, dt)
        return torch.tensor(self.mean, dtype=dt, device=dev) + \
            _times(self.std, n)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        n = _tf.truncated_normal(rnd.next_key(), shape, dev, -2.0, 2.0, dt)
        return torch.tensor(self.mean, dtype=dt, device=dev) + \
            _times(self.std, n)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        return _tf.uniform(rnd.next_key(), shape, dev, self.low, self.high,
                           dt)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        fi, fo = _fan(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _times(std, _tf.normal(rnd.next_key(), shape, dev, dt))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        fi, fo = _fan(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _tf.uniform(rnd.next_key(), shape, dev, -limit, limit, dt)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        fi, _ = _fan(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        std = gain / math.sqrt(fi)
        return _times(std, _tf.normal(rnd.next_key(), shape, dev, dt))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        fi, _ = _fan(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _tf.uniform(rnd.next_key(), shape, dev, -limit, limit, dt)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        v = self.value
        v = getattr(v, "_value", v)
        if torch.is_tensor(v):
            v = v.detach().to(device=dev, dtype=dt)
        else:
            v = torch.tensor(np.asarray(v), dtype=dt, device=dev)
        assert tuple(v.shape) == shape, (tuple(v.shape), shape)
        return v


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        rows, cols = shape[0], int(np.prod(shape[1:]))
        flat = _tf.normal(rnd.next_key(), (max(rows, cols), min(rows, cols)),
                          dev)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return _times(self.gain, q[:rows, :cols]).reshape(shape).to(dt)


class Bilinear(Initializer):
    """Bilinear upsampling kernel (reference initializer/Bilinear): the
    standard start of a transposed-conv upsample layer."""

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        if len(shape) != 4:
            raise ValueError("Bilinear expects 4-D weight")
        weight = np.zeros(shape, np.float32)
        f = int(np.ceil(shape[3] / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            w = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
            weight[(i // (shape[2] * shape[3])) // shape[1],
                   (i // (shape[2] * shape[3])) % shape[1], y, x] = w
        return torch.tensor(weight, dtype=dt, device=dev)


class Dirac(Initializer):
    """Identity-preserving conv start (reference initializer/Dirac)."""

    def __init__(self, groups=1, name=None):
        self._groups = groups

    def __call__(self, shape, dtype="float32", device=None):
        shape, dt, dev = _args(shape, dtype, device)
        w = np.zeros(shape, np.float32)
        out_c, in_c = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        # per group g, a delta at (g * opg + d, d)
        opg = out_c // self._groups
        for g in range(self._groups):
            for d in range(min(opg, in_c)):
                w[(g * opg + d, d) + mid] = 1.0
        return torch.tensor(w, dtype=dt, device=dev)


_global_initializer = [None, None]   # (weight_init, bias_init)


def set_global_initializer(weight_init, bias_init=None):
    """Overrides the layers' default initializers (``Layer.
    create_parameter`` takes them when no attribute names one)."""
    _global_initializer[0] = weight_init
    _global_initializer[1] = bias_init


def get_global_initializer(is_bias=False):
    return _global_initializer[1 if is_bias else 0]
