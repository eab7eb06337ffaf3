"""The core layers: port of ``paddle_tpu/nn/layers_basic.py`` (Linear,
Embedding, convolutions, norms, dropout, activations, pooling, losses).

Every class is a ``Layer`` whose parameters ``create_parameter`` draws
with the reference's default initializers under the global key, so
``seed(s)`` then building a layer gives the reference's weights (the
uniform family bit for bit, the normal family within 3 ulps). Names and
layouts are the reference's: Linear ``weight [in, out]``, convolutions
``[out, in / groups, *k]`` (transposed: ``[in, out / groups, *k]``),
batch norm's buffers ``_mean`` and ``_variance``.

``Linear``, ``Embedding`` and ``LayerNorm`` also take ``dtype=`` and
``device=`` keywords (None: float32 and the default place), and
``Linear`` and ``Embedding`` draw in ``reset_parameters``, which a model
that draws its own weights overrides so that building it draws once.
``RMSNorm`` runs K5 through ``nn.functional.rms_norm``; the dropout
layers run R2.
"""
import numpy as np
import torch

from ..device import resolve_device
from ..ops.registry import OPS
from . import functional as F
from . import initializer as I
from .layer import Layer

__all__ = [
    "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Unflatten", "Pad1D", "Pad2D", "Pad3D",
    "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
    "CosineSimilarity", "Bilinear", "Identity",
    "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
    "Conv3DTranspose",
    "LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
    "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
    "ReLU", "ReLU6", "GELU", "SiLU", "Swish", "LeakyReLU", "ELU", "CELU",
    "SELU", "PReLU", "RReLU", "Sigmoid", "LogSigmoid", "Tanh", "Tanhshrink",
    "Hardshrink", "Softshrink", "Hardsigmoid", "Hardswish", "Hardtanh",
    "Mish", "Softmax", "LogSoftmax", "Softplus", "Softsign",
    "ThresholdedReLU", "Maxout", "GLU",
    "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
    "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "TripletMarginLoss", "HingeEmbeddingLoss",
    "PixelShuffle",
]


class Identity(Layer):
    def forward(self, x):
        return x


class _Placed(Layer):
    """A layer with the port's ``dtype=`` / ``device=`` keywords."""

    def __init__(self, dtype, device):
        super().__init__(dtype=dtype if dtype is not None else "float32")
        if device is not None:
            self._place = resolve_device(device)


class Linear(_Placed):
    """paddle.nn.Linear: ``weight [in_features, out_features]``
    (Xavier-normal), ``bias [out_features]`` (zeros) unless ``bias_attr``
    is False; ``x @ W + b``. ``draw=False`` leaves the weights undrawn
    (empty) for an owner that draws them itself."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=None, device=None,
                 draw=True):
        super().__init__(dtype, device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            (in_features, out_features), attr=weight_attr,
            default_initializer=I.XavierNormal(), draw=False)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = self.create_parameter(
                (out_features,), attr=bias_attr, is_bias=True, draw=False)
        if draw:
            self.reset_parameters()

    def reset_parameters(self):
        for p in (self.weight, self.bias):
            if p is not None:
                self.init_parameter(p)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(_Placed):
    """paddle.nn.Embedding: ``weight [num_embeddings, embedding_dim]``
    drawn N(0, 1), the ``padding_idx`` row zero (its output rows zero,
    their gradient too). ``sparse`` is accepted; the gradient is dense,
    as the reference's."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, dtype=None,
                 device=None):
        super().__init__(dtype, device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = self.create_parameter(
            (num_embeddings, embedding_dim), attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0), draw=False)
        self.reset_parameters()

    def reset_parameters(self):
        self.init_parameter(self.weight)
        if self.padding_idx is not None:
            with torch.no_grad():
                self.weight[self.padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return OPS["flatten"](x, self.start_axis, self.stop_axis)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        new_shape = list(x.shape)
        new_shape[self.axis:self.axis + 1] = list(self.shape)
        return x.reshape(new_shape)


class _PadND(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return OPS["pad"](x, self.padding, mode=self.mode, value=self.value,
                          data_format=self.data_format)


class Pad1D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadND):
    pass


class Pad3D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        super().__init__(padding, mode, value, data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "nearest", False, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "bilinear", True, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            (out_features, in1_features, in2_features), attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_features,), is_bias=True, attr=bias_attr)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


# ------------------------------------------------------------- convolution

_CONVS = {(1, False): F.conv1d, (2, False): F.conv2d, (3, False): F.conv3d,
          (1, True): F.conv1d_transpose, (2, True): F.conv2d_transpose,
          (3, True): F.conv3d_transpose}


class _ConvND(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, dims,
                 stride=1, padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format="NCHW", transpose=False, output_padding=0):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * dims
        self._dims = dims
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self._transpose = transpose
        self.output_padding = output_padding
        if transpose:
            wshape = (in_channels, out_channels // groups) + tuple(kernel_size)
        else:
            wshape = (out_channels, in_channels // groups) + tuple(kernel_size)
        fan_in = in_channels
        for k in kernel_size:
            fan_in *= k
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in // groups))
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), is_bias=True, attr=bias_attr)

    def forward(self, x):
        fn = _CONVS[(self._dims, self._transpose)]
        if self._transpose:
            return fn(x, self.weight, self.bias, stride=self.stride,
                      padding=self.padding,
                      output_padding=self.output_padding,
                      dilation=self.dilation, groups=self.groups,
                      data_format=self.data_format)
        return fn(x, self.weight, self.bias, stride=self.stride,
                  padding=self.padding, dilation=self.dilation,
                  groups=self.groups, data_format=self.data_format)


class Conv1D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv2D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv3D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv1DTranspose(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)


class Conv2DTranspose(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)


class Conv3DTranspose(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)


# ------------------------------------------------------------- normalization


class LayerNorm(_Placed):
    """paddle.nn.LayerNorm: ``weight`` (ones) and ``bias`` (zeros) of
    ``normalized_shape`` unless their attribute is False; ``bias_attr``
    names no initializer, as in the reference."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=None, device=None):
        super().__init__(dtype, device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self.normalized_shape,
                                  default_initializer=I.Constant(1.0),
                                  attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            self.normalized_shape, is_bias=True, attr=None)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"{self.normalized_shape}, epsilon={self.epsilon}"


class RMSNorm(Layer):
    """RMSNorm over the last axis: K5 forward and backward
    (``nn.functional.rms_norm``)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            (hidden_size,), default_initializer=I.Constant(1.0),
            attr=weight_attr)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_features,),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), is_bias=True)
        dev = self._param_device()
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=dev))

    def forward(self, x):
        training = self.training and not self.use_global_stats
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format)


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would be reduced over the data-parallel
    group; on one card it is ``BatchNorm`` (multi-card runs: ROADMAP item
    13)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer._modules.items()):
            if isinstance(sub, _BatchNormBase) and not isinstance(
                    sub, SyncBatchNorm):
                new = SyncBatchNorm(sub.num_features, sub.momentum,
                                    sub.epsilon, data_format=sub.data_format)
                new.weight = sub.weight
                new.bias = sub.bias
                new._buffers = sub._buffers
                layer._modules[name] = new
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_channels,),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_features,),
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``forward(weight)`` returns ``weight / sigma``, the top singular
    value estimated by power iteration on the persistent ``weight_u`` /
    ``weight_v`` buffers (started from ``RandomState(0)``, as the
    reference), which each call moves in place; no gradient reaches them
    (the reference's stop-gradient side channel)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        self._shape = list(weight_shape)
        h = self._shape[dim]
        w = int(np.prod(self._shape)) // h
        rng = np.random.RandomState(0)
        dev = self._param_device()
        self.register_buffer("weight_u", torch.tensor(
            rng.randn(h).astype(np.float32), device=dev), persistable=True)
        self.register_buffer("weight_v", torch.tensor(
            rng.randn(w).astype(np.float32), device=dev), persistable=True)

    def _matrix(self, w):
        perm = [self._dim] + [i for i in range(len(self._shape))
                              if i != self._dim]
        return w.permute(perm).reshape(self._shape[self._dim], -1)

    def forward(self, weight):
        eps = self._eps
        with torch.no_grad():
            mat = self._matrix(weight.detach())
            u, v = self.weight_u, self.weight_v
            for _ in range(self._power_iters):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ (self._matrix(weight) @ v)
        return weight / sigma


# ------------------------------------------------------------- activations


def _act_layer(fname, **fixed):
    class _Act(Layer):
        def __init__(self, **kw):
            super().__init__()
            self._kw = {**fixed, **kw}

        def forward(self, x):
            return getattr(F, fname)(x, **self._kw)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kw.items())

    _Act.__name__ = fname
    _Act.__qualname__ = fname
    return _Act


ReLU = _act_layer("relu")
ReLU6 = _act_layer("relu6")
GELU = _act_layer("gelu")
SiLU = _act_layer("silu")
Swish = _act_layer("swish")
Mish = _act_layer("mish")
Tanhshrink = _act_layer("tanhshrink")
Hardshrink = _act_layer("hardshrink")
Softshrink = _act_layer("softshrink")
Hardsigmoid = _act_layer("hardsigmoid")
Hardswish = _act_layer("hardswish")
Hardtanh = _act_layer("hardtanh")
Softplus = _act_layer("softplus")
Softsign = _act_layer("softsign")
ThresholdedReLU = _act_layer("thresholded_relu")
LogSoftmax = _act_layer("log_softmax")
Softmax = _act_layer("softmax")
GLU = _act_layer("glu")
ELU = _act_layer("elu")
CELU = _act_layer("celu")
SELU = _act_layer("selu")
LeakyReLU = _act_layer("leaky_relu")
RReLU = _act_layer("rrelu")


class Sigmoid(Layer):
    def forward(self, x):
        return OPS["sigmoid"](x)


class LogSigmoid(Layer):
    def forward(self, x):
        return OPS["logsigmoid"](x)


class Tanh(Layer):
    def forward(self, x):
        return OPS["tanh"](x)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), default_initializer=I.Constant(init),
            attr=weight_attr)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


# ------------------------------------------------------------- pooling


def _pool_layer(fname):
    class _Pool(Layer):
        def __init__(self, kernel_size, stride=None, padding=0, **kw):
            super().__init__()
            self.kernel_size = kernel_size
            self.stride = stride
            self.padding = padding
            self._kw = kw

        def forward(self, x):
            return getattr(F, fname)(x, self.kernel_size, self.stride,
                                     self.padding, **self._kw)

    _Pool.__name__ = fname
    _Pool.__qualname__ = fname
    return _Pool


MaxPool1D = _pool_layer("max_pool1d")
MaxPool2D = _pool_layer("max_pool2d")
MaxPool3D = _pool_layer("max_pool3d")
AvgPool1D = _pool_layer("avg_pool1d")
AvgPool2D = _pool_layer("avg_pool2d")
AvgPool3D = _pool_layer("avg_pool3d")


def _adaptive_pool_layer(fname):
    class _Pool(Layer):
        def __init__(self, output_size, **kw):
            super().__init__()
            self.output_size = output_size
            self._kw = kw

        def forward(self, x):
            return getattr(F, fname)(x, self.output_size, **self._kw)

    _Pool.__name__ = fname
    _Pool.__qualname__ = fname
    return _Pool


AdaptiveAvgPool1D = _adaptive_pool_layer("adaptive_avg_pool1d")
AdaptiveAvgPool2D = _adaptive_pool_layer("adaptive_avg_pool2d")
AdaptiveAvgPool3D = _adaptive_pool_layer("adaptive_avg_pool3d")
AdaptiveMaxPool1D = _adaptive_pool_layer("adaptive_max_pool1d")
AdaptiveMaxPool2D = _adaptive_pool_layer("adaptive_max_pool2d")


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


# ------------------------------------------------------------- losses


class CrossEntropyLoss(Layer):
    """``F.cross_entropy`` with its options held; ``use_softmax`` and
    ``name`` are accepted and not used, as in the reference."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.label_smoothing = label_smoothing

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               label_smoothing=self.label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.p = p
        self.epsilon = epsilon
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)
