"""The functional operators: those the Llama train step calls, those
``nn``'s layers call (convolutions and their transposes, pools, norms,
resampling, the layers' activations and losses) and the tail that
``layers_tail`` and the users of the flat namespace call (CTC and RNN-T,
the margin and focal losses, ``grid_sample``, ``fold`` / ``unfold``,
unpooling, ``gather_tree``, ``sparse_attention``, ...).

Port of ``paddle_tpu/nn/functional.py``: RMSNorm and attention ride the
hand-written kernels (K5 and K4, through their autograd Functions), the
rest is plain torch (cuDNN's convolutions and pools on the card), as the
JAX package leaves it to XLA. The layers' ops follow the reference, not
torch's defaults: ``batch_norm`` moves its running statistics paddle's
way round with the biased variance, the pools take XLA's padding and
ignore ``ceil_mode``, ``interpolate`` is ``jax.image.resize``, the
transposed convolutions do not flip their kernel, ``ctc_loss``'s
``"mean"`` is the batch mean. The dropout family
(``feature_alpha_dropout`` too) and ``gumbel_softmax`` draw their keys
from ``core.random.next_key`` exactly where the reference does, so the
same ``seed()`` gives the same masks; on the card the draw and dropout's
apply are R2 (``ops.kernels.threefry_fill``), dropout's backward reading
the keep flags its forward saved as bits. Under ``amp.auto_cast`` each entry
point casts its inputs under the reference's op name (``linear``, ``flash_attention``,
``sdp_attention``: the AMP dtype; ``rms_norm``, ``softmax``,
``cross_entropy_with_softmax``, ``cross_entropy_soft``: f32), as the
reference's dispatch does (``amp.cast_inputs_for_op``). Options of the
JAX functions that this slice does not port raise
``NotImplementedError`` naming the ROADMAP item.

Every function takes the paddle API's ``Tensor`` as well as a
``torch.Tensor`` and returns the kind it was given: a ``Tensor``
argument sends the call through ``core.tensor.dispatch``, plain torch
tensors call the function straight (what the train step and the
serving tick do, at the cost of one type check an argument). The
functions the reference registers as ops (the activations, ``softmax``,
``linear``, the losses, ...) are in ``ops.registry.OPS`` too, so they are
names of the flat namespace. The activations are the reference's
compositions, so their gradients at a kink are jnp's (``leaky_relu``'s
at 0 is 1, ``hardtanh``'s at a bound one half).
"""
import functools
import math

import numpy as np
import torch
import torch.nn.functional as tf

from ..amp import cast_inputs_for_op as _cast
from ..core.random import next_key as _next_key
from ..core.tensor import Tensor, dispatch
from ..ops.math import jabs as _abs
from ..ops.registry import OPS
from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import rms_norm as _rn
from ..ops.kernels import threefry_fill as _tf

__all__ = ["rms_norm", "layer_norm", "scaled_dot_product_attention",
           "flash_attention", "linear", "embedding", "silu", "swish", "gelu",
           "softmax", "log_softmax", "cross_entropy",
           "cross_entropy_with_softmax", "cross_entropy_soft",
           "mse_loss", "l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "cosine_similarity", "normalize", "label_smooth", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout", "gumbel_softmax",
           "relu", "relu6", "leaky_relu", "elu", "selu", "celu", "mish",
           "softplus", "softsign", "softshrink", "hardshrink", "tanhshrink",
           "hardsigmoid", "hardswish", "hardtanh", "rms_norm_ref",
           "prelu", "rrelu", "thresholded_relu", "maxout", "glu",
           "bilinear", "batch_norm", "instance_norm", "group_norm",
           "local_response_norm", "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
           "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "smooth_l1_loss",
           "nll_loss", "cosine_embedding_loss", "margin_ranking_loss",
           "hinge_embedding_loss", "triplet_margin_loss", "pixel_shuffle",
           "interpolate", "upsample",
           # the tail (item 15.3)
           "affine_grid", "temporal_shift", "sequence_mask", "zeropad2d",
           "pixel_unshuffle", "channel_shuffle", "pairwise_distance",
           "grid_sample", "unfold", "fold", "max_unpool1d", "max_unpool2d",
           "max_unpool3d", "adaptive_max_pool3d", "square_error_cost",
           "sigmoid_focal_loss", "huber_loss", "soft_margin_loss",
           "multi_label_soft_margin_loss", "poisson_nll_loss",
           "gaussian_nll_loss", "log_loss", "dice_loss", "npair_loss",
           "triplet_margin_with_distance_loss", "feature_alpha_dropout",
           "ctc_loss", "rnnt_loss", "softmax_with_cross_entropy",
           "margin_cross_entropy", "multi_margin_loss", "hsigmoid_loss",
           "gather_tree", "class_center_sample", "sparse_attention"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim (K5 forward and backward). An f32 x
    takes a narrower weight in f32, as the reference reads it (K5 takes
    the weight in x's type; the cast's backward rounds dw once, as the
    reference's ``astype`` does): a bf16 model under QAT's f32
    activations."""
    x, weight = _cast("rms_norm", [x, weight])
    if x.dtype == torch.float32 and weight.dtype != x.dtype:
        weight = weight.float()
    return _rn.rms_norm(x, weight, epsilon)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims
    (``functional.py:261-282`` of the reference): the biased variance of
    the centred values, statistics in f32 for f16/bf16 inputs and the
    result back in x's type, the scale and shift applied in the
    statistics' type."""
    (x,) = _cast("layer_norm", [x])
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    low = x.dtype in (torch.float16, torch.bfloat16)
    xc = x.float() if low else x
    centred = xc - xc.mean(dims, keepdim=True)
    out = centred * torch.rsqrt(centred.square().mean(dims, keepdim=True)
                                + epsilon)
    if weight is not None:
        out = out * weight.to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.to(x.dtype)


def flash_attention(query, key, value, causal=False, sm_scale=None):
    """Flash attention on ``[batch, seq, heads, head_dim]`` (K4)."""
    query, key, value = _cast("flash_attention", [query, key, value])
    return _fa.flash_attention(query, key, value, causal=causal,
                               sm_scale=sm_scale)


def _sdp_composition(q, k, v, mask, is_causal):
    """The reference's XLA composition (``functional.py:909-922``) on
    ``[batch, seq, heads, head_dim]``: scores in the inputs' type, the
    causal mask (-inf above the diagonal, top-left aligned), the additive
    ``mask``, softmax in f32 rounded back to q's type, then P V."""
    q_, k_, v_ = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q_, k_) * (1.0 / math.sqrt(
        q_.shape[-1]))
    if is_causal:
        qs, ks = s.shape[-2], s.shape[-1]
        keep = torch.ones((qs, ks), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    if mask is not None:
        s = s + mask
    p = torch.softmax(s.float(), dim=-1).to(q_.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v_).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """paddle.nn.functional.scaled_dot_product_attention on ``[batch,
    seq, heads, head_dim]``. Without a mask or dropout it runs the
    flash-attention kernels (K4; causal masking top-left aligned, query
    row i sees keys 0..i); with ``attn_mask`` (added to the scores) or
    ``dropout_p > 0`` the reference's composition in plain torch: K4
    takes neither. While training, ``dropout_p`` drops the attention's
    output (``dropout``), as the reference does (``functional.py:
    929-930``)."""
    if attn_mask is None and dropout_p == 0.0:
        query, key, value = _cast("flash_attention", [query, key, value])
        return _fa.flash_attention(query, key, value, causal=is_causal)
    query, key, value, attn_mask = _cast(
        "sdp_attention", [query, key, value, attn_mask])
    out = _sdp_composition(query, key, value, attn_mask, is_causal)
    if dropout_p > 0.0 and training:
        out = dropout(out, p=dropout_p, training=training)
    return out


class _Dropout(torch.autograd.Function):
    """Dropout under one key: the forward draws the mask, applies it and
    keeps it packed 8 flags to a byte (R2 on the card); the backward
    applies the vjp from those bits, as the reference's vjp keeps
    ``keep`` as its residual."""

    @staticmethod
    def forward(ctx, x, key, mask_shape, p, upscale):
        out, bits = _tf.dropout(x, key, mask_shape, p, upscale,
                                save_mask=True)
        ctx.save_for_backward(bits)
        ctx.args = (mask_shape, p, upscale)
        return out

    @staticmethod
    def backward(ctx, g):
        (bits,) = ctx.saved_tensors
        return (_tf.dropout_vjp(g, bits, *ctx.args), None, None, None, None)


def _scalar(v, like):
    """A Python number as a 0-d tensor of ``like``'s type on its device:
    the reference's weakly typed constant, rounded to the value's type."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """paddle.nn.functional.dropout (``functional.py:208-228``): keep each
    element (each slice along ``axis``, whose mask broadcasts over the
    other axes) with probability ``1 - p``, drawn from ``next_key()``;
    ``"upscale_in_train"`` divides what it keeps by ``1 - p`` in x's
    type, ``"downscale_in_infer"`` keeps it as it is while training and
    multiplies by ``1 - p`` outside it. ``name`` is accepted and unused."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * _scalar(1.0 - p, x)
        return x
    key = _next_key()
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else axis
        # as the reference: an axis is matched by its index as given
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    return _Dropout.apply(x, key, tuple(shape), float(p),
                          mode == "upscale_in_train")


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Dropout of whole channels of a 4-D input."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    """Dropout of whole channels of a 5-D input."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True):
    """SELU-preserving dropout (``functional.py:241-254``): dropped
    elements become ``-alpha * scale``, then ``a * v + b`` keeps the mean
    and variance; the keep mask is R2's on the card, the affine map plain
    torch, each constant rounded to x's type as in the reference."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    a = ((1 - p) * (1 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    keep = _tf.keep_mask(_next_key(), x.shape, 1.0 - p, x.device)
    return _scalar(a, x) * torch.where(keep, x, _scalar(alpha_p, x)) \
        + _scalar(b, x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` from
    ``uniform(next_key(), x.shape, f32, 1e-10, 1)`` (``functional.py:
    161-172``; R2 on the card, the logs taken in f64 as
    ``core.prng.log_rn``); ``hard`` returns the one-hot of the argmax
    with the soft gradient (straight through)."""
    g = _tf.gumbel(_next_key(), x.shape, x.device, 1e-10)
    y = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)``, weight ``[in, out]`` (paddle
    convention). Operands of two floating types meet in the wider, as
    ``jnp``'s promotion does (an f32 input to a layer cast to bf16
    computes in f32)."""
    x, weight, bias = _cast("linear", [x, weight, bias])
    if x.dtype != weight.dtype:
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at the ids ``x``; with ``padding_idx`` the rows
    of that id come out zero (times a 0/1 mask, so its gradient is zero
    too). ``sparse`` is accepted and not used: the gradient is dense, as
    the reference's."""
    out = weight[x.long()]
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


def silu(x):
    return tf.silu(x)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form (``jax.nn.gelu``'s)."""
    return tf.gelu(x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1, dtype=None):
    """Softmax over ``axis`` (in ``dtype`` when given)."""
    (x,) = _cast("softmax", [x])
    return torch.softmax(x.to(dtype) if dtype is not None else x, dim=axis)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy in f32 over ``axis`` of ``input``
    (``functional.py:744-797``).

    Hard labels (``label`` without the class axis, or with a trailing
    axis of 1): labels equal to ``ignore_index`` count neither in the sum
    nor in the mean's denominator; ``label_smoothing`` mixes the one-hot
    target with the uniform one. Soft labels (``soft_label=True``,
    ``label`` a distribution over the classes): ``-sum(label * logp)``,
    the mean taken over every row. ``reduction`` is ``"mean"``,
    ``"sum"`` or ``"none"``. ``weight`` and ``use_softmax`` are accepted
    and not used, as in the reference (ROADMAP, Queue 3)."""
    if soft_label:
        input, label = _cast("cross_entropy_soft", [input, label])
        logp = torch.log_softmax(input.float(), dim=axis)
        return _reduce(-(label * logp).sum(axis), reduction)
    if label.dim() == input.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    (input,) = _cast("cross_entropy_with_softmax", [input])
    logp = torch.log_softmax(input.float(), dim=axis)
    if axis not in (-1, input.dim() - 1):
        logp = logp.movedim(axis, -1)
    label = label.long()
    nclass = logp.shape[-1]
    # the reference's one-hot target: an all-zero row for a label outside
    # [0, classes), the ignored one included
    valid = (label >= 0) & (label < nclass)
    idx = label.where(valid, 0)
    if label_smoothing > 0.0:
        onehot = tf.one_hot(idx, nclass).to(logp.dtype) \
            * valid[..., None].to(logp.dtype)
        onehot = onehot * (1 - label_smoothing) + label_smoothing / nclass
        nll = -(onehot * logp).sum(-1)
    else:
        nll = -logp.gather(-1, idx[..., None])[..., 0] * valid.to(logp.dtype)
    mask = (label != ignore_index).to(nll.dtype)
    nll = nll * mask
    if reduction == "mean":
        return nll.sum() / mask.sum().clamp_min(1.0)
    if reduction == "sum":
        return nll.sum()
    return nll


def mse_loss(input, label, reduction="mean"):  # noqa: A002
    """``(input - label) ** 2``, reduced (``functional.py:718-720``)."""
    return _reduce((input - label).square(), reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    """Sigmoid cross-entropy on logits in the reference's stable form
    (``functional.py:810-822``)."""
    max_val = (-logit).clamp_min(0)
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (
            torch.log1p(torch.exp(-logit.abs())) + max_val)
    else:
        loss = (1 - label) * logit + max_val + \
            torch.log(torch.exp(-max_val) + torch.exp(-logit - max_val))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def swish(x):
    return tf.silu(x)


def log_softmax(x, axis=-1, dtype=None):
    """Log-softmax over ``axis`` (in ``dtype`` when given)."""
    (x,) = _cast("log_softmax", [x])
    return torch.log_softmax(x.to(dtype) if dtype is not None else x,
                             dim=axis)


def cross_entropy_with_softmax(logits, label, ignore_index=-100,
                               reduction="mean", label_smoothing=0.0,
                               axis=-1):
    """The reference's hard-label op (``functional.py:744``)."""
    return cross_entropy(logits, label, ignore_index=ignore_index,
                         reduction=reduction, axis=axis,
                         label_smoothing=label_smoothing)


def cross_entropy_soft(logits, label, reduction="mean", axis=-1):
    """The reference's soft-label op (``functional.py:767``)."""
    return cross_entropy(logits, label, reduction=reduction,
                         soft_label=True, axis=axis)


def l1_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(_abs(input - label), reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(input + eps)
             + (1 - label) * torch.log(1 - input + eps))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean"):  # noqa: A002
    loss = label * (torch.log(label.clamp_min(1e-12)) - input)
    return _reduce(loss, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = (x1 * x2).sum(axis)
    n1 = torch.sqrt((x1 * x1).sum(axis))
    n2 = torch.sqrt((x2 * x2).sum(axis))
    return dot / torch.clamp_min(n1 * n2, eps)


def normalize(x, p=2, axis=1, epsilon=1e-12):
    nrm = torch.pow(torch.pow(_abs(x), p).sum(axis, keepdim=True), 1.0 / p)
    return x / torch.clamp_min(nrm, epsilon)


def label_smooth(label, prior_dist=None, epsilon=0.1):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def rms_norm_ref(x, weight, epsilon=1e-6):
    """The reference's XLA RMSNorm (``functional.py:282``), plain torch:
    statistics and scale in f32, the result in x's type."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + epsilon) * weight.float()).to(x.dtype)


# -- activations: the reference's compositions (``functional.py:22-130``)

def _clip(x, lo, hi):
    """``jnp.clip``: maximum then minimum, half the gradient at a bound."""
    return torch.minimum(torch.maximum(x, _scalar(lo, x)), _scalar(hi, x))


def relu(x):
    return torch.relu(x)


def relu6(x):
    return tf.relu6(x)


def leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0):
    zero = _scalar(0.0, x)
    return torch.maximum(x, zero) + alpha * torch.expm1(
        torch.minimum(x, zero) / alpha)


def softplus(x, beta=1.0, threshold=20.0):
    return torch.where(beta * x > threshold, x,
                       (1.0 / beta) * torch.log1p(torch.exp(beta * x)))


def mish(x):
    return x * torch.tanh(torch.logaddexp(x, _scalar(0.0, x)))


def softsign(x):
    return x / (_abs(x) + 1)


def softshrink(x, threshold=0.5):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, threshold=0.5):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def tanhshrink(x):
    return x - torch.tanh(x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return _clip(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * _clip(x / 6.0 + 0.5, 0.0, 1.0)


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return _clip(x, min, max)


# -- the layers' ops (``functional.py:68-150``, ``:197``, ``:300-400``,
#    ``:401-715``, ``:729-870``, ``:976-1020`` of the reference): plain
#    torch, cuDNN's convolutions and pools through torch on the card, as
#    the reference leaves them to XLA

def prelu(x, weight, data_format="NCHW"):
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format == "NCHW" else -1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def rrelu(x, lower=0.125, upper=0.333, training=True):
    """The mean slope ``(lower + upper) / 2`` below zero, while training
    too: the reference draws no slope."""
    return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)


def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, _scalar(value, x))


def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(axis + 1)


def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def bilinear(x1, x2, weight, bias=None):
    """``x1 W x2`` with ``weight [out, in1, in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def _channel_axis(x, data_format):
    return 1 if data_format.startswith("NC") else x.dim() - 1


def _bcast(v, x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return v.reshape(shape)


def _moments(x, axes, keepdim=False):
    """Mean and biased variance (``jnp.var``) over ``axes``."""
    mean = x.mean(axes, keepdim=True)
    var = (x - mean).square().mean(axes, keepdim=keepdim)
    return (mean if keepdim else mean.squeeze(axes)), var


def batch_norm_func(x, running_mean, running_var, weight, bias,
                    training=False, momentum=0.9, epsilon=1e-5,
                    data_format="NCHW"):
    """Batch normalisation with the batch's statistics (``training``) or
    the running ones; no update (the reference's ``batch_norm_func``)."""
    caxis = _channel_axis(x, data_format)
    axes = tuple(i for i in range(x.dim()) if i != caxis)
    if training:
        mean, var = _moments(x, axes)
    else:
        mean, var = running_mean, running_var
    out = (x - _bcast(mean, x, caxis)) * torch.rsqrt(
        _bcast(var, x, caxis) + epsilon)
    if weight is not None:
        out = out * _bcast(weight, x, caxis)
    if bias is not None:
        out = out + _bcast(bias, x, caxis)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """paddle's batch norm (``functional.py:319-335``). While training
    the running statistics move in place, paddle's way round: ``running =
    momentum * running + (1 - momentum) * batch``, the batch variance the
    biased one; torch's ``batch_norm`` is not called (its momentum weighs
    the batch, its running variance is unbiased)."""
    out = batch_norm_func(x, running_mean, running_var, weight, bias,
                          training, momentum, epsilon, data_format)
    if training and torch.is_tensor(running_mean):
        caxis = _channel_axis(x, data_format)
        axes = tuple(i for i in range(x.dim()) if i != caxis)
        with torch.no_grad():
            m, v = _moments(x.detach(), axes)
            running_mean.copy_(momentum * running_mean + (1 - momentum) * m)
            running_var.copy_(momentum * running_var + (1 - momentum) * v)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """Per-sample, per-channel normalisation; the scale and the shift
    apply only when ``weight`` is given, as in the reference."""
    caxis = _channel_axis(x, data_format)
    axes = tuple(range(2, x.dim())) if caxis == 1 else \
        tuple(range(1, x.dim() - 1))
    mean, var = _moments(x, axes, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * _bcast(weight, x, caxis)
        if bias is not None:
            out = out + _bcast(bias, x, caxis)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW"):
    if data_format == "NHWC":
        out = group_norm(x.movedim(-1, 1), num_groups, epsilon, weight,
                         bias, "NCHW")
        return out.movedim(1, -1)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    mean, var = _moments(g, tuple(range(2, g.dim())), keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    if weight is not None:
        out = out * _bcast(weight, x, 1)
    if bias is not None:
        out = out + _bcast(bias, x, 1)
    return out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    caxis = _channel_axis(x, data_format)
    sq = x.square().movedim(caxis, -1)
    pad = (size - 1) // 2
    padded = tf.pad(sq, (pad, size - 1 - pad))
    c = sq.shape[-1]
    win = sum(padded[..., i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * win.movedim(-1, caxis), beta)


# -- convolution

def _tuple(v, dims):
    return (v,) * dims if isinstance(v, int) else tuple(v)


def _same_pads(sizes, window, strides):
    """XLA's "SAME" padding (``lax.padtype_to_pads``): the output has
    ``ceil(in / stride)`` positions, the extra padding after."""
    pads = []
    for n, w, s in zip(sizes, window, strides):
        total = max((-(-n // s) - 1) * s + w - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_pairs(padding, dims):
    """An int, ``dims`` ints or pairs, or ``2 * dims`` ints as (before,
    after) pairs."""
    if isinstance(padding, int):
        return [(padding, padding)] * dims
    padding = list(padding)
    if len(padding) == dims:
        return [(p, p) if isinstance(p, int) else tuple(p) for p in padding]
    return [(padding[2 * i], padding[2 * i + 1]) for i in range(dims)]


def _torch_pad(pairs):
    """(before, after) pairs, first spatial axis first, as ``F.pad``'s
    flat list (last axis first)."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


def _channels_first(x, channels_last):
    return x.movedim(-1, 1) if channels_last else x


def _channels_back(x, channels_last):
    return x.movedim(1, -1) if channels_last else x


_CONV = {1: tf.conv1d, 2: tf.conv2d, 3: tf.conv3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, dims,
             data_format):
    """``lax.conv_general_dilated`` with the reference's padding forms:
    explicit pairs pad first (``F.pad``), "SAME" / "VALID" by XLA's
    rule; weight ``[out, in / groups, *k]``."""
    channels_last = data_format in ("NHWC", "NLC", "NDHWC")
    stride, dilation = _tuple(stride, dims), _tuple(dilation, dims)
    x = _channels_first(x, channels_last)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pairs = [(0, 0)] * dims
        else:
            eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:],
                                                   dilation)]
            pairs = _same_pads(x.shape[2:], eff, stride)
    else:
        pairs = _pad_pairs(padding, dims)
    if any(lo != hi for lo, hi in pairs):
        x = tf.pad(x, _torch_pad(pairs))
        pad = 0
    else:
        pad = tuple(lo for lo, _ in pairs)
    out = _CONV[dims](x, weight.to(x.dtype), None, stride, pad, dilation,
                      groups)
    if bias is not None:
        out = out + _bcast(bias, out, 1)
    return _channels_back(out, channels_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def _transpose_pads(padding, ksizes, dilation, strides, output_padding,
                    dims):
    """``lax.conv_transpose``'s padding of the dilated input: for a
    conv padding p, ``(k - 1) d - p`` each side plus ``output_padding``
    after; "SAME" / "VALID" by jax's ``_conv_transpose_padding``."""
    eff = [(k - 1) * d + 1 for k, d in zip(ksizes, dilation)]
    if isinstance(padding, str):
        pads = []
        for k, s in zip(eff, strides):
            if padding.upper() == "SAME":
                total = k + s - 2
                lo = k - 1 if s > k - 1 else -(-total // 2)
            else:
                total = k + s - 2 + max(k - s, 0)
                lo = k - 1
            pads.append((lo, total - lo))
        return pads
    return [(e - 1 - lo, e - 1 - hi + op) for e, (lo, hi), op
            in zip(eff, _pad_pairs(padding, dims), output_padding)]


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, dims, data_format):
    """The reference's transposed convolution (``functional.py:459-511``,
    ``lax.conv_transpose`` with ``transpose_kernel=False``): the input
    dilated by the stride, padded, and convolved with the kernel as it is
    (not flipped, unlike ``torch.nn.functional.conv_transpose``), weight
    ``[in, out / groups, *k]``."""
    channels_last = not data_format.startswith("NC")
    stride, dilation = _tuple(stride, dims), _tuple(dilation, dims)
    output_padding = _tuple(output_padding, dims)
    x = _channels_first(x, channels_last)
    pads = _transpose_pads(padding, weight.shape[2:], dilation, stride,
                           output_padding, dims)
    n, c = x.shape[0], x.shape[1]
    if any(s > 1 for s in stride):
        sizes = [(i - 1) * s + 1 for i, s in zip(x.shape[2:], stride)]
        xd = x.new_zeros((n, c, *sizes))
        xd[(slice(None), slice(None)) + tuple(slice(None, None, s)
                                              for s in stride)] = x
        x = xd
    x = tf.pad(x, _torch_pad(pads))
    cin, opg = weight.shape[0], weight.shape[1]
    w = weight.reshape(groups, cin // groups, opg, *weight.shape[2:])
    w = w.transpose(1, 2).reshape(groups * opg, cin // groups,
                                  *weight.shape[2:])
    out = _CONV[dims](x, w.to(x.dtype), None, 1, 0, dilation, groups)
    if bias is not None:
        out = out + _bcast(bias, out, 1)
    return _channels_back(out, channels_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format)


# -- pooling

_MAX_POOL = {1: tf.max_pool1d, 2: tf.max_pool2d, 3: tf.max_pool3d}
_AVG_POOL = {1: tf.avg_pool1d, 2: tf.avg_pool2d, 3: tf.avg_pool3d}


def _pool_nd(x, ksize, stride, padding, dims, data_format, avg,
             count_include_pad=True):
    """``lax.reduce_window`` as the reference calls it
    (``functional.py:539-573``): explicit pairs or XLA's "SAME" /
    "VALID"; max pads with -inf; the average divides by the window
    (padding included, or a string padding) or by the count of real
    elements (``exclusive``). ``ceil_mode`` is not taken, as in the
    reference."""
    channels_last = not data_format.startswith("NC")
    ksize = _tuple(ksize, dims)
    stride = ksize if stride is None else _tuple(stride, dims)
    x = _channels_first(x, channels_last)
    if isinstance(padding, str):
        pairs = [(0, 0)] * dims if padding.upper() == "VALID" else \
            _same_pads(x.shape[2:], ksize, stride)
    else:
        pairs = _pad_pairs(padding, dims)
    padded = any(p != (0, 0) for p in pairs)
    if not avg:
        if padded:
            x = tf.pad(x, _torch_pad(pairs), value=float("-inf"))
        return _channels_back(_MAX_POOL[dims](x, ksize, stride), channels_last)
    xp = tf.pad(x, _torch_pad(pairs)) if padded else x
    out = _AVG_POOL[dims](xp, ksize, stride)
    if padded and not count_include_pad and not isinstance(padding, str):
        ones = tf.pad(torch.ones_like(x[:1, :1]), _torch_pad(pairs))
        counts = _AVG_POOL[dims](ones, ksize, stride) * math.prod(ksize)
        out = out * (math.prod(ksize) / counts)
    return _channels_back(out, channels_last)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCL"):
    return _pool_nd(x, kernel_size, stride, padding, 1, data_format, False)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW", return_mask=False):
    return _pool_nd(x, kernel_size, stride, padding, 2, data_format, False)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    return _pool_nd(x, kernel_size, stride, padding, 3, data_format, False)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _pool_nd(x, kernel_size, stride, padding, 1, data_format, True,
                    not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCHW"):
    return _pool_nd(x, kernel_size, stride, padding, 2, data_format, True,
                    not exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCDHW"):
    return _pool_nd(x, kernel_size, stride, padding, 3, data_format, True,
                    not exclusive)


def _adaptive_bins(in_size, o):
    """Bin edges ``[floor(i * in / o), ceil((i + 1) * in / o))``."""
    i = np.arange(o)
    return (i * in_size) // o, -((-(i + 1) * in_size) // o)


def _adaptive_general(out, d, o, avg):
    """One axis to ``o`` bins of any size: the averages from a cumulative
    sum, the maxima over a gather masked with -inf (separable, so exact
    per axis)."""
    in_size = out.shape[d]
    start, end = _adaptive_bins(in_size, o)
    if avg:
        zero = torch.zeros_like(out.narrow(d, 0, 1))
        csum = torch.cat([zero, out.cumsum(d)], d)
        hi = csum.index_select(d, torch.as_tensor(end, device=out.device))
        lo = csum.index_select(d, torch.as_tensor(start, device=out.device))
        cnt = torch.as_tensor((end - start).astype(np.float32),
                              device=out.device).to(out.dtype)
        shape = [1] * out.dim()
        shape[d] = o
        return (hi - lo) / cnt.reshape(shape)
    w = int((end - start).max())
    idx = start[:, None] + np.arange(w)[None, :]
    valid = idx < end[:, None]
    idx = np.minimum(idx, in_size - 1)
    g = out.index_select(d, torch.as_tensor(idx.reshape(-1),
                                            device=out.device))
    shape = list(out.shape)
    shape[d:d + 1] = [o, w]
    g = g.reshape(shape)
    mshape = [1] * len(shape)
    mshape[d], mshape[d + 1] = o, w
    neg = torch.tensor(float("-inf"), dtype=out.dtype, device=out.device)
    g = torch.where(torch.as_tensor(valid, device=out.device).reshape(mshape),
                    g, neg)
    return g.amax(d + 1)


def _adaptive_pool(x, output_size, dims, data_format, avg):
    channels_last = not data_format.startswith("NC")
    output_size = _tuple(output_size, dims) if not isinstance(
        output_size, int) else (output_size,) * dims
    first = 1 if channels_last else 2
    out = x
    for i in range(dims):
        d = first + i
        in_size, o = out.shape[d], output_size[i]
        if o is None or o == in_size:
            continue
        if in_size % o == 0:
            shape = list(out.shape)
            shape[d:d + 1] = [o, in_size // o]
            r = out.reshape(shape)
            out = r.mean(d + 1) if avg else r.amax(d + 1)
        else:
            out = _adaptive_general(out, d, o, avg)
    return out


def adaptive_avg_pool1d(x, output_size, data_format="NCL"):
    return _adaptive_pool(x, output_size, 1, data_format, True)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive_pool(x, output_size, 2, data_format, True)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _adaptive_pool(x, output_size, 3, data_format, True)


def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _adaptive_pool(x, output_size, 1, "NCL", False)


def adaptive_max_pool2d(x, output_size, return_mask=False):
    return _adaptive_pool(x, output_size, 2, "NCHW", False)


# -- the losses of the layers

def smooth_l1_loss(input, label, reduction="mean", delta=1.0):  # noqa: A002
    diff = _abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean"):
    """``-input[label]`` on the last axis; labels equal to
    ``ignore_index`` count neither in the sum nor in the mean's
    denominator. ``weight`` is accepted and not used, as in the
    reference."""
    label = label.long()
    nll = -torch.gather(input, -1, label.clamp(0, input.shape[-1] - 1)
                        [..., None])[..., 0]
    mask = (label != ignore_index).to(nll.dtype)
    nll = nll * mask
    if reduction == "mean":
        return nll.sum() / mask.sum().clamp_min(1.0)
    return _reduce(nll, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0,
                          reduction="mean"):
    cos = cosine_similarity(input1, input2, axis=-1)
    loss = torch.where(label == 1, 1 - cos, (cos - margin).clamp_min(0))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,  # noqa: A002
                        reduction="mean"):
    return _reduce((-label * (input - other) + margin).clamp_min(0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0,  # noqa: A002
                         reduction="mean"):
    loss = torch.where(label == 1, input, (margin - input).clamp_min(0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0,  # noqa: A002
                        p=2, eps=1e-6, swap=False, reduction="mean"):
    def pdist(a, b):
        return torch.pow(torch.pow(_abs(a - b) + eps, p).sum(-1), 1.0 / p)
    d_pos = pdist(input, positive)
    d_neg = pdist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, pdist(positive, negative))
    return _reduce((d_pos - d_neg + margin).clamp_min(0), reduction)


# -- resampling

def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, c // (r * r), r, r, h, w)
        return out.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r,
                                                      w * r)
    n, h, w, c = x.shape
    out = x.reshape(n, h, w, r, r, c // (r * r))
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r,
                                                  c // (r * r))


def interpolate_nearest(x, scale=2, data_format="NCHW"):
    axes = (2, 3) if data_format == "NCHW" else (1, 2)
    return x.repeat_interleave(scale, axes[0]).repeat_interleave(scale,
                                                                 axes[1])


def _keys_cubic(x):
    """Keys' cubic kernel at a = -0.5 (jax.image's)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return (1 - x.abs()).clamp_min(0)


def _resize_weights(in_size, out_size, kernel):
    """``jax.image``'s ``compute_weight_mat`` ``[in, out]`` in f32: half-
    pixel centres, the kernel widened by ``in / out`` when shrinking
    (antialiasing), columns normalised, samples outside the input
    zeroed."""
    scale = out_size / in_size
    inv = torch.tensor(1.0 / scale, dtype=torch.float32)
    kscale = torch.clamp_min(inv, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[
        :, None]).abs() / kscale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(v, out_shape, method):
    """``jax.image.resize(v, out_shape, method)`` (antialiased)."""
    if method == "nearest":
        for d in range(v.dim()):
            m, n = v.shape[d], out_shape[d]
            if m == n:
                continue
            off = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).to(torch.int64).to(v.device)
            v = v.index_select(d, off)
        return v
    kernel = _triangle if method == "linear" else _keys_cubic
    for d in range(v.dim()):
        m, n = v.shape[d], out_shape[d]
        if m == n:
            continue
        w = _resize_weights(m, n, kernel).to(device=v.device, dtype=v.dtype)
        v = torch.tensordot(v, w, dims=([d], [0])).movedim(-1, d)
    return v


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """``jax.image.resize`` as the reference calls it (``functional.py:
    996-1014``): half-pixel centres, ``align_corners`` not taken, bilinear
    and bicubic antialiased when shrinking, the cubic Keys' with a = -0.5
    (torch's bicubic takes -0.75)."""
    spatial = x.shape[2:] if data_format.startswith("NC") else x.shape[1:-1]
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, sf)]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "bicubic": "cubic", "trilinear": "linear"}[mode]
    size = [int(s) for s in size]
    if data_format.startswith("NC"):
        out_shape = tuple(x.shape[:2]) + tuple(size)
    else:
        out_shape = (x.shape[0],) + tuple(size) + (x.shape[-1],)
    return _resize(x, out_shape, method)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       data_format)


# -- the tail (item 15.3): the ops only ``layers_tail``'s layers, the
#    losses and the samplers call (``functional.py:1023-1719`` of the
#    reference: plain jnp there, plain torch here)

def _jmax(x, v):
    """``jnp.maximum(x, v)`` for a Python number ``v``: a tie takes half
    the gradient, as jnp's does (``clamp_min`` gives it all)."""
    return torch.maximum(x, _scalar(v, x))


def affine_grid(theta, out_shape, align_corners=True):
    """The ``[N, H, W, 2]`` sampling grid of the affine maps ``theta
    [N, 2, 3]`` over ``out_shape = (N, C, H, W)``."""
    n, _, h, w = [int(s) for s in out_shape]
    kw = {"dtype": torch.float32, "device": theta.device}
    ys = torch.linspace(-1, 1, h, **kw) if align_corners else \
        torch.linspace(-1 + 1 / h, 1 - 1 / h, h, **kw)
    xs = torch.linspace(-1, 1, w, **kw) if align_corners else \
        torch.linspace(-1 + 1 / w, 1 - 1 / w, w, **kw)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", theta, grid.to(theta.dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM: the first ``shift_ratio`` of the channels shift back one
    segment, the next as many forward, zeros coming in."""
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    left = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])],
                     dim=1)
    right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], dim=1)
    return torch.cat([left, right, v[:, :, 2 * fold:]],
                     dim=2).reshape(nt, c, h, w)


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """``mask[..., j] = j < lengths[...]`` in ``dtype`` (64-bit types
    narrowed, as everywhere in the port)."""
    from ..core.dtype import canonical, convert_dtype
    m = int(lengths.max()) if maxlen is None else int(maxlen)
    ar = torch.arange(m, device=lengths.device)
    return (ar < lengths[..., None]).to(canonical(convert_dtype(dtype)))


def zeropad2d(x, padding, data_format="NCHW"):
    left, right, top, bottom = padding
    if data_format == "NCHW":
        return tf.pad(x, (left, right, top, bottom))
    return tf.pad(x, (0, 0, left, right, top, bottom))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = downscale_factor
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


def channel_shuffle(x, groups, data_format="NCHW"):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = x - y + epsilon
    return (_abs(d) ** p).sum(-1, keepdim=keepdim) ** (1.0 / p)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """NCHW bilinear / nearest sampling at ``grid [N, Ho, Wo, 2]`` in
    [-1, 1] (x then y), padding ``"zeros"``, ``"border"`` or
    ``"reflection"``; differentiable in x and in the grid."""
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (w - 1)
        fy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1.0) * w - 1.0) * 0.5
        fy = ((gy + 1.0) * h - 1.0) * 0.5

    if padding_mode == "reflection":
        def reflect(f, size):
            if align_corners:
                span = size - 1
                if span == 0:
                    return torch.zeros_like(f)
                f = _abs(f) % (2 * span)
                return torch.where(f > span, 2 * span - f, f)
            span = size
            f = _abs(f + 0.5) % (2 * span)
            f = torch.where(f > span, 2 * span - f, f)
            return (f - 0.5).clamp(0, size - 1)

        fx = reflect(fx, w)
        fy = reflect(fy, h)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        inb = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        ixc = ix.clamp(0, w - 1).long()
        iyc = iy.clamp(0, h - 1).long()
        v = x[batch, :, iyc, ixc].movedim(-1, 1)       # [N, C, Ho, Wo]
        if padding_mode == "zeros":
            v = v * inb[:, None].to(v.dtype)
        return v

    if mode == "nearest":
        return sample(torch.round(fx), torch.round(fy))
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1, y0 + 1
    wa = (x1 - fx) * (y1 - fy)
    wb = (x1 - fx) * (fy - y0)
    wc = (fx - x0) * (y1 - fy)
    wd = (fx - x0) * (fy - y0)
    return (sample(x0, y0) * wa[:, None] + sample(x0, y1) * wb[:, None]
            + sample(x1, y0) * wc[:, None] + sample(x1, y1) * wd[:, None])


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C, H, W]`` -> ``[N, C * kh * kw, L]``."""
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)[:2]
    dh, dw = _pair(dilations)
    n, c = x.shape[0], x.shape[1]
    xp = tf.pad(x, (pw, pw, ph, ph))
    oh = (xp.shape[2] - (dh * (kh - 1) + 1)) // sh + 1
    ow = (xp.shape[3] - (dw * (kw - 1) + 1)) // sw + 1
    patches = [xp[:, :, i * dh:i * dh + oh * sh:sh,
                  j * dw:j * dw + ow * sw:sw]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, dim=2).reshape(n, c * kh * kw, oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im: ``[N, C * kh * kw, L]`` -> ``[N, C, H, W]``, overlapping
    patches summed."""
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    dh, dw = _pair(dilations)
    H, W = _pair(output_sizes)
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    oh = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    cols = x.reshape(n, c, kh, kw, oh, ow)
    out = torch.zeros((n, c, H + 2 * ph, W + 2 * pw), dtype=x.dtype,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            hs, ws = i * dh, j * dw
            out[:, :, hs:hs + sh * oh:sh, ws:ws + sw * ow:sw] += \
                cols[:, :, i, j]
    return out[:, :, ph:ph + H, pw:pw + W]


def _max_unpool_nd(x, indices, spatial_out):
    n, c = x.shape[0], x.shape[1]
    numel = 1
    for s in spatial_out:
        numel *= int(s)
    flat = torch.zeros((n, c, numel), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, indices.reshape(n, c, -1).long(),
                        x.reshape(n, c, -1))
    return flat.reshape((n, c) + tuple(int(s) for s in spatial_out))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None):
    ks = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    st = stride or ks
    st = st if isinstance(st, int) else st[0]
    L = (x.shape[-1] - 1) * st + ks - 2 * padding if output_size is None \
        else output_size[-1]
    return _max_unpool_nd(x, indices, (L,))


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None):
    """Scatter pooled values back to their argmax positions."""
    h, w = x.shape[2], x.shape[3]
    ks = _pair(kernel_size)
    st = _pair(stride or ks)
    if output_size is None:
        spatial = ((h - 1) * st[0] + ks[0] - 2 * padding,
                   (w - 1) * st[1] + ks[1] - 2 * padding)
    else:
        spatial = tuple(output_size[-2:])
    return _max_unpool_nd(x, indices, spatial)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None):
    def _triple(v):
        return (v, v, v) if isinstance(v, int) else tuple(v)
    ks = _triple(kernel_size)
    st = _triple(stride) if stride is not None else ks
    pd = _triple(padding)
    if output_size is None:
        spatial = tuple((x.shape[2 + i] - 1) * st[i] + ks[i] - 2 * pd[i]
                        for i in range(3))
    else:
        spatial = tuple(output_size[-3:])
    return _max_unpool_nd(x, indices, spatial)


def adaptive_max_pool3d(x, output_size, return_mask=False):
    return _adaptive_pool(x, output_size, 3, "NCDHW", False)


def square_error_cost(input, label):  # noqa: A002
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    ce = binary_cross_entropy_with_logits(logit, label, reduction="none")
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * torch.pow(1 - p_t, gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean"):  # noqa: A002
    """``0.5 * d^2`` inside ``delta``, ``delta * (|d| - delta / 2)``
    outside."""
    diff = _abs(input - label)
    loss = torch.where(diff <= delta, 0.5 * diff * diff,
                       delta * (diff - 0.5 * delta))
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean"):  # noqa: A002
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,  # noqa: A002
                                 reduction="mean"):
    loss = -(label * tf.logsigmoid(input)
             + (1 - label) * tf.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,  # noqa: A002
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label + epsilon) - label
                    + 0.5 * torch.log(2 * math.pi * (label + epsilon)))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False,  # noqa: A002
                      epsilon=1e-6, reduction="mean"):
    var = _jmax(variance, epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4):  # noqa: A002
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    lab = tf.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * lab).sum(dims)
    union = input.sum(dims) + lab.sum(dims)
    return torch.mean(1.0 - (2 * inter + epsilon) / (union + epsilon))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    reg = l2_reg * (torch.square(anchor).sum(-1).mean()
                    + torch.square(positive).sum(-1).mean()) * 0.25
    sim = anchor @ positive.T
    lab = (labels[:, None] == labels[None, :]).to(sim.dtype)
    lab = lab / lab.sum(-1, keepdim=True)
    logp = torch.log_softmax(sim, -1)
    return -torch.mean((lab * logp).sum(-1)) + reg


def triplet_margin_with_distance_loss(input, positive,  # noqa: A002
                                      negative, distance_function=None,
                                      margin=1.0, swap=False,
                                      reduction="mean"):
    dist = distance_function or (
        lambda a, b: torch.sqrt(torch.square(a - b).sum(-1) + 1e-12))
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(_jmax(dp - dn + margin, 0.0), reduction)


def feature_alpha_dropout(x, p=0.5, training=True):
    """Alpha dropout of whole channels (the mask ``[N, C, 1, ...]``):
    keep where ``uniform(next_key()) >= p`` (R2's uniform fill on the
    card, the reference's key and bits), dropped channels at the SELU
    saturation ``alpha_p``, then ``a * v + b`` with ``a = 1 / sqrt((
    alpha_p^2 * p + 1) * (1 - p))`` rounded to f32 as jnp's is, each
    constant in x's type."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.7580993408473766
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
    u = _tf.uniform(_next_key(), shape, x.device)
    keep = (u >= _scalar(p, u)).to(x.dtype)
    a = np.float32(1.0) / np.sqrt(np.float32((alpha_p ** 2 * p + 1)
                                             * (1 - p)))
    a = _scalar(float(a), x)
    b = -a * _scalar(alpha_p, x) * _scalar(p, x)
    return a * (x * keep + _scalar(alpha_p, x) * (1 - keep)) + b


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC's alpha recursion in log space (``functional.py:1321-1388``):
    ``log_probs [T, N, C]`` (logits or log-probabilities: a log-softmax
    is taken), ``labels [N, S]`` padded past ``label_lengths``. Each
    step's log-sum-exp as the reference's (max shift, ``+ 1e-38``, -1e30
    for an impossible state); ``"mean"`` is the batch mean of the
    per-sequence losses, as the reference's (torch's built-in divides by
    the label lengths first, so it is not used)."""
    lp = torch.log_softmax(log_probs.float(), -1)
    T, N, _ = lp.shape
    S = labels.shape[1]
    dev = lp.device
    ext = torch.full((N, 2 * S + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_len = 2 * label_lengths.long() + 1
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    skip_ok = torch.cat(
        [torch.zeros((N, 2), dtype=torch.bool, device=dev),
         (ext[:, 2:] != ext[:, :-2]) & (ext[:, 2:] != blank)], dim=1)
    states = torch.arange(2 * S + 1, device=dev)[None, :]
    alpha = torch.where(states < 2, lp[0].gather(1, ext), neg_inf)
    hist = [alpha]
    pad1 = neg_inf.expand(N, 1)
    pad2 = neg_inf.expand(N, 2)
    for t in range(1, T):
        a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], dim=1),
                         neg_inf)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        tot = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                            + torch.exp(a2 - m) + 1e-38)
        alpha = tot + lp[t].gather(1, ext)
        hist.append(alpha)
    hist = torch.stack(hist)                             # [T, N, 2S+1]
    rows = torch.arange(N, device=dev)
    at_t = hist[(input_lengths.long() - 1).clamp(0, T - 1), rows]
    aN = at_t[rows, (ext_len - 1).clamp(0, 2 * S)]
    aN1 = at_t[rows, (ext_len - 2).clamp(0, 2 * S)]
    aN1 = torch.where(ext_len >= 2, aN1, neg_inf)
    m = torch.maximum(aN, aN1)
    loss = -(m + torch.log(torch.exp(aN - m) + torch.exp(aN1 - m) + 1e-38))
    if norm_by_times:
        loss = loss / _jmax(input_lengths.float(), 1.0)
    return _reduce(loss, reduction)


def rnnt_loss(logits, labels, logit_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean"):
    """RNN-Transducer loss (``functional.py:1581-1665``): the log-space
    alpha recursion over the ``(T, U + 1)`` lattice of ``logits [B, T,
    U + 1, C]`` (raw; a log-softmax is taken), ``labels [B, U]``.
    ``fastemit_lambda`` scales the label emissions' gradient by ``1 +
    lambda`` and leaves the value (FastEmit)."""
    lp = torch.log_softmax(logits.float(), -1)
    B, T, U1, _ = lp.shape
    U = U1 - 1
    blank_lp = lp[..., blank]                             # [B, T, U+1]
    lab_lp = lp[:, :, :U, :].gather(
        -1, labels.long()[:, None, :, None].expand(B, T, U, 1))[..., 0]
    rows_b = torch.arange(B, device=lp.device)
    ti = (logit_lengths.long() - 1).clamp(0, T - 1)
    ui = label_lengths.long().clamp(0, U)

    def nll(blank_lp, lab_lp):
        cur = torch.zeros(B, dtype=torch.float32, device=lp.device)
        row = [cur]
        for u in range(1, U1):
            cur = cur + lab_lp[:, 0, u - 1]
            row.append(cur)
        rows = [torch.stack(row, dim=1)]
        for t in range(1, T):
            from_blank = rows[-1] + blank_lp[:, t - 1, :]
            cur = from_blank[:, 0]
            row = [cur]
            for u in range(1, U1):
                cur = torch.logaddexp(from_blank[:, u],
                                      cur + lab_lp[:, t, u - 1])
                row.append(cur)
            rows.append(torch.stack(row, dim=1))
        all_rows = torch.stack(rows)                      # [T, B, U+1]
        return -(all_rows[ti, rows_b, ui] + blank_lp[rows_b, ti, ui])

    loss = nll(blank_lp, lab_lp)
    if fastemit_lambda:
        emit = nll(blank_lp.detach(), lab_lp)
        loss = loss + fastemit_lambda * (emit - emit.detach())
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    """Log-softmax in f32 and the NLL, the class axis kept (size 1)."""
    logp = torch.log_softmax(logits.float(), axis)
    if soft_label:
        loss = -(label * logp).sum(axis, keepdim=True)
    else:
        idx = label.long()
        if idx.dim() != logits.dim():
            idx = idx.unsqueeze(-1)
        loss = -logp.gather(axis, idx.clamp_min(0))
        loss = torch.where(idx != ignore_index, loss,
                           torch.zeros_like(loss))
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax cross-entropy (one shard): the
    target logit ``cos(theta)`` becomes ``cos(m1 * theta + m2) - m3``,
    everything times ``scale``."""
    lb = label.long().reshape(-1)
    cos = logits.float().clamp(-1.0, 1.0)
    tgt = cos.gather(-1, lb[:, None])[:, 0]
    theta = torch.arccos(tgt.clamp(-1 + 1e-7, 1 - 1e-7))
    tgt_m = torch.cos(margin1 * theta + margin2) - margin3
    onehot = tf.one_hot(lb, logits.shape[-1]).to(cos.dtype)
    out = scale * (cos * (1 - onehot) + tgt_m[:, None] * onehot)
    logp = torch.log_softmax(out, -1)
    loss = _reduce(-logp.gather(-1, lb[:, None])[:, 0], reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,  # noqa: A002
                      reduction="mean"):
    lb = label.long()
    tgt = input.gather(-1, lb[:, None])
    m = _jmax(margin - tgt + input, 0.0)
    if p == 2:
        m = m * m
    if weight is not None:
        m = m * weight[lb][:, None]
    onehot = tf.one_hot(lb, input.shape[-1]).to(input.dtype)
    return _reduce((m * (1 - onehot)).sum(-1) / input.shape[-1], reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid loss over the default complete binary tree:
    the internal nodes of ``(label + num_classes) >> level``, their
    rows of ``weight [num_classes - 1, H]`` (and ``bias``); ``[B, 1]``."""
    node = label.long().reshape(-1) + num_classes
    depth = max(1, int(math.ceil(math.log2(max(num_classes, 2)))))
    codes, ids = [], []
    for _ in range(depth):
        codes.append(node % 2)
        node = node // 2
        ids.append(node - 1)
    ids = torch.stack(ids, -1)                            # [B, D]
    codes = torch.stack(codes, -1)
    ids_c = ids.clamp(0, weight.shape[0] - 1)
    z = torch.einsum("bdh,bh->bd", weight[ids_c].float(), input.float())
    if bias is not None:
        z = z + bias.reshape(-1)[ids_c]
    logp = tf.logsigmoid(torch.where(codes > 0, z, -z))
    return -torch.where(ids >= 0, logp, torch.zeros_like(logp)).sum(
        -1, keepdim=True)


def gather_tree(ids, parents):
    """Beam-search backtrace: ``ids`` / ``parents [T, B, beam]`` -> the
    full sequences re-threaded by parent, from the last step back."""
    beam_idx = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    outs = []
    for t in range(ids.shape[0] - 1, -1, -1):
        outs.append(ids[t].gather(-1, beam_idx))
        beam_idx = parents[t].long().gather(-1, beam_idx)
    return torch.stack(outs[::-1])


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's class sampling on the host: the positive classes and
    ``num_samples - positives`` others drawn without replacement from
    numpy's global RNG (the reference's draw); returns (the labels
    remapped to the sampled index, the sampled classes), int32 as the
    reference's."""
    dev = label.device
    lb = label.detach().cpu().numpy()
    pos = np.unique(lb)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    n_extra = max(0, num_samples - pos.size)
    extra = np.random.choice(rest, size=min(n_extra, rest.size),
                             replace=False) if n_extra else np.array([], int)
    sampled = np.concatenate([pos, np.sort(extra)]).astype(np.int64)
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(sampled.size)
    return (torch.from_numpy(remap[lb].astype(np.int32)).to(dev),
            torch.from_numpy(sampled.astype(np.int32)).to(dev))


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over a CSR pattern a (batch, head): the pattern becomes
    a dense boolean mask and the scores a masked softmax in f32, as the
    reference computes it. ``[B, H, S, D]`` inputs, ``offset [B, H,
    S + 1]``, ``columns [B, H, nnz]``."""
    s, d = query.shape[2], query.shape[3]
    ent = torch.arange(sparse_csr_columns.shape[-1], device=query.device)
    off = sparse_csr_offset.long()
    rows = (ent >= off[..., :-1, None]) & (ent < off[..., 1:, None])
    cols = tf.one_hot(sparse_csr_columns.long(), s).float()
    mask = torch.einsum("bhsn,bhnc->bhsc", rows.float(), cols) > 0
    scores = torch.einsum("bhsd,bhtd->bhst", query.float(),
                          key.float()) / math.sqrt(float(d))
    scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    probs = torch.softmax(scores, -1)
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    return torch.einsum("bhst,bhtd->bhsd", probs,
                        value.float()).to(query.dtype)


# -- the paddle API's entry: a Tensor anywhere among the arguments sends
#    the call through dispatch; plain torch tensors call straight through

# the functions the reference registers as ops (its flat namespace),
# with its index arguments
_AS_OPS = {"relu": (), "relu6": (), "gelu": (), "silu": (), "swish": (),
           "leaky_relu": (), "elu": (), "selu": (), "celu": (),
           "hardshrink": (), "softshrink": (), "tanhshrink": (),
           "hardsigmoid": (), "hardswish": (), "hardtanh": (), "mish": (),
           "softplus": (), "softsign": (), "softmax": (), "log_softmax": (),
           "gumbel_softmax": (), "linear": (), "embedding": (0,),
           "layer_norm": (), "rms_norm_ref": (), "normalize": (),
           "mse_loss": (), "l1_loss": (), "cross_entropy_with_softmax": (1,),
           "cross_entropy_soft": (), "binary_cross_entropy": (),
           "binary_cross_entropy_with_logits": (), "kl_div": (),
           "cosine_similarity": (), "label_smooth": (), "prelu": (),
           "rrelu": (), "thresholded_relu": (), "maxout": (), "glu": (),
           "bilinear": (), "instance_norm": (), "group_norm": (),
           "local_response_norm": (), "conv1d": (), "conv2d": (),
           "conv3d": (), "conv1d_transpose": (), "conv2d_transpose": (),
           "conv3d_transpose": (), "max_pool1d": (), "max_pool2d": (),
           "max_pool3d": (), "avg_pool1d": (), "avg_pool2d": (),
           "avg_pool3d": (), "adaptive_avg_pool1d": (),
           "adaptive_avg_pool2d": (), "adaptive_avg_pool3d": (),
           "adaptive_max_pool1d": (), "adaptive_max_pool2d": (),
           "smooth_l1_loss": (), "nll_loss": (1,),
           "cosine_embedding_loss": (), "margin_ranking_loss": (),
           "hinge_embedding_loss": (), "triplet_margin_loss": (),
           "pixel_shuffle": (), "affine_grid": (), "temporal_shift": (),
           "zeropad2d": (), "pixel_unshuffle": (), "channel_shuffle": (),
           "pairwise_distance": (), "grid_sample": (), "unfold": (),
           "fold": (), "max_unpool1d": (1,), "max_unpool2d": (1,),
           "max_unpool3d": (1,), "adaptive_max_pool3d": (),
           "square_error_cost": (), "sigmoid_focal_loss": (),
           "huber_loss": (), "soft_margin_loss": (),
           "multi_label_soft_margin_loss": (), "poisson_nll_loss": (),
           "gaussian_nll_loss": (), "log_loss": (), "dice_loss": (),
           "npair_loss": (), "triplet_margin_with_distance_loss": (),
           "feature_alpha_dropout": (), "ctc_loss": (1, 2, 3),
           "rnnt_loss": (1, 2, 3), "softmax_with_cross_entropy": (),
           "margin_cross_entropy": (), "multi_margin_loss": (),
           "hsigmoid_loss": (), "gather_tree": (0, 1),
           "class_center_sample": (0,), "sparse_attention": ()}


def _takes_tensor(name, fn, nondiff_args=()):
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        for a in args:
            if isinstance(a, Tensor):
                return dispatch(fn, *args, name=name,
                                nondiff_args=nondiff_args, **kwargs)
        if kwargs:
            for a in kwargs.values():
                if isinstance(a, Tensor):
                    return dispatch(fn, *args, name=name,
                                    nondiff_args=nondiff_args, **kwargs)
        return fn(*args, **kwargs)
    return entry


for _name in __all__:
    globals()[_name] = _takes_tensor(_name, globals()[_name],
                                     _AS_OPS.get(_name, ()))
    if _name in _AS_OPS:
        OPS[_name] = globals()[_name]

# ops the reference registers under names of their own
for _name, _fn in (("batch_norm_func", batch_norm_func),
                   ("interpolate_nearest", interpolate_nearest)):
    OPS[_name] = _takes_tensor(_name, _fn)

# the activations and array ops of the flat namespace that are part of
# F's surface, as in the reference
tanh = OPS["tanh"]
sigmoid = OPS["sigmoid"]
log_sigmoid = OPS["logsigmoid"]
pad = OPS["pad"]
one_hot = OPS["one_hot"]
diag_embed = OPS["diag_embed"]


def _inplace_variant(fn_name):
    """``F.relu_(x)`` and the like: a ``Tensor``'s in-place method, or
    the op's value for a torch tensor (the reference's rule)."""
    def f(x, *args, **kwargs):
        if isinstance(x, Tensor):
            return getattr(x, fn_name + "_")(*args, **kwargs)
        return OPS[fn_name](x, *args, **kwargs)
    f.__name__ = fn_name + "_"
    return f


relu_ = _inplace_variant("relu")
tanh_ = _inplace_variant("tanh")
softmax_ = _inplace_variant("softmax")
elu_ = _inplace_variant("elu")
