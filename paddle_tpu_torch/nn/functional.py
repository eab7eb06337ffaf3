"""The functional operators the Llama train step calls.

Port of the matching subset of ``paddle_tpu/nn/functional.py``: RMSNorm
and attention ride the hand-written kernels (K5 and K4, through their
autograd Functions), the rest is plain torch, as the JAX package leaves
it to XLA. The dropout family and ``gumbel_softmax`` draw their keys
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
           "hardsigmoid", "hardswish", "hardtanh", "rms_norm_ref"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim (K5 forward and backward)."""
    x, weight = _cast("rms_norm", [x, weight])
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


def embedding(x, weight):
    """Rows of ``weight`` at the ids ``x``."""
    return weight[x.long()]


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
           "cosine_similarity": (), "label_smooth": ()}


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
