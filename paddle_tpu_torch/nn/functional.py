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
"""
import math

import torch
import torch.nn.functional as tf

from ..amp import cast_inputs_for_op as _cast
from ..core.random import next_key as _next_key
from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import rms_norm as _rn
from ..ops.kernels import threefry_fill as _tf

__all__ = ["rms_norm", "scaled_dot_product_attention", "flash_attention",
           "linear", "embedding", "silu", "softmax", "cross_entropy",
           "mse_loss", "binary_cross_entropy_with_logits", "dropout",
           "dropout2d", "dropout3d", "alpha_dropout", "gumbel_softmax"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim (K5 forward and backward)."""
    x, weight = _cast("rms_norm", [x, weight])
    return _rn.rms_norm(x, weight, epsilon)


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
    convention)."""
    x, weight, bias = _cast("linear", [x, weight, bias])
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Rows of ``weight`` at the ids ``x``."""
    return weight[x.long()]


def silu(x):
    return tf.silu(x)


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
