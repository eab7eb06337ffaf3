"""The functional operators the Llama train step calls.

Port of the matching subset of ``paddle_tpu/nn/functional.py``: RMSNorm
and attention ride the hand-written kernels (K5 and K4, through their
autograd Functions), the rest is plain torch, as the JAX package leaves
it to XLA. Options of the JAX functions that this slice does not port
raise ``NotImplementedError`` naming the ROADMAP item.
"""
import torch
import torch.nn.functional as tf

from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import rms_norm as _rn

__all__ = ["rms_norm", "scaled_dot_product_attention", "flash_attention",
           "linear", "embedding", "silu", "cross_entropy"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last dim (K5 forward and backward)."""
    return _rn.rms_norm(x, weight, epsilon)


def flash_attention(query, key, value, causal=False, sm_scale=None):
    """Flash attention on ``[batch, seq, heads, head_dim]`` (K4)."""
    return _fa.flash_attention(query, key, value, causal=causal,
                               sm_scale=sm_scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """paddle.nn.functional.scaled_dot_product_attention on ``[batch,
    seq, heads, head_dim]``, through the flash-attention kernels (K4).
    Causal masking is top-left aligned (query row i sees keys 0..i)."""
    if attn_mask is not None or dropout_p != 0.0:
        raise NotImplementedError(
            "scaled_dot_product_attention with attn_mask or dropout is not "
            "ported (ROADMAP, Queue 1 item 3: the rest of the training "
            "stack); the flash-attention kernels take neither")
    return _fa.flash_attention(query, key, value, causal=is_causal)


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)``, weight ``[in, out]`` (paddle
    convention)."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Rows of ``weight`` at the ids ``x``."""
    return weight[x.long()]


def silu(x):
    return tf.silu(x)


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Mean softmax cross-entropy with hard labels ``[...]`` over the
    last axis of ``input`` ``[..., classes]``, in f32
    (``functional.py:744-797``): labels equal to ``ignore_index`` count
    neither in the sum nor in the mean's denominator."""
    if (weight is not None or reduction != "mean" or soft_label
            or not use_softmax or label_smoothing
            or axis not in (-1, input.dim() - 1)):
        raise NotImplementedError(
            "cross_entropy is ported for the mean over hard labels on the "
            "last axis with softmax only (no weight, soft_label or "
            "label_smoothing): ROADMAP, Queue 1 item 3, the rest of the "
            "training stack")
    logp = torch.log_softmax(input.float(), dim=-1)
    label = label.long()
    keep = label != ignore_index
    nll = -logp.gather(-1, label.where(keep, 0)[..., None])[..., 0]
    return (nll * keep.to(nll.dtype)).sum() \
        / keep.sum().to(nll.dtype).clamp_min(1.0)
