"""Gradient clipping (``paddle.nn.ClipGradBy*``).

Port of ``paddle_tpu/nn/clip.py``. ``clip_values`` takes and returns
plain gradient tensors; an optimizer applies it to the live gradients
inside its step. Each clipped gradient is computed in f32 and rounded
back to the gradient's dtype, ``(g.float() * scale).to(g.dtype)``, as
the reference does (``clip.py:43`` and ``:63``): a bf16 gradient is
rounded to bf16 after clipping, and Adam widens it again.

The norms are f32 sums of squares, one per tensor, added in the order
of the tensors as the reference's Python ``sum`` adds them; each
tensor's own sum runs in torch's order, not XLA's, so a norm agrees with
the reference's to a few f32 ulps, not bit for bit. Scales are divided
tensor by tensor: on the card torch divides by a Python number as a
multiply by its reciprocal (ROADMAP, Queue 3); square roots are
correctly rounded (``multi_tensor_adam.sqrt_rn``) on every device.
"""
import torch
from torch.utils import _pytree

from ..ops.kernels.multi_tensor_adam import sqrt_rn

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_by_global_norm_tree"]


def _sq_sum(grads):
    """sum over ``grads`` of sum(g.float() ** 2), tensor by tensor in
    order, as an f32 scalar tensor."""
    sq = None
    for g in grads:
        s = g.float().square().sum()
        sq = s if sq is None else sq + s
    return sq


def _global_scale(sq, clip_norm):
    """(clip_norm / max(sqrt(sq), clip_norm), sqrt(sq)) in f32."""
    gn = sqrt_rn(sq)
    scale = torch.full_like(gn, clip_norm) / gn.clamp_min(clip_norm)
    return scale, gn


class ClipGradBase:
    def clip_values(self, grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads]
        clipped = self.clip_values(grads)
        return [(p, g) for (p, _), g in zip(params_grads, clipped)]


class ClipGradByValue(ClipGradBase):
    """Each element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def clip_values(self, grads):
        # the bounds take a low-precision gradient's type first, as the
        # reference's weakly typed bounds do
        return [g.clamp(float(torch.tensor(self.min, dtype=g.dtype)),
                        float(torch.tensor(self.max, dtype=g.dtype)))
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each tensor scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def clip_values(self, grads):
        out = []
        for g in grads:
            n = sqrt_rn(g.float().square().sum())
            scale = (torch.full_like(n, self.clip_norm)
                     / n.clamp_min(1e-12)).clamp_max(1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every tensor scaled by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all of them. On the card, Adam and AdamW
    fuse this clip into their multi-tensor step
    (``ops.kernels.multi_tensor_adam``)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def global_norm(self, grads):
        return sqrt_rn(_sq_sum(grads))

    def clip_values(self, grads, extra_sq_norm=None):
        sq = _sq_sum(grads)
        if extra_sq_norm is not None:
            sq = sq + extra_sq_norm
        scale, _ = _global_scale(sq, self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]


def clip_by_global_norm_tree(grads_tree, clip_norm, extra_sq_norm=None):
    """The global-norm clip over a pytree of gradients (dicts, lists,
    tuples of tensors). Returns ``(clipped tree, global norm)``."""
    leaves, spec = _pytree.tree_flatten(grads_tree)
    sq = _sq_sum(leaves)
    if extra_sq_norm is not None:
        sq = sq + extra_sq_norm
    scale, gn = _global_scale(sq, clip_norm)
    clipped = [(g.float() * scale).to(g.dtype) for g in leaves]
    return _pytree.tree_unflatten(clipped, spec), gn
