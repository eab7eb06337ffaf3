"""MoE-aware global-norm clip.

Port of ``paddle_tpu/parallel/moe/grad_clip.py`` (reference:
python/paddle/incubate/distributed/models/moe/grad_clip.py:23
ClipGradForMOEByGlobalNorm): with the parameters given, the expert
gradients' squared norm is taken apart from the others' and added to it
(the reference sums it over the expert-parallel group first: on one card
there is nothing to sum). Without them it is the plain global-norm clip,
which is what the optimizers apply: the reference's fused step calls
``clip_values(grads)``, and the port's Adam and AdamW fuse it into their
multi-tensor step as a ``ClipGradByGlobalNorm``.
"""
from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm, _global_scale

__all__ = ["ClipGradForMOEByGlobalNorm"]


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        super().__init__(clip_norm, group_name)
        self.is_expert_fn = is_expert_param_func or (
            lambda p: getattr(p, "is_expert", False))
        self.moe_group = moe_group

    def clip_values(self, grads, params=None):
        if params is None:
            return super().clip_values(grads)
        sq_norm = torch.zeros((), dtype=torch.float32,
                              device=grads[0].device)
        sq_exp = torch.zeros_like(sq_norm)
        for g, p in zip(grads, params):
            s = g.float().square().sum()
            if self.is_expert_fn(p):
                sq_exp = sq_exp + s
            else:
                sq_norm = sq_norm + s
        scale, _ = _global_scale(sq_norm + sq_exp, self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]
