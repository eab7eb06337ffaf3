"""Layers of the port: ``Linear``.

Port of ``paddle_tpu/nn/layers_basic.py:44-63``: paddle's Linear keeps
its weight as ``[in_features, out_features]`` and computes ``x @ W +
b``. The arguments are the reference's, in its order: ``weight_attr``,
``bias_attr`` (``False`` leaves the layer without a bias, as in paddle)
and ``name``; ``dtype`` and ``device`` follow as keywords.
"""
import torch
from torch import nn

from ..device import resolve_device
from . import functional as F

__all__ = ["Linear"]


class Linear(nn.Module):
    """paddle.nn.Linear: ``weight`` ``[in_features, out_features]``,
    ``bias`` ``[out_features]`` (zeros) unless ``bias_attr=False``.

    ``weight_attr`` and ``bias_attr`` take no parameter attribute or
    initializer yet, the port having none: ``None`` (the defaults) or
    ``False`` (no bias; a weight all the same, as the reference's
    ``create_parameter`` makes one); anything else raises
    ``NotImplementedError`` (ROADMAP Queue 1 item 15). ``name`` is
    accepted and unused: the port names parameters by their module path.
    ``device=None`` means the CUDA card (raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions).
    ``reset_parameters`` draws the weight Xavier-normal, the reference's
    default initializer; a model that draws its own weights overrides
    it."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        for what, attr in (("weight_attr", weight_attr),
                           ("bias_attr", bias_attr)):
            if attr is not None and attr is not False:
                raise NotImplementedError(
                    f"Linear({what}={attr!r}): parameter attributes and "
                    f"initializers are not ported yet (ROADMAP Queue 1 "
                    f"item 15)")
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            (in_features, out_features), dtype=dtype, device=device))
        self.bias = None if bias_attr is False else nn.Parameter(
            torch.zeros((out_features,), dtype=dtype, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        nn.init.xavier_normal_(self.weight)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")
