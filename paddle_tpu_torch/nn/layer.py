"""Layers of the port: ``Linear``, the loss layers ``CrossEntropyLoss``,
``MSELoss`` and ``BCEWithLogitsLoss``, and ``set_state_dict``.

Port of ``paddle_tpu/nn/layers_basic.py:44-63`` and ``:710-790``:
paddle's Linear keeps its weight as ``[in_features, out_features]`` and
computes ``x @ W + b``. The arguments are the reference's, in its order:
``weight_attr``, ``bias_attr`` (``False`` leaves the layer without a
bias, as in paddle) and ``name``; ``dtype`` and ``device`` follow as
keywords. The loss layers hold their options and call
``nn.functional``.
"""
import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from . import functional as F

__all__ = ["Linear", "CrossEntropyLoss", "MSELoss", "BCEWithLogitsLoss",
           "set_state_dict"]


@torch.no_grad()
def set_state_dict(module, state_dict, use_structured_name=True):
    """paddle's ``Layer.set_state_dict`` (``nn/layer.py:295-308``) on a
    torch module: every entry of ``state_dict`` (a tensor or an array,
    under the names of ``module.state_dict()``: parameters and
    persistent buffers) is copied into the module's own tensor, cast to
    its dtype and device. Returns ``(missing, unexpected)`` names, as
    the reference does; a shape that differs raises ValueError before
    anything is copied."""
    own = module.state_dict(keep_vars=True)
    missing = [k for k in own if k not in state_dict]
    unexpected = [k for k in state_dict if k not in own]
    vals = {}
    for k, v in state_dict.items():
        if k not in own:
            continue
        t = v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v))
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} does not match "
                             f"the layer's {tuple(own[k].shape)}")
        vals[k] = t
    for k, t in vals.items():
        own[k].copy_(t.to(device=own[k].device, dtype=own[k].dtype))
    return missing, unexpected


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

    set_state_dict = set_state_dict

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` with its options held (``layers_basic.py:
    710-728``); ``use_softmax`` and ``name`` are accepted and not used,
    as in the reference."""

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


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)
