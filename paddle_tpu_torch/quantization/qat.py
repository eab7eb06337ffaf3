"""True-int8 inference layers: ``Int8InferLinear`` and
``to_int8_inference``.

Port of ``paddle_tpu/quantization/qat.py:138-200``. ``to_int8_inference``
swaps every ``nn.Linear`` of a model for an ``Int8InferLinear``, whose
weight is quantized once to int8 per output channel and whose forward
quantizes its input per tensor and runs the int8 matmul with the fused
dequantize (K8, ``ops.kernels.quant_matmul``). The codes are kept once,
K-major (``[out, in]``), the layout K8's ``wgmma`` route reads; the
reference's ``[in, out]`` layout is a view, and it is the layout of
the state dict: ``state_dict()`` writes ``qweight [in, out]`` (keys and
shapes the reference's) and ``load_state_dict`` reads it back into the
K-major buffer. Deploy only: the forward builds no graph, as the
reference cuts the tangent.

The QAT/PTQ engines, ``QuantedLinear``, ``QuantConfig`` and the
observers run no kernel and are not ported yet (ROADMAP, Queue 1 item
15); a model holding a ``QuantedLinear`` has nothing of it here to
convert.
"""
import copy

import torch
from torch import nn

from ..nn.layers_basic import Linear
from ..ops.kernels.quant_matmul import (quantize_tensor,
                                        quantized_matmul_kmajor)

__all__ = ["Int8InferLinear", "to_int8_inference"]


def _set_sublayer(root, dotted, new):
    """Replace the submodule at ``dotted`` (``ModuleList`` indices
    included: ``setattr(module_list, "3", m)`` replaces entry 3)."""
    parts = dotted.split(".")
    obj = root
    for p in parts[:-1]:
        obj = getattr(obj, p)
    setattr(obj, parts[-1], new)


class Int8InferLinear(nn.Module):
    """Int8 deploy Linear: the codes and ``w_scale`` ``[out]`` (in the
    weight's dtype) from ``quantize_tensor(weight, per_channel_axis=1)``
    at construction, the codes kept once as ``qweight_t`` int8 ``[out,
    in]`` (K-major); ``qweight`` is the reference's ``[in, out]`` view of
    them. ``forward`` quantizes x per tensor, runs K8 with x's dtype out
    (one rounding of the f32 dequantized value, as the reference's f32
    result cast to x's dtype) and adds the layer's bias, if any."""

    def __init__(self, layer):
        super().__init__()
        with torch.no_grad():
            qw, sw = quantize_tensor(layer.weight.detach(),
                                     per_channel_axis=1)
            qw = qw.t().contiguous()       # the [in, out] codes are freed
        self.register_buffer("qweight_t", qw)
        self.register_buffer("w_scale", sw)
        self.bias = getattr(layer, "bias", None)

    @property
    def qweight(self):
        """The int8 codes in the reference's ``[in, out]`` layout (a
        view of ``qweight_t``)."""
        return self.qweight_t.t()

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        """The state dict in the reference's layout: ``qweight [in,
        out]`` (a view of the codes) in place of ``qweight_t``."""
        super()._save_to_state_dict(destination, prefix, keep_vars)
        codes = destination.pop(prefix + "qweight_t")
        destination[prefix + "qweight"] = codes.t()

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        """Read the reference's ``qweight [in, out]`` into the K-major
        ``qweight_t``."""
        codes = state_dict.pop(prefix + "qweight", None)
        if codes is not None:
            state_dict[prefix + "qweight_t"] = torch.as_tensor(codes).t()
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys,
                                      unexpected_keys, error_msgs)

    def forward(self, x):
        with torch.no_grad():
            x = x.detach()
            shape = x.shape
            qx, sx = quantize_tensor(x.reshape(-1, shape[-1]))
            # K8 writes f32 or bf16; any other type is cast from f32
            kind = x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
                else torch.float32
            if torch.compiler.is_exporting():    # custom_ops' K8 face
                out = torch.ops.paddle_tpu_torch.quantized_matmul(
                    qx, self.qweight_t, sx, self.w_scale, kind)
            else:
                out = quantized_matmul_kmajor(qx, self.qweight_t, sx,
                                              self.w_scale, out_dtype=kind)
            out = out.reshape(*shape[:-1], out.shape[-1]).to(x.dtype)
        if self.bias is not None:
            out = out + self.bias
        return out


def to_int8_inference(model, inplace=False):
    """Replace every ``Linear`` of ``model`` (the root excepted) with an
    ``Int8InferLinear``; ``inplace=False`` converts a deep copy and
    leaves ``model`` untouched. Layers are looked up by name one at a
    time, so in place each float weight is freed as its layer is
    replaced."""
    if not inplace:
        model = copy.deepcopy(model)
    names = [name for name, sub in list(model.named_modules())[1:]
             if isinstance(sub, Linear)]
    for name in names:
        _set_sublayer(model, name,
                      Int8InferLinear(model.get_submodule(name)))
    return model
