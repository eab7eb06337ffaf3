"""QAT and PTQ, the quantized layers and the true-int8 inference path.

Port of ``paddle_tpu/quantization/qat.py``:

- ``QuantedLinear`` / ``QuantedConv2D``: the layer's own weight (and
  bias) through its weight quanter and its input through its activation
  quanter, then ``F.linear`` / ``F.conv2d``; a bf16 layer under an f32
  activation scale computes in f32, as the reference's promotion does;
- ``Quantization`` (``QAT``, ``PTQ``): ``quantize`` swaps every sublayer
  whose type the config's QAT mapping names (``Linear``, ``Conv2D``; the
  port's models build their projections from private subclasses of
  ``nn.Linear`` that stand for the reference's plain ``nn.Linear``, and
  say so in ``_reference_type``) and that a config covers, in a deep copy
  unless ``inplace``; ``convert`` puts the model in eval mode and freezes
  its observers;
- ``Int8InferLinear`` / ``to_int8_inference``: every ``Linear`` or
  ``QuantedLinear`` of a model becomes an int8 layer whose weight is
  quantized once to int8 per output channel and whose forward quantizes
  its input per tensor and runs the int8 matmul with the fused
  dequantize (K8, ``ops.kernels.quant_matmul``). The codes are kept
  once, K-major (``[out, in]``), the layout K8's ``wgmma`` route reads;
  the reference's ``[in, out]`` layout is a view, and it is the layout of
  the state dict: ``state_dict()`` writes ``qweight [in, out]`` (keys and
  shapes the reference's) and ``load_state_dict`` reads it back into the
  K-major buffer. Deploy only: the forward builds no graph, as the
  reference cuts the tangent.

The sublayers are walked as ``named_modules()`` less the root, which is
the reference's ``named_sublayers()`` on a ``Layer`` and works on any
``torch.nn.Module`` (``LlamaForCausalLM`` is one).
"""
import copy

import torch
from torch import nn

from ..nn import functional as F
from ..nn.layer import Layer
from ..nn.layers_basic import Conv2D, Linear
from ..ops.kernels.quant_matmul import (quantize_tensor,
                                        quantized_matmul_kmajor)
from .config import QuantConfig, SingleLayerConfig
from .observers import BaseObserver

__all__ = ["QuantedLinear", "QuantedConv2D", "Quantization", "QAT", "PTQ",
           "Int8InferLinear", "to_int8_inference"]


class _Quanted(Layer):
    """The layer's weight and bias, shared, and a quanter of each kind
    the config gives (None otherwise)."""

    def __init__(self, layer, q_config: SingleLayerConfig):
        super().__init__()
        self.weight = layer.weight
        self.bias = layer.bias
        self.activation_quanter = (
            q_config.activation._instance(layer)
            if q_config.activation else None)
        self.weight_quanter = (
            q_config.weight._instance(layer) if q_config.weight else None)

    def _quantized(self, x):
        w = self.weight
        if self.weight_quanter is not None:
            w = self.weight_quanter(w)
        if self.activation_quanter is not None:
            x = self.activation_quanter(x)
        return x, w


class QuantedLinear(_Quanted):
    """Linear with weight and activation fake quant."""

    def forward(self, x):
        x, w = self._quantized(x)
        return F.linear(x, w, self.bias)


class QuantedConv2D(_Quanted):
    """Conv2D with weight and activation fake quant. The convolution's
    settings are copied as plain attributes: keeping the Conv2D as a
    sublayer would let a second ``quantize`` wrap it again."""

    def __init__(self, layer, q_config: SingleLayerConfig):
        super().__init__(layer, q_config)
        self._stride = layer.stride
        self._padding = layer.padding
        self._dilation = layer.dilation
        self._groups = layer.groups
        self._data_format = layer.data_format

    def forward(self, x):
        x, w = self._quantized(x)
        return F.conv2d(x, w, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


_DEFAULT_QAT_MAPPING = {Linear: QuantedLinear, Conv2D: QuantedConv2D}


def _reference_type(layer):
    """The type the reference's mapping would look ``layer`` up by."""
    return getattr(type(layer), "_reference_type", type(layer))


def _sublayers(model):
    """``(name, module)`` of every module under ``model``, the root
    excepted, in ``named_modules`` order."""
    return list(model.named_modules())[1:]


class Quantization:
    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model, inplace=False):
        """Every sublayer the mapping and the config both cover, swapped
        for its quantized layer (``QuantedLinear`` ...), in a deep copy
        unless ``inplace``: the float original stays intact."""
        if not inplace:
            model = copy.deepcopy(model)
        for name, sub in _sublayers(model):
            cfg = self._config._config_for(sub, name)
            target = self._config._qat_mapping.get(_reference_type(sub))
            if cfg is not None and target is not None:
                _set_sublayer(model, name, target(sub, cfg))
        return model

    def convert(self, model, inplace=False):
        """The model in eval mode (quanters use their stored scales) with
        every observer frozen; ``inplace=False`` returns a frozen copy and
        leaves the QAT or calibration model live."""
        if not inplace:
            model = copy.deepcopy(model)
        model.eval()
        for sub in model.modules():
            if isinstance(sub, BaseObserver):
                sub._frozen = True
        return model


class QAT(Quantization):
    """Quantization-aware training: ``quantize`` swaps layers for their
    fake-quantized forms, trained through the straight-through
    gradient."""


class PTQ(Quantization):
    """Post-training quantization: ``quantize`` with observers, run
    calibration batches, then ``convert``."""


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
    """Replace every ``Linear`` and ``QuantedLinear`` of ``model`` (the
    root excepted) with an ``Int8InferLinear`` of its float weight;
    ``inplace=False`` converts a deep copy and leaves ``model``
    untouched. Layers are looked up by name one at a
    time, so in place each float weight is freed as its layer is
    replaced."""
    if not inplace:
        model = copy.deepcopy(model)
    names = [name for name, sub in _sublayers(model)
             if isinstance(sub, (Linear, QuantedLinear))]
    for name in names:
        _set_sublayer(model, name,
                      Int8InferLinear(model.get_submodule(name)))
    return model
