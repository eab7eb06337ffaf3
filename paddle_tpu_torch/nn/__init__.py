"""Neural-network layers and operators of the port (paddle.nn): port of
``paddle_tpu/nn``.

- ``Layer`` (a ``torch.nn.Module``), ``Sequential``, ``LayerList``,
  ``ParameterList``, ``LayerDict`` (``layer``);
- the core layers of ``layers_basic`` (Linear, Embedding, the
  convolutions, norms, dropouts, activations, pools and losses), the
  recurrent layers of ``rnn`` and the Transformer stack of
  ``transformer``;
- the tail of ``layers_tail`` (CTC, RNN-T, HSigmoid, fold / unfold,
  unpooling, the margin losses, ``BeamSearchDecoder``,
  ``dynamic_decode``);
- ``functional``, ``initializer`` (with ``ParamAttr`` of ``param_attr``),
  ``utils`` (weight and spectral norm, the parameter vectors), the
  gradient clips of ``clip``, and ``set_state_dict`` for any torch
  module;
- ``quant``: the quantized layers (``QuantedConv2D``, ``QuantedLinear``,
  ``Stub``) the ``quantization`` package swaps in.
"""
from . import functional, initializer, utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_by_global_norm_tree)
from .layer import (HookRemoveHelper, Layer, LayerDict,  # noqa: F401
                    LayerList, ParameterList, Sequential, set_state_dict)
from .layers_basic import *  # noqa: F401,F403
from .layers_basic import __all__ as _basic_all
from .param_attr import ParamAttr  # noqa: F401
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn_all
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer_all
from .layers_tail import *  # noqa: F401,F403
from .layers_tail import __all__ as _tail_all

__all__ = (
    ["Layer", "LayerList", "Sequential", "ParameterList", "LayerDict",
     "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
     "functional", "initializer", "utils", "set_state_dict",
     "clip_by_global_norm_tree", "ParamAttr", "HookRemoveHelper"]
    + list(_basic_all) + list(_rnn_all) + list(_transformer_all)
    + list(_tail_all)
)
