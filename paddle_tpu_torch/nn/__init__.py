"""Neural-network operators and layers of the port: ``nn.functional``,
the subset of the JAX package's functional API that the Llama train step
and the loss layers call, ``nn.Linear``, ``nn.Embedding``,
``nn.LayerNorm``, the loss layers
``CrossEntropyLoss``, ``MSELoss`` and ``BCEWithLogitsLoss``,
``set_state_dict``, and the gradient clips ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm``."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_by_global_norm_tree)
from .layer import (BCEWithLogitsLoss, CrossEntropyLoss, Embedding,
                    LayerNorm, Linear, MSELoss, set_state_dict)

__all__ = ["functional", "Linear", "Embedding", "LayerNorm",
           "CrossEntropyLoss", "MSELoss",
           "BCEWithLogitsLoss", "set_state_dict", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_by_global_norm_tree"]
