"""Neural-network operators and layers of the port: ``nn.functional``,
the subset of the JAX package's functional API that the Llama train step
calls, ``nn.Linear``, and the gradient clips ``ClipGradByValue``,
``ClipGradByNorm`` and ``ClipGradByGlobalNorm``."""
from . import functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_by_global_norm_tree)
from .layer import Linear

__all__ = ["functional", "Linear", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_by_global_norm_tree"]
