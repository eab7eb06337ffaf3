"""paddle.incubate.nn parity: ``functional`` (the fused ops; K7 and K6
behind four of them) and the fused transformer layers, which are not
ported yet and raise on construction."""
from . import functional
from .fused_transformer import (FusedBiasDropoutResidualLayerNorm,
                                FusedEcMoe, FusedFeedForward, FusedLinear,
                                FusedMultiHeadAttention,
                                FusedMultiTransformer,
                                FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe",
           "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]
