"""paddle.incubate.nn parity: ``functional`` (the fused ops) and the
fused transformer layers."""
from . import functional
from .fused_transformer import (FusedBiasDropoutResidualLayerNorm,
                                FusedEcMoe, FusedFeedForward, FusedLinear,
                                FusedMultiHeadAttention,
                                FusedMultiTransformer,
                                FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe",
           "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]
