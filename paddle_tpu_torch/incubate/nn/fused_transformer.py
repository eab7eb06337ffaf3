"""paddle.incubate.nn's fused transformer layers: not ported yet.

The reference's layers (``paddle_tpu/incubate/nn/fused_transformer.py``)
compose the fused functional ops that run no kernel. Each name is here so
that a caller finds it, and constructing one raises
``NotImplementedError`` (ROADMAP, Queue 1 item 15).
"""
__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedLinear", "FusedBiasDropoutResidualLayerNorm", "FusedEcMoe"]


class _NotPorted:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"incubate.nn.{type(self).__name__} is not ported (ROADMAP, "
            f"Queue 1 item 15: the rest of the API surface)")


FusedMultiHeadAttention = type("FusedMultiHeadAttention", (_NotPorted,), {})
FusedFeedForward = type("FusedFeedForward", (_NotPorted,), {})
FusedTransformerEncoderLayer = type("FusedTransformerEncoderLayer",
                                    (_NotPorted,), {})
FusedMultiTransformer = type("FusedMultiTransformer", (_NotPorted,), {})
FusedLinear = type("FusedLinear", (_NotPorted,), {})
FusedBiasDropoutResidualLayerNorm = type("FusedBiasDropoutResidualLayerNorm",
                                         (_NotPorted,), {})
FusedEcMoe = type("FusedEcMoe", (_NotPorted,), {})
