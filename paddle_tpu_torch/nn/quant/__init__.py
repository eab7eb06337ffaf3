"""paddle.nn.quant parity: ``Stub`` and the quantized layers.

Port of ``paddle_tpu/nn/quant/__init__.py``."""
from ...quantization import QuantedConv2D, QuantedLinear  # noqa: F401
from ..layer import Layer

__all__ = ["Stub"]


class Stub(Layer):
    """A placeholder layer marking where an activation quanter attaches;
    being a layer, ``quantize``'s walk and a ``QuantConfig`` see it. Its
    forward is the identity."""

    def __init__(self, observer=None):
        super().__init__()
        self._observer = observer

    def forward(self, x):
        return x
