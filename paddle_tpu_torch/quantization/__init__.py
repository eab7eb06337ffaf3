"""paddle.quantization parity: observers and fake quanters
(``observers``), ``QuantConfig`` (``config``), the QAT / PTQ engines,
the quantized layers and the true-int8 inference path over K8
(``qat``). Port of ``paddle_tpu/quantization/``."""
from .observers import (fake_quant, quant_dequant, BaseQuanter,
                        BaseObserver, QuanterFactory, quanter,
                        AbsmaxObserver, AbsmaxObserverLayer, EMAObserver,
                        EMAObserverLayer, AVGObserver, AVGObserverLayer,
                        HistObserver, HistObserverLayer, KLObserver,
                        KLObserverLayer, MSEObserver, MSEObserverLayer,
                        FakeQuanterWithAbsMaxObserver,
                        FakeQuanterWithAbsMaxObserverLayer,
                        FakeQuanterChannelWiseAbsMax,
                        FakeQuanterChannelWiseAbsMaxLayer)
from .config import SingleLayerConfig, QuantConfig
from .qat import (QuantedLinear, QuantedConv2D, Quantization, QAT, PTQ,
                  Int8InferLinear, to_int8_inference)

__all__ = [
    "fake_quant", "quant_dequant", "BaseQuanter", "BaseObserver",
    "QuanterFactory", "quanter", "AbsmaxObserver", "EMAObserver",
    "AVGObserver", "HistObserver", "KLObserver", "MSEObserver",
    "FakeQuanterWithAbsMaxObserver", "FakeQuanterChannelWiseAbsMax",
    "QuantConfig", "QAT", "PTQ", "QuantedLinear", "QuantedConv2D",
    "to_int8_inference",
]
