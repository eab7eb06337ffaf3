"""Quantization of the port: the true-int8 inference path
(``Int8InferLinear``, ``to_int8_inference``) over K8. The QAT/PTQ engines
and the observers come later (ROADMAP, Queue 1 item 15)."""
from .qat import Int8InferLinear, to_int8_inference

__all__ = ["Int8InferLinear", "to_int8_inference"]
