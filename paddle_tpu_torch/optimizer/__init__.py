"""Optimizers of the port with the JAX package's update rules
(``optimizer.optimizer``): ``Optimizer``, ``SGD``, ``Momentum``,
``Adam``, ``AdamW`` (one multi-tensor kernel a step on the card),
``Adamax``, ``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb`` and
``LarsMomentum``; and the learning-rate schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        LarsMomentum, Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum", "lr"]
