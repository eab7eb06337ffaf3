"""Optimizers of the port: ``Optimizer``, ``Adam`` and ``AdamW`` with
the JAX package's update rule (``optimizer.optimizer``)."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW"]
