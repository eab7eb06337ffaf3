"""paddle.regularizer parity: ``L1Decay`` / ``L2Decay``.

Port of ``paddle_tpu/regularizer.py``: each is a callable ``(param,
grad) -> grad`` plus its decay term (``coeff * sign(param)``, ``coeff *
param``)."""
import torch

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * param

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"
