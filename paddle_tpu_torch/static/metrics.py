"""The static metric ops (``paddle_tpu/static/metrics.py``): accuracy,
AUC, the CTR bundle, and the fluid-era learning-rate decay helper."""
import numpy as np
import torch

from ..core.tensor import Tensor, dispatch, to_tensor

__all__ = ["accuracy", "auc", "ctr_metric_bundle", "exponential_decay"]


def accuracy(input, label, k=1, correct=None, total=None):  # noqa: A002
    """Top-``k`` accuracy over a batch (f32 scalar); recorded as an op
    on Variables."""
    def accuracy(logits, lb):
        topk = torch.argsort(-logits, dim=-1, stable=True)[..., :k]
        hit = (topk == lb.reshape(-1, 1)).any(-1)
        return hit.float().mean()

    return dispatch(accuracy, input, label, nondiff_args=(1,),
                    name="accuracy")


def _host(x):
    return np.asarray(x.numpy() if isinstance(x, Tensor) else x)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,  # noqa: A002
        slide_steps=1, ins_tag_weight=None):
    """``(auc, batch_auc, [])``: the AUC by the rank statistic, both one
    f32 tensor."""
    probs = _host(input)
    lb = _host(label).reshape(-1)
    pos_scores = probs[:, 1] if probs.ndim == 2 and probs.shape[1] > 1 \
        else probs.reshape(-1)
    order = np.argsort(pos_scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    n_pos = (lb == 1).sum()
    n_neg = (lb == 0).sum()
    if n_pos == 0 or n_neg == 0:
        value = 0.0
    else:
        value = (ranks[lb == 1].sum() - n_pos * (n_pos + 1) / 2) \
            / (n_pos * n_neg)
    place = input._value.device if isinstance(input, Tensor) else None
    v = to_tensor(np.float32(value), place=place)
    return v, v, []


def ctr_metric_bundle(input, label, ins_tag_weight=None):  # noqa: A002
    return auc(input, label)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """The legacy schedule as an ``optimizer.lr.ExponentialDecay``."""
    from ..optimizer.lr import ExponentialDecay
    return ExponentialDecay(learning_rate=learning_rate, gamma=decay_rate)
