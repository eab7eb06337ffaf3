"""paddle.metric parity (Accuracy/Precision/Recall/Auc).

Port of ``paddle_tpu/metric/__init__.py``: metrics accumulate on the
host in numpy; torch tensors (on any device, bf16 widened to f32) are
read as numpy arrays. ``publish`` puts a metric into a telemetry gauge.
"""
import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "publish"]


def publish(metric, registry, name=None):
    """Publish a ``Metric``'s ``accumulate()`` into a telemetry gauge
    (``eval_<metric base name>`` by default) so eval-loop quality
    metrics ride the same ``/metrics`` exposition as the
    serving/training signals. Multi-valued metrics (e.g. top-k
    Accuracy) keep one gauge per metric and label each component.
    Returns the value(s) published."""
    vals = metric.accumulate()
    names = metric.name()
    base = name or f"eval_{getattr(metric, '_name', None) or 'metric'}"
    if isinstance(vals, (list, tuple)):
        g = registry.gauge(base, "Eval metric value",
                           labelnames=("component",))
        for n, v in zip(names, vals):
            g.labels(component=n).set(float(v))
    else:
        registry.gauge(base, "Eval metric value").set(float(vals))
    return vals


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l[..., 0]
        idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        correct = idx == l[..., None]
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        n = int(np.prod(correct.shape[:-1]))
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(-1).sum()
            self.total[i] += float(c)
            self.count[i] += n
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = _np(labels).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(np.int64), 0,
                       self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._pos[b] += 1
            else:
                self._neg[b] += 1

    def accumulate(self):
        tot_pos = self._pos.sum()
        tot_neg = self._neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over thresholds descending
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))


def accuracy(input, label, k=1):  # noqa: A002
    p = _np(input)
    l = _np(label)
    if l.ndim == p.ndim and l.shape[-1] == 1:
        l = l[..., 0]
    idx = np.argsort(-p, axis=-1)[..., :k]
    correct = (idx == l[..., None]).any(-1).mean()
    return torch.tensor(correct, dtype=torch.float32)
