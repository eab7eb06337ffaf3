"""The port's ``metric`` against the JAX package's, on the same seeded
numpy inputs (and the same inputs as torch tensors, bf16 among them):
``Accuracy`` (top-1 and top-k, its ``compute`` / ``update`` /
``accumulate`` / ``name``), ``Precision``, ``Recall``, ``Auc`` and
``accuracy`` agree exactly; ``publish`` names its ROADMAP item."""
import numpy as np
import pytest
import torch

import paddle_tpu.metric as jm
from paddle_tpu_torch import metric as tm


def _inputs(seed=0, n=40, k=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, k)).astype(np.float32)
    labels = rng.integers(0, k, (n, 1))
    probs = rng.random(n).astype(np.float32)
    binary = (rng.random(n) > 0.4).astype(np.int64)
    return logits, labels, probs, binary


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_accuracy_equals_reference(topk, as_tensor):
    logits, labels, _, _ = _inputs()
    j, t = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    conv = torch.tensor if as_tensor else (lambda a: a)
    for lo in range(0, 40, 10):
        x, y = logits[lo:lo + 10], labels[lo:lo + 10]
        got = t.update(t.compute(conv(x), conv(y)))
        want = j.update(j.compute(x, y))
        assert got == want
    assert t.accumulate() == j.accumulate()
    assert t.name() == j.name()
    t.reset()
    assert t.accumulate() == (0.0 if len(t.topk) == 1 else [0.0, 0.0])


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_equal_reference(cls):
    _, _, probs, binary = _inputs(1)
    j, t = getattr(jm, cls)(), getattr(tm, cls)()
    # the port reads bf16 tensors; the reference gets the same values
    rounded = torch.tensor(probs).bfloat16()
    for lo in range(0, 40, 8):
        j.update(rounded[lo:lo + 8].float().numpy(), binary[lo:lo + 8])
        t.update(rounded[lo:lo + 8], torch.tensor(binary[lo:lo + 8]))
    assert t.accumulate() == j.accumulate()
    assert t.name() == j.name()


def test_auc_two_column_probabilities():
    _, _, probs, binary = _inputs(2)
    two = np.stack([1 - probs, probs], 1)
    j, t = jm.Auc(), tm.Auc()
    j.update(two, binary)
    t.update(torch.tensor(two), binary)
    assert t.accumulate() == j.accumulate() and 0.0 <= t.accumulate() <= 1


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy(k):
    logits, labels, _, _ = _inputs(3)
    got = tm.accuracy(torch.tensor(logits), torch.tensor(labels), k=k)
    want = jm.accuracy(logits, labels, k=k)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.item() == float(np.asarray(want.numpy()))


def test_publish_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 8"):
        tm.publish(tm.Accuracy(), registry=object())
