"""paddle.incubate parity: ``incubate.nn`` (the fused ops and layers),
``incubate.autograd``, ``LookAhead`` / ``ModelAverage``
(``incubate.optimizer``), the auto-checkpoint (``incubate.checkpoint``),
``softmax_mask_fuse*`` and ``identity_loss``. Port of
``paddle_tpu/incubate/__init__.py``.

The graph aliases (``segment_*``, ``graph_send_recv``,
``graph_reindex``, ``graph_sample_neighbors``, ``graph_khop_sampler``)
stand over ``paddle.geometric``, which the port does not have yet: each
raises ``NotImplementedError`` (ROADMAP, Queue 1 item 15.7).
"""
from . import autograd, checkpoint, nn  # noqa: F401
from .nn.functional import (  # noqa: F401
    fused_softmax_mask as softmax_mask_fuse,
    fused_softmax_mask_upper_triangle as softmax_mask_fuse_upper_triangle,
)
from .optimizer import LookAhead, ModelAverage  # noqa: F401

_GEOMETRIC = "ROADMAP, Queue 1 item 15.7: paddle.geometric"


def _needs_geometric(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"incubate.{name} is an alias over paddle.geometric, which is "
            f"not ported yet ({_GEOMETRIC})")
    fn.__name__ = fn.__qualname__ = name
    return fn


segment_max = _needs_geometric("segment_max")
segment_mean = _needs_geometric("segment_mean")
segment_min = _needs_geometric("segment_min")
segment_sum = _needs_geometric("segment_sum")
graph_send_recv = _needs_geometric("graph_send_recv")
graph_reindex = _needs_geometric("graph_reindex")
graph_sample_neighbors = _needs_geometric("graph_sample_neighbors")
graph_khop_sampler = _needs_geometric("graph_khop_sampler")


def identity_loss(x, reduction="none"):
    """The loss marker: ``x`` reduced by ``reduction`` (``"none"`` / 2,
    ``"sum"`` / 1, else the mean)."""
    if reduction in ("none", 2):
        return x
    if reduction in ("sum", 1):
        return x.sum()
    return x.mean()
