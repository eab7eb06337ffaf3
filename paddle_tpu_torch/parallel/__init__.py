"""Parallel training utilities of the port: activation recompute
(``parallel.recompute_util``). The rest of the JAX package's
``parallel/`` (hybrid, pipeline, sharding, moe, ring attention) is
ROADMAP Queue 1 item 13."""
from .recompute_util import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
