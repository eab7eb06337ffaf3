"""Parallel training utilities of the port: activation recompute
(``parallel.recompute_util``) and the single-card mixture of experts
(``parallel.moe``). The rest of the JAX package's ``parallel/`` (hybrid,
pipeline, sharding, ring attention, and moe's expert-parallel
``all_to_all`` across cards) is ROADMAP Queue 1 item 13."""
from . import moe  # noqa: F401
from .recompute_util import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
