"""paddle.incubate parity: ``incubate.nn`` (the fused functional ops
``fused_linear_activation``, ``fused_matmul_bias`` and
``fused_rotary_position_embedding`` over K7 and K6). The rest of the
reference's incubate package runs no kernel and comes later (ROADMAP,
Queue 1 item 15)."""
from . import nn

__all__ = ["nn"]
